"""The port's launcher, ``python -m horovod_tpu_torch.runner`` (the
reference's ``hvdrun``, :mod:`horovod_tpu_torch.runner.run`), and the
ranks' half of its planes (:mod:`horovod_tpu_torch.runner.rpc`)."""

from horovod_tpu_torch.runner.run import main, run_command  # noqa: F401
