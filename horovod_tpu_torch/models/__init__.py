"""Models of the PyTorch port: ResNet v1.5 (through the registry) and the
transformer LM (``models.transformer``)."""

from horovod_tpu_torch.models.registry import get_model  # noqa: F401
