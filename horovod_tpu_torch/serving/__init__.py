"""Multi-tenant serving plane: continuous-batching inference with hot
weight updates.

Counterpart of ``horovod_tpu/serving/``:

* :mod:`~horovod_tpu_torch.serving.model`: the three-method decode
  contract a replica drives, and the deterministic :class:`ToyModel`
  that tests assert exact tokens against;
* :mod:`~horovod_tpu_torch.serving.replica`: one weight copy served over
  the authenticated RPC plane, hot updates staged through the broadcast
  plane and applied at decode-step boundaries;
* :mod:`~horovod_tpu_torch.serving.router`: per-tenant queues,
  token-level continuous batching, quota and SLO admission, crash retry
  and the autoscaler's stats document.
"""

from horovod_tpu_torch.serving.model import DecodeModel, ToyModel  # noqa: F401
from horovod_tpu_torch.serving.replica import (  # noqa: F401
    ReplicaCrashed, ReplicaWorker, broadcast_weights, load_replica_model,
)
from horovod_tpu_torch.serving.router import (  # noqa: F401
    LocalReplicaHandle, ReplicaHandle, RequestHandle, Router,
    RpcReplicaHandle, TenantConfig, stats_path_from_env,
)
