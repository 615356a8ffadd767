"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` reads like the reference: process and
topology state over ``torch.distributed`` (NCCL on the GPU, gloo on the
CPU), the ``hvd.*`` collectives with their async handles, process sets
and ``join`` on a name-negotiating control plane,
``DistributedOptimizer`` and the state broadcasts, the callbacks, the
data-parallel mesh, fused gradient averaging, the ZeRO-1 sharded update
and its wire codecs, expert parallelism (``parallel.expert``),
checkpoints (``hvd.checkpoint``), the step guard and its host-side
ladder (``hvd.StepGuard``, last-known-good, the divergence sentinel,
preemption), elastic continuity and warm restart (spill files, the
recovery ladder, the heartbeat to the launcher, fail-in-place
``resilience.reform_world``), ResNet v1.5, the transformer LM with its flash-attention
kernels, and the synthetic training benchmarks.  The package imports
``torch`` and never JAX or any module of ``horovod_tpu``.

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size()),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
"""

from horovod_tpu_torch.topology import (  # noqa: F401
    Mesh,
    build_mesh,
    data_axis,
    mesh_size,
)
# Imported after the topology submodule, so ``topology`` names the
# accessor below and not the submodule.
from horovod_tpu_torch.basics import (  # noqa: F401
    CoordinatorInfo,
    Topology,
    coordinator,
    cross_rank,
    cross_size,
    ddl_built,
    device,
    gloo_built,
    gloo_enabled,
    init,
    is_initialized,
    local_devices,
    local_rank,
    local_size,
    mesh,
    mlsl_built,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    num_devices,
    rank,
    resolve_device,
    shutdown,
    size,
    topology,
    tpu_built,
    tpu_enabled,
    world_epoch,
)
from horovod_tpu_torch.ops.collective import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    ProcessSet,
    Sum,
    add_process_set,
    allgather,
    allgather_async,
    allgather_object,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_ragged,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    broadcast_object,
    global_process_set,
    grouped_allreduce,
    grouped_allreduce_async,
    join,
    poll,
    reducescatter,
    synchronize,
)
from horovod_tpu_torch.ops.fusion import (  # noqa: F401
    fused_psum,
    fused_pytree_mean,
)
from horovod_tpu_torch.ops.compression import resolve_codec  # noqa: F401
from horovod_tpu_torch.parallel.data import (  # noqa: F401
    Compression,
    DistributedGradientTape,
    DistributedOptimizer,
    broadcast_optimizer_state,
    broadcast_parameters,
    broadcast_variables,
    elastic_continuity,
    elastic_shard,
    elastic_transition,
    make_training_step,
)
from horovod_tpu_torch.parallel.zero import (  # noqa: F401
    reshard_state,
    sharded_optimizer,
)
from horovod_tpu_torch import callbacks  # noqa: F401
from horovod_tpu_torch.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    Callback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
    scaled_lr,
    warmup_schedule,
)
from horovod_tpu_torch import checkpoint  # noqa: F401
from horovod_tpu_torch import resilience  # noqa: F401
from horovod_tpu_torch.resilience import (  # noqa: F401
    StepGuard,
    apply_step_guard,
    report_progress,
    warm_restore,
)
from horovod_tpu_torch import telemetry  # noqa: F401
from horovod_tpu_torch.telemetry import metrics_snapshot  # noqa: F401

__version__ = "0.1.0"
