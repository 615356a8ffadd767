"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` reads like the reference: process and
topology state over ``torch.distributed`` (NCCL on the GPU, gloo on the
CPU), the ``hvd.*`` collectives with their async handles, process sets
and ``join`` on a name-negotiating control plane,
``DistributedOptimizer`` and the state broadcasts, the callbacks, the
data-parallel mesh, fused gradient averaging, the step guard,
ResNet v1.5, the transformer LM with its flash-attention kernels, and
the synthetic training benchmarks.  The package imports ``torch`` and
never JAX or any module of ``horovod_tpu``.

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
    Topology,
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
from horovod_tpu_torch.parallel.data import (  # noqa: F401
    Compression,
    DistributedGradientTape,
    DistributedOptimizer,
    broadcast_optimizer_state,
    broadcast_parameters,
    broadcast_variables,
    make_training_step,
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
from horovod_tpu_torch.resilience import apply_step_guard  # noqa: F401

__version__ = "0.1.0"
