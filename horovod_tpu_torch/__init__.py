"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The ``hvd.*`` surface this slice provides: process and topology state over
``torch.distributed`` (NCCL on the GPU, gloo on the CPU), the data-parallel
mesh, fused gradient averaging, the step guard, ResNet v1.5, the
transformer LM with its flash-attention kernels, and the synthetic
training benchmarks.  The package imports ``torch`` and never JAX or any
module of ``horovod_tpu``.
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
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    mesh,
    rank,
    resolve_device,
    shutdown,
    size,
    topology,
)
from horovod_tpu_torch.ops.fusion import (  # noqa: F401
    fused_psum,
    fused_pytree_mean,
)
from horovod_tpu_torch.resilience import apply_step_guard  # noqa: F401

__version__ = "0.1.0"
