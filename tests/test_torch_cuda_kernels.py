"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips without a
CUDA device (a CUDA kernel has no CPU mode).  This file imports torch and
the port only, so it runs on a GPU host without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda
"""

import pytest
import torch

from horovod_tpu_torch.ops import fused_stem


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    scale = torch.randn(shape[-1], generator=g) + 0.5
    offset = torch.randn(shape[-1], generator=g)
    return x.cuda(), scale.cuda(), offset.cuda()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 8, 4), torch.float32), ((3, 12, 16, 8), torch.bfloat16),
    ((1, 6, 10, 3), torch.float32), ((2, 112, 112, 64), torch.bfloat16)])
def test_fused_stem_bitwise_equals_plain_version(cuda_device, shape, dtype):
    """Tolerance: none.  The kernel rounds where the plain version does,
    and it counts exactly one launch."""
    x, s, b = _inputs(shape, dtype, seed=8)
    before = fused_stem.launches.count
    out = fused_stem.fused_bn_relu_maxpool(x, s, b)
    torch.cuda.synchronize()
    assert fused_stem.launches.count == before + 1
    assert torch.equal(out, fused_stem._tail(x, s.to(dtype), b.to(dtype)))


@pytest.mark.cuda
def test_fused_stem_propagates_nan(cuda_device):
    """A NaN input poisons its pooled outputs, as the plain version's
    relu and maximum do, so the step guard sees a bad step."""
    x, s, b = _inputs((1, 8, 8, 8), torch.bfloat16, seed=9)
    x[0, 2, 2, 3] = float("nan")
    out = fused_stem.fused_bn_relu_maxpool(x, s, b)
    ref = fused_stem._tail(x, s.to(x.dtype), b.to(x.dtype))
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.isnan(out).any()


@pytest.mark.cuda
def test_fused_stem_rejects_device_mismatch(cuda_device):
    x, s, b = _inputs((1, 4, 4, 8), torch.float32, seed=10)
    with pytest.raises(ValueError, match="scale"):
        fused_stem.fused_bn_relu_maxpool(x, s.cpu(), b)
