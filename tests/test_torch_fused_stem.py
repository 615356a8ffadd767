"""The port's fused stem tail against the JAX package's.

Same inputs (numpy, seeded) through ``horovod_tpu.ops.fused_stem`` (its
plain lax version, and its Pallas kernel in interpret mode) and through
``horovod_tpu_torch.ops.fused_stem`` (its plain PyTorch version, the route
a CPU tensor takes).  The CUDA kernel itself runs only on the card:
``tests/test_torch_cuda_kernels.py`` holds it against the plain version
there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fused_stem as jfs
from horovod_tpu_torch.ops import fused_stem as tfs


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) + 0.5).astype(np.float32)
    offset = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, scale, offset


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 12, 16, 8),
                                   (3, 6, 10, 3)])
def test_plain_version_bitwise_equals_jax_f32(shape):
    """Tolerance: none.  Both compute x*scale, +offset, relu and the
    pair/odd pool as separate eager f32 ops."""
    x, s, b = _inputs(shape, seed=1)
    want = np.asarray(jfs._tail(*_jax(x, s, b)))
    got = tfs._tail(*_torch(x, s, b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_matches_jax_kernel_in_interpret_mode(monkeypatch):
    """Against the Pallas kernel (interpret mode); tolerance 2e-6, as the
    JAX package's own kernel test uses (its kernel may fuse to an FMA)."""
    monkeypatch.setenv("HOROVOD_FUSED_STEM_INTERPRET", "1")
    x, s, b = _inputs((2, 8, 8, 4), seed=3)
    want = np.asarray(jfs.fused_bn_relu_maxpool(*_jax(x, s, b)))
    got = tfs.fused_bn_relu_maxpool(*_torch(x, s, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 12, 16, 8)])
def test_gradients_match_jax(shape):
    """d/dx, d/dscale, d/doffset of sum(out**2) against jax.grad through
    the reference's custom_vjp; tolerance 1e-6 (f32 sums in another
    order)."""
    x, s, b = _inputs(shape, seed=4)

    def f_jax(x_, s_, b_):
        return (jfs.fused_bn_relu_maxpool(x_, s_, b_) ** 2).sum()

    want = jax.grad(f_jax, argnums=(0, 1, 2))(*_jax(x, s, b))
    leaves = [t.requires_grad_() for t in _torch(x, s, b)]
    (tfs.fused_bn_relu_maxpool(*leaves) ** 2).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_tied_maxima_split_gradient_evenly_like_jax():
    """Equal positive values in a pool window: both packages split the
    gradient evenly between them (a max_pool2d backward would not)."""
    x = np.ones((1, 4, 4, 1), np.float32)
    s, b = np.ones(1, np.float32), np.zeros(1, np.float32)
    want = jax.grad(lambda x_: jfs.fused_bn_relu_maxpool(
        x_, *_jax(s, b)).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tfs.fused_bn_relu_maxpool(xt, *_torch(s, b)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert len(np.unique(xt.grad.numpy())) > 1


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_bf16_within_one_ulp_of_jax():
    """bf16 input, f32 coefficients cast to bf16 by both: outputs within
    one bf16 ulp of the JAX package's."""
    x, s, b = _inputs((2, 12, 16, 8), seed=5)
    want = np.asarray(jfs.fused_bn_relu_maxpool(
        jnp.asarray(x, jnp.bfloat16), *_jax(s, b)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tfs.fused_bn_relu_maxpool(xt, *_torch(s, b))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))


@pytest.mark.parametrize("shape", [(1, 7, 8, 4), (1, 8, 5, 4)])
def test_odd_shapes_rejected(shape):
    with pytest.raises(ValueError, match="even"):
        tfs.fused_bn_relu_maxpool(torch.zeros(shape), torch.ones(4),
                                  torch.zeros(4))


def test_other_dtypes_and_layouts_rejected():
    with pytest.raises(TypeError):
        tfs.fused_bn_relu_maxpool(torch.zeros(1, 4, 4, 2, dtype=torch.float64),
                                  torch.ones(2), torch.zeros(2))
    with pytest.raises(ValueError, match="contiguous"):
        tfs.fused_bn_relu_maxpool(torch.zeros(1, 4, 8, 2)[:, :, ::2],
                                  torch.ones(2), torch.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        tfs.fused_bn_relu_maxpool(torch.zeros(1, 4, 4, 2), torch.ones(3),
                                  torch.zeros(2))


def test_cpu_route_is_the_plain_version_and_launches_nothing():
    x, s, b = _torch(*_inputs((2, 8, 8, 4), seed=6))
    before = tfs.launches.count
    out = tfs.fused_bn_relu_maxpool(x, s, b)
    assert tfs.launches.count == before
    assert torch.equal(out, tfs._tail(x, s, b))
