"""The port's flash attention against the JAX package's, on the CPU.

The same seeded inputs (numpy ``default_rng``) go through the JAX kernel
in Pallas interpret mode (``interpret=True``, as
``tests/test_flash_attention.py`` runs it) and through the port's
``flash_attention``, which on CPU tensors
runs its plain PyTorch versions (``_fwd_parts_plain``, ``_bwd_dq_plain``,
``_bwd_dkv_plain``).  Tolerances: f32 forward 2e-5 and gradients 2e-4
(both sides accumulate in f32, in different orders), bf16 3e-2 (the
reference's own bf16 tolerance).  The CUDA kernels are held to the same
plain versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu.parallel.sequence import local_attention as jax_local
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel.sequence import local_attention

FWD_TOL = 2e-5
GRAD_TOL = 2e-4
BF16_TOL = 3e-2


def _qkv(seed, b=2, t=64, h=2, d=16):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _segments(b, lengths):
    ids = np.concatenate([np.full(n, i) for i, n in enumerate(lengths)])
    return np.repeat(ids[None].astype(np.int32), b, axis=0)


def _jax_flash(q, k, v, causal, scale=None, bq=32, bk=32, seg=None):
    return np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, bq,
        bk, True, segment_ids=None if seg is None else jnp.asarray(seg)))


def _port_flash(q, k, v, causal, scale=None, bq=32, bk=32, seg=None):
    return tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale, bq, bk,
        segment_ids=None if seg is None else torch.from_numpy(seg)).numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ["plain", "uneven_blocks", "custom_scale",
                                  "segments"])
def test_forward_matches_jax(causal, case):
    """Causal and not, block_q != block_k, a custom scale, and packed
    segments of uneven lengths."""
    q, k, v = _qkv(0)
    kw = {}
    if case == "uneven_blocks":
        kw = dict(bq=32, bk=16)
    elif case == "custom_scale":
        kw = dict(scale=0.5)
    elif case == "segments":
        kw = dict(seg=_segments(2, [20, 28, 16]))
    np.testing.assert_allclose(_port_flash(q, k, v, causal, **kw),
                               _jax_flash(q, k, v, causal, **kw),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
def test_gradients_match_jax(causal, segmented):
    q, k, v = _qkv(1)
    seg = _segments(2, [24, 40]) if segmented else None

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, None, 32, 32, True,
                                segment_ids=None if seg is None
                                else jnp.asarray(seg))
        return jnp.sum(o * (o + 1.0))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal, block_q=32, block_k=32,
                            segment_ids=None if seg is None
                            else torch.from_numpy(seg))
    got = torch.autograd.grad((o * (o + 1.0)).sum(), leaves)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def _parts_inputs(case):
    """Folded q/k/v and [B, 1, T] q- and k-side segment ids.  In
    ``split`` the q side's segment 3 never appears on the k side, so its
    rows are fully masked (ring attention's rotated ids give this)."""
    b, t, h = 2, 64, 2
    q, k, v = (jfa._fold(jnp.asarray(x)) for x in _qkv(2, b, t, h))
    if case == "none":
        return q, k, v, None, None, h
    qseg = _segments(b, [24, 24, 16])
    kseg = qseg
    if case == "split":
        qseg = np.where(qseg == 2, 3, qseg)
        kseg = _segments(b, [24, 40])
    return q, k, v, qseg[:, None], kseg[:, None], h


def _np(x):
    return np.array(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ["none", "self", "split"])
def test_fwd_parts_match_jax(causal, case):
    """(o, m, l) of the folded forward: m the row max of the scaled
    scores, l the UNnormalized row sum; fully masked rows have m = -inf,
    l = 0 and o = 0 in both."""
    q, k, v, qs, ks, h = _parts_inputs(case)
    jo, jm, jl = jfa._fwd_parts(q, k, v, qs, ks, h, causal, 0.3, 32, 16,
                                True)
    o, m, l = tfa._fwd_parts(_t(q), _t(k), _t(v), _t(qs), _t(ks), causal,
                             0.3)
    assert m.shape == l.shape == (q.shape[0], 1, q.shape[1])
    np.testing.assert_allclose(o.numpy(), _np(jo), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(l.numpy(), _np(jl), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(m.numpy(), _np(jm), rtol=FWD_TOL,
                               atol=FWD_TOL)
    if case == "split":
        masked = slice(48, 64)
        assert np.all(np.isneginf(m.numpy()[:, 0, masked]))
        assert not np.any(l.numpy()[:, 0, masked])
        assert not np.any(o.numpy()[:, masked])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ["none", "self", "split"])
def test_bwd_parts_match_jax(causal, case):
    """(dq, dk, dv) from the global (m, l); fully masked rows get zero
    gradients."""
    q, k, v, qs, ks, h = _parts_inputs(case)
    jo, jm, jl = jfa._fwd_parts(q, k, v, qs, ks, h, causal, 0.3, 32, 32,
                                True)
    do = jnp.asarray(np.random.default_rng(3).standard_normal(
        q.shape).astype(np.float32))
    want = jfa._bwd_parts(q, k, v, jo, do, jm, jl, qs, ks, h, causal, 0.3,
                          32, 32, True)
    got = tfa._bwd_parts(*map(_t, (q, k, v, jo, do, jm, jl, qs, ks)),
                         causal, 0.3)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")
    if case == "split":
        assert not np.any(got[0].numpy()[:, 48:64])


def test_bf16_inputs_match_jax():
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(4))
    want = np.asarray(jfa.flash_attention(
        *map(jnp.asarray, (q, k, v)), True, None, 32, 32, True),
        dtype=np.float32)
    got = tfa.flash_attention(
        *(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
          for x in (q, k, v)), causal=True, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_short_sequence_block_clamp_matches_jax():
    """Blocks larger than T clamp to T instead of failing."""
    q, k, v = _qkv(5, t=40)
    np.testing.assert_allclose(
        _port_flash(q, k, v, True, bq=128, bk=128),
        _jax_flash(q, k, v, True, bq=128, bk=128), rtol=FWD_TOL,
        atol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
def test_local_attention_matches_jax(causal, segmented):
    q, k, v = _qkv(6)
    seg = _segments(2, [30, 34]) if segmented else None
    want = jax_local(*map(jnp.asarray, (q, k, v)), causal=causal,
                     segment_ids=None if seg is None else jnp.asarray(seg))
    got = local_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          segment_ids=_t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_local_attention_singleton_segments_attend_to_themselves():
    """Every token its own segment, not causal: each row's only allowed
    key is itself, so o == v and the gradients are finite."""
    q, k, v = _qkv(7, b=1, t=16)
    seg = np.arange(16, dtype=np.int32)[None]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = local_attention(*leaves, causal=False, segment_ids=_t(seg))
    np.testing.assert_allclose(o.detach().numpy(), v, rtol=1e-6, atol=1e-6)
    grads = torch.autograd.grad(o.sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_port_local_attention(causal):
    q, k, v = _qkv(8)
    want = local_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(_port_flash(q, k, v, causal), want.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("t", [8, 24, 40, 64, 100, 128, 192, 256, 1000,
                               2048, 4096])
@pytest.mark.parametrize("head_dim", [64, 256])
def test_block_contract_matches_jax(t, head_dim):
    """Which sequence lengths the default blocks accept, and the blocks
    chosen, are the reference's."""
    try:
        want = jfa._eff_blocks(t, None, None, head_dim)
    except ValueError as e:
        with pytest.raises(ValueError, match="divisible"):
            tfa._eff_blocks(t, None, None, head_dim)
        assert "divisible" in str(e)
    else:
        assert tfa._eff_blocks(t, None, None, head_dim) == want


def test_rejects_ragged_sequence():
    q, k, v = _qkv(9, t=100)
    with pytest.raises(ValueError, match="divisible"):
        _port_flash(q, k, v, True, bq=64, bk=64)
    with pytest.raises(ValueError, match="divisible"):
        _jax_flash(q, k, v, True, bq=64, bk=64)


@pytest.mark.parametrize("bad,match", [
    ("shape_mismatch", "shapes must match"),
    ("not_4d", "shapes must match|B, T, H, D"),
    ("segment_shape", r"segment_ids must be \[B, T\]"),
    ("segment_dtype", "integer"),
])
def test_shape_and_dtype_errors(bad, match):
    q, k, v = map(torch.from_numpy, _qkv(10))
    seg = None
    if bad == "shape_mismatch":
        k = k[:, :32]
    elif bad == "not_4d":
        q, k, v = q[0], k[0], v[0]
    elif bad == "segment_shape":
        seg = torch.zeros((2, 32), dtype=torch.int32)
    else:
        seg = torch.zeros((2, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, v, True, None, 32, 32, segment_ids=seg)


def test_kernel_wrapper_checks_run_before_any_launch():
    """What the CUDA kernels refuse, checked before any launch (the
    wrapper's checks run on any device)."""
    x = torch.zeros((1, 64, 2, 16))
    with pytest.raises(TypeError, match="bfloat16.*float32"):
        tfa._kernel_operands(x, x, x)
    y = torch.zeros((1, 64, 2, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 48"):
        tfa._kernel_operands(y, y, y)
    z = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one shape"):
        tfa._kernel_operands(z, z[:, :32], z)
    with pytest.raises(ValueError, match="segment-id rows"):
        tfa._Geometry(z, torch.zeros((3, 64), dtype=torch.int32))


def test_cpu_route_launches_no_kernel():
    before = (tfa.fwd_launches.count, tfa.dq_launches.count,
              tfa.dkv_launches.count)
    leaves = [torch.from_numpy(x).requires_grad_() for x in _qkv(11)]
    tfa.flash_attention(*leaves, block_q=32, block_k=32).sum().backward()
    assert (tfa.fwd_launches.count, tfa.dq_launches.count,
            tfa.dkv_launches.count) == before


def test_unsupported_device_raises():
    q = torch.zeros((1, 64, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q, q, q, True, None, 32, 32)
