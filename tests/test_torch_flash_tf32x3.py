"""The f32 flash kernels' three-pass TF32 arithmetic, emulated on the CPU.

The forward, dQ and dK/dV kernels of ``csrc/flash_attention_f32.cu``
multiply f32 operands on the tensor cores, which take them only as TF32.  Each
operand x is split into ``big = tf32(x)`` and ``small = tf32(x - big)``,
and a product is summed in three passes, small terms first:
``a.b = a_small.b_big + a_big.b_small + a_big.b_big``.  ``tf32`` rounds
to nearest, ties away from zero, keeping 10 of f32's 23 mantissa bits, as
PTX ``cvt.rna.tf32.f32`` does; ``_tf32`` below does it with the bit mask
``(bits + 0x1000) & ~0x1fff`` (on an H100 the kernels' outputs were
bitwise the same with either rounding).

The emulation runs the port's plain versions (``_fwd_parts_plain``,
``_bwd_dq_plain``, ``_bwd_dkv_plain``) with every ``torch.matmul``
replaced by the three-pass product of the split f32 operands (the plain dQ
forms dP - di in f64 from f64 copies of them, read back here as the
kernels read them), and dQ's ``di`` taken as the dQ kernel takes it,
the diagonal of dO . O^T by the products that give dP (``_kernel_di``; the
plain versions sum the reference's ``rowsum(dO * O)``).  A TF32 x TF32
product is exact in f32, so the emulated passes differ from the card's
only in how their sums are added: f32 rounding here, where the tensor
cores truncate (the kernels keep every such chain short for that reason).
The numpy-seeded inputs also go through the JAX package's kernels in
Pallas interpret mode (as its own tests run them), and o, dq, dk and dv
are held to them with ``chip_smoke.py``'s f32 row limits
(``FLASH_F32_ROW_RTOL`` and ``_ATOL``, 2^-16), row by row.  The same
emulation with one TF32 pass misses those limits by far: that is why the
kernels take three.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

_MATMUL = torch.matmul
B, H = 1, 2
# (head dim, T, segment lengths or None): causal, packed where given.
CASES = ((16, 256, (100, 156)), (64, 256, None), (128, 128, (50, 78)),
         (256, 128, (64, 64)))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32 rounds: add half the weight
    of the 13 dropped mantissa bits to the magnitude, then clear them (the
    sign is apart from the magnitude, so ties go away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _matmul_f32(a, b):
    """f32 products of the operands as the kernels read them (the plain
    versions' f64 copies of f32 operands, for dP, read back exactly)."""
    return _MATMUL(a.float(), b.float())


def _matmul_tf32x3(a, b):
    a, b = a.float(), b.float()
    ab, asm = _split(a)
    bb, bsm = _split(b)
    return (_MATMUL(asm, bb) + _MATMUL(ab, bsm)) + _MATMUL(ab, bb)


def _matmul_tf32(a, b):
    return _MATMUL(_tf32(a.float()), _tf32(b.float()))


def _segments(lengths):
    ids = np.concatenate([np.full(n, i) for i, n in enumerate(lengths)])
    return ids[None, None].astype(np.int32)  # [B, 1, T]


def _inputs(d, t, lengths):
    rs = np.random.default_rng(d + t)
    q, k, v, do = (rs.standard_normal((B * H, t, d)).astype(np.float32)
                   for _ in range(4))
    seg = None if lengths is None else _segments(lengths)
    return q, k, v, do, seg


@functools.lru_cache(maxsize=None)
def _jax(d, t, lengths):
    """The JAX kernels (interpret mode): o, m, l and (dq, dk, dv) from the
    global m and l, numpy."""
    q, k, v, do, seg = (None if x is None else jnp.asarray(x)
                        for x in _inputs(d, t, lengths))
    o, m, l = jfa._fwd_parts(q, k, v, seg, seg, H, True, d ** -0.5, 64, 64,
                             True)
    dq, dk, dv = jfa._bwd_parts(q, k, v, o, do, m, l, seg, seg, H, True,
                                d ** -0.5, 64, 64, True)
    return tuple(np.array(x) for x in (o, m, l, dq, dk, dv))


def _kernel_di(common):
    """``tfa._bwd_common`` with its di taken as the f32 dQ kernel takes it:
    the diagonal of dO . O^T by the products that give dP (``torch.matmul``
    of the same shapes and layout, so the same summation), block by
    block."""
    def bwd_common(qf, of, dof, m, l, qseg, kseg):
        safe_m, denom, _, *rest = common(qf, of, dof, m, l, qseg, kseg)
        o, do = of.float().contiguous(), dof.float().contiguous()
        di = torch.empty(o.shape[:2])
        for k0 in range(0, o.shape[1], tfa._PLAIN_BLOCK_K):
            k1 = min(k0 + tfa._PLAIN_BLOCK_K, o.shape[1])
            di[:, k0:k1] = torch.matmul(do, o[:, k0:k1].transpose(1, 2))[
                :, k0:k1].diagonal(dim1=1, dim2=2)
        return (safe_m, denom, di, *rest)
    return bwd_common


def _emulated(monkeypatch, matmul, d, t, lengths):
    """The port's plain forward, dQ (with the kernel's di) and dK/dV with
    ``matmul`` for every product; the backward takes the JAX kernels' o,
    m and l, as the card's takes the forward's."""
    q, k, v, do, seg = (None if x is None else torch.from_numpy(x)
                        for x in _inputs(d, t, lengths))
    jo, jm, jl = (torch.from_numpy(x) for x in _jax(d, t, lengths)[:3])
    monkeypatch.setattr(torch, "matmul", matmul)
    o, m, l = tfa._fwd_parts_plain(q, k, v, seg, seg, True, d ** -0.5)
    with monkeypatch.context() as mp:
        mp.setattr(tfa, "_bwd_common", _kernel_di(tfa._bwd_common))
        dq = tfa._bwd_dq_plain(q, k, v, jo, do, jm, jl, seg, seg, True,
                               d ** -0.5)
    dk, dv = tfa._bwd_dkv_plain(q, k, v, jo, do, jm, jl, seg, seg, True,
                                d ** -0.5)
    monkeypatch.undo()
    return o, m, l, dq, dk, dv


def _ratios(got, d, t, lengths):
    """Each output's worst row over its f32 row limit (<= 1 passes)."""
    want = [torch.from_numpy(x) for x in _jax(d, t, lengths)]
    lim = (chip_smoke.FLASH_F32_ROW_RTOL, chip_smoke.FLASH_F32_ROW_ATOL)
    return {name: chip_smoke._row_ratio(got[i], want[i], *lim)
            for name, i in (("o", 0), ("dq", 3), ("dk", 4), ("dv", 5))}


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The bit mask rounds as cvt.rna.tf32.f32: a tie (1 + 2^-11) goes
    away from zero, in both signs; below a tie it goes down; and big +
    (x - big) gives back x exactly."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      3 * ulp, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 3 * ulp, 0.0, -0.0],
                        dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    big = _tf32(y)
    assert torch.equal(big + (y - big), y)
    assert not torch.any(big.view(torch.int32) & 0x1FFF)
    small = _tf32(y - big)
    assert float(((y - big - small).abs() / y.abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("d,t,lengths", CASES)
def test_three_tf32_passes_hold_the_f32_row_limits(monkeypatch, d, t,
                                                   lengths):
    """The three-pass products in the forward, dQ and dK/dV math against
    the JAX kernels: o, dq, dk and dv within the f32 row limits, m and l
    within FLASH_ML_TOL."""
    got = _emulated(monkeypatch, _matmul_tf32x3, d, t, lengths)
    ratios = _ratios(got, d, t, lengths)
    assert max(ratios.values()) <= 1.0, ratios
    m, l = got[1:3]
    jm, jl = (torch.from_numpy(x) for x in _jax(d, t, lengths)[1:3])
    for got, want in ((m, jm), (l, jl)):
        assert chip_smoke._rel_to_one(got, want) <= chip_smoke.FLASH_ML_TOL


@pytest.mark.parametrize("d,t,lengths", CASES)
def test_one_tf32_pass_misses_the_f32_row_limits(monkeypatch, d, t,
                                                 lengths):
    """The same math with one TF32 pass (big . big): every one of o, dq,
    dk and dv misses its row limit."""
    got = _emulated(monkeypatch, _matmul_tf32, d, t, lengths)
    ratios = _ratios(got, d, t, lengths)
    assert min(ratios.values()) > 1.0, ratios


def _one_key_rows(t, lengths):
    """The rows whose one visible key is themselves: the first query and,
    packed, each segment's first."""
    starts = np.cumsum((0,) + tuple(lengths or ())[:-1])
    return sorted(set(int(x) for x in starts) | {0})


@pytest.mark.parametrize("d,t,lengths", CASES)
@pytest.mark.parametrize("matmul", [_matmul_f32, _matmul_tf32x3],
                         ids=["f32", "tf32x3"])
def test_dq_of_a_row_with_one_visible_key_is_zero(monkeypatch, matmul, d,
                                                  t, lengths):
    """The dQ kernel's di is the diagonal of dO . O^T by the products that
    give dP, so where a row's one visible key is itself (o = v there) dP -
    di cancels exactly and dq is 0, as in exact arithmetic, with f32
    products and with three TF32 passes; the other rows are not 0."""
    dq = _emulated(monkeypatch, matmul, d, t, lengths)[3]
    rows = _one_key_rows(t, lengths)
    assert not dq[:, rows].any()
    others = np.setdiff1d(np.arange(t), rows)
    assert bool(dq[:, others].norm(dim=-1).gt(0).all())
