"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips without a
CUDA device (a CUDA kernel has no CPU mode).  This file imports torch and
the port only, so it runs on a GPU host without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda
"""

import ctypes
import subprocess

import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as fa
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
    ((1, 6, 10, 3), torch.float32), ((2, 112, 112, 64), torch.bfloat16),
    # The kernel stages strips of output rows (and, for wide rows, column
    # tiles) with their halo: one output row, a last strip cut short, one
    # output column, ragged column tiles in both dtypes, and a vector
    # instance of three 16-byte channel groups.
    ((2, 2, 8, 64), torch.bfloat16), ((1, 118, 112, 64), torch.bfloat16),
    ((2, 8, 2, 16), torch.bfloat16), ((1, 16, 448, 64), torch.bfloat16),
    ((2, 20, 112, 64), torch.float32), ((2, 12, 16, 24), torch.bfloat16)])
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


# ---------------------------------------------------------------------------
# Flash attention: the forward, dQ and dK/dV kernels
# ---------------------------------------------------------------------------


# bf16 operands, f32 accumulation: o max abs; m, l relative to max(1,
# |ref|); o, dq, dk, dv row by row (one row: the D values of one
# (batch*head, position)), ||err_r|| <= ROW_RTOL * ||ref_r|| + ROW_ATOL *
# median_r ||ref_r||.  Causal gradients of late rows are 30-50x smaller
# than the first rows', so a limit scaled by the largest value would pass
# a kernel wrong on every late tile (test_flash_row_check_catches_...).
O_TOL, ML_TOL = 2e-2, 1e-4
ROW_RTOL, ROW_ATOL = 2 ** -6, 2 ** -8
# f32 operands (the FFMA kernels): chip_smoke.py's FLASH_F32_ROW_* and
# their reasons.
F32_ROW_RTOL, F32_ROW_ATOL = 2 ** -16, 2 ** -16


def _flash_inputs(bh, t, d, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((bh, t, d), generator=g).to(dtype).cuda()
            for _ in range(4)]


def _rel_to_one(a, b):
    both = a == b       # equal infinities (fully masked rows' m)
    return ((a - b).abs() / b.abs().clamp_min(1.0)).masked_fill(
        both, 0.0).max().item()


def _row_ratio(a, b, rtol=ROW_RTOL, atol=ROW_ATOL):
    """The worst row's error over its limit (passes at <= 1)."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    err, ref = (a - b).norm(dim=-1), b.norm(dim=-1)
    limit = rtol * ref + atol * ref.median()
    return torch.where(err == 0, 0.0, err / limit).max().item()


def _seg(b, lengths):
    ids = torch.repeat_interleave(torch.arange(len(lengths)),
                                  torch.tensor(lengths))
    return ids[None].repeat(b, 1).to(torch.int32).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,d,causal,scale,segs", [
    (8, 256, 128, True, None, None),
    (8, 64, 64, False, None, None),
    (6, 192, 128, True, 0.3, None),
    (2, 40, 16, True, None, None),
    (4, 192, 32, False, None, ([64, 64, 40, 24], [64, 64, 64])),
    (2, 512, 64, True, None, ([200, 300, 12], [200, 300, 12])),
    # The Hopper forward and dK/dV tile by 128 rows or keys: half-empty,
    # ragged and multi-tile T, the small head dims, segment borders inside
    # a tile, and a non-causal ragged T.
    (4, 64, 64, True, None, None),
    (4, 320, 64, True, None, None),
    (4, 256, 16, True, None, None),
    (4, 256, 32, True, None, None),
    (4, 512, 64, True, None, ([100, 200, 150, 62], [100, 200, 150, 62])),
    (4, 192, 128, False, None, None),
])
def test_flash_kernels_match_plain_versions(cuda_device, bh, t, d, causal,
                                            scale, segs):
    q, k, v, do = _flash_inputs(bh, t, d, seed=t + d)
    qs = ks = None
    if segs is not None:
        qs, ks = _seg(bh // 2, segs[0]), _seg(bh // 2, segs[1])
    sc = d ** -0.5 if scale is None else scale
    before = (fa.fwd_launches.count, fa.dq_launches.count,
              fa.dkv_launches.count)
    o, m, l = fa._fwd_parts(q, k, v, qs, ks, causal, sc)
    ro, rm, rl = fa._fwd_parts_plain(q, k, v, qs, ks, causal, sc)
    dq, dk, dv = fa._bwd_parts(q, k, v, ro, do, rm, rl, qs, ks, causal, sc)
    rdq, rdk, rdv = fa._bwd_parts_plain(q, k, v, ro, do, rm, rl, qs, ks,
                                        causal, sc)
    torch.cuda.synchronize()
    assert (fa.fwd_launches.count, fa.dq_launches.count,
            fa.dkv_launches.count) == tuple(x + 1 for x in before)
    assert (o.float() - ro.float()).abs().max().item() <= O_TOL
    assert _rel_to_one(m, rm) <= ML_TOL and _rel_to_one(l, rl) <= ML_TOL
    for a, b in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert _row_ratio(a, b) <= 1.0
    if segs is not None and segs[0] != segs[1]:
        # q-side segment 3 has no key: o = 0, l = 0 and dq = 0 there.
        assert not o[:, 168:].any() and not l[:, 0, 168:].any()
        assert not dq[:, 168:].any()


@pytest.mark.cuda
def test_flash_function_gradients_match_plain_route(cuda_device):
    """The autograd Function on [B, T, H, D] (the kernels read it in
    place): its o against the plain forward, its gradients against the
    plain backward fed the o it saved (the backward takes di from that
    bf16 o, as the TPU kernels do; another o, the plain forward's or
    autograd's f32 one, moves di by more than the row limit on rows whose
    attention sits on one key)."""
    g = torch.Generator().manual_seed(3)
    q, k, v, go = (torch.randn((2, 256, 2, 128), generator=g)
                   .to(torch.bfloat16).cuda() for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, block_q=128,
                             block_k=128)
    got = torch.autograd.grad(out, leaves, go)
    qf, kf, vf, gf = (fa._fold(x) for x in (q, k, v, go))
    ro, rm, rl = fa._fwd_parts_plain(qf, kf, vf, None, None, True,
                                     128 ** -0.5)
    want = fa._bwd_parts_plain(qf, kf, vf, fa._fold(out.detach()), gf, rm,
                               rl, None, None, True, 128 ** -0.5)
    assert (fa._fold(out).float() - ro.float()).abs().max() <= O_TOL
    for a, b in zip((out,) + got, (ro,) + want):
        assert _row_ratio(fa._fold(a), b) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("bh,t,d,causal,segs", [
    (8, 256, 128, True, None),
    (4, 320, 256, True, None),
    (4, 192, 256, False, ([64, 64, 40, 24], [64, 64, 64])),
    (4, 320, 80, True, None),
    (2, 40, 96, True, None),
    (2, 256, 16, True, None),
])
def test_flash_instances_match_plain_versions(cuda_device, dtype, bh, t, d,
                                              causal, segs):
    """The f16 (Hopper) and f32 (FFMA) instances and head dims 256, 80
    and 96 (padded to 128): o, dq, dk and dv in the operands' dtype, row
    by row against the plain versions (f32 at F32_ROW_*)."""
    q, k, v, do = _flash_inputs(bh, t, d, seed=t + d, dtype=dtype)
    qs = ks = None
    if segs is not None:
        qs, ks = _seg(bh // 2, segs[0]), _seg(bh // 2, segs[1])
    sc = d ** -0.5
    o, m, l = fa._fwd_parts(q, k, v, qs, ks, causal, sc)
    ro, rm, rl = fa._fwd_parts_plain(q, k, v, qs, ks, causal, sc)
    got = (o,) + fa._bwd_parts(q, k, v, ro, do, rm, rl, qs, ks, causal, sc)
    want = (ro,) + fa._bwd_parts_plain(q, k, v, ro, do, rm, rl, qs, ks,
                                       causal, sc)
    torch.cuda.synchronize()
    lim = (F32_ROW_RTOL, F32_ROW_ATOL) if dtype == torch.float32 else ()
    assert _rel_to_one(m, rm) <= ML_TOL and _rel_to_one(l, rl) <= ML_TOL
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == q.shape
        assert _row_ratio(a, b, *lim) <= 1.0


@pytest.mark.cuda
def test_flash_kernels_reject_float64(cuda_device):
    """f64 and head dims above 256 raise before any launch."""
    x = torch.zeros((1, 64, 2, 64), device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        fa.flash_attention(x, x, x)
    y = torch.zeros((1, 64, 2, 272), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 272"):
        fa.flash_attention(y, y, y)


@pytest.mark.cuda
def test_flash_kernels_propagate_nan(cuda_device):
    """A NaN in q poisons its row's output, as the reference's max and
    exp do, so the step guard sees a bad step."""
    q, k, v, _ = _flash_inputs(2, 128, 64, seed=5)
    q[0, 70, 3] = float("nan")
    o, m, l = fa._fwd_parts(q, k, v, None, None, True, 0.125)
    ref, _, _ = fa._fwd_parts_plain(q, k, v, None, None, True, 0.125)
    assert torch.equal(torch.isnan(o), torch.isnan(ref))
    assert torch.isnan(o[0, 70]).all() and not torch.isnan(o[0, :70]).any()


# Faults planted in a copy of the kernel source, each wrong only on the
# late tiles (queries or keys from 1024 on), where the causal gradients
# are small: (text in flash_attention.cu, its faulty replacement).  The
# faults sit in the tile-count helpers that each kernel's producer and
# consumers share, so the faulty kernels still finish.
PLANTED_FAULTS = {
    # The forward drops its diagonal key tile.
    "fwd_drops_diagonal_k_tile": (
        "const int kend = causal ? min(T, q0 + FWD_BR) : T;",
        "const int kend = causal ? min(T, q0 + FWD_BR) - (q0 >= 1024) * "
        "FWD_BC : T;"),
    # dK/dV starts one q tile late: it skips the diagonal tile.
    "dkv_starts_one_q_tile_late": (
        "return causal ? k0 / DKV_BQ : 0;",
        "return causal ? k0 / DKV_BQ + (k0 >= 1024) : 0;"),
    # dQ drops its last key tiles, the diagonal ones of both warpgroups.
    "dq_drops_last_k_tile": (
        "const int kend = causal ? min(T, q0 + DQ_BR) : T;",
        "const int kend = causal ? min(T, q0 + DQ_BR) - (q0 >= 1024) * "
        "DQ_BR : T;"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_flash_row_check_catches_planted_faults(cuda_device, tmp_path,
                                                monkeypatch, fault):
    """The row check passes the kernels at T = 2048 and fails a copy with
    a fault on the late tiles.  Prints, for the record, the check it
    replaced: max abs over max(1, max |ref|), with its 3e-2 limit."""
    q, k, v, do = _flash_inputs(8, 2048, 128, seed=21)
    sc = 128 ** -0.5
    ro, rm, rl = fa._fwd_parts_plain(q, k, v, None, None, True, sc)
    want = (ro,) + fa._bwd_parts_plain(q, k, v, ro, do, rm, rl, None, None,
                                       True, sc)

    def outputs():
        o, _, _ = fa._fwd_parts(q, k, v, None, None, True, sc)
        return (o,) + fa._bwd_parts(q, k, v, ro, do, rm, rl, None, None,
                                    True, sc)

    for name, a, b in zip(("o", "dq", "dk", "dv"), outputs(), want):
        ratio = _row_ratio(a, b)
        print(f"unmodified kernels: {name} worst row / limit {ratio:.4g}")
        assert ratio <= 1.0

    old, new = PLANTED_FAULTS[fault]
    with open(f"{_build.CSRC}/flash_attention.cu") as f:
        src = f.read()
    assert src.count(old) == 1
    cu, lib = tmp_path / "flash_attention.cu", tmp_path / "libfault.so"
    cu.write_text(src.replace(old, new))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", str(lib), str(cu)], check=True, capture_output=True,
                   timeout=600)
    monkeypatch.setitem(_build._libs, "flash_attention",
                        ctypes.CDLL(str(lib)))
    ratios = {}
    for name, a, b in zip(("o", "dq", "dk", "dv"), outputs(), want):
        old_err = ((a.float() - b.float()).abs().max()
                   / b.float().abs().max().clamp_min(1.0)).item()
        ratios[name] = _row_ratio(a, b)
        print(f"{fault}: {name} worst row / limit {ratios[name]:.4g}; "
              f"max abs / max(1, max |ref|) {old_err:.4g}")
    assert max(ratios.values()) > 1.0
