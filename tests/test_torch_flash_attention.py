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

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu.parallel.sequence import local_attention as jax_local
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel.sequence import local_attention
from torch_support import flash_kernels_as_plain

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
    wrapper's checks run on any device): f64 and head dims above 256.
    f32 and a head dim between the kernels' (48) get a plan instead: f32's
    kernels, the operands padded with zero columns to 64."""
    x = torch.zeros((1, 64, 2, 16), dtype=torch.float64)
    with pytest.raises(TypeError, match="float64.*x64"):
        tfa._kernel_operands(x, x, x)
    y = torch.zeros((1, 64, 2, 272), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 272.*up to 256"):
        tfa._kernel_operands(y, y, y)
    w = torch.randn((1, 64, 2, 48), generator=torch.Generator().manual_seed(0))
    assert tfa._kernel_plan(w.dtype, 48) == ("f32", 64)
    out = tfa._kernel_operands(w, w, w)
    assert all(o.shape == (1, 64, 2, 64) and o.is_contiguous() for o in out)
    assert torch.equal(out[0][..., :48], w) and not out[0][..., 48:].any()
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


# ---------------------------------------------------------------------------
# The kernels' whole input domain: f32 and f16 operands, head dims up to
# 256 (16, 32, 64, 128 and 256 run their own instances; others pad).
# ---------------------------------------------------------------------------

WIDE_DIMS = (16, 80, 96, 256)
_NP_DT = {"float32": np.float32, "float16": np.float16}
_JNP_DT = {"float32": jnp.float32, "float16": jnp.float16}
_TORCH_DT = {"float32": torch.float32, "float16": torch.float16}
# f16 operands: both sides upcast to f32, accumulate there (in different
# orders) and round o and the gradients to f16, whose half ulp is a
# relative 2^-11 = 4.9e-4; the backward takes di from each side's own f16
# o, so an o that rounds the other way moves a gradient by about an ulp
# more.  Read on the CPU: o 3.0e-4, gradients 4.8e-4 (of 1 + |ref|).
F16_TOL = 1e-3
F16_GRAD_TOL = 2e-3


def _tol(dtype, grad=False):
    if dtype == "float32":
        return GRAD_TOL if grad else FWD_TOL
    return F16_GRAD_TOL if grad else F16_TOL


def _wide_inputs(dtype, d, t=64, h=2):
    """q, k, v and the cotangent's weights w, [1, T, H, D], numpy."""
    rs = np.random.default_rng(d)
    return [rs.standard_normal((1, t, h, d)).astype(_NP_DT[dtype])
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_wide(dtype, d, causal=True):
    """The JAX kernel (interpret mode) on ``_wide_inputs``: o and the
    gradients of sum(o * w) (f32 numpy), computed once per case."""
    q, k, v, w = (jnp.asarray(x) for x in _wide_inputs(dtype, d))
    seg = jnp.asarray(_segments(1, [40, 24]))

    def fn(q, k, v):
        return jfa.flash_attention(q, k, v, causal, None, 32, 32, True,
                                   segment_ids=seg)

    @jax.jit
    def run(q, k, v, w):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o,) + vjp(w)

    return [np.asarray(x, dtype=np.float32) for x in run(q, k, v, w)]


def _port_wide(dtype, d, causal=True):
    q, k, v, w = (torch.from_numpy(x) for x in _wide_inputs(dtype, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal, block_q=32, block_k=32,
                            segment_ids=torch.from_numpy(_segments(1, [40,
                                                                       24])))
    grads = torch.autograd.grad(o, leaves, w)
    assert o.dtype == _TORCH_DT[dtype]
    assert all(g.dtype == _TORCH_DT[dtype] for g in grads)
    return [x.detach().float().numpy() for x in (o,) + grads]


def _assert_wide(got, want, dtype, what):
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        tol = _tol(dtype, grad=name != "o")
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_f32_and_f16_match_jax_at_every_head_dim(dtype, d):
    """The CPU route in f32 and f16 at D 16, 80, 96 and 256, packed and
    causal: o and the gradients against the JAX kernel, in the operands'
    dtype."""
    _assert_wide(_port_wide(dtype, d), _jax_wide(dtype, d), dtype,
                 f"{dtype} D={d}")


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("d", [80, 96])
def test_padded_route_matches_jax(monkeypatch, dtype, d):
    """The card's route at a head dim between the kernels': the operands
    reach the kernel calls padded with zero columns to 128, with the
    scale of the true head dim, and the outputs come back sliced, equal to
    the JAX kernel's (the kernel calls run the plain versions here)."""
    seen = flash_kernels_as_plain(monkeypatch)
    inst = {"float32": "f32", "float16": "f16"}[dtype]
    before = {k: c.count for k, c in tfa.instance_launches.items()}
    got = _port_wide(dtype, d)
    assert seen == [(kind, inst, (1, 64, 2, 128))
                    for kind in ("fwd", "bwd_dq", "bwd_dkv")]
    moved = {k: c.count - before[k] for k, c in
             tfa.instance_launches.items() if c.count != before[k]}
    assert moved == {(kind, inst, 128): 1
                     for kind in ("fwd", "bwd_dq", "bwd_dkv")}
    _assert_wide(got, _jax_wide(dtype, d), dtype, f"padded {dtype} D={d}")


@pytest.mark.parametrize("dtype,inst", [(torch.bfloat16, "bf16"),
                                        (torch.float16, "f16"),
                                        (torch.float32, "f32")])
def test_kernel_plan_covers_every_head_dim(dtype, inst):
    """Every head dim from 1 to 256 takes the dtype's kernels at the
    smallest kernel head dim that holds it; 257 and up raise."""
    for d in range(1, 257):
        want = min(x for x in tfa.KERNEL_HEAD_DIMS if x >= d)
        assert tfa._kernel_plan(dtype, d) == (inst, want), d
    for d in (257, 272, 512):
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            tfa._kernel_plan(dtype, d)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32,
                                   torch.complex64])
def test_kernel_plan_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        tfa._kernel_plan(dtype, 64)


# The slice as a whole: a small LM whose heads are 256 wide (d 512, 2
# heads, 1 layer, T 32), through the flash route in f32 and f16.
WIDE_LM = dict(vocab_size=64, d_model=512, n_heads=2, n_layers=1, d_ff=128,
               max_seq=32)
# f16: the activations round to f16 at every layer, on each side after its
# own matmul order (XLA's against PyTorch's), so the logits and the
# gradients differ by a few f16 ulps (read on the CPU: 1.0e-3 of 1 +
# |ref|, the logits the worst); f32: test_torch_transformer.py's 1e-4.
WIDE_LM_TOL = {"float32": 1e-4, "float16": 4e-3}


def _wide_lm_params(seed=0):
    rng = np.random.default_rng(seed)
    d, f = WIDE_LM["d_model"], WIDE_LM["d_ff"]

    def dense(shape, scale=None):
        return (rng.standard_normal(shape) * (scale or shape[0] ** -0.5)
                ).astype(np.float32)

    def norm():
        return (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)

    return {
        "embed": dense((WIDE_LM["vocab_size"], d), 0.02),
        "pos": dense((WIDE_LM["max_seq"], d), 0.02),
        "ln_f_scale": norm(),
        "layers": [{"ln1_scale": norm(), "ln2_scale": norm(),
                    "wq": dense((d, d)), "wk": dense((d, d)),
                    "wv": dense((d, d)), "wo": dense((d, d)),
                    "w1": dense((d, f)), "w2": dense((f, d))}
                   for _ in range(WIDE_LM["n_layers"])],
    }


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_lm_with_256_wide_heads_matches_jax(dtype):
    """The port's LM (weights carried from the flax tree by
    ``models/convert.py``) against the JAX package's, both with
    ``attention="flash"``: logits and the gradients of the loss."""
    params = _wide_lm_params()
    t = WIDE_LM["max_seq"]
    toks = np.random.default_rng(1).integers(0, 64, (2, t + 1)).astype(
        np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    jcfg = jtfm.TransformerConfig(dtype=_JNP_DT[dtype], **WIDE_LM)
    tcfg = tfm.TransformerConfig(dtype=_TORCH_DT[dtype], **WIDE_LM)
    assert tcfg.d_model // tcfg.n_heads == 256

    def jloss(p):
        logits = jtfm.forward(p, jnp.asarray(tokens), jcfg,
                              attention="flash")
        return jtfm.xent(logits, jnp.asarray(labels)), logits

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    model = tfm.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.lm_params_to_torch(params))
    leaves = dict(convert.lm_ordered_parameters(model))
    logits = tfm.forward(model.tree(), torch.from_numpy(tokens), tcfg,
                         attention="flash")
    grads = torch.autograd.grad(
        tfm.xent(logits, torch.from_numpy(labels)), list(leaves.values()))
    tol = WIDE_LM_TOL[dtype]
    np.testing.assert_allclose(logits.detach().float().numpy(),
                               np.asarray(jlogits, dtype=np.float32),
                               rtol=tol, atol=tol)
    want = convert.lm_params_to_torch(jax.tree_util.tree_map(
        lambda g: np.asarray(g, dtype=np.float32), jgrads))
    for (name, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.float().numpy(), want[name],
                                   rtol=tol, atol=tol, err_msg=name)
