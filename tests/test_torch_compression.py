"""The port's wire codecs against the JAX package's, on the CPU.

One 4-rank gloo job (started first; the JAX side computes on 4 CPU
devices meanwhile) runs, for every codec, three steps of
``compressed_reduce_scatter`` and ``compressed_all_gather`` with the
codec state carried, on per-rank gradients of the reference EF harness's
shapes, each package from its own initial state (PowerSGD's first
factor is the reference's ``PRNGKey`` draw in both, held bitwise here).
Tolerances: ``none`` bitwise; the others f32 ``rtol`` 1e-6 (int8's
codes are bitwise; its f32 sums
and PowerSGD's all-reduces and QR sum in another order), PowerSGD's
factors compared up to column sign.  The same job runs the reference's
error-feedback convergence harness (``tests/test_compression.py``) and
``cross_level_psum`` under each stateless codec.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import compression as JC
from horovod_tpu.ops import fusion as jfusion
import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import _threefry, compression as TC
from horovod_tpu_torch.ops import fusion as tfusion

from torch_support import start_port_job, world1  # noqa: F401

N = 4
SHAPES = [(16, 8), (37,), (5,)]
CODECS = ["none", "bf16", "fp16", "int8", "powersgd:2"]
STEPS = 3
RTOL = 1e-6
EF_STEPS = {"bf16": 3, "fp16": 3, "int8": 15, "powersgd:2": 20}
CROSS = ["none", "bf16", "fp16", "int8"]


def _grads(step, seed=0):
    """Per-rank gradients: leaf i is ``[N, *SHAPES[i]]``."""
    rng = np.random.RandomState(seed + 100 * step)
    return [_grid(rng.randn(N, *s)) for s in SHAPES]


def _grid(a):
    """``a`` rounded to a 2^-3 grid: a sum over four ranks is then exact
    whatever its order, in f32 and on the bf16 and fp16 wires (gloo and
    XLA's CPU collectives add the ranks in different orders)."""
    return (np.round(np.asarray(a) * 8) / 8).astype(np.float32)


def _proto():
    return [jax.ShapeDtypeStruct(s, jnp.float32) for s in SHAPES]


def _jplan(codec):
    return jfusion.make_reduce_scatter_plan(_proto(), N,
                                            codec=JC.resolve_codec(codec))


def _jinit(codec):
    c = JC.resolve_codec(codec)
    return c.init_state(_jplan(codec))


def _inputs():
    x = {}
    for t in range(STEPS):
        for i, g in enumerate(_grads(t)):
            x[f"g{t}_{i}"] = g
    rng = np.random.default_rng(3)
    x["cross"] = _grid(rng.standard_normal((N, 11)))
    return x


JOB = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import compression as C, fusion

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
x = dict(np.load(os.path.join(out, "inputs.npz")))
SHAPES = %(shapes)r
res = {}
proto = [torch.empty(s) for s in SHAPES]
for spec in %(codecs)r:
    codec = C.resolve_codec(spec)
    plan = fusion.make_reduce_scatter_plan(proto, %(n)d, codec=codec)
    st = codec.init_state(plan)
    for t in range(%(steps)d):
        leaves = [torch.from_numpy(x[f"g{t}_{i}"][r])
                  for i in range(len(SHAPES))]
        shards, st = C.compressed_reduce_scatter(leaves, None, codec,
                                                 plan=plan, state=st)
        full, st = C.compressed_all_gather(shards, plan, None, codec, st)
        for b, s in enumerate(shards):
            res[f"{spec}/{t}/shard{b}"] = s.numpy()
        for i, f in enumerate(full):
            res[f"{spec}/{t}/leaf{i}"] = f.numpy()
    if st is not None:
        for name in ("rs", "ag", "factors"):
            for b, a in enumerate(getattr(st, name)):
                if a is not None:
                    res[f"{spec}/state/{name}{b}"] = a.numpy()

# The reference's error-feedback harness: the same per-rank gradients
# every step, the cumulative mean's relative error against the true mean.
for spec, steps in %(ef)r.items():
    codec = C.resolve_codec(spec)
    rng = np.random.RandomState(0)
    g_all = [rng.randn(%(n)d, *s).astype(np.float32) for s in SHAPES]
    true_mean = [g.mean(0) for g in g_all]
    plan = fusion.make_reduce_scatter_plan(proto, %(n)d, codec=codec)
    st = codec.init_state(plan)
    acc = [np.zeros(s, np.float32) for s in SHAPES]
    errs = []
    for t in range(steps):
        o, st = C.compressed_allreduce(
            [torch.from_numpy(g[r]) for g in g_all], None, codec,
            plan=plan, state=st, mean=True)
        acc = [a + oo.numpy() for a, oo in zip(acc, o)]
        errs.append(max(float(np.abs(a / (t + 1) - m).max()
                              / (np.abs(m).max() + 1e-9))
                        for a, m in zip(acc, true_mean)))
    res[f"ef/{spec}"] = np.array(errs)
    res[f"ef/{spec}/lowrank"] = np.array(
        [plan.bucket_leaf_shape(b) for b in plan.lowrank]).reshape(-1, 2)

for spec in %(cross)r:
    fusion.collective_bytes.reset()
    got = C.cross_level_psum(torch.from_numpy(x["cross"][r]), None, spec)
    res[f"cross/{spec}"] = got.numpy()
    res[f"cross/{spec}/bytes"] = np.array(
        fusion.collective_bytes.total(kind="cross_psum", level="dcn"))
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _jax_codec_run(codec, x, mesh):
    """Three steps of the reference's reduce-scatter and all-gather in
    shard_map: per step the global shards, the leaves; the final state."""
    c = JC.resolve_codec(codec)
    plan = _jplan(codec)
    specs = c.state_specs(plan, "data")

    def step(gs, st):
        shards, st = JC.compressed_reduce_scatter(
            list(gs), "data", c, plan=plan, state=st, mean=True)
        full, st = JC.compressed_all_gather(shards, plan, "data", c, st)
        return tuple(shards), tuple(full), st

    nb = len(plan.buckets)
    f = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(tuple(P("data") for _ in SHAPES), specs),
        out_specs=(tuple(P("data") for _ in range(nb)),
                   tuple(P() for _ in SHAPES), specs),
        check_vma=False))
    st = c.init_state(plan)
    out = []
    for t in range(STEPS):
        gs = tuple(jnp.asarray(x[f"g{t}_{i}"].reshape((-1,) + s[1:]))
                   for i, s in enumerate(SHAPES))
        shards, full, st = f(gs, st)
        out.append(([np.asarray(s) for s in shards],
                    [np.asarray(a) for a in full]))
    return plan, out, st


def _jax_cross(x, spec, mesh):
    f = jax.jit(jax.shard_map(
        lambda v: JC.cross_level_psum(v, "data", spec), mesh=mesh,
        in_specs=P("data"), out_specs=P("data"), check_vma=False))
    return np.asarray(f(jnp.asarray(x["cross"].reshape(-1)))).reshape(N, -1)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("compression")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    finish = start_port_job(
        JOB % dict(shapes=SHAPES, codecs=CODECS, n=N, steps=STEPS,
                   ef=EF_STEPS, cross=CROSS),
        str(out), np_=N, timeout=300, env={"OMP_NUM_THREADS": "1"})
    mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
    want = {c: _jax_codec_run(c, x, mesh) for c in CODECS}
    cross = {c: _jax_cross(x, c, mesh) for c in CROSS}
    ranks, _ = finish()
    return x, ranks, want, cross


@pytest.mark.parametrize("codec", CODECS)
def test_reduce_scatter_and_all_gather_match_jax(results, codec):
    """Every step's shards (this rank's slice of the reference's global
    shard array) and gathered leaves, on every rank."""
    _, ranks, want, _ = results
    plan, steps, _ = want[codec]
    for t, (shards, leaves) in enumerate(steps):
        for r, got in enumerate(ranks):
            for b, s in enumerate(shards):
                k = plan.shard_size(b)
                w = s[r * k:(r + 1) * k]
                g = got[f"{codec}/{t}/shard{b}"]
                if codec == "none":
                    np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL,
                                               err_msg=f"step {t} b{b}")
            for i, w in enumerate(leaves):
                g = got[f"{codec}/{t}/leaf{i}"]
                if codec == "none":
                    np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL,
                                               err_msg=f"step {t} leaf {i}")


@pytest.mark.parametrize("codec", ["int8", "powersgd:2"])
def test_codec_state_matches_jax(results, codec):
    """The residuals after three steps: rank r's ``rs`` is row r of the
    reference's global ``rs``, its ``ag`` its slice of the global ``ag``;
    PowerSGD's factors match up to the sign of each column."""
    _, ranks, want, _ = results
    plan, _, st = want[codec]
    for r, got in enumerate(ranks):
        for b in range(len(plan.buckets)):
            if st.rs[b] is not None:
                np.testing.assert_allclose(
                    got[f"{codec}/state/rs{b}"],
                    np.asarray(st.rs[b]).reshape(N, -1)[r], rtol=RTOL,
                    atol=RTOL)
            if st.ag[b] is not None:
                k = plan.shard_size(b)
                np.testing.assert_allclose(
                    got[f"{codec}/state/ag{b}"],
                    np.asarray(st.ag[b])[r * k:(r + 1) * k], rtol=RTOL,
                    atol=RTOL)
            if st.factors[b] is not None:
                g = got[f"{codec}/state/factors{b}"]
                w = np.asarray(st.factors[b])
                sign = np.sign(np.sum(g * w, axis=0))
                np.testing.assert_allclose(g * sign, w, rtol=1e-5,
                                           atol=1e-5)


def test_int8_codes_match_jax_bitwise():
    """Scale, offset and uint8 codes: IEEE division, then round half to
    even, in both libraries."""
    rng = np.random.default_rng(11)
    for m in (rng.standard_normal(1000).astype(np.float32) * 3,
              np.full(17, 2.5, np.float32),
              np.linspace(-1, 1, 255, dtype=np.float32)):
        js, jl = JC._affine_qparams(jnp.asarray(m))
        jq = JC._affine_encode(jnp.asarray(m), js, jl)
        ts, tl = TC._affine_qparams(torch.from_numpy(m))
        tq = TC._affine_encode(torch.from_numpy(m), ts, tl)
        assert float(ts) == float(js) and float(tl) == float(jl)
        assert tq.dtype == torch.uint8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(
            TC._affine_decode(tq, ts, tl).numpy(),
            np.asarray(JC._affine_decode(jq, js, jl)))


@pytest.mark.parametrize("spec", ["bf16", "fp16"])
def test_cast_codecs_bounded_error(results, spec):
    _, ranks, _, _ = results
    tol = {"bf16": 0.02, "fp16": 0.005}[spec]
    assert ranks[0][f"ef/{spec}"][-1] < tol


def test_int8_error_feedback_converges_to_true_mean(results):
    """As ``tests/test_compression.py`` asserts at 8 ranks: lossy steps,
    the cumulative mean closing in about 1/t."""
    errs = results[1][0]["ef/int8"]
    assert errs[0] > errs[-1] * 3
    assert errs[-1] < 5e-3, errs


def test_powersgd_error_feedback_converges(results):
    got = results[1][0]
    errs = got["ef/powersgd:2"]
    np.testing.assert_array_equal(got["ef/powersgd:2/lowrank"], [[16, 8]])
    assert errs[-1] < errs[0] / 3
    assert errs[-1] < 0.25, errs


@pytest.mark.parametrize("spec", CROSS)
def test_cross_level_psum_matches_jax(results, spec):
    """The sum over 4 ranks through each stateless codec: none bitwise,
    the casts and int8 (a shared scale, an int32 sum) within f32 rtol;
    the dcn-level wire bytes as the codec's width."""
    _, ranks, _, cross = results
    width = {"none": 4, "bf16": 2, "fp16": 2, "int8": 1}[spec]
    for r, got in enumerate(ranks):
        g = got[f"cross/{spec}"]
        if spec == "none":
            np.testing.assert_array_equal(g, cross[spec][r])
        else:
            np.testing.assert_allclose(g, cross[spec][r], rtol=RTOL,
                                       atol=RTOL)
        assert int(got[f"cross/{spec}/bytes"]) == 11 * width


def test_cross_level_psum_rejects_stateful_codec_like_jax(world1):
    mesh = Mesh(np.array(jax.devices()[:1]), ("dcn",))
    with pytest.raises(ValueError) as jexc:
        jax.jit(jax.shard_map(
            lambda v: JC.cross_level_psum(v, "dcn", "powersgd"),
            mesh=mesh, in_specs=P(), out_specs=P()))(
                jnp.ones((4,), jnp.float32))
    with pytest.raises(ValueError) as texc:
        TC.cross_level_psum(torch.ones(4), None, "powersgd")
    assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("spec", ["none", "bf16", "fp16", "int8",
                                  "powersgd", "powersgd:3", " INT8 ",
                                  "zstd", "powersgd:x"])
def test_parse_codec_matches_jax(spec):
    try:
        want = JC.parse_codec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            TC.parse_codec(spec)
        assert str(exc.value) == str(e)
        return
    got = TC.parse_codec(spec)
    assert got.name == want.name
    assert getattr(got, "rank", None) == getattr(want, "rank", None)
    assert got.stateful == want.stateful


@pytest.mark.parametrize("env", [None, "int8", "powersgd:2", "bogus"])
@pytest.mark.parametrize("form", ["default", "none_class", "none_str",
                                  "fp16_class", "bf16_class", "bf16_str"])
def test_resolve_codec_matches_jax(monkeypatch, env, form):
    """Every form, with ``HOROVOD_COMPRESSION`` unset, set or bad: only
    the default forms consult it."""
    if env is None:
        monkeypatch.delenv("HOROVOD_COMPRESSION", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_COMPRESSION", env)
    forms = {"default": (None, None),
             "none_class": (JC.Compression.none, TC.Compression.none),
             "none_str": ("none", "none"),
             "fp16_class": (JC.Compression.fp16, TC.Compression.fp16),
             "bf16_class": (JC.Compression.bf16, TC.Compression.bf16),
             "bf16_str": ("bf16", "bf16")}
    j, t = forms[form]
    want, got = JC.resolve_codec(j), TC.resolve_codec(t)
    assert got.name == want.name
    assert (JC.as_legacy(want) is None) == (TC.as_legacy(got) is None)


@pytest.mark.parametrize("env", ["", "cross:fp16,local:none", "cross:int8",
                                 "bogus,cross:bf16", "cross:zstd"])
@pytest.mark.parametrize("level", ["flat", "local", "cross"])
def test_link_codec_matches_jax(monkeypatch, env, level):
    monkeypatch.setenv("HOROVOD_TRANSPORT_CODECS", env)
    monkeypatch.delenv("HOROVOD_COMPRESSION", raising=False)
    assert (TC.link_codec(level, "bf16").name
            == JC.link_codec(level, "bf16").name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.int64])
@pytest.mark.parametrize("name", ["fp16", "bf16"])
def test_legacy_compressors(dtype, name):
    """The per-tensor casts take f32 and f64 (as the reference torch
    binding's fp16 does) and clamp fp16 to ±65504 as the JAX package's
    does, where an unclamped cast gives inf."""
    x = torch.tensor([1e5, -3e38, 7.0, 0.0, -2.5], dtype=torch.float64)
    x = x.clamp(-1e30, 1e30).to(dtype) if dtype != torch.int64 else \
        torch.tensor([1, -2, 3])
    comp = getattr(TC.Compression, name)
    got, ctx = comp.compress(x)
    if dtype in (torch.float32, torch.float64):
        want, _ = getattr(JC.Compression, name).compress(
            jnp.asarray(x.numpy()))
        assert ctx == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        assert torch.isfinite(got).all()
    else:
        assert ctx is None and got is x
    assert comp.decompress(got, ctx).dtype == dtype
    assert thvd.Compression is TC.Compression


def test_reshard_state_keeps_pending_error_like_jax():
    """The reference's reshard on the global layout, 4 -> 2 ranks, on the
    same random residuals: int8's summed and rescaled pending error and
    re-bucketed all-gather residual, PowerSGD's factors by leaf."""
    rng = np.random.default_rng(7)
    for spec in ("int8", "powersgd:2"):
        jc, tc = JC.resolve_codec(spec), TC.resolve_codec(spec)
        jold, jnew = (jfusion.make_reduce_scatter_plan(_proto(), n,
                                                       codec=jc)
                      for n in (4, 2))
        told, tnew = (tfusion.make_reduce_scatter_plan(
            [torch.empty(s) for s in SHAPES], n, codec=tc) for n in (4, 2))
        st = jc.init_state(jold)
        arrs = [None if a is None else
                rng.standard_normal(a.shape).astype(np.float32)
                for a in st.rs + st.ag + st.factors]
        nb = len(st.rs)
        jst = JC.CodecState(*(tuple(None if a is None else jnp.asarray(a)
                                    for a in arrs[k * nb:(k + 1) * nb])
                              for k in range(3)))
        tst = TC.CodecState(*(tuple(None if a is None else
                                    torch.from_numpy(a)
                                    for a in arrs[k * nb:(k + 1) * nb])
                              for k in range(3)))
        want = jc.reshard_state(jst, jold, jnew)
        got = tc.reshard_state(tst, told, tnew)
        for wg, gg in zip((want.rs, want.ag, want.factors),
                          (got.rs, got.ag, got.factors)):
            for w, g in zip(wg, gg):
                assert (w is None) == (g is None)
                if w is not None:
                    np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                               rtol=RTOL, atol=RTOL)
        # The pending error in mean units is unchanged.
        for b in range(len(tnew.buckets)):
            if got.rs[b] is not None:
                assert got.rs[b].reshape(2, -1)[1].abs().max() == 0


def test_zero_residuals_keeps_factors():
    plan = tfusion.make_reduce_scatter_plan(
        [torch.empty(s) for s in SHAPES], 1, codec=TC.parse_codec("powersgd:2"))
    st = TC.parse_codec("powersgd:2").init_state(plan)
    st = TC.CodecState([None if a is None else a + 1 for a in st.rs],
                       st.ag, st.factors)
    z = TC.zero_residuals(st)
    assert all(a is None or not a.any() for a in z.rs + z.ag)
    assert z.factors is st.factors
    assert TC.zero_residuals(None) is None
    jst = JC.resolve_codec("powersgd:2").init_state(_jplan("powersgd:2"))
    assert ([f is None for f in st.factors]
            == [f is None for f in jst.factors])
    for f, jf in zip(st.factors, jst.factors):
        if f is not None:
            assert tuple(f.shape) == tuple(jf.shape)
            assert f.dtype == torch.float32


@pytest.mark.parametrize("b", [0, 1, 2, 5, 17, 192])
@pytest.mark.parametrize("n_cols", [3072, 12288])
def test_powersgd_first_factor_is_the_references_draw(b, n_cols):
    """``jax.random.normal(PRNGKey(0x9D + 31 b), (n_cols, 4), f32)`` bit
    for bit, at the LM of record's widths (d_model and d_ff)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0x9D + 31 * b),
                                        (n_cols, 4), jnp.float32))
    got = _threefry.normal(0x9D + 31 * b, (n_cols, 4))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(0x9D + 31 * b),
                                      (n_cols, 4), jnp.uint32))
    np.testing.assert_array_equal(_threefry.random_bits(0x9D + 31 * b,
                                                        (n_cols, 4)), bits)


def test_powersgd_init_state_equals_the_references():
    """The codec's whole initial state, factors included, as JAX's."""
    codec = TC.parse_codec("powersgd:2")
    plan = tfusion.make_reduce_scatter_plan(
        [torch.empty(s) for s in SHAPES], N, codec=codec)
    st = codec.init_state(plan)
    jst = _jinit("powersgd:2")
    for f, jf in zip(st.factors, jst.factors):
        assert (f is None) == (jf is None)
        if f is not None:
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


TRAJECTORY_STEPS = 8
TRAJECTORY_RTOL = 1e-4


def _near(got, want, what, rtol=TRAJECTORY_RTOL):
    """Norm-wise: ``|got - want| <= rtol * |want|``."""
    err = np.linalg.norm(got - want)
    assert err <= rtol * np.linalg.norm(want), (what, err)


def test_powersgd_trajectory_matches_jax_from_its_own_factor(world1):
    """Eight PowerSGD steps at one rank, each package from its own initial
    state (no factor carried across): the reduce-scattered means, the
    residuals and the factors (up to the sign of each column) within a
    norm-wise ``rtol`` of 1e-4, the all-gathered leaves within 2^-8 (that
    phase rides the bf16 cast, so an f32 difference at a rounding
    boundary moves a value by a bf16 step).  The two QRs and
    matrix products sum in other orders; through the warm-started factor
    that f32 difference grows from 3e-7 to about 1.5e-5 of the norm over
    the first six steps, then stays there."""
    spec = "powersgd:2"
    rng = np.random.default_rng(5)
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(TRAJECTORY_STEPS)]
    jc = JC.resolve_codec(spec)
    jplan = jfusion.make_reduce_scatter_plan(_proto(), 1, codec=jc)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    specs = jc.state_specs(jplan, "data")

    def jstep(gs, st):
        shards, st = JC.compressed_reduce_scatter(
            list(gs), "data", jc, plan=jplan, state=st, mean=True)
        full, st = JC.compressed_all_gather(shards, jplan, "data", jc, st)
        return shards, full, st

    f = jax.jit(jax.shard_map(
        jstep, mesh=mesh, in_specs=(tuple(P() for _ in SHAPES), specs),
        out_specs=(P(), P(), specs), check_vma=False))
    tc = TC.resolve_codec(spec)
    tplan = tfusion.make_reduce_scatter_plan(
        [torch.empty(s) for s in SHAPES], 1, codec=tc)
    assert len(tplan.lowrank) == 1
    jst, tst = jc.init_state(jplan), tc.init_state(tplan)
    for t, gs in enumerate(grads):
        jshards, jout, jst = f(tuple(jnp.asarray(g) for g in gs), jst)
        tshards, tst = TC.compressed_reduce_scatter(
            [torch.from_numpy(g) for g in gs], None, tc, plan=tplan,
            state=tst, mean=True)
        tout, tst = TC.compressed_all_gather(tshards, tplan, None, tc, tst)
        for b, (a, w) in enumerate(zip(tshards, jshards)):
            _near(a.numpy(), np.asarray(w), f"step {t} shard {b}")
        for i, (a, w) in enumerate(zip(tout, jout)):
            _near(a.numpy(), np.asarray(w), f"step {t} leaf {i}", 2 ** -8)
    for a, w in zip(tst.rs, jst.rs):
        if a is not None:
            _near(a.numpy(), np.asarray(w).reshape(-1), "residual")
    for a, w in zip(tst.factors, jst.factors):
        if a is not None:
            g, w = a.numpy(), np.asarray(w)
            _near(g * np.sign(np.sum(g * w, axis=0)), w, "factor")


@pytest.mark.parametrize("kind", ["reduce_scatter", "all_gather"])
def test_wire_bytes_at_size1_match_the_codec_widths(world1, kind):
    """The logical bytes a step counts per codec, at one rank: none the
    padded f32 buckets, the casts half, int8 one byte an element plus the
    qparams (8 bytes, 8·N on the gather)."""
    leaves = [torch.randn(s) for s in SHAPES]
    for spec in CODECS:
        codec = TC.resolve_codec(spec)
        plan = tfusion.make_reduce_scatter_plan(leaves, 1, codec=codec)
        st = codec.init_state(plan)
        tfusion.collective_bytes.reset()
        shards, st = TC.compressed_reduce_scatter(leaves, None, codec,
                                                  plan=plan, state=st)
        TC.compressed_all_gather(shards, plan, None, codec, st)
        got = tfusion.collective_bytes.total(kind=kind, codec=codec.name)
        sizes = [plan.padded_size(b) for b in range(len(plan.buckets))]
        want = {"none": 4 * sum(sizes), "bf16": 2 * sum(sizes),
                "fp16": 2 * sum(sizes),
                "int8": sum(sizes) + 8 * len(sizes)}.get(spec)
        if spec.startswith("powersgd"):
            lr = plan.lowrank[0]
            want = (2 * sum(s for b, s in enumerate(sizes) if b != lr)
                    + (24 * 2 * 4 if kind == "reduce_scatter"
                       else 2 * sizes[lr]))
        assert got == want, (spec, got, want)
