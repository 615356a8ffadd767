"""The port's ZeRO-1 sharded update against the JAX package's, on the CPU.

A 4-rank gloo job (the JAX side computes on 4 CPU devices meanwhile)
steps ``ShardedOptimizer`` around ``optim.adam``, ``optim.sgd`` with
momentum, and ``sgd`` under the int8 codec, six steps each, on the
reference test's parameter tree with per-rank gradients (on a 2^-3 grid,
so that a sum over the ranks is exact in any order), and checks the
state's layout, ``gather_full_state``/``scatter_full_state`` and a
``reshard_state`` from 4 to 2 shards.  A 2-rank job runs the LM's
``make_train_step(shard_optimizer=True)`` under ``none`` and ``int8``
against the JAX 2-device ZeRO LM step, which applies the mean gradient
(unlike the JAX package's plain LM step: ROADMAP Queue 3).
Tolerances: parameters 1e-5 against JAX (Adam's and the LM's f32
arithmetic round differently), the port's sharded update against its
own replicated one bitwise.  The momentum is f32 here: inside ``jit``
XLA skips the bf16 rounding of ``decay * trace`` that optax's arithmetic
(and the port's, :mod:`horovod_tpu_torch.optim`) has
(``xla_allow_excess_precision``), so with a bf16 trace the JAX step
drifts from optax's own eager arithmetic by one bf16 ulp of the momentum
a step; the bf16 trace is held to optax in
``tests/test_torch_transformer.py::test_sgd_matches_optax``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import zero as jzero
import horovod_tpu_torch as thvd
from horovod_tpu_torch import optim
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel import zero as tzero
from horovod_tpu_torch.topology import build_mesh

from torch_support import start_port_job, world1  # noqa: F401

N = 4
STEPS = 6
TOL = 1e-5
INT8_TOL = 1.6e-3
THRESHOLD = 64          # bytes: several buckets
CAP = "48"              # HOROVOD_MAX_BUCKET_BYTES: chunks within leaves
SHAPES = {"dense1.b": (7,), "dense1.w": (13, 7), "dense2.w": (7, 3),
          "scale": (5,)}
KEYS = sorted(SHAPES)
OPTS = ("adam", "sgd", "sgd_int8")


def _jopt(name):
    if name == "adam":
        return optax.adam(1e-2)
    return optax.sgd(0.1, momentum=0.9)


def _codec(name):
    return "int8" if name.endswith("int8") else "none"


def _inputs():
    rng = np.random.default_rng(0)
    x = {f"p/{k}": (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in SHAPES.items()}
    for t in range(STEPS):
        for k, s in SHAPES.items():
            x[f"g{t}/{k}"] = (np.round(rng.standard_normal((N,) + s) * 8)
                              / 8).astype(np.float32)
    return x


def _jtree(flat):
    return {"dense1": {"b": flat["dense1.b"], "w": flat["dense1.w"]},
            "dense2": {"w": flat["dense2.w"]}, "scale": flat["scale"]}


def _jflat(tree):
    return {"dense1.b": tree["dense1"]["b"], "dense1.w": tree["dense1"]["w"],
            "dense2.w": tree["dense2"]["w"], "scale": tree["scale"]}


JOB = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import optim
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.parallel import zero

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
x = dict(np.load(os.path.join(out, "inputs.npz")))
KEYS = %(keys)r


def opt(name):
    if name == "adam":
        return optim.adam(1e-2)
    return optim.sgd(0.1, momentum=0.9)


def param_fields(state):
    out = []
    optim.map_params(state, lambda v: out.append(v) or v)
    return out


res = {}
for name in %(opts)r:
    codec = "int8" if name.endswith("int8") else "none"
    params = {k: torch.from_numpy(x[f"p/{k}"]).clone() for k in KEYS}
    rep = {k: v.clone() for k, v in params.items()}
    zopt = zero.sharded_optimizer(opt(name), "data", threshold=%(thr)d,
                                  compression=codec)
    st = zopt.init(params)
    inner = opt(name)
    rst = inner.init([rep[k] for k in KEYS])
    for t in range(%(steps)d):
        grads = {k: torch.from_numpy(x[f"g{t}/{k}"][r]) for k in KEYS}
        upd, st = zopt.update(grads, st, params)
        for k in KEYS:
            params[k] += upd[k]
        # The port's replicated update: the fused mean, the whole update.
        mean = fusion.fused_psum([grads[k] for k in KEYS], mean=True)
        u, rst = inner.update(mean, rst)
        for k, uu in zip(KEYS, u):
            rep[k] += uu
    for k in KEYS:
        res[f"{name}/p/{k}"] = params[k].numpy()
        res[f"{name}/rep/{k}"] = rep[k].numpy()
    fields = param_fields(st.inner)
    res[f"{name}/shard_sizes"] = np.array([[t.numel() for t in f]
                                           for f in fields])
    res[f"{name}/index"] = np.array(st.index)
    # The reference's state after its six steps, carried in: the layout
    # conversions below start from the same numbers as the reference's.
    arrays = dict(np.load(os.path.join(out, f"{name}_state.npz")))
    nb = len(st.plan.buckets)
    fields_in = {f: [arrays[f"{f}{b}"] for b in range(nb)]
                 for f in ("trace", "mu", "nu") if f"{f}0" in arrays}
    if "count" in arrays:
        fields_in["count"] = arrays["count"]
    wire = None
    if st.wire is not None:
        wire = tuple([arrays.get(f"{g}{b}") for b in range(nb)]
                     for g in ("rs", "ag", "factors"))
    carried = convert.zero_state_to_torch(fields_in, st, wire)
    fields_out, wire_out = convert.zero_state_to_arrays(carried)
    for f, flats in fields_out.items():
        if f == "count":
            res[f"{name}/carried/count"] = flats
            continue
        for b, a in enumerate(flats):
            res[f"{name}/carried/{f}{b}"] = a
    if wire_out is not None:
        for g, group in zip(("rs", "ag"), wire_out):
            for b, a in enumerate(group):
                if a is not None:
                    res[f"{name}/carried/{g}{b}"] = a
    full = zero.gather_full_state(carried)
    for field in ("trace", "mu", "nu"):
        if hasattr(full, field):
            for k in KEYS:
                res[f"{name}/full/{field}/{k}"] = \
                    getattr(full, field)[k].float().numpy()
    # Back to shards and gathered again: the same per-leaf state (the
    # shards' padding holds whatever the codec decoded there, and the
    # replicated layout has none).
    again = zero.gather_full_state(zero.scatter_full_state(full,
                                                           like=carried))
    res[f"{name}/scatter_same"] = np.array(all(
        torch.equal(a[k], b[k]) for a, b in zip(
            param_fields(again), param_fields(full))
        for k in KEYS))
    res[f"{name}/digest"] = np.array(zero.local_state_digest(carried),
                                     dtype=np.int64)
    like = zero.sharded_optimizer(opt(name), "data", axis_size=2,
                                  threshold=%(thr)d,
                                  compression=codec).init(params)
    moved = zero.reshard_state(carried, like)
    res[f"{name}/like_index"] = np.array(moved.index)
    for j, f in enumerate(param_fields(moved.inner)):
        for b, s in enumerate(f):
            res[f"{name}/reshard/{j}/{b}"] = s.float().numpy()
    if moved.wire is not None:
        for gname in ("rs", "ag"):
            for b, a in enumerate(getattr(moved.wire, gname)):
                if a is not None:
                    res[f"{name}/reshard/wire/{gname}{b}"] = a.numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _jax_run(name, x, mesh):
    """Six sharded steps of the reference in shard_map; returns the params,
    the final state, its gathered replicated form and its reshard to 2."""
    opt = _jopt(name)
    zopt = jzero.sharded_optimizer(opt, "data", axis_size=N,
                                   threshold=THRESHOLD,
                                   compression=_codec(name))
    params = _jtree({k: jnp.asarray(x[f"p/{k}"]) for k in KEYS})
    st = zopt.init(params)
    specs = zopt.state_specs(st)

    def step(p, s, g):
        upd, s = zopt.update(g, s, p)
        return optax.apply_updates(p, upd), s

    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), specs,
                                                         P("data")),
                              out_specs=(P(), specs), check_vma=False))
    p = params
    for t in range(STEPS):
        g = _jtree({k: jnp.asarray(x[f"g{t}/{k}"].reshape(
            (-1,) + SHAPES[k][1:])) for k in KEYS})
        p, st = f(p, st, g)
    like = jzero.sharded_optimizer(opt, "data", axis_size=2,
                                   threshold=THRESHOLD,
                                   compression=_codec(name)).init(p)
    return p, st, jzero.gather_full_state(st), jzero.reshard_state(st, like)


def _save_state(path, st):
    """The reference's sharded state as global numpy arrays."""
    inner = st.inner[0]
    arrays = {}
    for f in ("trace", "mu", "nu"):
        if hasattr(inner, f):
            arrays.update({f"{f}{b}": np.asarray(a, np.float32)
                           for b, a in enumerate(getattr(inner, f))})
    if "count" in inner._fields:
        arrays["count"] = np.asarray(inner.count)
    if st.wire is not None:
        for g in ("rs", "ag", "factors"):
            arrays.update({f"{g}{b}": np.asarray(a) for b, a in
                           enumerate(getattr(st.wire, g)) if a is not None})
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    old = os.environ.get("HOROVOD_MAX_BUCKET_BYTES")
    os.environ["HOROVOD_MAX_BUCKET_BYTES"] = CAP
    try:
        mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
        want = {name: _jax_run(name, x, mesh) for name in OPTS}
    finally:
        if old is None:
            os.environ.pop("HOROVOD_MAX_BUCKET_BYTES")
        else:
            os.environ["HOROVOD_MAX_BUCKET_BYTES"] = old
    for name in OPTS:
        _save_state(out / f"{name}_state.npz", want[name][1])
    ranks, _ = start_port_job(
        JOB % dict(keys=KEYS, opts=OPTS, thr=THRESHOLD, steps=STEPS),
        str(out), np_=N, timeout=300,
        env={"OMP_NUM_THREADS": "1", "HOROVOD_MAX_BUCKET_BYTES": CAP})()
    return x, ranks, want


@pytest.mark.parametrize("name", OPTS)
def test_sharded_trajectory_matches_jax(results, name):
    """Six steps: every rank's parameters against the reference's
    sharded update, and bitwise against the port's replicated update.

    Under int8, the decoded shards' f32 sum (``(q * scale + lo).sum(0)``)
    is not exact, and the two libraries add the four ranks in different
    orders; where that last bit moves a value across a rounding boundary
    of the next quantization, one code differs by one step.  With these
    gradients a step (``scale``) is at most 8/255 and moves the mean by
    scale/4, a parameter by ``lr * scale / 4`` < 8e-4: INT8_TOL allows
    about two such flips over the six steps (error feedback pays each
    back on the next step)."""
    _, ranks, want = results
    jp = _jflat(want[name][0])
    tol = INT8_TOL if name == "sgd_int8" else TOL
    for got in ranks:
        for k in KEYS:
            np.testing.assert_allclose(got[f"{name}/p/{k}"],
                                       np.asarray(jp[k]), rtol=tol,
                                       atol=tol, err_msg=k)
            if name != "sgd_int8":
                np.testing.assert_array_equal(got[f"{name}/p/{k}"],
                                              got[f"{name}/rep/{k}"])


@pytest.mark.parametrize("name", OPTS)
def test_state_is_one_shard_per_rank(results, name):
    """Each parameter-shaped state field holds ``padded/N`` elements of
    every bucket on each rank: ``full/N`` plus the padding."""
    _, ranks, want = results
    plan = want[name][1].plan
    full = sum(int(np.prod(s)) for s in SHAPES.values())
    for r, got in enumerate(ranks):
        sizes = got[f"{name}/shard_sizes"]
        assert int(got[f"{name}/index"]) == r
        for field in sizes:
            assert list(field) == [plan.shard_size(b)
                                   for b in range(len(plan.buckets))]
            assert sum(field) * N == full + sum(
                plan.pad_elems(b) for b in range(len(plan.buckets)))
    assert len(plan.buckets) > len(SHAPES)        # chunked


@pytest.mark.parametrize("name", OPTS)
def test_gather_and_scatter_full_state(results, name):
    """``gather_full_state`` is the reference's replicated state, leaf by
    leaf; ``scatter_full_state`` then ``gather_full_state`` gives it back,
    bitwise."""
    _, ranks, want = results
    jfull = want[name][2][0]
    for got in ranks:
        assert bool(got[f"{name}/scatter_same"])
        for field in ("trace", "mu", "nu"):
            if not hasattr(jfull, field):
                continue
            jf = _jflat(getattr(jfull, field))
            for k in KEYS:
                np.testing.assert_allclose(
                    got[f"{name}/full/{field}/{k}"],
                    np.asarray(jf[k], np.float32), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", OPTS)
def test_reshard_to_two_shards_matches_jax(results, name):
    """4 -> 2 shards: rank r holds shard ``r mod 2`` of the reference's
    resharded buckets, and the int8 codec's pending error with it."""
    _, ranks, want = results
    moved = want[name][3]
    plan = moved.plan
    fields = [getattr(moved.inner[0], f) for f in ("trace", "mu", "nu")
              if hasattr(moved.inner[0], f)]
    for r, got in enumerate(ranks):
        idx = int(got[f"{name}/like_index"])
        assert idx == r % 2
        for j, flats in enumerate(fields):
            for b, flat in enumerate(flats):
                k = plan.shard_size(b)
                np.testing.assert_allclose(
                    got[f"{name}/reshard/{j}/{b}"],
                    np.asarray(flat, np.float32)[idx * k:(idx + 1) * k],
                    rtol=TOL, atol=TOL)
        if moved.wire is None:
            continue
        for b in range(len(plan.buckets)):
            if moved.wire.rs[b] is not None:
                np.testing.assert_allclose(
                    got[f"{name}/reshard/wire/rs{b}"],
                    np.asarray(moved.wire.rs[b]).reshape(2, -1)[idx],
                    rtol=TOL, atol=TOL)
            if moved.wire.ag[b] is not None:
                k = plan.shard_size(b)
                np.testing.assert_allclose(
                    got[f"{name}/reshard/wire/ag{b}"],
                    np.asarray(moved.wire.ag[b])[idx * k:(idx + 1) * k],
                    rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", OPTS)
def test_jax_state_crosses_into_the_port_and_back(results, name):
    """``convert.zero_state_to_torch`` puts each rank's shard of the
    reference's state (and its int8 residuals) into the port;
    ``zero_state_to_arrays`` gathers it back to the reference's global
    layout, bitwise."""
    _, ranks, want = results
    st = want[name][1]
    inner = st.inner[0]
    for got in ranks:
        if "count" in inner._fields:
            assert int(got[f"{name}/carried/count"]) == int(inner.count)
        for f in ("trace", "mu", "nu"):
            for b, a in enumerate(getattr(inner, f, ())):
                np.testing.assert_array_equal(got[f"{name}/carried/{f}{b}"],
                                              np.asarray(a, np.float32))
        if st.wire is not None:
            for g in ("rs", "ag"):
                for b, a in enumerate(getattr(st.wire, g)):
                    if a is not None:
                        np.testing.assert_array_equal(
                            got[f"{name}/carried/{g}{b}"], np.asarray(a))


def test_state_digest_is_per_rank(results):
    _, ranks, _ = results
    digests = [int(got[f"{name}/digest"]) for got in ranks
               for name in OPTS]
    assert len(set(digests)) == N * len(OPTS)


# ---------------------------------------------------------------------------
# The guards, word for word.
# ---------------------------------------------------------------------------

def _jax_error(fn, *args, mesh_axes=("data",)):
    mesh = Mesh(np.array(jax.devices()[:1]), mesh_axes)
    with pytest.raises(Exception) as exc:
        jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                              check_vma=False))(*args)
    return exc.value


def test_update_requires_params_like_jax(world1):
    jz = jzero.sharded_optimizer(optax.sgd(0.1), "data", axis_size=1)
    p = {"w": jnp.ones((3,))}
    jst = jz.init(p)
    jerr = _jax_error(lambda g: jz.update(g, jst)[0], p)
    tz = tzero.sharded_optimizer(optim.sgd(0.1), "data")
    tp = {"w": torch.ones(3)}
    with pytest.raises(ValueError) as exc:
        tz.update(tp, tz.init(tp))
    assert str(exc.value) == str(jerr)


def test_update_rejects_another_tree_like_jax(world1):
    jz = jzero.sharded_optimizer(optax.sgd(0.1), "data", axis_size=1)
    jst = jz.init({"w": jnp.ones((3,))})
    jerr = _jax_error(lambda g: jz.update(g, jst, g)[0],
                      {"v": jnp.ones((3,))})
    tz = tzero.sharded_optimizer(optim.sgd(0.1), "data")
    tst = tz.init({"w": torch.ones(3)})
    with pytest.raises(ValueError) as exc:
        tz.update({"v": torch.ones(3)}, tst, {"v": torch.ones(3)})
    head, tail = "gradient tree structure ", (
        " does not match the structure this state was initialized with ")
    for msg in (str(jerr), str(exc.value)):
        assert msg.startswith(head) and tail in msg


def test_update_rejects_another_axis_size_like_jax(world1):
    jz = jzero.sharded_optimizer(optax.sgd(0.1), "data", axis_size=2)
    p = {"w": jnp.ones((3,))}
    jst = jz.init(p)
    jerr = _jax_error(lambda g: jz.update(g, jst, g)[0], p)
    tz = tzero.sharded_optimizer(optim.sgd(0.1), "data", axis_size=2)
    tp = {"w": torch.ones(3)}
    with pytest.raises(ValueError) as exc:
        tz.update(tp, tz.init(tp), tp)
    assert str(exc.value) == str(jerr)


def test_one_axis_and_functional_optimizer_guards(world1):
    with pytest.raises(NotImplementedError) as jexc:
        jzero.ShardedOptimizer(optax.sgd(0.1), ("data", "seq"))
    with pytest.raises(NotImplementedError) as texc:
        tzero.ShardedOptimizer(optim.sgd(0.1), ("data", "seq"))
    assert str(texc.value) == str(jexc.value)
    m = torch.nn.Linear(2, 2)
    with pytest.raises(TypeError, match="optim.sgd or horovod_tpu_torch"
                                        ".optim.adam"):
        tzero.ShardedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1))


@pytest.mark.parametrize("kw", [dict(shard_optimizer=True,
                                     model_axis="model"),
                                dict(compression="int8")])
def test_lm_step_guards_like_jax(world1, kw):
    """ZeRO-1 composes with pure data parallelism only, and a codec rides
    the ZeRO wire: the reference's two ``NotImplementedError``s."""
    jcfg, tcfg = _cfgs()
    mesh_axes = ("data", "model") if "model_axis" in kw else ("data",)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(mesh_axes)),
                 mesh_axes)
    with pytest.raises(NotImplementedError) as jexc:
        jtfm.make_train_step(jcfg, optax.sgd(0.1), jmesh, **kw)
    model = tfm.TransformerLM(tcfg, device="cpu")
    opt = optim.SGD([p for _, p in convert.lm_ordered_parameters(model)],
                    0.1, 0.9)
    mesh = build_mesh(axes=mesh_axes, shape=(1,) * len(mesh_axes))
    with pytest.raises(NotImplementedError) as texc:
        tfm.make_train_step(model, opt, mesh, **kw)
    assert str(texc.value) == str(jexc.value)


# ---------------------------------------------------------------------------
# The LM's ZeRO step at 2 ranks against the JAX 2-device ZeRO step.
# ---------------------------------------------------------------------------

LR = 0.1
LM_STEPS = 2
LM_CODECS = ("none", "int8")


def _cfgs():
    kw = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_seq=32)
    return (jtfm.TransformerConfig(dtype=jnp.float32, **kw),
            tfm.TransformerConfig(dtype=torch.float32, **kw))


def _lm_params(cfg):
    rng = np.random.default_rng(4)
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape, scale=None):
        return (rng.standard_normal(shape) * (scale or shape[0] ** -0.5)
                ).astype(np.float32)

    def norm():
        return (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)

    return {"embed": dense((cfg.vocab_size, d), 0.02),
            "pos": dense((cfg.max_seq, d), 0.02), "ln_f_scale": norm(),
            "layers": [{"ln1_scale": norm(), "ln2_scale": norm(),
                        "wq": dense((d, d)), "wk": dense((d, d)),
                        "wv": dense((d, d)), "wo": dense((d, d)),
                        "w1": dense((d, f)), "w2": dense((f, d))}
                       for _ in range(cfg.n_layers)]}


def _lm_tokens():
    toks = np.random.default_rng(9).integers(0, 64, (4, 33))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


LM_JOB = r'''
import os, pickle, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import optim
from horovod_tpu_torch.models import convert, transformer as tfm

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
with open(os.path.join(out, "lm.pkl"), "rb") as f:
    params, tokens, labels, kw = pickle.load(f)
cfg = tfm.TransformerConfig(dtype=torch.float32, **kw)
rows = slice(2 * r, 2 * r + 2)
res = {}
for codec in %(codecs)r:
    model = tfm.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_to_torch(params))
    named = convert.lm_ordered_parameters(model)
    opt = optim.SGD([p for _, p in named], %(lr)r, momentum=0.9)
    step = tfm.make_train_step(model, opt, hvd.mesh(), attention="local",
                               shard_optimizer=True, compression=codec)
    losses = [float(step(torch.from_numpy(tokens[rows]),
                         torch.from_numpy(labels[rows])))
              for _ in range(%(steps)d)]
    res[f"{codec}/losses"] = np.array(losses)
    assert step.optimizer.codec.name == codec and opt.state is None
    for n, p in named:
        res[f"{codec}/{n}"] = p.detach().numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _jax_lm(codec, params, tokens, labels):
    jcfg, _ = _cfgs()
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    opt = optax.sgd(LR, momentum=0.9)
    step, _, _ = jtfm.make_train_step(jcfg, opt, mesh, data_axis="data",
                                      attention="local", donate=False,
                                      shard_optimizer=True,
                                      compression=codec)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    st = step.init(p)
    losses = []
    for _ in range(LM_STEPS):
        p, st, loss = step(p, st, jnp.asarray(tokens), jnp.asarray(labels))
        losses.append(float(loss))
    named = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        named[".".join(parts)] = np.asarray(leaf)
    return np.array(losses), named


@pytest.fixture(scope="module")
def lm_results(tmp_path_factory):
    import pickle
    out = tmp_path_factory.mktemp("zero_lm")
    jcfg, _ = _cfgs()
    params = _lm_params(jcfg)
    tokens, labels = _lm_tokens()
    kw = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_seq=32)
    with open(out / "lm.pkl", "wb") as f:
        pickle.dump((params, tokens, labels, kw), f)
    finish = start_port_job(
        LM_JOB % dict(codecs=LM_CODECS, lr=LR, steps=LM_STEPS), str(out),
        np_=2, timeout=300, env={"OMP_NUM_THREADS": "1"})
    want = {c: _jax_lm(c, params, tokens, labels) for c in LM_CODECS}
    ranks, _ = finish()
    return ranks, want


@pytest.mark.parametrize("codec", LM_CODECS)
def test_lm_zero_step_at_two_ranks_matches_jax(lm_results, codec):
    """Two steps of the LM's ZeRO step on 2 gloo ranks, each on its half
    of the batch, against the JAX ZeRO step on 2 devices: the mean losses
    and every parameter on both ranks."""
    ranks, want = lm_results
    jl, jp = want[codec]
    for got in ranks:
        np.testing.assert_allclose(got[f"{codec}/losses"], jl, rtol=TOL,
                                   atol=TOL)
        for name, w in jp.items():
            np.testing.assert_allclose(got[f"{codec}/{name}"], w,
                                       rtol=TOL, atol=TOL, err_msg=name)
    for name in jp:
        np.testing.assert_array_equal(ranks[0][f"{codec}/{name}"],
                                      ranks[1][f"{codec}/{name}"])


def test_drop_residuals_zeroes_only_the_error_feedback(world1):
    """``_drop_residuals`` on a ZeRO state and on a bare codec state: every
    residual zero, the factors and the optimizer state as they were."""
    from horovod_tpu_torch.parallel import data as tdata
    zopt = tzero.sharded_optimizer(optim.sgd(0.1, momentum=0.9), "data",
                                   compression="powersgd:1")
    p = {"w": torch.randn(6, 4), "b": torch.randn(3)}
    st = zopt.init(p)
    upd, st = zopt.update({k: torch.randn_like(v) for k, v in p.items()},
                          st, p)
    assert any(r is not None and r.any() for r in st.wire.rs)
    dropped = tdata._drop_residuals(st)
    assert all(r is None or not r.any()
               for r in dropped.wire.rs + dropped.wire.ag)
    assert dropped.wire.factors is st.wire.factors
    assert dropped.inner is st.inner
    bare = tdata._drop_residuals(st.wire)
    assert all(r is None or not r.any() for r in bare.rs + bare.ag)
    assert tdata._drop_residuals(st.inner) is st.inner


def test_package_exports_the_reference_zero_names():
    import horovod_tpu as jhvd
    for name in ("sharded_optimizer", "reshard_state", "resolve_codec",
                 "Compression"):
        assert callable(getattr(thvd, name)) == callable(getattr(jhvd, name))


def _jax_loss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["dense1"]["w"] + p["dense1"]["b"])
    out = h @ p["dense2"]["w"] * jnp.mean(p["scale"])
    return jnp.mean((out - y) ** 2)


class _Net(torch.nn.Module):
    """The reference test's model, its parameters named as the JAX tree
    flattens (``dense1.b`` < ``dense1.w`` < ``dense2.w`` < ``scale``)."""

    def __init__(self, flat):
        super().__init__()
        self.p = torch.nn.ParameterDict(
            {k.replace(".", "_"): torch.nn.Parameter(torch.from_numpy(v))
             for k, v in flat.items()})

    def forward(self, x):
        p = self.p
        h = torch.tanh(x @ p["dense1_w"] + p["dense1_b"])
        return h @ p["dense2_w"] * p["scale"].mean()


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_make_training_step_sharded_adam_matches_jax(world1, compression):
    """``hvd.make_training_step(shard_optimizer=True)`` with ``optim.adam``
    against the reference's on a 1-device mesh, six steps of the
    reference test's regression problem: parameters within 1e-5 under
    none, and within int8's quantization step (the codes of the one rank
    are the reference's bitwise on the same input, but Adam's f32
    arithmetic rounds differently and moves a code now and then)."""
    import horovod_tpu as jhvd
    rng = np.random.default_rng(3)
    flat = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for k, s in SHAPES.items()}
    batches = [(rng.standard_normal((8, 13)).astype(np.float32),
                rng.standard_normal((8, 3)).astype(np.float32))
               for _ in range(STEPS)]
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jhvd.make_training_step(_jax_loss, optax.adam(1e-2), mesh,
                                    shard_optimizer=True,
                                    compression=compression)
    jp = _jtree({k: jnp.asarray(v) for k, v in flat.items()})
    jst = jstep.init(jp)
    for x, y in batches:
        jp, jst, _ = jstep(jp, jst, (jnp.asarray(x), jnp.asarray(y)))
    net = _Net(flat)
    step = thvd.make_training_step(
        lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(), net,
        optim.adam(1e-2), shard_optimizer=True, compression=compression)
    for x, y in batches:
        step((torch.from_numpy(x), torch.from_numpy(y)))
    tol = TOL if compression == "none" else INT8_TOL
    for k, w in _jflat(jp).items():
        np.testing.assert_allclose(
            net.p[k.replace(".", "_")].detach().numpy(), np.asarray(w),
            rtol=tol, atol=tol, err_msg=k)
