"""The port's pipeline parallelism against the JAX package's, on the CPU.

The same seeded inputs (numpy ``default_rng``; the LM's weights from the
JAX package's ``init_params``) go through ``horovod_tpu.parallel.
pipeline`` under ``shard_map`` on 4 of the conftest's CPU devices (and
the single-device sequential oracles of ``tests/test_parallel.py:182``,
``:692``, ``:796`` and ``:850``) and through ``horovod_tpu_torch.
parallel.pipeline`` on 4 gloo ranks, one job on a (data, pipe) = 1 x 4
mesh and one on 2 x 2, started together while the JAX side runs:

* the toy stages ``tanh(x @ w)`` (d 8): GPipe (M 6) and interleaved
  (P 4, virtual 2, M 8) outputs and the gradients of ``sum(y**2)``
  through an outer backward; 1F1B (M 6) and interleaved 1F1B (M 8)
  through ``make_pipeline_1f1b_loss`` (loss, stage, aux and microbatch
  gradients); 1F1B with a data axis on 2 x 2;
* the LM (vocab 32, d_model 16, 2 heads, 8 layers, d_ff 32, T 8, batch
  8): ``forward_pipelined`` against the plain forward and its gradients
  through an outer backward against the plain loss's;
  ``make_train_step_pipelined`` under all four schedules at dp 1
  (P 4) and dp 2 (P 2), two steps of SGD (lr 0.1, momentum 0.9),
  against the JAX single-device plain step on the global batch.

Tolerances: the reference's 2e-5 for the toy stages, 2e-4 for the
pipelined logits (``:568``), 1e-4 relative and 1e-5 absolute for the
LM's gradients (``:613``), 1e-5 for the steps' losses and parameters.
Virtual ranks (threads of one process, phase 12 (c) of
``chip_smoke.py``) are held to the gloo ranks, and the error paths to
the JAX package's messages word for word.
"""

import functools
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import pipeline as jpp
from horovod_tpu.topology import build_mesh as jax_build_mesh
import horovod_tpu_torch as thvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.optim import SGD
from horovod_tpu_torch.parallel import pipeline as pp
from horovod_tpu_torch.parallel.sequence import VirtualAxis
from torch_support import start_port_job

TOY_TOL = 2e-5
LOGIT_TOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
STEP_TOL = 1e-5
SCHEDULES = ("gpipe", "1f1b", "interleaved", "interleaved_1f1b")
MICRO = 4
D = 8


def _virtual_of(schedule):
    return 2 if schedule.startswith("interleaved") else 1


def _jcfg():
    return jtfm.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                                  d_ff=32, n_layers=8, max_seq=8,
                                  dtype=jnp.float32)


def _tcfg():
    return tfm.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                                 d_ff=32, n_layers=8, max_seq=8,
                                 dtype=torch.float32)


def _inputs():
    rng = np.random.default_rng(7)
    f32 = np.float32
    toks = rng.integers(0, 32, (8, 9))
    lm = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(0), _jcfg()))
    return {
        "stage_ws": (rng.standard_normal((4, D, D)) * 0.3).astype(f32),
        "stage_ws8": (rng.standard_normal((8, D, D)) * 0.3).astype(f32),
        "stage_ws2": (rng.standard_normal((2, D, D)) * 0.3).astype(f32),
        "xs": rng.standard_normal((6, 2, D)).astype(f32),
        "xs8": rng.standard_normal((8, 2, D)).astype(f32),
        "xs4": rng.standard_normal((4, 4, D)).astype(f32),
        "tgts": rng.standard_normal((6, 2, D)).astype(f32),
        "tgts8": rng.standard_normal((8, 2, D)).astype(f32),
        "tgts4": rng.standard_normal((4, 4, D)).astype(f32),
        "scale": rng.standard_normal(D).astype(f32),
        "tokens": toks[:, :-1], "labels": toks[:, 1:], "lm": lm,
    }


# ---------------------------------------------------------------------------
# The gloo jobs
# ---------------------------------------------------------------------------

JOB = r'''
import os, pickle, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.optim import SGD
from horovod_tpu_torch.parallel import pipeline as pp
from horovod_tpu_torch.topology import build_mesh

out = sys.argv[1]
hvd.init(device="cpu")
with open(os.path.join(out, "inputs.pkl"), "rb") as fh:
    inp = pickle.load(fh)
shape = tuple(inp["shape"])
mesh = build_mesh(axes=("data", "pipe"), shape=shape)
pipe = mesh.axis("pipe")
n_pipe, p, d = shape[1], mesh.axis_index("pipe"), mesh.axis_index("data")
T = lambda a: torch.from_numpy(np.array(a))
res = {}


def stage_fn(prm, x):
    return torch.tanh(x @ prm["w"][0])


def toy_loss(y, tgt, aux):
    return ((y * aux["scale"] - tgt) ** 2).mean()


def leaf(x):
    return x.clone().requires_grad_()


if shape[0] == 1:
    ws, xs = T(inp["stage_ws"]), leaf(T(inp["xs"]))
    w = leaf(ws[p:p + 1])
    y = pp.pipeline_apply(stage_fn, {"w": w}, xs, pipe)
    res["gpipe_y"] = y.detach()
    res["gpipe_gw"], res["gpipe_gx"] = torch.autograd.grad(
        y.square().sum(), [w, xs])
    ws8, xs8 = T(inp["stage_ws8"]), leaf(T(inp["xs8"]))
    w = leaf(torch.stack([ws8[k * n_pipe + p] for k in range(2)]))
    y = pp.pipeline_apply_interleaved(stage_fn, {"w": w}, xs8, pipe, 2)
    res["interleaved_y"] = y.detach()
    res["interleaved_gw"], res["interleaved_gx"] = torch.autograd.grad(
        y.square().sum(), [w, xs8])
    for name, v, wrows, x, tgt in (
            ("1f1b", 1, ws[p:p + 1], inp["xs"], inp["tgts"]),
            ("interleaved_1f1b", 2,
             torch.stack([ws8[k * n_pipe + p] for k in range(2)]),
             inp["xs8"], inp["tgts8"])):
        f = pp.make_pipeline_1f1b_loss(stage_fn, toy_loss, mesh, "pipe",
                                       virtual=v)
        w, x, s = leaf(wrows), leaf(T(x)), leaf(T(inp["scale"]))
        loss = f({"w": w}, {"scale": s}, x, T(tgt))
        res[f"{name}_loss"] = loss.detach()
        (res[f"{name}_gw"], res[f"{name}_gscale"],
         res[f"{name}_gx"]) = torch.autograd.grad(loss, [w, s, x])
else:
    half = inp["xs4"].shape[1] // shape[0]
    rows = slice(d * half, (d + 1) * half)
    f = pp.make_pipeline_1f1b_loss(stage_fn, toy_loss, mesh, "pipe",
                                   data_axes=("data",))
    w = leaf(T(inp["stage_ws2"])[p:p + 1])
    x, s = leaf(T(inp["xs4"][:, rows])), leaf(T(inp["scale"]))
    loss = f({"w": w}, {"scale": s}, x, T(inp["tgts4"][:, rows]))
    res["dp_loss"] = loss.detach()
    res["dp_gw"], res["dp_gscale"], res["dp_gx"] = torch.autograd.grad(
        loss, [w, s, x])

cfg = tfm.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                            n_layers=8, d_ff=32, max_seq=8,
                            dtype=torch.float32)
tree = {k: (T(v) if k != "layers" else
            [{a: T(b) for a, b in l.items()} for l in v])
        for k, v in inp["lm"].items()}
tokens, labels = T(inp["tokens"]), T(inp["labels"])
if shape[0] == 1:
    for v, m in ((1, 2), (2, 4)):
        split = tfm.split_pipeline_params(tree, n_pipe, v)
        base = {k: leaf(x) for k, x in split["base"].items()}
        st = {k: leaf(x[p * v:(p + 1) * v])
              for k, x in split["stacked"].items()}
        logits = tfm.forward_pipelined(base, st, tokens, cfg, pipe,
                                       n_microbatches=m, virtual=v)
        res[f"fwd{v}_logits"] = logits.detach()
        grads = torch.autograd.grad(tfm.xent(logits, labels),
                                    list(base.values()) + list(st.values()))
        for k, g in zip(list(base) + list(st), grads):
            res[f"fwd{v}_g_{k}"] = g
local = tokens.shape[0] // shape[0]
rows = slice(d * local, (d + 1) * local)
for sched in ("gpipe", "1f1b", "interleaved", "interleaved_1f1b"):
    v = 2 if sched.startswith("interleaved") else 1
    split = tfm.split_pipeline_params(tree, n_pipe, v)
    model = tfm.PipelineLM(cfg, n_pipe, p, v, device="cpu")
    model.load_state_dict(convert.lm_pipeline_to_rank(split, p, v))
    opt = SGD([x for _, x in convert.lm_pipeline_ordered_parameters(model)],
              0.1, momentum=0.9)
    step = tfm.make_train_step_pipelined(model, opt, mesh, "data", "pipe",
                                         n_microbatches=4, schedule=sched,
                                         virtual=v)
    res[f"step_{sched}_losses"] = np.array(
        [float(step(tokens[rows], labels[rows])) for _ in range(2)])
    back = convert.lm_rank_to_pipeline(model.state_dict(), pipe, v)
    for group in ("base", "stacked"):
        for k, x in back[group].items():
            res[f"step_{sched}_{group}_{k}"] = x
np.savez(os.path.join(out, f"rank{hvd.rank()}.npz"),
         **{k: np.asarray(v) for k, v in res.items()})
hvd.shutdown()
'''


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"][0])


def _toy_loss(y, tgt, aux):
    return jnp.mean((y * aux["scale"] - tgt) ** 2)


def _sequential(ws, xs):
    y = xs
    for i in range(ws.shape[0]):
        y = jnp.tanh(y @ ws[i])
    return y


def _jax_toys(x):
    """The JAX functions on 4 devices and the sequential oracles."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    want = {}
    ws, xs = jnp.asarray(x["stage_ws"]), jnp.asarray(x["xs"])
    ws8, xs8 = jnp.asarray(x["stage_ws8"]), jnp.asarray(x["xs8"])
    rows8 = jnp.stack([ws8[(j % 2) * 4 + j // 2] for j in range(8)])
    spec = {"w": P("pipe", None, None)}
    for name, stacked, order, inputs, fn in (
            ("gpipe", ws, ws, xs, jpp.pipeline_apply),
            ("interleaved", rows8, ws8, xs8,
             functools.partial(jpp.pipeline_apply_interleaved, virtual=2))):
        run = jax.shard_map(functools.partial(fn, _stage_fn,
                                              axis_name="pipe"),
                            mesh=mesh, in_specs=(spec, P()), out_specs=P())
        want[f"{name}_y_jax"] = jax.jit(run)({"w": stacked}, inputs)
        want[f"{name}_gw_jax"] = jax.jit(jax.grad(
            lambda s, v: jnp.sum(run(s, v) ** 2)))({"w": stacked},
                                                   inputs)["w"]
        want[f"{name}_y"] = _sequential(order, inputs)
        want[f"{name}_gw"], want[f"{name}_gx"] = jax.grad(
            lambda w_, v: jnp.sum(_sequential(w_, v) ** 2),
            argnums=(0, 1))(order, inputs)
    scale = jnp.asarray(x["scale"])
    for name, stacked, order, inputs, tgts, v in (
            ("1f1b", ws, ws, xs, jnp.asarray(x["tgts"]), 1),
            ("interleaved_1f1b", rows8, ws8, xs8, jnp.asarray(x["tgts8"]),
             2)):
        f = jpp.make_pipeline_1f1b_loss(_stage_fn, _toy_loss, mesh,
                                        stage_spec=spec, mb_spec=P(),
                                        axis_name="pipe", virtual=v)
        want[f"{name}_loss_jax"] = jax.jit(f)({"w": stacked},
                                              {"scale": scale}, inputs, tgts)
        gj = jax.jit(jax.grad(lambda w_, a, v_: f(w_, a, v_, tgts),
                              argnums=(0, 1, 2)))({"w": stacked},
                                                  {"scale": scale}, inputs)
        want[f"{name}_gw_jax"] = gj[0]["w"]
        want[f"{name}_gscale_jax"] = gj[1]["scale"]
        want[f"{name}_gx_jax"] = gj[2]

        def oracle(w_, s_, v_, tgts=tgts):
            return jnp.mean((_sequential(w_, v_) * s_ - tgts) ** 2)

        want[f"{name}_loss"] = oracle(order, scale, inputs)
        (want[f"{name}_gw"], want[f"{name}_gscale"],
         want[f"{name}_gx"]) = jax.grad(oracle, argnums=(0, 1, 2))(
            order, scale, inputs)
    ws2, xs4, tgts4 = (jnp.asarray(x[k]) for k in ("stage_ws2", "xs4",
                                                   "tgts4"))

    def dp_oracle(w_, s_, v_):
        return jnp.mean((_sequential(w_, v_) * s_ - tgts4) ** 2)

    want["dp_loss"] = dp_oracle(ws2, scale, xs4)
    want["dp_gw"], want["dp_gscale"], want["dp_gx"] = jax.grad(
        dp_oracle, argnums=(0, 1, 2))(ws2, scale, xs4)
    return want


def _jax_lm(x):
    """The plain forward, the plain loss's gradients and two plain SGD
    steps on one device, on the global batch."""
    cfg = _jcfg()
    params = jax.tree_util.tree_map(jnp.asarray, x["lm"])
    tokens = jnp.asarray(x["tokens"], jnp.int32)
    labels = jnp.asarray(x["labels"], jnp.int32)
    want = {"logits": jtfm.forward(params, tokens, cfg, attention="local")}
    want["grads"] = jax.grad(lambda p_: jtfm.loss_fn(
        p_, tokens, labels, cfg, attention="local"))(params)
    mesh = jax_build_mesh(axes=("data",), shape=(1,),
                          devices=jax.devices()[:1])
    opt = optax.sgd(0.1, momentum=0.9)
    step, _, _ = jtfm.make_train_step(cfg, opt, mesh, data_axis="data",
                                      attention="local", donate=False)
    p_, s_, losses = params, opt.init(params), []
    for _ in range(2):
        p_, s_, loss = step(p_, s_, tokens, labels)
        losses.append(float(loss))
    want["step_losses"], want["step_params"] = losses, p_
    return want


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    x = _inputs()
    finishes = {}
    for shape in ((1, 4), (2, 2)):
        out = tmp_path_factory.mktemp(f"pipe{shape[0]}x{shape[1]}")
        with open(out / "inputs.pkl", "wb") as fh:
            pickle.dump(dict(x, shape=shape), fh)
        # One intra-op thread a rank: eight ranks of two jobs share the
        # host's cores (with a thread per core each, the jobs took 8x as
        # long).
        finishes[shape[0]] = start_port_job(
            JOB, str(out), np_=4, timeout=300, env={"OMP_NUM_THREADS": "1"})
    want = _jax_toys(x)
    want.update(_jax_lm(x))
    want = jax.tree_util.tree_map(np.asarray, want)
    got = {dp: finish()[0] for dp, finish in finishes.items()}
    return x, want, got


def _close(got, want, tol=TOY_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# The pipeline functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["gpipe", "interleaved"])
def test_pipeline_apply_output_matches_jax(results, fn):
    """Every rank gets the last stage's outputs: the JAX function's and the
    sequential oracle's."""
    _, want, got = results
    for rank in got[1]:
        _close(rank[f"{fn}_y"], want[f"{fn}_y_jax"])
        _close(rank[f"{fn}_y"], want[f"{fn}_y"])


@pytest.mark.parametrize("fn", ["gpipe", "interleaved"])
def test_pipeline_apply_gradients_match_jax(results, fn):
    """An outer backward through the schedule: each rank's stage rows of
    the JAX gradient, and every rank the whole microbatch gradient."""
    _, want, got = results
    for p, rank in enumerate(got[1]):
        if fn == "gpipe":
            rows = [p]
        else:
            rows = [k * 4 + p for k in range(2)]
            jrows = [2 * p, 2 * p + 1]
            _close(rank[f"{fn}_gw"], want[f"{fn}_gw_jax"][jrows])
        _close(rank[f"{fn}_gw"], want[f"{fn}_gw"][rows])
        _close(rank[f"{fn}_gx"], want[f"{fn}_gx"])
    if fn == "gpipe":
        _close(np.concatenate([r["gpipe_gw"] for r in got[1]]),
               want["gpipe_gw_jax"])


@pytest.mark.parametrize("what", ["loss", "gw", "gscale", "gx"])
@pytest.mark.parametrize("fn", ["1f1b", "interleaved_1f1b"])
def test_1f1b_loss_and_gradients_match_jax(results, fn, what):
    """make_pipeline_1f1b_loss: the loss, and through an ordinary backward
    the stage, aux and microbatch gradients, against the JAX function
    (stage rows of this rank) and the sequential oracle."""
    _, want, got = results
    for p, rank in enumerate(got[1]):
        g = rank[f"{fn}_{what}"]
        if what == "gw":
            rows = ([p] if fn == "1f1b" else [k * 4 + p for k in range(2)])
            jrows = [p] if fn == "1f1b" else [2 * p, 2 * p + 1]
            _close(g, want[f"{fn}_gw"][rows])
            _close(g, want[f"{fn}_gw_jax"][jrows])
        else:
            _close(g, want[f"{fn}_{what}"])
            _close(g, want[f"{fn}_{what}_jax"])


@pytest.mark.parametrize("what", ["loss", "gw", "gscale", "gx"])
def test_1f1b_with_a_data_axis_matches_the_oracle(results, what):
    """On 2 x 2, each data rank's half of the microbatch rows: the loss and
    the stage and aux gradients averaged over the data axis are the global
    batch's; each rank's microbatch gradient is its rows of the global
    one (the per-shard cotangent divided by the data size)."""
    _, want, got = results
    for r, rank in enumerate(got[2]):
        d, p = divmod(r, 2)
        g = rank[f"dp_{what}"]
        if what == "gw":
            _close(g, want["dp_gw"][[p]])
        elif what == "gx":
            _close(g, want["dp_gx"][:, 2 * d:2 * d + 2])
        else:
            _close(g, want[f"dp_{what}"])


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_make_pipeline_loss_matches_the_oracle(results, schedule):
    """make_pipeline_loss, the pipelined step's loss maker, under each
    schedule on 4 virtual ranks (CPU threads): the loss, and through an
    ordinary backward the stage, aux and microbatch gradients, are the
    sequential oracle's within the toy tolerance.  The GPipe forms take
    the mean loss over every microbatch at once, the 1F1B forms one
    microbatch at a time; with a mean loss the two are the same."""
    x, want, _ = results
    v = _virtual_of(schedule)
    oracle = "interleaved_1f1b" if v > 1 else "1f1b"
    ws, xs, tgts = (torch.from_numpy(x[k + ("8" if v > 1 else "")])
                    for k in ("stage_ws", "xs", "tgts"))
    scale = torch.from_numpy(x["scale"])

    def rank(r):
        f = pp.make_pipeline_loss(
            lambda prm, a: torch.tanh(a @ prm["w"][0]),
            lambda y, t, aux: ((y * aux["scale"] - t) ** 2).mean(),
            axis_name=r, schedule=schedule, virtual=v)
        w = ws[[k * 4 + r.index for k in range(v)]].requires_grad_()
        s, xx = scale.clone().requires_grad_(), xs.clone().requires_grad_()
        loss = f({"w": w}, {"scale": s}, xx, tgts)
        return (loss.detach(), *torch.autograd.grad(loss, [w, s, xx]))

    for p, (loss, gw, gs, gx) in enumerate(VirtualAxis(4).run(rank)):
        _close(loss, want[f"{oracle}_loss"])
        _close(gw, want[f"{oracle}_gw"][[k * 4 + p for k in range(v)]])
        _close(gs, want[f"{oracle}_gscale"])
        _close(gx, want[f"{oracle}_gx"])


def test_make_pipeline_loss_refuses_an_unknown_schedule():
    with pytest.raises(ValueError, match=re.escape(
            "schedule='zero_bubble': expected 'gpipe', '1f1b', "
            "'interleaved' or 'interleaved_1f1b'") + "$"):
        pp.make_pipeline_loss(None, None, schedule="zero_bubble")


# ---------------------------------------------------------------------------
# The pipelined LM
# ---------------------------------------------------------------------------

def _split_np(tree, n_stages, virtual):
    return jax.tree_util.tree_map(
        np.asarray, jtfm.split_pipeline_params(
            jax.tree_util.tree_map(jnp.asarray, tree), n_stages, virtual))


@pytest.mark.parametrize("virtual", [1, 2])
def test_forward_pipelined_matches_plain_forward(results, virtual):
    """4 pipe ranks (GPipe, M 2; interleaved, M 4): the logits on every
    rank are the plain forward's (``tests/test_parallel.py:568``)."""
    _, want, got = results
    for rank in got[1]:
        _close(rank[f"fwd{virtual}_logits"], want["logits"], LOGIT_TOL)


@pytest.mark.parametrize("virtual", [1, 2])
def test_forward_pipelined_gradients_match_plain(results, virtual):
    """Gradients through the pipeline by an outer backward equal the plain
    loss's: the base leaves on every rank (the tied embedding's head and
    input parts once each) and each rank's stage rows
    (``tests/test_parallel.py:613``)."""
    _, want, got = results
    oracle = _split_np(want["grads"], 4, virtual)
    for p, rank in enumerate(got[1]):
        for k, g in oracle["base"].items():
            np.testing.assert_allclose(rank[f"fwd{virtual}_g_{k}"], g,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)
        for k, g in oracle["stacked"].items():
            np.testing.assert_allclose(
                rank[f"fwd{virtual}_g_{k}"],
                g[p * virtual:(p + 1) * virtual], rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=k)
            assert np.linalg.norm(rank[f"fwd{virtual}_g_{k}"]) > 0, k


@pytest.mark.parametrize("what", ["loss", "params"])
@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_train_step_pipelined_matches_single_device_jax(results, schedule,
                                                        dp, what):
    """Two DP x PP steps (P 4 at dp 1, P 2 at dp 2; M 4) against the JAX
    single-device plain step on the global batch: the loss averaged over
    the data axis, and every parameter gathered over the pipe axis."""
    _, want, got = results
    ranks = got[dp]
    if what == "loss":
        for rank in ranks:
            _close(rank[f"step_{schedule}_losses"], want["step_losses"],
                   STEP_TOL)
        return
    n_pipe, v = 4 // dp, _virtual_of(schedule)
    oracle = _split_np(want["step_params"], n_pipe, v)
    for rank in ranks:
        for group in ("base", "stacked"):
            for k, w in oracle[group].items():
                _close(rank[f"step_{schedule}_{group}_{k}"], w, STEP_TOL,
                       f"{group}.{k}")


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved_1f1b"])
def test_jax_pipelined_step_at_dp2_matches_the_single_device_step(
        results, schedule):
    """Reference side: unlike the plain LM step on a data mesh (ROADMAP
    Queue 3), the JAX package's pipelined step at dp 2 applies the mean
    gradient: two steps on a 2 x 2 mesh equal the single-device step on
    the global batch."""
    x, want, _ = results
    cfg = _jcfg()
    v = _virtual_of(schedule)
    mesh = jax_build_mesh(axes=("data", "pipe"), shape=(2, 2),
                          devices=jax.devices()[:4])
    opt = optax.sgd(0.1, momentum=0.9)
    step, shardings = jtfm.make_train_step_pipelined(
        cfg, opt, mesh, data_axis="data", n_microbatches=MICRO,
        schedule=schedule, virtual=v, donate=False)
    params = _split_np(x["lm"], 2, v)
    p_sh, o_sh = shardings(params)
    params = jax.device_put(params, p_sh)
    state = jax.device_put(opt.init(params), o_sh)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state,
                                   jnp.asarray(x["tokens"], jnp.int32),
                                   jnp.asarray(x["labels"], jnp.int32))
        losses.append(float(loss))
    _close(losses, want["step_losses"], STEP_TOL)
    oracle = _split_np(want["step_params"], 2, v)
    got = jax.tree_util.tree_map(np.asarray, params)
    for group in ("base", "stacked"):
        for k, w in oracle[group].items():
            _close(got[group][k], w, STEP_TOL, f"{group}.{k}")


# ---------------------------------------------------------------------------
# Virtual ranks, the cotangent of the broadcast, layouts and errors
# ---------------------------------------------------------------------------

def _torch_tree(tree):
    return {k: (torch.from_numpy(np.array(v)) if k != "layers" else
                [{a: torch.from_numpy(np.array(b)) for a, b in l.items()}
                 for l in v]) for k, v in tree.items()}


@pytest.fixture()
def port_world():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_virtual_ranks_match_gloo_ranks(results, port_world, schedule):
    """The path of ``chip_smoke.py`` phase 12 (c): the pipe axis as 4
    threads of this process, on the CPU, gives the gloo ranks' losses and
    parameters (to 1e-6: the same operations in the same order)."""
    x, _, got = results
    cfg, v = _tcfg(), _virtual_of(schedule)
    split = tfm.split_pipeline_params(_torch_tree(x["lm"]), 4, v)
    tokens, labels = (torch.from_numpy(x[k]) for k in ("tokens", "labels"))

    def rank(r):
        model = tfm.PipelineLM(cfg, 4, r.index, v, device="cpu")
        model.load_state_dict(convert.lm_pipeline_to_rank(split, r.index,
                                                          v))
        opt = SGD([w for _, w in
                   convert.lm_pipeline_ordered_parameters(model)], 0.1, 0.9)
        step = tfm.make_train_step_pipelined(
            model, opt, thvd.mesh(), "data", r, n_microbatches=MICRO,
            schedule=schedule, virtual=v)
        losses = [float(step(tokens, labels)) for _ in range(2)]
        return losses, convert.lm_rank_to_pipeline(model.state_dict(), r, v)

    out = VirtualAxis(4).run(rank)
    for p, (losses, back) in enumerate(out):
        gloo = got[1][p]
        _close(losses, gloo[f"step_{schedule}_losses"], 1e-6)
        for group in ("base", "stacked"):
            for k, w in back[group].items():
                _close(w, gloo[f"step_{schedule}_{group}_{k}"], 1e-6, k)


def _summed_cotangent(d_outputs, axis):
    """The fault this guards against: the broadcast's backward summing
    every rank's cotangent (a psum's transpose taken literally)."""
    return sum(axis.axis.exchange(axis.index, d_outputs))


@pytest.mark.parametrize("plant", [False, True])
def test_output_broadcast_takes_the_cotangent_once(results, monkeypatch,
                                                   plant):
    """Every pipe rank computes the same loss from the broadcast outputs;
    the last stage takes that loss's cotangent once.  Held to the plain
    loss's gradients on 4 virtual ranks (outer backward on the CPU); with
    the cotangent summed over the ranks planted instead, every stage's
    gradient comes out 4 times the oracle's and the check fails."""
    x, want, _ = results
    if plant:
        monkeypatch.setattr(pp, "_output_cotangent", _summed_cotangent)
    cfg = _tcfg()
    split = tfm.split_pipeline_params(_torch_tree(x["lm"]), 4)
    tokens, labels = (torch.from_numpy(x[k]) for k in ("tokens", "labels"))
    oracle = _split_np(want["grads"], 4, 1)["stacked"]

    def rank(r):
        base = {k: w.clone().requires_grad_()
                for k, w in split["base"].items()}
        st = {k: w[r.index:r.index + 1].clone().requires_grad_()
              for k, w in split["stacked"].items()}
        loss = tfm.xent(tfm.forward_pipelined(base, st, tokens, cfg, r),
                        labels)
        return dict(zip(st, (g.numpy() for g in torch.autograd.grad(
            loss, list(st.values())))))

    out = VirtualAxis(4).run(rank)
    ratio = np.linalg.norm(out[1]["w1"]) / np.linalg.norm(
        oracle["w1"][[1]])
    if plant:
        assert ratio == pytest.approx(4.0, rel=1e-4)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(out[1]["w1"], oracle["w1"][[1]],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
    else:
        assert ratio == pytest.approx(1.0, rel=1e-4)
        for p, g in enumerate(out):
            for k, w in g.items():
                np.testing.assert_allclose(w, oracle[k][[p]], rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("n_stages,virtual", [(4, 1), (2, 1), (4, 2),
                                              (2, 4)])
def test_split_and_rank_layout_match_jax(n_stages, virtual):
    """``split_pipeline_params`` stacks as the JAX package does (the
    round-robin rows of ``:561`` included), a rank's module takes rows
    ``[p·v, (p+1)·v)``, and gathering the ranks back gives the split."""
    x = _inputs()
    want = _split_np(x["lm"], n_stages, virtual)
    got = tfm.split_pipeline_params(_torch_tree(x["lm"]), n_stages, virtual)
    for group in ("base", "stacked"):
        for k, w in want[group].items():
            np.testing.assert_array_equal(got[group][k].numpy(), w)
    cfg = _tcfg()

    def rank(r):
        model = tfm.PipelineLM(cfg, n_stages, r.index, virtual,
                               device="cpu")
        model.load_state_dict(convert.lm_pipeline_to_rank(want, r.index,
                                                          virtual))
        return convert.lm_rank_to_pipeline(model.state_dict(), r, virtual)

    for back in VirtualAxis(n_stages).run(rank):
        for group in ("base", "stacked"):
            for k, w in want[group].items():
                np.testing.assert_array_equal(back[group][k], w)


def test_pipeline_parameter_order_is_the_pytree_order():
    """The optimizer's leaves in the JAX flatten order of the
    ``{"base", "stacked"}`` tree: base leaves by name, then every stacked
    leaf's rows and layers."""
    x = _inputs()
    split = _split_np(x["lm"], 2, 2)
    flat = jax.tree_util.tree_flatten_with_path(split)[0]
    model = tfm.PipelineLM(_tcfg(), 2, 1, 2, device="cpu")
    model.load_state_dict(convert.lm_pipeline_to_rank(split, 1, 2))
    named = convert.lm_pipeline_ordered_parameters(model)
    assert len(named) == 3 + 8 * 2 * 2
    jax_order = [path[1].key for path, _ in flat]
    port_order = [n.split(".")[-1] for n, _ in named]
    dedup = lambda seq: [k for i, k in enumerate(seq)
                         if i == 0 or seq[i - 1] != k]
    assert dedup(port_order) == dedup(jax_order)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_stage_fn_refuses_more_than_one_stage():
    """The reference's "each device must hold exactly one stage", word for
    word, for a stacked tree whose local stage dim is 2."""
    x = _inputs()
    act = np.zeros((1, 8, 16), np.float32)
    two = {k: w[:2] for k, w in _split_np(x["lm"], 4, 1)["stacked"].items()}
    want = _message(lambda: jtfm._pipe_stage_fn(_jcfg())(
        two, jnp.asarray(act)))
    stacked = tfm.split_pipeline_params(_torch_tree(x["lm"]), 4)["stacked"]
    with pytest.raises(ValueError, match=re.escape(want) + "$"):
        tfm._pipe_stage_fn(_tcfg())({k: w[:2] for k, w in stacked.items()},
                                    torch.from_numpy(act))
    assert "exactly one stage" in want


def _jax_guard(fn, stacked, mb, **kw):
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    run = jax.shard_map(lambda s, m: fn(_stage_fn, s, m, "pipe", **kw),
                        mesh=mesh, in_specs=({"w": P("pipe")}, P()),
                        out_specs=P(), check_vma=False)
    return _message(lambda: run({"w": jnp.asarray(stacked)},
                                jnp.asarray(mb)))


@pytest.mark.parametrize("case", ["indivisible", "misstacked"])
def test_interleaved_guards_match_jax(case):
    """``pipeline_apply_interleaved`` refuses M not divisible by P and a
    tree not stacked ``[virtual, ...]``, word for word
    (``tests/test_parallel.py:910``)."""
    rows = np.zeros((8 if case == "indivisible" else 4, D, D), np.float32)
    mb = np.zeros((6 if case == "indivisible" else 4, 1, D), np.float32)
    want = _jax_guard(jpp.pipeline_apply_interleaved, rows, mb, virtual=2)
    per = rows.shape[0] // 4

    def rank(r):
        w = torch.from_numpy(rows[r.index * per:(r.index + 1) * per])
        pp.pipeline_apply_interleaved(lambda p_, x_: x_ @ p_["w"][0],
                                      {"w": w}, torch.from_numpy(mb), r, 2)

    with pytest.raises(ValueError, match=re.escape(want) + "$"):
        VirtualAxis(4).run(rank)


@pytest.mark.parametrize("case", ["indivisible", "too_few", "misstacked"])
def test_interleaved_1f1b_guards_match_jax(case):
    """``pipeline_1f1b_interleaved`` refuses M not divisible by P, M < P
    and a tree not stacked ``[virtual, ...]``, word for word."""
    m = {"indivisible": 6, "too_few": 2, "misstacked": 4}[case]
    rows = np.zeros((4 if case == "misstacked" else 8, D, D), np.float32)
    mb = np.zeros((m, 1, D), np.float32)
    scale = jnp.ones(D)

    def jfn(stage_fn, s, mb_, axis, virtual):
        return jpp.pipeline_1f1b_interleaved(
            stage_fn, _toy_loss, s, {"scale": scale}, mb_, mb_, axis,
            virtual)[0]

    want = _jax_guard(jfn, rows, mb, virtual=2)
    per = rows.shape[0] // 4

    def rank(r):
        w = torch.from_numpy(rows[r.index * per:(r.index + 1) * per])
        x_ = torch.from_numpy(mb)
        pp.pipeline_1f1b_interleaved(
            lambda p_, v_: v_ @ p_["w"][0],
            lambda y, t, a: ((y * a["scale"] - t) ** 2).mean(), {"w": w},
            {"scale": torch.ones(D)}, x_, x_, r, 2)

    with pytest.raises(ValueError, match=re.escape(want) + "$"):
        VirtualAxis(4).run(rank)


@pytest.mark.parametrize("kw", [dict(schedule="zero_bubble"),
                                dict(schedule="interleaved", virtual=3)])
def test_make_train_step_pipelined_errors_match_jax(port_world, kw):
    """An unknown schedule, and layers that do not split over the pipe
    chunks, raise the reference's ValueErrors word for word."""
    jmesh = jax_build_mesh(axes=("data", "pipe"), shape=(1, 4),
                           devices=jax.devices()[:4])
    want = _message(lambda: jtfm.make_train_step_pipelined(
        _jcfg(), optax.sgd(0.1), jmesh, **kw))
    model = tfm.PipelineLM(_tcfg(), 4, 0, 1, device="cpu")
    opt = SGD([w for _, w in convert.lm_pipeline_ordered_parameters(model)],
              0.1, 0.9)
    with pytest.raises(ValueError, match=re.escape(want) + "$"):
        tfm.make_train_step_pipelined(model, opt, thvd.mesh(), "data",
                                      VirtualAxis(4).run(lambda r: r)[0],
                                      **kw)


@pytest.mark.parametrize("fn,args", [
    ("stack_layer_params", (3,)),
    ("stack_layer_params_interleaved", (4, 3)),
])
def test_stacking_errors_match_jax(fn, args):
    x = _inputs()
    want = _message(lambda: getattr(jtfm, fn)(
        jax.tree_util.tree_map(jnp.asarray, x["lm"]), *args))
    with pytest.raises(ValueError, match=re.escape(want) + "$"):
        getattr(tfm, fn)(_torch_tree(x["lm"]), *args)


def test_embed_microbatches_refuses_an_uneven_batch():
    x = _inputs()
    want = _message(lambda: jtfm._embed_microbatches(
        jax.tree_util.tree_map(jnp.asarray, x["lm"]),
        jnp.zeros((6, 8), jnp.int32), _jcfg(), 4))
    with pytest.raises(ValueError, match=re.escape(want) + "$"):
        tfm._embed_microbatches(_torch_tree(x["lm"]),
                                torch.zeros((6, 8), dtype=torch.long),
                                _tcfg(), 4)


def test_chip_smoke_phase_12_pipeline_on_cpu_threads(port_world):
    """Phase 12 (c) of ``chip_smoke.py`` end to end on the CPU at a tiny
    size: the plain local step, then every schedule on 2 virtual ranks,
    each held to it by the phase's own checks."""
    import chip_smoke
    tiny = dict(d_model=32, n_layers=4, n_heads=2, d_ff=64, vocab_size=64,
                seq_len=16, batch_size=4)
    res = chip_smoke.phase_pipeline("cpu", device="cpu", lm=tiny,
                                    microbatches=4, virtual=2, steps=2)
    assert set(res) == set(SCHEDULES)
    for r in res.values():
        assert r["loss_rel"] <= chip_smoke.LM_PP_LOSS_RTOL
        assert r["worst_update"][1] <= chip_smoke.LM_PP_UPDATE_TOL
