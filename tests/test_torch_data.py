"""The port's data-parallel API against the JAX package's, on the CPU.

* ``DistributedOptimizer``, the state broadcasts, ``DistributedGradientTape``
  and ``MetricAverageCallback`` at 2 ranks are held against the reference's
  torch binding (``horovod_tpu.torch``) and JAX API in ONE
  ``python -m horovod_tpu.runner -np 2`` job: every rank trains the same
  tiny torch model from the same seeds through both packages, the
  reference on its native runtime, the port on gloo.  The fusion
  threshold is 48 bytes there, so the port's optimizer fills several
  buckets.  A sum of two values has one order, so the parameters agree
  bitwise; Adasum's f64 dot products sum in another order (tolerance
  1e-6).
* ``make_training_step`` at 2 ranks (in the same job) is held against the
  JAX ``make_training_step`` on a 2-device mesh; the two backends' matmuls
  sum in another order, so tolerance 1e-6.
* Size-1 behaviour and the error contracts run in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu.torch as jt
from horovod_tpu.parallel import data as jdata
from horovod_tpu.topology import build_mesh as jax_build_mesh
import horovod_tpu_torch as thvd
from horovod_tpu_torch.parallel import data as tdata

from torch_support import jax_world, run_job, world1  # noqa: F401

JOB = r'''
import sys

import jax.numpy as jnp
import numpy as np
import torch

import horovod_tpu as jhvd
import horovod_tpu.callbacks as jcb
import horovod_tpu.torch as jt
import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
jhvd.init()
thvd.init(device="cpu")
r = thvd.rank()
assert (jhvd.rank(), jhvd.size(), thvd.size()) == (r, 2, 2)
out = {}


def mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Tanh(),
                               torch.nn.Linear(3, 2))


class TwoBranch(torch.nn.Module):
    """Rank 0 builds branch a first, rank 1 branch b first, so backward
    produces their gradients in opposite orders; only rank 0's loss
    touches c."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(1)
        self.a = torch.nn.Linear(4, 3)
        self.b = torch.nn.Linear(4, 3)
        self.c = torch.nn.Linear(4, 1)

    def forward(self, x):
        first, second = (self.a, self.b) if r == 0 else (self.b, self.a)
        loss = (first(x) ** 2).mean()
        loss = loss + (second(x) ** 2).mean()
        if r == 0:
            loss = loss + (self.c(x) ** 2).mean()
        return loss


def batch(i):
    g = np.random.default_rng(1000 * i + r)
    return torch.from_numpy(g.standard_normal((5, 4)).astype(np.float32))


def flat(model):
    return torch.cat([p.detach().reshape(-1)
                      for p in model.parameters()]).numpy()


def train(pkg, case):
    model = TwoBranch() if case == "order" else mlp()
    kw = {}
    if case == "fp16":
        kw["compression"] = pkg.Compression.fp16
    if case == "bpps2":
        kw["backward_passes_per_step"] = 2
    if case == "adasum":
        kw["op"] = pkg.Adasum
    opt = pkg.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), **kw)
    if case == "order":
        # Every rank holds a gradient for c (zeros on rank 1), so the
        # reference's force-allreduce covers it on both ranks.
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
    losses = []
    for step in range(3):
        for k in range(2 if case == "bpps2" else 1):
            x = batch(10 * step + k)
            loss = model(x) if case == "order" else (model(x) ** 2).mean()
            loss.backward()
        if case == "skip_sync":
            opt.synchronize()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 0.05)
            with opt.skip_synchronize():
                opt.step()
        else:
            opt.step()
        opt.zero_grad(set_to_none=case != "order")
        losses.append(loss.item())
    return np.concatenate([flat(model), losses])


for case in ("plain", "bpps2", "fp16", "skip_sync", "order", "adasum"):
    out[f"ref/{case}"] = train(jt, case)
    out[f"port/{case}"] = train(thvd, case)


class Mirror(torch.nn.Module):
    """Two branches that rank 0 runs in one order and rank 1 in the
    other, so backward fills their buckets in opposite orders."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(2)
        self.a = torch.nn.Linear(4, 3)
        self.b = torch.nn.Linear(4, 3)

    def forward(self, x):
        first, second = (self.a, self.b) if r == 0 else (self.b, self.a)
        h = first(x)
        return (h ** 2).mean() + (second(x + h.sum()) ** 2).mean()


def fill_order(pkg):
    """Each bucket is submitted as soon as it fills; returns the
    parameters after three steps and, for the port, the order in which
    the buckets went out during each backward."""
    model = Mirror()
    opt = pkg.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    orders = []
    for step in range(3):
        model(batch(40 + step)).backward()
        orders.append([b for b, _, _ in getattr(opt, "_inflight", [])])
        opt.step()
        opt.zero_grad()
    return flat(model), np.array(orders)


out["ref/fill_order"], _ = fill_order(jt)
out["port/fill_order"], out["port/fill_order_buckets"] = fill_order(thvd)


def guards(pkg):
    """zero_grad between backward and step, and a skip_synchronize step
    with no synchronize after the backward: both must raise."""
    model = mlp()
    opt = pkg.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    (model(batch(0)) ** 2).mean().backward()
    raised = []
    try:
        opt.zero_grad()
        raised.append(False)
    except AssertionError:
        raised.append(True)
    opt.step()
    opt.zero_grad()
    (model(batch(1)) ** 2).mean().backward()
    try:
        with opt.skip_synchronize():
            opt.step()
        raised.append(False)
    except AssertionError:
        raised.append(True)
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    return np.array(raised + [True])


out["ref/guards"], out["port/guards"] = guards(jt), guards(thvd)


def bcast(pkg):
    """Diverged models and a root-only Adam state, broadcast from 0."""
    torch.manual_seed(r)
    model = torch.nn.Linear(3, 2)
    opt = pkg.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    if r == 0:
        for p in model.parameters():
            p.grad = torch.full_like(p, 0.5)
        type(opt).__mro__[1].step(opt)
        for p in model.parameters():
            p.grad = None
        opt.param_groups[0]["lr"] = 0.05
    pkg.broadcast_parameters(model.state_dict(), root_rank=0)
    pkg.broadcast_optimizer_state(opt, root_rank=0)
    sd = opt.state_dict()
    parts = [flat(model), [sd["param_groups"][0]["lr"]]]
    for pid in sorted(sd["state"]):
        for key in sorted(sd["state"][pid]):
            parts.append(np.asarray(sd["state"][pid][key]).reshape(-1))
    return np.concatenate(parts).astype(np.float64)


out["ref/broadcast_state"], out["port/broadcast_state"] = (bcast(jt),
                                                           bcast(thvd))

# DistributedGradientTape on the same gradients, list and (value, grads).
grads = [torch.from_numpy(np.random.default_rng(50 + r).standard_normal(
    s).astype(np.float32)) for s in ((3, 2), (5,))]
ref = jhvd.DistributedGradientTape(
    lambda: [jnp.asarray(g.numpy()) for g in grads])()
port = thvd.DistributedGradientTape(lambda: list(grads))()
value, port_pair = thvd.DistributedGradientTape(
    lambda: (torch.tensor(1.5), tuple(grads)))()
out["ref/tape"] = np.concatenate([np.asarray(g).ravel() for g in ref])
out["port/tape"] = np.concatenate([g.numpy().ravel() for g in port])
out["port/tape_pair"] = np.concatenate([g.numpy().ravel() for g in
                                        port_pair] + [[value.item()]])

logs = {"loss": 1.0 + r, "acc": 0.25 * (r + 1)}
ref_logs, port_logs = dict(logs), dict(logs)
jcb.MetricAverageCallback().on_epoch_end(0, ref_logs)
thvd.MetricAverageCallback().on_epoch_end(0, port_logs)
out["ref/metric_average"] = np.array([ref_logs[k] for k in sorted(logs)])
out["port/metric_average"] = np.array([port_logs[k] for k in sorted(logs)])

# make_training_step on this rank's half of a global regression batch.
g = np.random.default_rng(3)
w0 = g.standard_normal((4, 2)).astype(np.float32)
b0 = g.standard_normal(2).astype(np.float32)
xs = g.standard_normal((8, 4)).astype(np.float32)
ys = g.standard_normal((8, 2)).astype(np.float32)
lin = torch.nn.Linear(4, 2)
with torch.no_grad():
    lin.weight.copy_(torch.from_numpy(w0.T))
    lin.bias.copy_(torch.from_numpy(b0))
step = thvd.make_training_step(
    lambda m, bt: ((m(bt[0]) - bt[1]) ** 2).mean(), lin,
    torch.optim.SGD(lin.parameters(), lr=0.1, momentum=0.9))
shard = (torch.from_numpy(xs[4 * r:4 * r + 4]),
         torch.from_numpy(ys[4 * r:4 * r + 4]))
losses = [step(shard).item() for _ in range(2)]
out["port/train_step"] = np.concatenate(
    [lin.weight.detach().numpy().T.ravel(), lin.bias.detach().numpy(),
     losses])

thvd.shutdown()
np.savez(f"{out_dir}/rank{r}.npz", **out)
jhvd.shutdown()
print(f"rank {r}: data job done", flush=True)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return run_job(JOB, str(tmp_path_factory.mktemp("data_job")), np_=2,
                   env={"HOROVOD_FUSION_THRESHOLD": "48"})


def test_buckets_go_out_as_they_fill_in_any_order(job):
    """``Mirror``'s backward fills the buckets in opposite orders on the
    two ranks; each rank submits every bucket during its backward, in
    its own order, and the control plane pairs them by name: the
    parameters equal the reference binding's bit for bit on both ranks."""
    orders = [job[r]["port/fill_order_buckets"] for r in range(2)]
    for o in orders:
        assert sorted(o[0].tolist()) == list(range(len(o[0]))) and (
            o == o[0]).all()
    assert orders[0][0].tolist() != orders[1][0].tolist()
    for r in range(2):
        np.testing.assert_array_equal(job[r]["port/fill_order"],
                                      job[r]["ref/fill_order"])
    np.testing.assert_array_equal(job[0]["port/fill_order"],
                                  job[1]["port/fill_order"])


@pytest.mark.parametrize("case", ["plain", "bpps2", "fp16", "skip_sync",
                                  "order"])
def test_distributed_optimizer_matches_reference_bitwise(job, case):
    """Three steps of SGD with momentum: parameters (and the losses) equal
    the reference binding's bit for bit on both ranks, and the ranks hold
    the same parameters.  ``order``: backward orders differ between the
    ranks and one parameter has a gradient on rank 0 only."""
    for r in range(2):
        np.testing.assert_array_equal(job[r][f"port/{case}"],
                                      job[r][f"ref/{case}"])
    n = len(job[0][f"port/{case}"]) - 3
    np.testing.assert_array_equal(job[0][f"port/{case}"][:n],
                                  job[1][f"port/{case}"][:n])


def test_distributed_optimizer_adasum_matches_reference(job):
    for r in range(2):
        np.testing.assert_allclose(job[r]["port/adasum"],
                                   job[r]["ref/adasum"], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["guards", "broadcast_state", "tape",
                                  "metric_average"])
def test_data_api_matches_reference(job, case):
    for r in range(2):
        np.testing.assert_array_equal(job[r][f"port/{case}"],
                                      job[r][f"ref/{case}"])
    if case == "broadcast_state":
        np.testing.assert_array_equal(job[1]["port/broadcast_state"],
                                      job[0]["port/broadcast_state"])
    if case == "tape":
        for r in range(2):
            np.testing.assert_array_equal(
                job[r]["port/tape_pair"],
                np.append(job[r]["ref/tape"], 1.5))


def _jax_train_step():
    g = np.random.default_rng(3)
    w0 = g.standard_normal((4, 2)).astype(np.float32)
    b0 = g.standard_normal(2).astype(np.float32)
    xs = g.standard_normal((8, 4)).astype(np.float32)
    ys = g.standard_normal((8, 2)).astype(np.float32)

    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)

    mesh = jax_build_mesh(axes=("data",), shape=(2,),
                          devices=jax.devices()[:2])
    step = jdata.make_training_step(loss_fn, optax.sgd(0.1, momentum=0.9),
                                    mesh, donate=False)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = step.init(params)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state,
                                   (jnp.asarray(xs), jnp.asarray(ys)))
        losses.append(float(loss))
    return np.concatenate([np.asarray(params["w"]).ravel(),
                           np.asarray(params["b"]), losses])


def test_make_training_step_matches_jax_two_device_mesh(job):
    want = _jax_train_step()
    for r in range(2):
        np.testing.assert_allclose(job[r]["port/train_step"], want,
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# In this process: a world of one
# ---------------------------------------------------------------------------


def _linear():
    torch.manual_seed(0)
    return torch.nn.Linear(3, 2)


@pytest.mark.parametrize("named,match", [
    (lambda m: [("w", m.weight), ("w", m.bias)], "unique"),
    (lambda m: [m.weight], "tuples"),
    (lambda m: [("w", m.weight)], "does not cover all"),
])
def test_named_parameters_validation_matches_reference(jax_world, named,
                                                       match):
    msgs = []
    for pkg in (thvd, jt):
        m = _linear()
        with pytest.raises(ValueError, match=match) as e:
            pkg.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                     named_parameters=named(m))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_size1_optimizer_is_the_wrapped_one(jax_world):
    """At size 1 no hook and no collective: three steps equal the plain
    optimizer's bitwise, as the reference binding's do; the wrapper is a
    subclass of the wrapped class with its name."""
    runs = []
    for wrap in (None, thvd, jt):
        m = _linear()
        opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
        if wrap is not None:
            opt = wrap.DistributedOptimizer(
                opt, named_parameters=m.named_parameters())
            assert isinstance(opt, torch.optim.SGD)
            assert type(opt).__name__ == "SGD"
            assert not getattr(opt, "_hooks", [])
        for i in range(3):
            (m(torch.full((4, 3), float(i))) ** 2).sum().backward()
            opt.step()
            opt.zero_grad()
        runs.append(torch.cat([p.detach().reshape(-1)
                               for p in m.parameters()]))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("compression", ["none", "fp16"])
def test_planned_bucket_goes_out_as_one_all_reduce(world1, monkeypatch,
                                                   compression):
    """Each bucket of the optimizer's plan leaves as ONE flat all-reduce,
    counted once in ``fusion.allreduce_calls`` once its results are in,
    even when the fusion threshold has since shrunk below its leaves (the
    plan is not walked again, and the runtime fuses at the threshold it
    read at ``init``) and fp16 compression has changed the wire dtype;
    the result is each gradient's average (itself at size 1)."""
    from horovod_tpu_torch.ops import collective, fusion
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1mb")
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1),
        named_parameters=m.named_parameters(), compression=compression)
    assert [len(b) for b in opt._buckets] == [4]
    (m(torch.ones(2, 3)) ** 2).sum().backward()
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1")
    fusion.allreduce_calls.reset()
    collective.calls.reset()
    opt._issue(0)
    (_, pending, ctxs), = opt._inflight
    wire = torch.float16 if compression == "fp16" else torch.float32
    for p, out in zip(opt._buckets[0], pending.result()):
        assert out.dtype == wire
        assert torch.equal(out, p.grad.to(wire))
    assert fusion.allreduce_calls.count == 1 and collective.calls.count == 0


def test_size1_broadcast_optimizer_state_fills_like_reference(jax_world):
    """An empty state is filled by one local zero-gradient step in both
    packages: the same keys and values, parameters unchanged."""
    states = []
    for pkg in (thvd, jt):
        m = _linear()
        before = [p.detach().clone() for p in m.parameters()]
        opt = pkg.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
            named_parameters=m.named_parameters())
        pkg.broadcast_optimizer_state(opt, root_rank=0)
        pkg.broadcast_parameters(m.state_dict(), root_rank=0)
        for p, b in zip(m.parameters(), before):
            assert torch.equal(p, b)
        states.append(opt.state_dict())
    assert states[0]["param_groups"] == states[1]["param_groups"]
    for pid in states[1]["state"]:
        for key, v in states[1]["state"][pid].items():
            assert torch.equal(states[0]["state"][pid][key], v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.int64])
def test_compression_fp16_matches_reference(dtype):
    x = torch.linspace(-3, 3, 7).to(dtype)
    got, ctx = tdata.Compression.fp16.compress(x)
    want, wctx = jt.Compression.fp16.compress(x)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert ctx == wctx
    assert torch.equal(tdata.Compression.fp16.decompress(got, ctx),
                       jt.Compression.fp16.decompress(want, wctx))
    assert tdata.Compression.none.compress(x) == (x, None)


@pytest.mark.parametrize("kw", [dict(shard_optimizer=True),
                                dict(compression="int8"),
                                dict(compression="powersgd:2")])
def test_make_training_step_options_not_ported_raise(world1, kw):
    """The options run now, and raise as the reference's do when misused:
    the sharded update needs a functional optimizer (a ``torch.optim``
    one steps in place), and a stateful codec's step needs ``step.init``
    first (the reference's ``RuntimeError``)."""
    m = _linear()
    if kw.get("shard_optimizer"):
        with pytest.raises(TypeError, match="optim.sgd or "
                                            "horovod_tpu_torch.optim.adam"):
            thvd.make_training_step(lambda mod, b: mod(b).sum(), m,
                                    torch.optim.SGD(m.parameters(), lr=0.1),
                                    **kw)
        return
    step = thvd.make_training_step(lambda mod, b: mod(b).sum(), m,
                                   torch.optim.SGD(m.parameters(), lr=0.1),
                                   **kw)
    with pytest.raises(RuntimeError, match="call step.init"):
        step(torch.ones(2, 4))


@pytest.mark.parametrize("env", [None, "int8"])
@pytest.mark.parametrize("compression", ["none", "bf16", "fp16", "int8",
                                         "powersgd:2", "default"])
def test_per_leaf_compression_matches_jax(monkeypatch, caplog, env,
                                          compression):
    """The per-leaf paths' Compressor for each ``compression=`` form, as
    the reference's ``_legacy_compression``: the casts map to their
    Compressor, a stateful codec (also one named by HOROVOD_COMPRESSION
    under the default form) falls back to none with one warning."""
    if env is None:
        monkeypatch.delenv("HOROVOD_COMPRESSION", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_COMPRESSION", env)
    monkeypatch.setattr(tdata, "_warned_stateful_per_leaf", False)
    monkeypatch.setattr(jdata, "_warned_stateful_per_leaf", False)
    t_arg = tdata.Compression.none if compression == "default" else \
        compression
    j_arg = jdata.Compression.none if compression == "default" else \
        compression
    with caplog.at_level("WARNING", logger="horovod_tpu_torch"):
        got = tdata._compression(t_arg)
        tdata._compression(t_arg)
    want = jdata._legacy_compression(j_arg)
    assert got.__name__ == want.__name__
    warned = [r for r in caplog.records
              if r.name == "horovod_tpu_torch.parallel.data"]
    assert len(warned) == (got.__name__ == "NoneCompressor"
                           and (compression in ("int8", "powersgd:2")
                                or (compression == "default"
                                    and env == "int8")))


def test_make_training_step_size1_matches_jax_one_device(world1):
    """The port at size 1 against the JAX step on a 1-device mesh, same
    regression problem on the whole batch; tolerance 1e-6."""
    g = np.random.default_rng(3)
    w0 = g.standard_normal((4, 2)).astype(np.float32)
    b0 = g.standard_normal(2).astype(np.float32)
    xs = g.standard_normal((8, 4)).astype(np.float32)
    ys = g.standard_normal((8, 2)).astype(np.float32)
    lin = torch.nn.Linear(4, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w0.T))
        lin.bias.copy_(torch.from_numpy(b0))
    step = thvd.make_training_step(
        lambda m, bt: ((m(bt[0]) - bt[1]) ** 2).mean(), lin,
        torch.optim.SGD(lin.parameters(), lr=0.1, momentum=0.9))
    for _ in range(2):
        loss = step((torch.from_numpy(xs), torch.from_numpy(ys)))

    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)

    mesh = jax_build_mesh(axes=("data",), shape=(1,),
                          devices=jax.devices()[:1])
    jstep = jdata.make_training_step(loss_fn, optax.sgd(0.1, momentum=0.9),
                                     mesh, donate=False)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = jstep.init(params)
    for _ in range(2):
        params, state, jloss = jstep(params, state,
                                     (jnp.asarray(xs), jnp.asarray(ys)))
    np.testing.assert_allclose(lin.weight.detach().numpy().T,
                               np.asarray(params["w"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lin.bias.detach().numpy(),
                               np.asarray(params["b"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def test_gradient_tape_size1_keeps_structure(world1):
    grads = {"w": torch.ones(2, 3), "b": torch.arange(3.0)}
    out = thvd.DistributedGradientTape(lambda: grads)()
    assert out.keys() == grads.keys()
    for k in grads:
        assert torch.equal(out[k], grads[k])
    value, pair = thvd.DistributedGradientTape(
        lambda: (torch.tensor(2.0), (grads["w"],)))()
    assert value.item() == 2.0 and isinstance(pair, tuple)
    assert torch.equal(pair[0], grads["w"])
