"""The port's expert parallelism against the JAX package's, on the CPU.

* Routing (``top1_routing``, ``top2_routing``): dispatch and combine bit
  for bit at f32 from the same logits, capacity drops included, and the
  reference's own routing oracles (``tests/test_parallel.py:251-332``).
* One 4-rank gloo job (started first; the JAX side computes under
  ``shard_map`` on 4 of the conftest's CPU devices meanwhile) runs every
  case of :data:`MOE`: ``moe_layer`` top-1 at capacity factor 1.25 and
  top-2 at 2.5 (``examples/jax_moe.py``'s defaults) and with ample
  capacity, ``moe_layer_ragged`` with ample capacity and at overflow
  (capacity 3 a rank: most tokens dropped), over the dense twin and the
  primitive route, ``load_balancing_loss``, and ``alltoall_ragged``
  (payloads that name sender, destination and row; a capacity drop; the
  gradient) over both routes.  The expert is the example's
  ``relu(x @ w1) @ w2``; its parameters cross with
  ``convert.moe_params_to_torch``.  Gradients are those of
  ``sum(y * ct)`` over every rank for a fixed random ``ct``; the port's
  replicated router gradient is summed over its ranks.  Tolerance: f32
  ``rtol`` and ``atol`` 1e-6 (the expert's matmuls sum in another order),
  and ``atol`` 1e-5 for the router's gradient, a sum of 64 token terms
  up to about 8 in size, taken over four ranks in another order.
* The same cases on 4 virtual ranks (threads of this process, every
  exchange a swap in memory, one backward over every rank's loss) give
  the gloo ranks' answers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import collective as jcollective
from horovod_tpu.parallel import expert as JE
from horovod_tpu_torch.parallel import expert as TE
from horovod_tpu_torch.parallel import sequence as sq
from torch_support import start_port_job

S, T, D, H = 4, 16, 8, 16
RTOL = ATOL = 1e-6
ROUTER_GRAD_ATOL = 1e-5
A2A_ROWS, A2A_CAP = 9, 7

# name -> (layer, capacity factor, router or use_primitive)
MOE = {
    "dense_top1": ("dense", 1.25, "top1"),
    "dense_top2": ("dense", 2.5, "top2"),
    "dense_top1_ample": ("dense", 4.0, "top1"),
    "ragged_ample_twin": ("ragged", 4.0, False),
    "ragged_ample_primitive": ("ragged", 4.0, True),
    "ragged_overflow_twin": ("ragged", 0.75, False),
    "ragged_overflow_primitive": ("ragged", 0.75, True),
}
A2A = {f"a2a_{cap}_{route}": (cap, route == "primitive")
       for cap in ("oracle", "drop") for route in ("twin", "primitive")}
CASES = list(MOE) + ["aux"] + list(A2A)


def _inputs() -> dict:
    rng = np.random.default_rng(31)
    x = {"x": rng.standard_normal((S, T, D)).astype(np.float32),
         "router": rng.standard_normal((D, S)).astype(np.float32),
         "w1": (rng.standard_normal((S, D, H)) * 0.4).astype(np.float32),
         "w2": (rng.standard_normal((S, H, D)) * 0.4).astype(np.float32),
         "ct": rng.standard_normal((S, T, D)).astype(np.float32)}
    # alltoall_ragged: row i of rank s's block for d carries (s, d, i);
    # rows past sum(splits) are junk that must never arrive.
    splits = rng.integers(0, 3, size=(S, S)).astype(np.int64)
    rows = np.full((S, A2A_ROWS, 3), -777.0, np.float32)
    for s in range(S):
        k = 0
        for d in range(S):
            for i in range(splits[s, d]):
                rows[s, k] = (s, d, i)
                k += 1
    x["a2a_splits"], x["a2a_rows"] = splits, rows
    x["a2a_grad_x"] = rng.standard_normal((S, A2A_ROWS, 2)).astype(
        np.float32)
    return x


# The cases as every rank of the port runs them, gloo or virtual: the
# job executes this source, and so does the virtual-rank test.
CASES_SRC = r'''
import torch

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel import expert as E


def expert_fn(p, tok):
    return torch.relu(tok @ p["w1"]) @ p["w2"]


def forwards(axis, r, inp, moe, a2a, cap):
    """Every case on rank ``r``: name -> (outputs, loss, leaves)."""
    out = {}
    prm = convert.moe_params_to_torch(
        {k: inp[k] for k in ("router", "w1", "w2")}, rank=r)
    ct = torch.from_numpy(inp["ct"][r])

    def leaves():
        x = torch.from_numpy(inp["x"][r].copy()).requires_grad_()
        rw = prm["router"].clone().requires_grad_()
        ex = {k: v.clone().requires_grad_()
              for k, v in prm["experts"].items()}
        return x, rw, ex

    for name, (kind, cf, extra) in moe.items():
        x, rw, ex = leaves()
        if kind == "dense":
            y = E.moe_layer(x, rw, expert_fn, ex, axis, cf, router=extra)
        else:
            y = E.moe_layer_ragged(x, rw, expert_fn, ex, axis, cf,
                                   use_primitive=extra)
        out[name] = ({"y": y}, (y * ct).sum(),
                     {"x": x, "router": rw, "w1": ex["w1"],
                      "w2": ex["w2"]})
    x, rw, _ = leaves()
    aux = E.load_balancing_loss(x @ rw, axis)
    out["aux"] = ({"aux": aux.reshape(1)}, aux, {"x": x, "router": rw})
    splits = torch.from_numpy(inp["a2a_splits"][r])
    for name, (which, primitive) in a2a.items():
        if which == "oracle":
            rows = torch.from_numpy(inp["a2a_rows"][r])
            o, recv = C.alltoall_ragged(rows, splits, cap, axis,
                                        use_primitive=primitive)
            out[name] = ({"out": o, "recv": recv}, None, {})
        else:
            # The oracle's splits, and then row d to peer d from every
            # rank, where 3 of the 4 rows fit.
            g = torch.from_numpy(inp["a2a_grad_x"][r].copy())
            g.requires_grad_()
            o, recv = C.alltoall_ragged(g, splits, cap, axis,
                                        use_primitive=primitive)
            o2, recv2 = C.alltoall_ragged(
                g[:len(splits)], torch.ones(len(splits), dtype=torch.long),
                3, axis, use_primitive=primitive)
            out[name] = ({"out": o, "recv": recv, "drop": o2,
                          "drop_recv": recv2},
                         (o ** 2).sum() + (o2 ** 2).sum(), {"x": g})
    return out


def grads_of(loss, leaves):
    if loss is None:
        return {}
    got = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, got))
'''

JOB = r'''
import os
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd

out_dir = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
exec(%(src)r)
res = {}
for name, (outs, loss, leaves) in forwards(None, r, inp, %(moe)r, %(a2a)r,
                                           %(cap)d).items():
    for k, v in outs.items():
        res[f"{name}/{k}"] = v.detach().numpy()
    for k, g in grads_of(loss, leaves).items():
        res[f"{name}/grad/{k}"] = g.numpy()
np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _mesh():
    return Mesh(np.array(jax.devices()[:S]), ("expert",))


def _jexpert(p, tok):
    return jax.nn.relu(tok @ p["w1"][0]) @ p["w2"][0]


def _jax_moe(x, kind, cf, extra):
    """``y`` per rank and the gradients of ``sum(y * ct)``, JAX."""
    def layer(xx, rw, w1, w2):
        p = {"w1": w1, "w2": w2}
        if kind == "dense":
            return JE.moe_layer(xx, rw, _jexpert, p, axis_name="expert",
                                capacity_factor=cf, router=extra)
        return JE.moe_layer_ragged(xx, rw, _jexpert, p, axis_name="expert",
                                   capacity_factor=cf, use_primitive=False)

    f = jax.shard_map(layer, mesh=_mesh(),
                      in_specs=(P("expert"), P(), P("expert"), P("expert")),
                      out_specs=P("expert"), check_vma=kind == "dense")
    args = (jnp.asarray(x["x"].reshape(S * T, D)), jnp.asarray(x["router"]),
            jnp.asarray(x["w1"]), jnp.asarray(x["w2"]))
    ct = jnp.asarray(x["ct"].reshape(S * T, D))
    y = np.asarray(jax.jit(f)(*args)).reshape(S, T, D)
    g = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * ct),
                         argnums=(0, 1, 2, 3)))(*args)
    return y, dict(zip(("x", "router", "w1", "w2"),
                       [np.asarray(v) for v in g]))


def _jax_aux(x):
    def aux(xx, rw):
        return JE.load_balancing_loss(xx @ rw, "expert").reshape(1)

    f = jax.shard_map(aux, mesh=_mesh(), in_specs=(P("expert"), P()),
                      out_specs=P("expert"), check_vma=True)
    args = (jnp.asarray(x["x"].reshape(S * T, D)), jnp.asarray(x["router"]))
    val = np.asarray(jax.jit(f)(*args))
    g = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a)), argnums=(0, 1)))(*args)
    return val, {"x": np.asarray(g[0]), "router": np.asarray(g[1])}


def _jax_a2a(x, cap):
    def f(rows, sp):
        return jcollective.alltoall_ragged(rows, sp, cap, axis_name="expert",
                                           use_primitive=False)

    g = jax.jit(jax.shard_map(f, mesh=_mesh(), in_specs=(P("expert"),
                                                         P("expert")),
                              out_specs=(P("expert"), P("expert"))))
    out, recv = g(jnp.asarray(x["a2a_rows"].reshape(S * A2A_ROWS, 3)),
                  jnp.asarray(x["a2a_splits"].reshape(-1).astype(np.int32)))
    return (np.asarray(out).reshape(S, cap, 3),
            np.asarray(recv).reshape(S, S))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("expert")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    finish = start_port_job(
        JOB % dict(src=CASES_SRC, moe=MOE, a2a=A2A, cap=A2A_CAP), str(out),
        np_=S, timeout=300, env={"OMP_NUM_THREADS": "1"})
    want = {name: _jax_moe(x, *spec) for name, spec in MOE.items()}
    want["aux"] = _jax_aux(x)
    want["a2a"] = _jax_a2a(x, A2A_CAP)
    ranks, _ = finish()
    return x, ranks, want


def _port(ranks, key):
    return np.stack([rk[key] for rk in ranks])


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("case", list(MOE))
def test_moe_layers_match_jax_at_four_gloo_ranks(results, case):
    x, ranks, want = results
    y, g = want[case]
    _close(_port(ranks, f"{case}/y"), y, f"{case} y")
    _close(_port(ranks, f"{case}/grad/x").reshape(S * T, D), g["x"],
           f"{case} dx")
    _close(_port(ranks, f"{case}/grad/router").sum(0), g["router"],
           f"{case} drouter", ROUTER_GRAD_ATOL)
    for w in ("w1", "w2"):
        _close(_port(ranks, f"{case}/grad/{w}"), g[w], f"{case} d{w}")


def test_top1_and_top2_drop_tokens_at_these_capacities(results):
    """The cases exercise the capacity rule: some rows are dropped."""
    _, ranks, want = results
    for case in ("dense_top1", "ragged_overflow_twin"):
        y = _port(ranks, f"{case}/y")
        assert (np.abs(y).sum(-1) == 0).any(), case


def test_ragged_without_overflow_equals_the_dense_layer(results):
    """``test_moe_ragged_matches_dense``: ample capacity, same routing."""
    _, ranks, _ = results
    dense = _port(ranks, "dense_top1_ample/y")
    for route in ("twin", "primitive"):
        np.testing.assert_allclose(_port(ranks, f"ragged_ample_{route}/y"),
                                   dense, rtol=1e-5, atol=1e-6)


def test_ragged_overflow_values_match_the_numpy_oracle(results):
    """``test_moe_ragged_overflow_values_match_oracle``: expert j's buffer
    is granted to source ranks in rank order, tokens in token order;
    survivors keep gate * expert(token), the dropped rows are zero."""
    x, ranks, _ = results
    cap = max(int(0.75 * T / S), 1)
    buf = S * cap
    logits = x["x"] @ x["router"]
    e_ = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e_ / e_.sum(-1, keepdims=True)
    dest = probs.argmax(-1)
    gate = np.take_along_axis(probs, dest[..., None], -1)[..., 0]
    want = np.zeros_like(x["x"])
    for j in range(S):
        used = 0
        for s in range(S):
            for tok in range(T):
                if dest[s, tok] != j:
                    continue
                if used < buf:
                    h = np.maximum(x["x"][s, tok] @ x["w1"][j], 0)
                    want[s, tok] = gate[s, tok] * (h @ x["w2"][j])
                used += 1
    zero_rows = int((want == 0).all(-1).sum())
    assert 0 < zero_rows < S * T
    for route in ("twin", "primitive"):
        np.testing.assert_allclose(
            _port(ranks, f"ragged_overflow_{route}/y"), want, rtol=1e-4,
            atol=1e-5)


def test_load_balancing_loss_matches_jax(results):
    _, ranks, want = results
    val, g = want["aux"]
    _close(_port(ranks, "aux/aux").reshape(-1), val, "aux")
    _close(_port(ranks, "aux/grad/x").reshape(S * T, D), g["x"], "aux dx")
    _close(_port(ranks, "aux/grad/router").sum(0), g["router"],
           "aux drouter", ROUTER_GRAD_ATOL)


@pytest.mark.parametrize("route", ["twin", "primitive"])
def test_alltoall_ragged_matches_jax_and_the_oracle(results, route):
    """``test_alltoall_ragged_matches_oracle``: every row lands at its
    destination after the lower senders' rows, in order, bitwise; rows
    past the capacity and past ``sum(splits)`` never arrive."""
    x, ranks, want = results
    out, recv = want["a2a"]
    np.testing.assert_array_equal(_port(ranks, f"a2a_oracle_{route}/out"),
                                  out)
    np.testing.assert_array_equal(_port(ranks, f"a2a_oracle_{route}/recv"),
                                  recv)
    sp = x["a2a_splits"]
    for d in range(S):
        rows = [x["a2a_rows"][s][sp[s, :d].sum():sp[s, :d].sum() + sp[s, d]]
                for s in range(S)]
        cat = np.concatenate(rows)[:A2A_CAP]
        np.testing.assert_array_equal(out[d][:len(cat)], cat)
        assert (out[d][len(cat):] == 0).all()
        np.testing.assert_array_equal(recv[d], sp[:, d])


@pytest.mark.parametrize("route", ["twin", "primitive"])
def test_alltoall_ragged_drops_past_capacity(results, route):
    """``test_alltoall_ragged_capacity_drop``: 4 rows arrive, 3 fit, from
    senders 0..2 in source order."""
    x, ranks, _ = results
    drop = _port(ranks, f"a2a_drop_{route}/drop")
    assert (_port(ranks, f"a2a_drop_{route}/drop_recv") == 1).all()
    g = x["a2a_grad_x"]
    for d in range(S):
        np.testing.assert_array_equal(drop[d], g[:3, d])


@pytest.mark.parametrize("route", ["twin", "primitive"])
def test_alltoall_ragged_gradient(results, route):
    """``test_alltoall_ragged_gradient``: a landed row gets its cotangent
    back (2x for sum of squares), a dropped or slack row zero."""
    x, ranks, _ = results
    g, sp = x["a2a_grad_x"], x["a2a_splits"]
    want = np.zeros_like(g)
    for s in range(S):
        k = 0
        for d in range(S):
            before = sp[:s, d].sum()
            for i in range(sp[s, d]):
                if before + i < A2A_CAP:
                    want[s, k + i] += 2 * g[s, k + i]
            k += sp[s, d]
        for d in range(S):      # the drop case: row d to peer d, 3 fit
            if s < 3:
                want[s, d] += 2 * g[s, d]
    np.testing.assert_allclose(_port(ranks, f"a2a_drop_{route}/grad/x"),
                               want, rtol=1e-6)


def test_virtual_ranks_give_the_gloo_ranks_answers(results):
    """Phase 14 (a)'s ranks: threads of one process, one backward over
    every rank's loss."""
    x, ranks, _ = results
    ns: dict = {}
    exec(CASES_SRC, ns)
    axis = sq.VirtualAxis(S)
    per_rank = axis.run(lambda vr: ns["forwards"](vr, vr.index, x, MOE, A2A,
                                                  A2A_CAP))
    for name in CASES:
        outs = [per_rank[r][name][0] for r in range(S)]
        for k in outs[0]:
            got = np.stack([o[k].detach().numpy() for o in outs])
            np.testing.assert_allclose(got, _port(ranks, f"{name}/{k}"),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {k}")
        losses = [per_rank[r][name][1] for r in range(S)]
        if losses[0] is None:
            continue
        leaves = [per_rank[r][name][2] for r in range(S)]
        keys = list(leaves[0])
        flat = [lv[k] for lv in leaves for k in keys]
        grads = torch.autograd.grad(sum(losses), flat)
        for i, k in enumerate(keys):
            got = np.stack([grads[r * len(keys) + i].numpy()
                            for r in range(S)])
            np.testing.assert_allclose(got, _port(ranks, f"{name}/grad/{k}"),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} d{k}")


# ---------------------------------------------------------------------------
# Routing, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["top1_routing", "top2_routing"])
@pytest.mark.parametrize("capacity", [64, 9, 1])
@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_routing_is_bitwise_the_references(router, capacity, scale):
    """Dispatch, combine and what capacity drops, bit for bit at f32."""
    rng = np.random.default_rng(int(capacity * 10 + scale))
    logits = (rng.standard_normal((64, 4)) * scale).astype(np.float32)
    jd, jc = getattr(JE, router)(jnp.asarray(logits), capacity)
    td, tc = getattr(TE, router)(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy().view(np.uint32),
                                  np.asarray(jc).view(np.uint32))


def test_top1_routing_oracle():
    """``tests/test_parallel.py::test_top1_routing`` on the port."""
    t, e = 32, 4
    logits = torch.nn.functional.one_hot(torch.arange(t) % e, e) * 50.0
    dispatch, combine = TE.top1_routing(logits, capacity=t)
    assert tuple(dispatch.shape) == (t, e, t)
    np.testing.assert_allclose(dispatch.sum(dim=(1, 2)).numpy(), 1.0)
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(), 1.0,
                               rtol=1e-5)
    dispatch, _ = TE.top1_routing(logits, capacity=1)
    kept = dispatch.sum(dim=(1, 2)).numpy()
    assert kept.sum() == e
    np.testing.assert_allclose(kept[:e], 1.0)
    np.testing.assert_allclose(kept[e:], 0.0)


def test_top2_routing_oracle():
    """``tests/test_parallel.py::test_top2_routing`` on the port."""
    t, e = 8, 4
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    dispatch, combine = TE.top2_routing(torch.from_numpy(logits), 2 * t)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    i1 = probs.argmax(-1)
    i2 = (probs * (1 - np.eye(e)[i1])).argmax(-1)
    np.testing.assert_allclose(dispatch.sum(dim=(1, 2)).numpy(), 2.0)
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(), 1.0,
                               rtol=1e-5)
    per_expert = dispatch.sum(dim=2).numpy()
    for tok in range(t):
        assert per_expert[tok, i1[tok]] == 1.0
        assert per_expert[tok, i2[tok]] == 1.0
    kept = TE.top2_routing(torch.from_numpy(logits), 1)[0].sum(dim=2).numpy()
    for ex in range(e):
        takers = np.nonzero(kept[:, ex])[0]
        assert len(takers) <= 1
        if len(takers) == 1 and (i1 == ex).any():
            assert takers[0] == np.nonzero(i1 == ex)[0][0]


def test_softmax_gradient_is_softmax_s():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((16, 4)).astype(
        np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    g, = torch.autograd.grad((TE._softmax(logits) * w).sum(), logits)
    want, = torch.autograd.grad((torch.softmax(logits, -1) * w).sum(),
                                logits)
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_moe_params_cross_as_the_example_lays_them_out():
    from horovod_tpu_torch.models import convert
    x = _inputs()
    got = convert.moe_params_to_torch({k: x[k] for k in ("router", "w1",
                                                         "w2")})
    np.testing.assert_array_equal(got["router"].numpy(), x["router"])
    assert len(got["experts"]) == S
    for e in range(S):
        np.testing.assert_array_equal(got["experts"][e]["w1"].numpy(),
                                      x["w1"][e])
        np.testing.assert_array_equal(got["experts"][e]["w2"].numpy(),
                                      x["w2"][e])
    one = convert.moe_params_to_torch({k: x[k] for k in ("router", "w1",
                                                         "w2")}, rank=2)
    np.testing.assert_array_equal(one["experts"]["w2"].numpy(), x["w2"][2])
