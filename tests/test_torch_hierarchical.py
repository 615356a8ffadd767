"""The port's two-level collectives against flat ones and the JAX package's.

A 4-rank gloo job on a 2 x 2 ``("dcn", "ici")`` mesh (its shape derived
from ``HOROVOD_TOPOLOGY=a:2,b:2``) runs ``hierarchical_allreduce``,
``hierarchical_pytree_mean``, ``hierarchical_allgather``,
``fused_hierarchical_reduce_scatter`` with ``fused_all_gather`` over the
ici axis, ``cross_level_psum`` over the dcn axis under each stateless
codec, and the two-level ``ShardedOptimizer``; the JAX side runs the
reference's functions in ``shard_map(check_vma=False)`` on 4 CPU devices
meanwhile (``check_vma=True`` fails for two of the reference's own tests:
ROADMAP Queue 3).  Inputs lie on a 2^-3 grid, so that every sum over the
ranks is exact in any order: the two-level results are held bitwise to
the flat collectives and to the reference, int8 within f32 ``rtol`` 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import compression as jc
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import hierarchical as jh
from horovod_tpu.parallel import zero as jzero
from horovod_tpu_torch import basics
from horovod_tpu_torch.topology import build_mesh

from torch_support import start_port_job, world1  # noqa: F401

N = 4
CODECS = ["none", "bf16", "fp16", "int8"]


def _grid(shape, rng):
    return (np.round(rng.standard_normal(shape) * 8) / 8).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(17)
    return {"x": _grid((N, 6, 5), rng), "odd": _grid((N, 7), rng),
            "ints": rng.integers(-9, 9, (N, 6)).astype(np.int32),
            "l0": _grid((N, 4, 3), rng), "l1": _grid((N, 5), rng),
            "rows": _grid((N, 2, 3), rng), "w": _grid((6, 2), rng),
            "gw": _grid((N, 6, 2), rng)}


JOB = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch import optim
from horovod_tpu_torch.ops import compression as C, fusion
from horovod_tpu_torch.parallel import hierarchical as H, zero
from horovod_tpu_torch.topology import build_mesh

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
x = {k: torch.from_numpy(v[r]) if v.shape[0] == 4 else torch.from_numpy(v)
     for k, v in np.load(os.path.join(out, "inputs.npz")).items()}
mesh = build_mesh(axes=("dcn", "ici"))
ici, dcn = mesh.axis("ici"), mesh.axis("dcn")
res = {"shape": np.array(mesh.shape), "coords": np.array(mesh.coords)}


def flat_sum(t):
    t = t.clone()
    dist.all_reduce(t)
    return t


res["sum"] = H.hierarchical_allreduce(x["x"], ici, dcn).numpy()
res["mean"] = H.hierarchical_allreduce(x["x"], ici, dcn, average=True).numpy()
res["odd"] = H.hierarchical_allreduce(x["odd"], ici, dcn, average=True).numpy()
res["ints"] = H.hierarchical_allreduce(x["ints"], ici, dcn,
                                       average=True).numpy()
res["flat_sum"] = flat_sum(x["x"]).numpy()
res["flat_odd_mean"] = (flat_sum(x["odd"]) * 0.25).numpy()
tree = H.hierarchical_pytree_mean({"l0": x["l0"], "l1": x["l1"]}, ici, dcn)
flat_tree = fusion.fused_pytree_mean({"l0": x["l0"], "l1": x["l1"]})
for k in ("l0", "l1"):
    res[f"tree/{k}"] = tree[k].numpy()
    res[f"flat_tree/{k}"] = flat_tree[k].numpy()
res["gather"] = H.hierarchical_allgather(x["rows"], ici, dcn).numpy()
full = torch.empty((8, 3))
dist.all_gather(list(full.chunk(4)), x["rows"])
res["flat_gather"] = full.numpy()

leaves = [x["l0"], x["l1"], x["x"]]
shards, plan = fusion.fused_hierarchical_reduce_scatter(leaves, ici, dcn,
                                                        threshold=64)
for i, t in enumerate(fusion.fused_all_gather(shards, plan, ici)):
    res[f"hrs/{i}"] = t.numpy()
for i, t in enumerate(fusion.fused_pytree_mean(leaves)):
    res[f"flat_mean/{i}"] = t.numpy()
res["hrs/calls"] = np.array([len(plan.buckets), plan.axis_size])

for spec in %(codecs)r:
    res[f"cross/{spec}"] = C.cross_level_psum(x["odd"], dcn, spec).numpy()

# Two-level ZeRO (ici-sharded, summed over dcn) against flat ZeRO over
# every rank: the same mean gradient, the same SGD step.
params = {"w": x["w"].clone()}
grads = {"w": x["gw"]}
for name, kw in (("hier", dict(cross_axis_name=dcn)),
                 ("hier_int8", dict(cross_axis_name=dcn,
                                    cross_compression="int8")),
                 ("flat", {})):
    axis = ici if name.startswith("hier") else None
    zopt = zero.sharded_optimizer(optim.sgd(0.1), axis, **kw)
    st = zopt.init(params)
    upd, st = zopt.update(grads, st, params)
    res[f"zero/{name}"] = (params["w"] + upd["w"]).numpy()
    res[f"zero/{name}/shard"] = np.array(st.plan.axis_size)
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _jax_side(x):
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, 2), ("dcn", "ici"))
    both = P(("dcn", "ici"))

    def run(fn, *arrays, out=both):
        f = jax.jit(jax.shard_map(fn, mesh=mesh,
                                  in_specs=tuple(both for _ in arrays),
                                  out_specs=out, check_vma=False))
        return f(*[jnp.asarray(a.reshape((-1,) + a.shape[2:]))
                   for a in arrays])

    want = {
        "sum": run(lambda v: jh.hierarchical_allreduce(v, "ici", "dcn"),
                   x["x"]),
        "mean": run(lambda v: jh.hierarchical_allreduce(
            v, "ici", "dcn", average=True), x["x"]),
        "odd": run(lambda v: jh.hierarchical_allreduce(
            v, "ici", "dcn", average=True), x["odd"]),
        "ints": run(lambda v: jh.hierarchical_allreduce(
            v, "ici", "dcn", average=True), x["ints"]),
        "gather": run(lambda v: jh.hierarchical_allgather(v, "ici", "dcn"),
                      x["rows"], out=P()),
    }
    tree = run(lambda a, b: jh.hierarchical_pytree_mean(
        {"l0": a, "l1": b}, "ici", "dcn"), x["l0"], x["l1"])
    want["tree/l0"], want["tree/l1"] = tree["l0"], tree["l1"]

    def hrs(a, b, c):
        shards, plan = jfusion.fused_hierarchical_reduce_scatter(
            [a, b, c], "ici", "dcn", mean=True, threshold=64)
        return tuple(jfusion.fused_all_gather(shards, plan, "ici"))
    for i, t in enumerate(run(hrs, x["l0"], x["l1"], x["x"],
                              out=(both, both, both))):
        want[f"hrs/{i}"] = t
    for spec in CODECS:
        want[f"cross/{spec}"] = run(
            lambda v, s=spec: jc.cross_level_psum(v, "dcn", s), x["odd"])

    def zero_step(w, g, cross):
        opt = jzero.sharded_optimizer(optax.sgd(0.1), "ici", axis_size=2,
                                      cross_axis_name="dcn",
                                      cross_compression=cross)
        p = {"w": w}
        st = opt.init(p)
        upd, _ = opt.update({"w": g}, st, p)
        return optax.apply_updates(p, upd)["w"]
    f = jax.jit(jax.shard_map(
        lambda w, g: zero_step(w, g, "none"), mesh=mesh,
        in_specs=(P(), both), out_specs=P(), check_vma=False))
    want["zero/hier"] = f(jnp.asarray(x["w"]),
                          jnp.asarray(x["gw"].reshape(-1, 2)))
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("hier")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    finish = start_port_job(
        JOB % dict(codecs=CODECS), str(out), np_=N, timeout=300,
        env={"OMP_NUM_THREADS": "1", "HOROVOD_TOPOLOGY": "a:2,b:2"})
    want = _jax_side(x)
    ranks, _ = finish()
    return x, ranks, want


def _row(want, r, like):
    """Device r's block of a result gathered along dim 0."""
    return want.reshape((N,) + like.shape)[r]


def test_mesh_shape_comes_from_the_topology(results):
    _, ranks, _ = results
    for r, got in enumerate(ranks):
        assert tuple(got["shape"]) == (2, 2)
        assert tuple(got["coords"]) == (r // 2, r % 2)


@pytest.mark.parametrize("key", ["sum", "mean", "odd", "ints"])
def test_allreduce_matches_flat_and_jax(results, key):
    """The sum, the mean (one 1/(ici*dcn) multiply on the shard), a size
    not divisible by ici (padding), an int payload (divided after the
    gather, as a float)."""
    x, ranks, want = results
    for r, got in enumerate(ranks):
        g = got[key]
        np.testing.assert_array_equal(g, _row(want[key], r, g))
        if key == "sum":
            np.testing.assert_array_equal(g, got["flat_sum"])
        if key == "mean":
            np.testing.assert_array_equal(g, got["flat_sum"] * 0.25)
        if key == "odd":
            np.testing.assert_array_equal(g, got["flat_odd_mean"])
        if key == "ints":
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, x["ints"].sum(0) / 4)


def test_pytree_mean_matches_fused_pytree_mean_and_jax(results):
    _, ranks, want = results
    for r, got in enumerate(ranks):
        for k in ("l0", "l1"):
            g = got[f"tree/{k}"]
            np.testing.assert_array_equal(g, got[f"flat_tree/{k}"])
            np.testing.assert_array_equal(g, _row(want[f"tree/{k}"], r, g))


def test_allgather_matches_flat_and_jax(results):
    """Rows in (dcn, ici, local row) order: a flat all-gather's order on a
    mesh whose ici axis is minor."""
    _, ranks, want = results
    for got in ranks:
        np.testing.assert_array_equal(got["gather"], got["flat_gather"])
        np.testing.assert_array_equal(got["gather"], want["gather"])


def test_fused_hierarchical_reduce_scatter_matches_flat_mean(results):
    """Reduce-scatter over ici, the shard summed over dcn, gathered over
    ici only: the flat mean over all four ranks, and the reference's."""
    _, ranks, want = results
    for r, got in enumerate(ranks):
        n_buckets, axis = got["hrs/calls"]
        assert axis == 2 and n_buckets > 1
        for i in range(3):
            g = got[f"hrs/{i}"]
            np.testing.assert_array_equal(g, got[f"flat_mean/{i}"])
            np.testing.assert_array_equal(g, _row(want[f"hrs/{i}"], r, g))


@pytest.mark.parametrize("spec", CODECS)
def test_cross_level_psum_over_dcn_matches_jax(results, spec):
    _, ranks, want = results
    for r, got in enumerate(ranks):
        g = got[f"cross/{spec}"]
        w = _row(want[f"cross/{spec}"], r, g)
        if spec == "int8":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def test_two_level_zero_matches_flat_zero_and_jax(results):
    """The two-level ShardedOptimizer (state 1/ici per host, the shard's
    sum over dcn) takes flat ZeRO's step over all four ranks, and the
    reference's; under an int8 cross codec within its quantization step
    (the shared scale's step, absmax/127, times lr)."""
    x, ranks, want = results
    for got in ranks:
        assert int(got["zero/hier/shard"]) == 2
        assert int(got["zero/flat/shard"]) == 4
        np.testing.assert_array_equal(got["zero/hier"], got["zero/flat"])
        np.testing.assert_array_equal(got["zero/hier"], want["zero/hier"])
        step = np.abs(x["gw"]).max() / 127 * 0.1
        np.testing.assert_allclose(got["zero/hier_int8"], got["zero/flat"],
                                   rtol=0, atol=step)


def test_build_mesh_single_host_degenerates(world1, monkeypatch):
    monkeypatch.delenv("HOROVOD_TOPOLOGY", raising=False)
    mesh = build_mesh(axes=("dcn", "ici"))
    assert mesh.shape == (1, 1) and mesh.axes == ("dcn", "ici")


def test_build_mesh_indivisible_raises(world1, monkeypatch):
    """Ranks that do not divide over the hosts: the reference's error."""
    topo = basics.topology()
    monkeypatch.setattr(basics, "topology", lambda: topo._replace(
        hosts=(("a", 1), ("b", 1))))
    with pytest.raises(ValueError, match="divide evenly over 2 hosts"):
        build_mesh(axes=("dcn", "ici"))


def test_build_mesh_other_axes_still_require_shape(world1):
    with pytest.raises(ValueError, match="shape required"):
        build_mesh(axes=("data", "model"))
