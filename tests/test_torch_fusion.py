"""The port's gradient fusion against the JAX package's.

Bucketing: the same leaf shapes, dtypes and thresholds give the same
buckets, down to the ResNet-50 gradient leaf list at the default 64 MiB.
Reduction: a 2-rank gloo job (spawned with torch.multiprocessing) runs
``fused_psum``/``fused_pytree_mean`` and is held against the reference's
``fused_psum`` under ``shard_map`` on a 2-device submesh.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import get_model as jax_get_model
from horovod_tpu.ops import fusion as jfusion
import horovod_tpu_torch as thvd
from horovod_tpu_torch.models import get_model
from horovod_tpu_torch.models.convert import flax_ordered_parameters
from horovod_tpu_torch.ops import collective as tcollective
from horovod_tpu_torch.ops import fusion as tfusion

from torch_support import caplog, jax_world, world1  # noqa: F401

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16, "int32": jnp.int32}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}


@pytest.mark.parametrize("text", ["67108864", "64mb", "32MiB", "1.5k",
                                  "8g", " 12 kb ", "64xb", "", "-5", "1e3"])
def test_parse_size_bytes_matches_jax(text):
    assert tfusion.parse_size_bytes(text) == jfusion.parse_size_bytes(text)


@pytest.mark.parametrize("value", [None, "32MiB", "1048576", "garbage"])
def test_fusion_threshold_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", value)
    assert tfusion.fusion_threshold_bytes() == jfusion.fusion_threshold_bytes()


def _leaf_specs(seed, n=24):
    rng = np.random.default_rng(seed)
    dtypes = list(_JNP)
    specs = []
    for _ in range(n):
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(d) for d in rng.integers(1, 9, ndim))
        specs.append((shape, dtypes[int(rng.integers(len(dtypes)))]))
    return specs


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("threshold", [0, 64, 1000, 1 << 20])
def test_buckets_match_jax(seed, threshold):
    specs = _leaf_specs(seed)
    jl = [jnp.zeros(shape, _JNP[dt]) for shape, dt in specs]
    tl = [torch.empty(shape, dtype=_TORCH[dt], device="meta")
          for shape, dt in specs]
    assert (tfusion._bucket_leaves(tl, threshold)
            == [list(b) for b in jfusion._bucket_leaves(jl, threshold)])


def test_resnet50_gradient_buckets_match_jax_at_default_threshold():
    """The port orders its gradient leaves as flax flattens params, so its
    buckets are the reference's (two at 64 MiB)."""
    model = jax_get_model("resnet50", num_classes=1000, stem="s2d_fused")
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 12)),
        train=False))["params"]
    jl = [np.zeros(s.shape, np.float32)
          for s in jax.tree_util.tree_leaves(shapes)]
    tm = get_model("resnet50", stem="s2d_fused", device="meta")
    tl = [p for _, p in flax_ordered_parameters(tm)]
    assert [tuple(p.shape) for p in tl] == [
        tuple(np.moveaxis(a, (-1, -2), (0, 1)).shape) if a.ndim == 4
        else a.shape[::-1] for a in jl]
    threshold = tfusion.DEFAULT_FUSION_THRESHOLD
    want = [list(b) for b in jfusion._bucket_leaves(jl, threshold)]
    assert tfusion._bucket_leaves(tl, threshold) == want
    assert len(want) == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leaves(rank):
    rng = np.random.default_rng(10 + rank)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in [(3, 5), (7,), (2, 2, 3), (1,), (9,), (4, 4)]]


def _fusion_worker(rank, size, addr, out_dir):
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    os.environ["HOROVOD_COORDINATOR_ADDR"] = addr
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        tensors = [torch.from_numpy(a) for a in _leaves(rank)]
        out = tfusion.fused_psum(tensors, mean=True, threshold=64,
                                 prescale_factor=0.5, postscale_factor=3.0)
        tree = tfusion.fused_pytree_mean(
            {f"leaf{i}": t for i, t in enumerate(tensors)})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 *[t.numpy() for t in out],
                 *[tree[f"leaf{i}"].numpy() for i in range(len(tensors))])
    finally:
        hvd.shutdown()


def test_two_rank_gloo_fused_psum_matches_jax_shard_map(tmp_path):
    """Tolerance 1e-6: the sum of two f32 values is exact in either order;
    the scale factors round alike."""
    addr = f"127.0.0.1:{_free_port()}"
    mp.start_processes(_fusion_worker, args=(2, addr, str(tmp_path)),
                       nprocs=2, start_method="spawn")
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    per_rank = [_leaves(r) for r in range(2)]
    stacked = [np.concatenate([per_rank[0][i], per_rank[1][i]])
               for i in range(len(per_rank[0]))]
    specs = tuple(P("data") for _ in stacked)

    def fn(*ts):
        return tuple(jfusion.fused_psum(
            list(ts), "data", mean=True, threshold=64,
            prescale_factor=0.5, postscale_factor=3.0)) + tuple(
            jfusion.fused_pytree_mean(list(ts), "data"))

    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=specs,
                              out_specs=specs + specs, check_vma=False))
    want = [np.asarray(w) for w in f(*stacked)]
    n = len(stacked)
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for i in range(2 * n):
            rows = per_rank[rank][i % n].shape[0]
            w = want[i][rank * rows:(rank + 1) * rows]
            np.testing.assert_allclose(got[f"arr_{i}"], w, rtol=1e-6,
                                       atol=1e-6)


def _scaling_leaves(dtype):
    rng = np.random.default_rng(7)
    return [rng.standard_normal(shape).astype(np.float32).astype(
        _JNP[dtype]) for shape in [(3, 5), (7,), (2, 2, 3), (4, 4)]]


@pytest.mark.parametrize("route", ["fused_psum", "grouped_allreduce"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_size1_bucket_arithmetic_matches_jax(jax_world, dtype, route):
    """Both users of the one bucket all-reduce against their reference
    at size 1, bitwise, with factors no 16-bit type holds exactly:
    ``fused_psum`` computes in the bucket's dtype as the reference's SPMD
    ``fused_psum`` under ``shard_map`` does; ``grouped_allreduce`` in
    numpy's promotion, as the reference's eager plane.  Each bucket is
    one all-reduce, counted once, in ``fusion.allreduce_calls``."""
    hvd = jax_world
    leaves = _scaling_leaves(dtype)
    tensors = [torch.from_numpy(np.asarray(a, np.float32)).to(_TORCH[dtype])
               for a in leaves]
    kw = dict(prescale_factor=0.1, postscale_factor=3.3)
    tfusion.allreduce_calls.reset()
    tcollective.calls.reset()
    if route == "fused_psum":
        got = tfusion.fused_psum(tensors, mean=True, threshold=64, **kw)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        specs = tuple(P("data") for _ in leaves)
        f = jax.jit(jax.shard_map(
            lambda *ts: tuple(jfusion.fused_psum(
                list(ts), "data", mean=True, threshold=64, **kw)),
            mesh=mesh, in_specs=specs, out_specs=specs, check_vma=False))
        want = f(*[jnp.asarray(a) for a in leaves])
        n_buckets = len(tfusion._bucket_leaves(tensors, 64))
    else:
        got = thvd.grouped_allreduce(tensors, **kw)
        want = hvd.grouped_allreduce([jnp.asarray(a) for a in leaves], **kw)
        n_buckets = len(tfusion._bucket_leaves(
            tensors, tfusion.fusion_threshold_bytes()))
    assert tfusion.allreduce_calls.count == n_buckets
    assert tcollective.calls.count == 0
    for g, w, t in zip(got, want, tensors):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_array_equal(
            g.float().numpy(),
            np.asarray(np.asarray(w).astype(_JNP[dtype]), np.float32))


# ---------------------------------------------------------------------------
# Fusion v2: the reduce-scatter plan, its chunking, the pair on 4 ranks.
# ---------------------------------------------------------------------------

def _plan_fields(plan):
    return (plan.buckets, plan.shapes, plan.dtypes, plan.axis_size,
            plan.lowrank, [plan.padded_size(b)
                           for b in range(len(plan.buckets))],
            plan.total_padded_bytes(), plan.total_pad_bytes())


@pytest.mark.parametrize("axis_size", [1, 3, 4])
@pytest.mark.parametrize("cap", [0, 40, 1000, None])
@pytest.mark.parametrize("threshold", [0, 64, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_reduce_scatter_plan_matches_jax(seed, threshold, cap, axis_size):
    """Buckets as spans, chunks, padding and geometry equal the
    reference's field for field (``cap=None``: the 32 MiB default)."""
    specs = _leaf_specs(seed)
    jl = [jnp.zeros(shape, _JNP[dt]) for shape, dt in specs]
    tl = [torch.empty(shape, dtype=_TORCH[dt], device="meta")
          for shape, dt in specs]
    want = jfusion.make_reduce_scatter_plan(jl, axis_size, threshold,
                                            cap=cap)
    got = tfusion.make_reduce_scatter_plan(tl, axis_size, threshold,
                                           cap=cap)
    assert _plan_fields(got) == _plan_fields(want)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_reduce_scatter_plan_with_lowrank_codec_matches_jax(rank):
    """PowerSGD claims its 2-D float leaves as whole, never chunked
    buckets at the end of the plan."""
    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc
    specs = [((16, 8), "float32"), ((37,), "float32"), ((6, 9), "float32"),
             ((4, 4), "int32"), ((40, 3), "bfloat16"), ((64, 64), "float32")]
    jl = [jnp.zeros(shape, _JNP[dt]) for shape, dt in specs]
    tl = [torch.empty(shape, dtype=_TORCH[dt], device="meta")
          for shape, dt in specs]
    spec = f"powersgd:{rank}"
    want = jfusion.make_reduce_scatter_plan(
        jl, 4, 256, codec=jc.parse_codec(spec), cap=512)
    got = tfusion.make_reduce_scatter_plan(
        tl, 4, 256, codec=tc.parse_codec(spec), cap=512)
    assert _plan_fields(got) == _plan_fields(want)
    assert got.lowrank and all(got.bucket_leaf_shape(b) is not None
                               for b in got.lowrank)


def test_lm_of_record_plan_matches_jax():
    """The benchmark of record's 1.23e9 f32 parameters at the default
    threshold (64 MiB) and cap (32 MiB): the reference's plan, 193
    buckets, each w1 and w2 (151 MB) cut into 5 chunks."""
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    kw = dict(vocab_size=32768, d_model=3072, n_heads=24, n_layers=10,
              d_ff=12288, max_seq=2048)
    abstract = jax.tree_util.tree_leaves(jtfm.init_abstract(
        jtfm.TransformerConfig(**kw)))
    model = tfm.TransformerLM(tfm.TransformerConfig(**kw), device="meta")
    tl = [p for _, p in convert.lm_ordered_parameters(model)]
    want = jfusion.make_reduce_scatter_plan(abstract, 1)
    got = tfusion.make_reduce_scatter_plan(tl, 1)
    assert _plan_fields(got) == _plan_fields(want)
    mlp = [i for i, t in enumerate(tl)
           if tuple(t.shape) in ((3072, 12288), (12288, 3072))]
    chunks = [sum(1 for bucket in got.buckets for i, _, _ in bucket if i == w)
              for w in mlp]
    assert chunks == [5] * 20
    assert len(got.buckets) == 193


@pytest.mark.parametrize("value", [None, "0", "16MiB", "1048576", "1.5k",
                                   "garbage"])
def test_max_bucket_bytes_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HOROVOD_MAX_BUCKET_BYTES", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_MAX_BUCKET_BYTES", value)
    assert tfusion.max_bucket_bytes() == jfusion.max_bucket_bytes()
    assert tfusion.DEFAULT_MAX_BUCKET_BYTES == jfusion.DEFAULT_MAX_BUCKET_BYTES


def test_bad_max_bucket_bytes_warns_once(monkeypatch, caplog):
    from horovod_tpu_torch import config
    monkeypatch.setattr(config, "_warned_bad_cap", False)
    monkeypatch.setenv("HOROVOD_MAX_BUCKET_BYTES", "lots")
    with caplog.at_level("WARNING", logger="horovod_tpu_torch.config"):
        assert tfusion.max_bucket_bytes() == 32 << 20
        assert tfusion.max_bucket_bytes() == 32 << 20
    assert sum("HOROVOD_MAX_BUCKET_BYTES='lots'" in r.message
               for r in caplog.records) == 1


RS_SHAPES = [(6, 5), (37,), (5,), (3, 3, 2), (101,)]

RS_JOB = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import fusion

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
x = dict(np.load(os.path.join(out, "inputs.npz")))
leaves = [torch.from_numpy(x[f"leaf{i}"][r]) for i in range(%(n)d)]
res = {}
for cap in (0, 64):
    plan = fusion.make_reduce_scatter_plan(leaves, 4, 128, cap=cap)
    for mean in (False, True):
        fusion.reduce_scatter_calls.reset()
        fusion.all_gather_calls.reset()
        fusion.collective_bytes.reset()
        shards, plan = fusion.fused_reduce_scatter(leaves, mean=mean,
                                                   plan=plan)
        full = fusion.fused_all_gather(shards, plan)
        key = f"{cap}/{mean}"
        for b, s in enumerate(shards):
            res[f"{key}/shard{b}"] = s.numpy()
        for i, f in enumerate(full):
            res[f"{key}/leaf{i}"] = f.numpy()
        res[f"{key}/calls"] = np.array([fusion.reduce_scatter_calls.count,
                                        fusion.all_gather_calls.count,
                                        len(plan.buckets)])
        res[f"{key}/bytes"] = np.array([
            fusion.collective_bytes.total(kind="reduce_scatter"),
            fusion.collective_bytes.total(kind="all_gather"),
            plan.total_padded_bytes()])
# The round trip: every rank's shard of the same buffers, gathered back.
same = [torch.from_numpy(x[f"leaf{i}"][0]) for i in range(%(n)d)]
plan = fusion.make_reduce_scatter_plan(same, 4, 64, cap=48)
own = [plan.shard_slice(b, f, r) for b, f in enumerate(plan.concat(same))]
for i, f in enumerate(fusion.fused_all_gather(own, plan)):
    res[f"trip/leaf{i}"] = f.numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _rs_inputs():
    rng = np.random.default_rng(21)
    # On a 2^-3 grid: four ranks' f32 sum is exact in any order (gloo and
    # XLA add the ranks in different orders).
    return {f"leaf{i}": (np.round(rng.standard_normal((4,) + s) * 8) / 8
                         ).astype(np.float32)
            for i, s in enumerate(RS_SHAPES)}


def _jax_rs(x, cap, mean):
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    proto = [jax.ShapeDtypeStruct(s, jnp.float32) for s in RS_SHAPES]
    plan = jfusion.make_reduce_scatter_plan(proto, 4, 128, cap=cap)

    def fn(*ts):
        shards, _ = jfusion.fused_reduce_scatter(list(ts), "data", mean=mean,
                                                 plan=plan)
        return tuple(shards), tuple(jfusion.fused_all_gather(shards, plan,
                                                             "data"))

    nb = len(plan.buckets)
    f = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=tuple(P("data") for _ in RS_SHAPES),
        out_specs=(tuple(P("data") for _ in range(nb)),
                   tuple(P() for _ in RS_SHAPES)), check_vma=False))
    shards, full = f(*[jnp.asarray(x[f"leaf{i}"].reshape((-1,) + s[1:]))
                       for i, s in enumerate(RS_SHAPES)])
    return plan, [np.asarray(a) for a in shards], [np.asarray(a)
                                                   for a in full]


@pytest.fixture(scope="module")
def rs_results(tmp_path_factory):
    from torch_support import start_port_job
    out = tmp_path_factory.mktemp("rs")
    x = _rs_inputs()
    np.savez(out / "inputs.npz", **x)
    finish = start_port_job(RS_JOB % dict(n=len(RS_SHAPES)), str(out),
                            np_=4, timeout=300, env={"OMP_NUM_THREADS": "1"})
    want = {(cap, mean): _jax_rs(x, cap, mean) for cap in (0, 64)
            for mean in (False, True)}
    ranks, _ = finish()
    return x, ranks, want


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("cap", [0, 64])
def test_four_rank_reduce_scatter_matches_jax(rs_results, cap, mean):
    """Each rank's shards are its slice of the reference's, bitwise; the
    all-gather gives the sum (or the mean, a multiply by 1/4 in f32)
    bitwise; one reduce-scatter and one all-gather a bucket; the logical
    bytes are the plan's padded bytes each way."""
    x, ranks, want = rs_results
    plan, shards, full = want[(cap, mean)]
    key = f"{cap}/{mean}"
    for r, got in enumerate(ranks):
        for b, s in enumerate(shards):
            k = plan.shard_size(b)
            np.testing.assert_array_equal(got[f"{key}/shard{b}"],
                                          s[r * k:(r + 1) * k])
        for i, f in enumerate(full):
            np.testing.assert_array_equal(got[f"{key}/leaf{i}"], f)
            total = x[f"leaf{i}"].sum(0)
            np.testing.assert_array_equal(
                got[f"{key}/leaf{i}"],
                total * np.float32(0.25) if mean else total)
        calls, gathers, nb = got[f"{key}/calls"]
        assert calls == gathers == nb == len(plan.buckets)
        rs, ag, padded = got[f"{key}/bytes"]
        assert rs == ag == padded == plan.total_padded_bytes()


def test_four_rank_all_gather_round_trips_bitwise(rs_results):
    x, ranks, _ = rs_results
    for got in ranks:
        for i in range(len(RS_SHAPES)):
            np.testing.assert_array_equal(got[f"trip/leaf{i}"],
                                          x[f"leaf{i}"][0])
