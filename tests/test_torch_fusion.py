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
from horovod_tpu_torch.models import get_model
from horovod_tpu_torch.models.convert import flax_ordered_parameters
from horovod_tpu_torch.ops import fusion as tfusion

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
