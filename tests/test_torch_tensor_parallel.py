"""The port's Megatron tensor parallelism against the JAX package's, on
the CPU.

The same seeded inputs (numpy ``default_rng``) go through the port's
``parallel/tensor.py`` on 2 gloo ranks (one job for the module) and
through the JAX package's, under ``shard_map`` on 2 of the conftest's
CPU devices and as the dense single-device oracle of
``tests/test_parallel.py:94`` and ``:448``: the column -> row parallel
MLP (tanh GELU, f32, x ``[4, 16]``, hidden 64) in values and in the
gradients of ``sum(y * w)``; the same with biases; and the
sharding-aware global-norm clip.  The gradient of the MLP's input is
also computed with the "f" all-reduce left out and with it done twice,
which the dense oracle must tell apart.  Tolerance: the reference's
2e-5, 1e-6 for the clip (optax's own arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import tensor as jtp
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel import tensor as tp
from torch_support import start_port_job, world1  # noqa: F401

TOL = 2e-5
N_DEV = 2


def _inputs():
    rng = np.random.default_rng(3)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((4, 16)).astype(f32),
        w1=(rng.standard_normal((16, 64)) * 0.1).astype(f32),
        w2=(rng.standard_normal((64, 16)) * 0.1).astype(f32),
        b1=(rng.standard_normal(64) * 0.1).astype(f32),
        b2=(rng.standard_normal(16) * 0.1).astype(f32),
        wy=rng.standard_normal((4, 16)).astype(f32),
        col=rng.standard_normal((8, 16)).astype(f32),
        row=rng.standard_normal((16, 8)).astype(f32),
        rep=rng.standard_normal(8).astype(f32))


def _lm_params():
    rng = np.random.default_rng(4)
    d, f = 32, 64

    def dense(shape):
        return (rng.standard_normal(shape) * shape[0] ** -0.5).astype(
            np.float32)

    return {
        "embed": dense((64, d)), "pos": dense((32, d)),
        "ln_f_scale": np.ones(d, np.float32),
        "layers": [{"ln1_scale": np.ones(d, np.float32),
                    "ln2_scale": np.ones(d, np.float32),
                    "wq": dense((d, d)), "wk": dense((d, d)),
                    "wv": dense((d, d)), "wo": dense((d, d)),
                    "w1": dense((d, f)), "w2": dense((f, d))}
                   for _ in range(2)]}


JOB = r'''
import os, pickle, sys
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel import tensor as tp
from horovod_tpu_torch.topology import build_mesh

out = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
x = {k: torch.from_numpy(v) for k, v in
     np.load(os.path.join(out, "inputs.npz")).items()}
mesh = build_mesh(axes=("model",), shape=(n,))
g = mesh.axis("model")
cols, rows = slice(r * 64 // n, (r + 1) * 64 // n), slice(r * 64 // n,
                                                         (r + 1) * 64 // n)
res = {}


def mlp(xin, w1, w2, b1=None, b2=None, f=tp.region_input):
    h = f(xin, g) @ w1 if b1 is None else tp.column_parallel(xin, w1, g, b1)
    u = F.gelu(h, approximate="tanh")
    return tp.row_parallel(u, w2, g, b2)


leaves = [x["x"].clone().requires_grad_(), x["w1"][:, cols].clone()
          .requires_grad_(), x["w2"][rows].clone().requires_grad_()]
y = mlp(*leaves)
res["y"] = y.detach().numpy()
for name, gr in zip(("dx", "dw1", "dw2"),
                    torch.autograd.grad((y * x["wy"]).sum(), leaves)):
    res[name] = gr.numpy()
for tag, f in (("missing", lambda t, _: t),
               ("doubled", lambda t, a: tp.region_input(
                   tp.region_input(t, a), a))):
    xin = x["x"].clone().requires_grad_()
    yy = mlp(xin, leaves[1], leaves[2], f=f)
    res["dx_" + tag] = torch.autograd.grad((yy * x["wy"]).sum(), xin)[0] \
        .numpy()
bias = leaves + [x["b1"][cols].clone().requires_grad_(),
                 x["b2"].clone().requires_grad_()]
yb = mlp(*bias)
res["yb"] = yb.detach().numpy()
for name, gr in zip(("bx", "bw1", "bw2", "bb1", "bb2"),
                    torch.autograd.grad((yb * x["wy"]).sum(), bias)):
    res[name] = gr.numpy()
specs = [(None, "model"), ("model", None), ()]
grads = [x["col"][:, r * 16 // n:(r + 1) * 16 // n],
         x["row"][r * 16 // n:(r + 1) * 16 // n], x["rep"]]
for tag, max_norm in (("clip", 0.5), ("noclip", 1e6)):
    for name, c in zip(("col", "row", "rep"),
                       tp.clip_by_global_norm(grads, max_norm, specs, mesh)):
        res[f"{tag}_{name}"] = c.numpy()
with open(os.path.join(out, "lm.pkl"), "rb") as fh:
    params = pickle.load(fh)
cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_seq=32,
                            dtype=torch.float32)
model = tfm.TransformerLM(cfg, device="cpu", model_shards=n)
model.load_state_dict(convert.lm_params_to_shards(params, mesh))
res["wq_shape"] = np.array(model.layers[0].wq.shape)
back = convert.lm_shards_to_params(model.state_dict(), mesh)
res["round_trip"] = np.array(all(
    np.array_equal(back[k], params[k]) for k in ("embed", "pos")) and all(
    np.array_equal(a[leaf], b[leaf]) for a, b in zip(back["layers"],
                                                     params["layers"])
    for leaf in b))
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _gelu_mlp(x, w1, w2, b1=0.0, b2=0.0):
    return jax.nn.gelu(x @ w1 + b1) @ w2 + b2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import pickle
    out = tmp_path_factory.mktemp("tp")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    with open(out / "lm.pkl", "wb") as fh:
        pickle.dump(_lm_params(), fh)
    finish = start_port_job(JOB, str(out), np_=N_DEV, timeout=300)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = {}
    want["y"], vjp = jax.vjp(_gelu_mlp, j["x"], j["w1"], j["w2"])
    want["dx"], want["dw1"], want["dw2"] = vjp(j["wy"])
    want["yb"], vjp = jax.vjp(_gelu_mlp, j["x"], j["w1"], j["w2"], j["b1"],
                              j["b2"])
    for name, gr in zip(("bx", "bw1", "bw2", "bb1", "bb2"), vjp(j["wy"])):
        want[name] = gr
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("model",))
    tp_fn = jax.jit(jax.shard_map(
        lambda x, a, b: jtp.row_parallel(jax.nn.gelu(
            jtp.column_parallel(x, a, "model")), b, "model"),
        mesh=mesh, in_specs=(P(), P(None, "model"), P("model", None)),
        out_specs=P()))
    want["y_shard_map"] = tp_fn(j["x"], j["w1"], j["w2"])
    tree = {"col": j["col"], "row": j["row"], "rep": j["rep"]}
    specs = {"col": P(None, "model"), "row": P("model", None), "rep": P()}
    for tag, max_norm in (("clip", 0.5), ("noclip", 1e6)):
        oracle, _ = optax.clip_by_global_norm(max_norm).update(
            tree, optax.EmptyState())
        clip = jtp.clip_by_global_norm(max_norm, specs)
        sharded = jax.jit(jax.shard_map(
            lambda g: clip.update(g, clip.init(None))[0], mesh=mesh,
            in_specs=(specs,), out_specs=specs))(tree)
        for name in tree:
            want[f"{tag}_{name}"] = oracle[name]
            want[f"{tag}_{name}_shard_map"] = sharded[name]
    ranks, _ = finish()
    return {k: np.asarray(v) for k, v in want.items()}, ranks


def _cat(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis)


def test_tp_mlp_output_matches_jax(results):
    want, ranks = results
    for r in ranks:
        np.testing.assert_allclose(r["y"], want["y"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["y"], want["y_shard_map"], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("leaf,axis", [("dx", None), ("dw1", 1),
                                       ("dw2", 0)])
def test_tp_mlp_gradients_match_dense(results, leaf, axis):
    """dx is whole on every rank (the "f" all-reduce summed the
    branches); dw1/dw2 are this rank's column/row shards."""
    want, ranks = results
    got = [r[leaf] for r in ranks] if axis is None else [
        _cat(ranks, leaf, axis)]
    for g in got:
        np.testing.assert_allclose(g, want[leaf], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", ["missing", "doubled"])
def test_dense_oracle_catches_a_missing_or_doubled_f(results, variant):
    """Without the "f" all-reduce each rank's dx is its branch's partial
    (they sum to the dense dx); with two it is twice the dense dx.  So
    the dense check of ``test_tp_mlp_gradients_match_dense`` fails on
    both."""
    want, ranks = results
    got = [r["dx_" + variant] for r in ranks]
    for g in got:
        assert not np.allclose(g, want["dx"], rtol=TOL, atol=TOL)
    if variant == "missing":
        np.testing.assert_allclose(sum(got), want["dx"], rtol=TOL, atol=TOL)
    else:
        for g in got:
            np.testing.assert_allclose(g, 2 * want["dx"], rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("leaf,axis", [("yb", None), ("bx", None),
                                       ("bw1", 1), ("bw2", 0), ("bb1", 0),
                                       ("bb2", None)])
def test_parallel_matmuls_with_bias_match_dense(results, leaf, axis):
    want, ranks = results
    got = [r[leaf] for r in ranks] if axis is None else [
        _cat(ranks, leaf, axis)]
    for g in got:
        np.testing.assert_allclose(g, want[leaf], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tag", ["clip", "noclip"])
def test_clip_by_global_norm_matches_oracle(results, tag):
    """Column, row and replicated leaves, against optax's clip of the
    whole gradients and the JAX package's sharded clip."""
    want, ranks = results
    for name, axis in (("col", 1), ("row", 0), ("rep", None)):
        got = ([r[f"{tag}_{name}"] for r in ranks] if axis is None
               else [_cat(ranks, f"{tag}_{name}", axis)])
        for g in got:
            np.testing.assert_allclose(g, want[f"{tag}_{name}"], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(
                g, want[f"{tag}_{name}_shard_map"], rtol=1e-6, atol=1e-6,
                err_msg=name)


def test_lm_shards_round_trip(results):
    """``lm_params_to_shards`` gives each rank its Megatron shards, a
    ``TransformerLM(model_shards=2)`` holds them, and
    ``lm_shards_to_params`` gathers the full tree back."""
    _, ranks = results
    for r in ranks:
        assert tuple(r["wq_shape"]) == (32, 16)
        assert bool(r["round_trip"])


@pytest.mark.parametrize("shape,size,dim", [
    ((16, 64), 2, 1), ((64, 16), 4, 0), ((8, 6, 4), 2, 1), ((10,), 5, 0)])
def test_shard_dim_matches_jax(shape, size, dim):
    assert tp.shard_dim(shape, size, dim) == jtp.shard_dim(shape, size, dim)


def test_shard_dim_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="not divisible"):
        tp.shard_dim((10, 6), 4, 1)


@pytest.mark.parametrize("axis", ["model", None])
def test_param_specs_match_jax(axis):
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=3, d_ff=64,
              max_seq=32)
    got = tfm.param_specs(tfm.TransformerConfig(**kw), axis)
    want = jtfm.param_specs(jtfm.TransformerConfig(**kw), axis)
    assert jax.tree_util.tree_structure(got, is_leaf=lambda x:
                                        isinstance(x, tuple)) == \
        jax.tree_util.tree_structure(want, is_leaf=lambda x:
                                     isinstance(x, P))
    flat_got = jax.tree_util.tree_leaves(got, is_leaf=lambda x:
                                         isinstance(x, tuple))
    flat_want = jax.tree_util.tree_leaves(want, is_leaf=lambda x:
                                          isinstance(x, P))
    assert [tuple(s) for s in flat_want] == flat_got


def test_boundaries_are_identity_at_size_one(world1):
    """On an axis of one rank "f" and "g" are the identity (no
    collective, no Function)."""
    from horovod_tpu_torch.topology import build_mesh
    g = build_mesh(axes=("model",), shape=(1,)).axis("model")
    x = torch.randn(3, 4, requires_grad=True)
    assert tp.region_input(x, g) is x and tp.psum(x, g) is x
    model = tfm.TransformerLM(tfm.TransformerConfig(
        vocab_size=8, d_model=8, n_heads=2, n_layers=1, d_ff=16,
        max_seq=4), device="cpu", model_shards=2)
    assert tuple(model.layers[0].w2.shape) == (8, 8)
    assert convert._lm_split_dims(1, "model") == {
        "layers.0.wq": 1, "layers.0.wk": 1, "layers.0.wv": 1,
        "layers.0.wo": 0, "layers.0.w1": 1, "layers.0.w2": 0}
