"""Synchronized BatchNorm (``axis_name``) in the port against the JAX
package.

A 2-rank gloo job runs the port's ``make_train_step`` on a small ResNet
(``s2d_fused``, so the stem's statistics are synchronized too) whose
BatchNorms average over the world, against the JAX ``make_train_step``
on a 2-device CPU mesh with ``axis_name="data"``: loss, parameters,
momentum and statistics within the f32 limits of
``test_torch_train_step.py``, the statistics equal on both ranks.  The
same job steps with the statistics all-reduce's backward replaced by the
two wrong transposes (each rank's own cotangent; the sum without the
mean), and those must miss the JAX step: the test tells the transposes
apart.  The same job steps with ``remat`` ``"lean"`` and ``"full"``: the
step is bitwise the synchronized ``remat=None`` step, and a recompute
issues no statistics all-reduce (still one per BatchNorm).  VGG-11 (f32)
and Inception-v3 (f64, where its deep train-mode BatchNorms do not
amplify rounding; see ``test_torch_inception.py``) forwards with
synchronized statistics at 2 ranks are held to flax under
``shard_map``.  At size 1 a synchronized model is bitwise the
unsynchronized one.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.benchmark import make_train_step as jax_make_train_step
from horovod_tpu.models import inception as ji
from horovod_tpu.models import resnet as jrn
from horovod_tpu.models import vgg as jv
from horovod_tpu.topology import build_mesh as jax_build_mesh
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as trn
from torch_support import (assert_trees_close, flat,  # noqa: F401
                           randomize_variables, start_port_job, world1)

LR = 0.1
PER_RANK = 2
ATOL, RTOL = 2e-5, 1e-4
WRONG = ("local", "sum")
REMATS = ("lean", "full")


def _resnet_jax():
    model = jrn.ResNet(stage_sizes=[1, 1], block_cls=jrn.BottleneckBlock,
                       num_classes=5, num_filters=8, stem="s2d_fused",
                       dtype=jnp.float32, axis_name="data")
    v = randomize_variables(jax.eval_shape(functools.partial(
        model.init, train=False), jax.random.PRNGKey(0),
        np.zeros((1, 8, 8, 12), np.float32)))
    return model, v


def _batch(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2 * PER_RANK,) + shape).astype(np.float32)
    return x, rng.integers(0, 5, (2 * PER_RANK,)).astype(np.int32)


def _mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _vgg_jax():
    model = jv.VGG11(num_classes=5, dtype=jnp.float32, axis_name="data")
    x, _ = _batch((32, 32, 3), 3)
    v = randomize_variables(jax.eval_shape(functools.partial(
        model.init, train=False), jax.random.PRNGKey(0), x))
    return model, v, x


def _inception_jax():
    model = ji.InceptionV3(num_classes=5, dtype=jnp.float64,
                           axis_name="data")
    x, _ = _batch((75, 75, 3), 4)
    v = randomize_variables(jax.eval_shape(functools.partial(
        model.init, train=False), jax.random.PRNGKey(0), x))
    return model, v, x


def _synced_forward(model, v, x):
    def fwd(v, x):
        logits, mut = model.apply(v, x, train=True, mutable=["batch_stats"])
        return logits, mut["batch_stats"]

    fn = jax.jit(jax.shard_map(fwd, mesh=_mesh2(),
                               in_specs=(P(), P("data")),
                               out_specs=(P("data"), P()), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(v, x))


JOB = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.benchmark import make_train_step
from horovod_tpu_torch.models import convert, inception, resnet, vgg

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
inp = dict(np.load(os.path.join(out, "inputs.npz")))
rows = slice(r * {per}, (r + 1) * {per})


def weights(prefix):
    return {{k[len(prefix):]: torch.from_numpy(a) for k, a in inp.items()
             if k.startswith(prefix)}}


def flat(tree, prefix):
    res = {{}}
    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + "/" + k)
            else:
                res[path + "/" + k] = v
    walk(tree, prefix)
    return res


res = {{}}
right = resnet._StatsMean.backward
wrong = {{
    # each rank's own cotangent, no exchange
    "local": lambda ctx, g: (g, None, None),
    # the sum over ranks without the mean
    "sum": lambda ctx, g: (hvd.allreduce(g, op=hvd.Sum), None, None),
}}
remats = ("lean", "full")
for variant in ("right",) + remats + tuple(wrong):
    resnet._StatsMean.backward = staticmethod(wrong.get(variant, right))
    m = resnet.ResNet(stage_sizes=[1, 1], block_cls=resnet.BottleneckBlock,
                      num_classes=5, num_filters=8, stem="s2d_fused",
                      dtype=torch.float32, axis_name="data",
                      remat=variant if variant in remats else None,
                      device="cpu")
    m.load_state_dict(weights("resnet."))
    named = convert.flax_ordered_parameters(m)
    opt = torch.optim.SGD([p for _, p in named], lr={lr}, momentum=0.9)
    step = make_train_step(m, opt, hvd.mesh())
    before = resnet.stats_allreduce_calls.count
    loss = step(torch.from_numpy(inp["x"][rows]),
                torch.from_numpy(inp["y"][rows]).long())
    res[variant + "/calls"] = np.int64(
        resnet.stats_allreduce_calls.count - before)
    res[variant + "/loss"] = np.float32(loss)
    res.update(flat(convert.state_dict_to_flax(m.state_dict()), variant))
    for name, p in named:
        buf = opt.state[p]["momentum_buffer"]
        res.update(flat(convert.state_dict_to_flax({{name: buf}})["params"],
                        variant + "/momentum"))
resnet._StatsMean.backward = right

for name, model, key in (
        ("vgg", vgg.VGG11(num_classes=5, dtype=torch.float32,
                          axis_name="data", device="cpu"), "xv"),
        ("inception", inception.InceptionV3(
            num_classes=5, dtype=torch.float64, axis_name="data",
            device="cpu"), "xi")):
    model.load_state_dict(weights(name + "."))
    model.train()
    with torch.no_grad():
        res[name + "/logits"] = model(torch.from_numpy(inp[key][rows])).numpy()
    res.update(flat(convert.state_dict_to_flax(model.state_dict())[
        "batch_stats"], name + "/stats"))
np.savez(os.path.join(out, f"rank{{r}}.npz"), **res)
hvd.shutdown()
'''.format(per=PER_RANK, lr=LR)


def _prefixed(prefix, variables):
    return {prefix + k: t.numpy() for k, t in
            convert.flax_to_state_dict(variables).items()}


def _jax_step(model, v, x, y):
    opt = optax.sgd(LR, momentum=0.9)
    mesh = jax_build_mesh(axes=("data",), shape=(2,),
                          devices=jax.devices()[:2])
    step = jax_make_train_step(model, opt, mesh)
    params, stats, opt_state, loss = step(
        v["params"], v["batch_stats"], opt.init(v["params"]), x, y)
    return float(loss), jax.tree_util.tree_map(np.asarray, {
        "params": params, "batch_stats": stats,
        "momentum": opt_state[0].trace})


def _under(got, prefix):
    return {k[len(prefix):]: a for k, a in got.items()
            if k.startswith(prefix)}


def _as_flax_keys(tree):
    return {"/" + "/".join(k.strip("[]'").split("']['")): a
            for k, a in flat(tree).items()}


def test_two_rank_step_and_forwards_match_jax(tmp_path):
    model, v = _resnet_jax()
    x, y = _batch((8, 8, 12), 7)
    vm, vv, xv = _vgg_jax()
    with jax.enable_x64(True):
        im, iv, xi = _inception_jax()
    np.savez(tmp_path / "inputs.npz", x=x, y=y, xv=xv, xi=xi,
             **_prefixed("resnet.", v), **_prefixed("vgg.", vv),
             **_prefixed("inception.", iv))
    finish = start_port_job(JOB, str(tmp_path), np_=2,
                            env={"OMP_NUM_THREADS": "1"}, timeout=240)
    jloss, jtree = _jax_step(model, v, x, y)
    vgg_logits, vgg_stats = _synced_forward(vm, vv, xv)
    with jax.enable_x64(True):
        inc_logits, inc_stats = _synced_forward(im, iv, xi)
    ranks, _ = finish()

    want = {"/params" + k: a for k, a in _as_flax_keys(
        jtree["params"]).items()}
    want.update({"/batch_stats" + k: a for k, a in _as_flax_keys(
        jtree["batch_stats"]).items()})
    want.update({"/momentum" + k: a for k, a in _as_flax_keys(
        jtree["momentum"]).items()})
    for r, got in enumerate(ranks):
        # 9 BatchNorms, one statistics all-reduce each in the forward.
        assert int(got["right/calls"]) == 9
        np.testing.assert_allclose(got["right/loss"], jloss, rtol=RTOL,
                                   atol=ATOL)
        mine = _under(got, "right")
        mine = {k: a for k, a in mine.items()
                if not k.startswith(("/calls", "/loss"))}
        assert mine.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(mine[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank{r} {k}")
        for remat in REMATS:
            assert int(got[remat + "/calls"]) == 9, remat
            theirs = _under(got, remat)
            for k in _under(got, "right"):
                np.testing.assert_array_equal(theirs[k], got["right" + k],
                                              err_msg=f"rank{r} {remat} {k}")
        for variant in WRONG:
            theirs = _under(got, variant)
            worst = max(float(np.max(np.abs(theirs[k] - want[k])
                                     - RTOL * np.abs(want[k])))
                        for k in want if k.startswith("/params"))
            assert worst > ATOL, f"the {variant} transpose passes too"
        rows = slice(r * PER_RANK, (r + 1) * PER_RANK)
        np.testing.assert_allclose(got["vgg/logits"], vgg_logits[rows],
                                   rtol=1e-4, atol=1e-4)
        assert_trees_close(_under(got, "vgg/stats"),
                           _as_flax_keys(vgg_stats), 1e-5, 1e-5, "vgg")
        np.testing.assert_allclose(got["inception/logits"],
                                   inc_logits[rows], rtol=1e-6, atol=1e-6)
        assert_trees_close(_under(got, "inception/stats"),
                           _as_flax_keys(inc_stats), 1e-7, 1e-7,
                           "inception")
    # The synchronized statistics are one value on both ranks.
    for k in ranks[0]:
        if "stats" in k:
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                          err_msg=k)


@pytest.mark.parametrize("stem", ["s2d_fused", "conv7"])
def test_size1_is_bitwise_unsynchronized(world1, stem):  # noqa: F811
    """At size 1 the all-reduce of the statistics returns them unchanged
    and its backward the cotangent: logits, gradients and statistics
    bitwise those of per-replica BatchNorm; one all-reduce per BatchNorm
    in train mode, none in eval mode."""
    g = torch.Generator().manual_seed(5)
    shape = (4, 16, 16, 3) if stem == "conv7" else (4, 8, 8, 12)
    x, y = torch.randn(shape, generator=g), torch.randint(0, 5, (4,),
                                                          generator=g)
    out = {}
    for axis in (None, "data"):
        m = trn.ResNet(stage_sizes=[1, 1], block_cls=trn.BasicBlock,
                       num_classes=5, num_filters=8, stem=stem,
                       dtype=torch.float32, axis_name=axis,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
        before = trn.stats_allreduce_calls.count
        m.train()
        logits = m(x)
        grads = torch.autograd.grad(F.cross_entropy(logits, y),
                                    list(m.parameters()))
        calls = trn.stats_allreduce_calls.count - before
        m.eval()
        with torch.no_grad():
            m(x)
        assert trn.stats_allreduce_calls.count - before == calls
        out[axis] = (logits, grads, m.state_dict(), calls)
    (l0, g0, s0, c0), (l1, g1, s1, c1) = out[None], out["data"]
    n_bn = sum(isinstance(mod, trn.BatchNorm) for mod in m.modules())
    assert c0 == 0 and c1 == n_bn
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_axis_name_resolves_through_the_mesh(world1):  # noqa: F811
    import torch.distributed as dist
    assert trn.resolve_axis("data") is dist.group.WORLD
    assert trn.resolve_axis(None) is None
    with pytest.raises(ValueError, match="not in the mesh"):
        trn.resolve_axis("model")
