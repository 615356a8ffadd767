"""The port's data-parallel training step against the JAX package's.

The same converted weights, batch and optimizer settings go through
``horovod_tpu.benchmark.make_train_step`` (on a 1- or 2-device mesh) and
``horovod_tpu_torch.benchmark.make_train_step`` (one process, or a 2-rank
gloo job spawned with torch.multiprocessing).  Loss, parameters, momentum
and rank 0's BatchNorm statistics must agree to f32 tolerance, and a
guarded NaN step must keep the state and report a NaN loss in both.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu.benchmark import make_train_step as jax_make_train_step
from horovod_tpu.models import resnet as jrn
from horovod_tpu.topology import build_mesh as jax_build_mesh
import horovod_tpu_torch as thvd
from horovod_tpu_torch.benchmark import make_train_step
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as trn

LR = 0.1
PER_RANK = 2
# f32 tolerance: convolutions and reductions sum in another order on the
# two CPU backends; one or two SGD steps keep the drift near 1e-6.
ATOL, RTOL = 2e-5, 1e-4


def _variables(seed=0):
    model = jrn.ResNet(stage_sizes=[1, 1], block_cls=jrn.BottleneckBlock,
                       num_classes=5, num_filters=8, stem="s2d_fused",
                       dtype=jnp.float32)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 12)),
                   train=False)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(
                x.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.2 * rng.standard_normal(x.shape)
        if name == "var":
            return 1.0 + 0.5 * rng.random(x.shape)
        return 0.1 * rng.standard_normal(x.shape)

    v = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(leaf(p, x), np.float32), v)
    return model, jax.tree_util.tree_map(np.asarray, v)


def _batch(n_ranks, nan=False):
    rng = np.random.default_rng(7)
    images = rng.standard_normal((PER_RANK * n_ranks, 8, 8, 12)).astype(
        np.float32)
    if nan:
        images[0, 3, 3, 5] = np.nan
    labels = rng.integers(0, 5, (PER_RANK * n_ranks,)).astype(np.int32)
    return images, labels


def _jax_steps(n_devices, steps, nan=False):
    model, v = _variables()
    mesh = jax_build_mesh(axes=("data",), shape=(n_devices,),
                          devices=jax.devices()[:n_devices])
    opt = optax.sgd(LR, momentum=0.9)
    params, stats = v["params"], v["batch_stats"]
    opt_state = opt.init(params)
    step = jax_make_train_step(model, opt, mesh)
    images, labels = _batch(n_devices, nan)
    for _ in range(steps):
        params, stats, opt_state, loss = step(params, stats, opt_state,
                                              images, labels)
    tree = jax.tree_util.tree_map(np.asarray, {
        "params": params, "batch_stats": stats,
        "momentum": opt_state[0].trace})
    return float(loss), tree


def _port_model(variables):
    tm = trn.ResNet(stage_sizes=[1, 1], block_cls=trn.BottleneckBlock,
                    num_classes=5, num_filters=8, stem="s2d_fused",
                    dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.flax_to_state_dict(variables))
    params = [p for _, p in convert.flax_ordered_parameters(tm)]
    return tm, torch.optim.SGD(params, lr=LR, momentum=0.9)


def _port_result(tm, opt):
    out = convert.state_dict_to_flax(tm.state_dict())
    mom = {}
    for name, p in convert.flax_ordered_parameters(tm):
        buf = opt.state.get(p, {}).get("momentum_buffer")
        mom[name] = None if buf is None else convert.state_dict_to_flax(
            {name: buf})["params"]
    return out, mom


def _port_steps(rank, n_ranks, steps, nan=False):
    """The port's steps on this rank's shard; returns (loss, flax-layout
    params and stats, momentum by name)."""
    _, v = _variables()
    tm, opt = _port_model(v)
    images, labels = _batch(n_ranks, nan)
    rows = slice(rank * PER_RANK, (rank + 1) * PER_RANK)
    step = make_train_step(tm, opt, thvd.mesh())
    for _ in range(steps):
        loss = step(torch.from_numpy(images[rows]),
                    torch.from_numpy(labels[rows]).long())
    return float(loss), *_port_result(tm, opt)


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _compare(loss, tree, mom, jloss, jtree):
    np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
    for coll in ("params", "batch_stats"):
        got, want = _flat(tree[coll]), _flat(jtree[coll])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=coll + k)
    want = _flat(jtree["momentum"])
    got = {}
    for m in mom.values():
        got.update(_flat(m))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg="momentum" + k)


@pytest.fixture()
def port_world():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.mark.parametrize("policy", ["off", "skip"])
def test_size1_steps_match_jax(port_world, monkeypatch, policy):
    """Two steps (the second applies momentum) on one rank and one device.
    A finite batch steps alike under every guard policy."""
    monkeypatch.setenv("HOROVOD_STEP_GUARD", policy)
    jloss, jtree = _jax_steps(1, steps=2)
    loss, tree, mom = _port_steps(0, 1, steps=2)
    _compare(loss, tree, mom, jloss, jtree)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_worker(rank, size, addr, out_dir):
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    os.environ["HOROVOD_COORDINATOR_ADDR"] = addr
    thvd.init(device="cpu")
    try:
        loss, tree, mom = _port_steps(rank, size, steps=1)
        flat = {"loss": np.float32(loss)}
        flat.update({"p" + k: v for k, v in _flat(tree["params"]).items()})
        flat.update({"s" + k: v for k, v in
                     _flat(tree["batch_stats"]).items()})
        for m in mom.values():
            flat.update({"m" + k: v for k, v in _flat(m).items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **flat)
    finally:
        thvd.shutdown()


def test_two_rank_gloo_step_matches_two_device_jax_mesh(tmp_path):
    """One step over 2 gloo ranks vs the 2-device JAX mesh on the same
    global batch: mean loss, params and momentum on every rank, and rank
    0's per-replica BatchNorm statistics."""
    addr = f"127.0.0.1:{_free_port()}"
    mp.start_processes(_train_worker, args=(2, addr, str(tmp_path)),
                       nprocs=2, start_method="spawn")
    jloss, jtree = _jax_steps(2, steps=1)
    for rank in range(2):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        np.testing.assert_allclose(got.pop("loss"), jloss, rtol=RTOL,
                                   atol=ATOL)
        want = {"p" + k: v for k, v in _flat(jtree["params"]).items()}
        want.update({"m" + k: v for k, v in
                     _flat(jtree["momentum"]).items()})
        if rank == 0:
            want.update({"s" + k: v for k, v in
                         _flat(jtree["batch_stats"]).items()})
        else:
            got = {k: v for k, v in got.items() if not k.startswith("s")}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank{rank} {k}")


def test_step_guard_skip_keeps_state_on_nan_batch(port_world, monkeypatch):
    """HOROVOD_STEP_GUARD=skip and a NaN in the batch: both packages keep
    params, statistics and momentum, and return a NaN loss."""
    monkeypatch.setenv("HOROVOD_STEP_GUARD", "skip")
    _, v = _variables()
    jloss, jtree = _jax_steps(1, steps=1, nan=True)
    assert np.isnan(jloss)
    loss, tree, mom = _port_steps(0, 1, steps=1, nan=True)
    assert np.isnan(loss)
    for coll in ("params", "batch_stats"):
        for k, want in _flat(v[coll]).items():
            np.testing.assert_array_equal(_flat(tree[coll])[k], want)
            np.testing.assert_array_equal(_flat(jtree[coll])[k], want)
    assert all(m is None for m in mom.values())
    assert all(not np.any(m) for m in jax.tree_util.tree_leaves(
        jtree["momentum"]))


def test_step_guard_rejects_unknown_policy(port_world, monkeypatch):
    monkeypatch.setenv("HOROVOD_STEP_GUARD", "sometimes")
    tm, opt = _port_model(_variables()[1])
    with pytest.raises(ValueError, match="HOROVOD_STEP_GUARD"):
        make_train_step(tm, opt, thvd.mesh())
