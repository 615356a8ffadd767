"""The port's ResNet v1.5 against the flax model of the JAX package.

Small models (two stages of one block, 8 filters, inputs of at most
16x16) get the same weights: the flax variables, randomised from a numpy
seed and converted with ``models/convert.py``.  Logits in train and eval
mode and the updated BatchNorm statistics are compared for every block
type and stem, at f32 and at bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import resnet as jrn
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as trn

BLOCKS = {"bottleneck": (jrn.BottleneckBlock, trn.BottleneckBlock),
          "basic": (jrn.BasicBlock, trn.BasicBlock)}


def _input(stem, seed=1, batch=2):
    rng = np.random.default_rng(seed)
    shape = (batch, 16, 16, 3) if stem == "conv7" else (batch, 8, 8, 12)
    return rng.standard_normal(shape).astype(np.float32)


def _randomize(variables, seed=0):
    """Every leaf random (numpy seed), so no branch hides behind a zero
    init: BN scales near 1, biases and means near 0, variances > 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = x.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name == "scale":
            return 1.0 + 0.2 * rng.standard_normal(shape)
        if name == "var":
            return 1.0 + 0.5 * rng.random(shape)
        return 0.1 * rng.standard_normal(shape)

    out = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(leaf(p, x), np.float32), variables)
    return jax.tree_util.tree_map(np.asarray, out)


def _pair(block, stem, dtype_j, dtype_t, seed=0):
    jb, tb = BLOCKS[block]
    jm = jrn.ResNet(stage_sizes=[1, 1], block_cls=jb, num_classes=5,
                    num_filters=8, stem=stem, dtype=dtype_j)
    x = _input(stem)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   train=False), seed)
    tm = trn.ResNet(stage_sizes=[1, 1], block_cls=tb, num_classes=5,
                    num_filters=8, stem=stem, dtype=dtype_t, device="cpu")
    tm.load_state_dict(convert.flax_to_state_dict(variables))
    return jm, variables, tm, x


def _stats_close(tm, jstats, atol, rtol=0.0):
    got = convert.state_dict_to_flax(tm.state_dict())["batch_stats"]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jstats))[0])
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_allclose(flat_got[k], flat_want[k], atol=atol,
                                   rtol=rtol, err_msg=str(k))


def test_converter_round_trips():
    jm = jrn.ResNet(stage_sizes=[1, 1], block_cls=jrn.BottleneckBlock,
                    num_classes=5, num_filters=8, stem="s2d_fused")
    variables = _randomize(jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8, 8, 12)), train=False))
    sd = convert.flax_to_state_dict(variables)
    assert sd["BottleneckBlock_0.Conv_1.kernel"].shape == (8, 8, 3, 3)
    assert sd["head.kernel"].shape == (5, 64)
    back = convert.state_dict_to_flax(sd)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_port_module_names_are_flax_paths():
    jm, variables, tm, _ = _pair("bottleneck", "s2d_fused", jnp.float32,
                                 torch.float32)
    assert set(tm.state_dict()) == set(convert.flax_to_state_dict(variables))
    names = [n for n, _ in convert.flax_ordered_parameters(tm)]
    flax_names = [".".join(k.key for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(
                      variables["params"])[0]]
    assert names == flax_names


def test_space_to_depth_matches_jax_exactly():
    x = np.random.default_rng(2).standard_normal((2, 8, 12, 3)).astype(
        np.float32)
    want = np.asarray(jrn.space_to_depth(jnp.asarray(x)))
    got = trn.space_to_depth(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_conv7_to_s2d_weights_matches_jax_exactly():
    w7 = np.random.default_rng(3).standard_normal((7, 7, 3, 8)).astype(
        np.float32)
    want = jrn.conv7_to_s2d_weights(w7)                     # HWIO
    got = trn.conv7_to_s2d_weights(
        torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()))  # OIHW
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


def test_s2d_stem_reparameterizes_conv7_stem():
    """In the port too: conv(s2d(x), w4, pad (2,1)) == conv(x, w7, s2,
    pad 3), to f32 rounding (1e-5)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(
        np.float32))
    c7 = trn.Conv(3, 8, (7, 7), (2, 2), ((3, 3), (3, 3)), torch.float32)
    c4 = trn.Conv(12, 8, (4, 4), (1, 1), ((2, 1), (2, 1)), torch.float32)
    c7.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        c4.kernel.copy_(trn.conv7_to_s2d_weights(c7.kernel))
        a = c7(x.permute(0, 3, 1, 2))
        b = c4(trn.space_to_depth(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stem", trn.STEMS)
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_f32_matches_flax(block, stem):
    """f32: train-mode logits within 1e-4, updated batch_stats within
    1e-5, eval-mode logits within 1e-4 (convolutions sum in another order
    on the two CPU backends)."""
    jm, variables, tm, x = _pair(block, stem, jnp.float32, torch.float32)
    logits, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=1e-4,
                               atol=1e-4)
    _stats_close(tm, mutated["batch_stats"], atol=1e-5, rtol=1e-5)

    tm.load_state_dict(convert.flax_to_state_dict(variables))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jm.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("stem", trn.STEMS)
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bf16_matches_flax(block, stem):
    """bf16 compute, f32 params: logits within 2e-2 (the tolerance the
    JAX package's own s2d vs s2d_fused test uses) in train and eval mode,
    running statistics within 1e-2."""
    jm, variables, tm, x = _pair(block, stem, jnp.bfloat16, torch.bfloat16)
    logits, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=2e-2,
                               atol=2e-2)
    _stats_close(tm, mutated["batch_stats"], atol=1e-2, rtol=1e-2)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    variables = dict(variables, batch_stats=jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"]))
    want = jm.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_unknown_stem_rejected():
    with pytest.raises(ValueError, match="stem"):
        trn.ResNet18(stem="conv3", device="cpu")
