"""The port's Inception-v3 against the flax model of the JAX package.

Inception-v3 at 75x75 (the least image its stem's reductions leave a
pixel of), batch 2, gets the flax variables, randomised from a numpy
seed and carried across by ``models/convert.py``; so does each block, A
to E, alone.  Every block at f32 in train mode (logits and updated
statistics) and the whole model in eval mode at f32 and bf16 are held to
the stated limits.  In train mode the whole model's 94 BatchNorms, the
last ones over two samples a channel, amplify every rounding: the
reference's own f32 logits there are about 0.06 from its f64 ones, its
bf16 logits about 1.3.  So the whole model's train mode is held to flax
at f64 (JAX's 64-bit mode), where the two agree to output rounding, and
at f32 and bf16 to at most twice the reference's own error.  One jitted
JAX program per model and dtype is shared by the module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import inception as ji
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import inception as ti
from horovod_tpu_torch.models import registry as treg
from torch_support import (assert_rounds_like_reference,
                           assert_trees_close, randomize_variables)

SIZE, BATCH, CLASSES = 75, 2, 5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f64": (jnp.float64, torch.float64)}


def _snapshot(m):
    return convert.state_dict_to_flax(
        {k: t.clone() for k, t in m.state_dict().items()})


@pytest.fixture(scope="module")
def flax_run():
    """``(variables, x, (train logits, updated batch_stats, eval logits))``
    of the flax model at a dtype, each computed once."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            with jax.enable_x64(dtype == "f64"):
                model = ji.InceptionV3(num_classes=CLASSES,
                                       dtype=DTYPES[dtype][0])
                x = np.random.default_rng(1).standard_normal(
                    (BATCH, SIZE, SIZE, 3)).astype(np.float32)
                v = randomize_variables(jax.eval_shape(functools.partial(
                    model.init, train=False), jax.random.PRNGKey(0), x))

                @jax.jit
                def run(v, x):
                    logits, mut = model.apply(v, x, train=True,
                                              mutable=["batch_stats"])
                    return logits, mut["batch_stats"], model.apply(
                        v, x, train=False)

                cache[dtype] = (v, x, jax.tree_util.tree_map(
                    np.asarray, run(v, x)))
        return cache[dtype]

    return get


@pytest.fixture(scope="module")
def port_run(flax_run):
    """The port's (train logits, updated batch_stats, eval logits) on the
    same variables and input, and the model's parameter names."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            v, x, _ = flax_run(dtype)
            m = ti.InceptionV3(num_classes=CLASSES, dtype=DTYPES[dtype][1],
                               device="cpu")
            m.load_state_dict(convert.flax_to_state_dict(v))
            m.train()
            with torch.no_grad():
                logits = m(torch.from_numpy(x))
            stats = _snapshot(m)["batch_stats"]
            m.load_state_dict(convert.flax_to_state_dict(v))
            m.eval()
            with torch.no_grad():
                eval_logits = m(torch.from_numpy(x))
            assert logits.dtype == torch.float32
            assert logits.shape == (BATCH, CLASSES)
            cache[dtype] = (logits.numpy(), stats, eval_logits.numpy(),
                            set(m.state_dict()),
                            [n for n, _ in convert.flax_ordered_parameters(m)])
        return cache[dtype]

    return get


def test_f64_train_mode_is_the_same_function(flax_run, port_run):
    """Train and eval logits equal to f32 output rounding, every updated
    statistic to f32 buffer rounding."""
    _, _, (logits, stats, eval_logits) = flax_run("f64")
    got, got_stats, got_eval, _, _ = port_run("f64")
    np.testing.assert_allclose(got, logits, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_eval, eval_logits, rtol=1e-6, atol=1e-6)
    assert_trees_close(got_stats, stats, 1e-7, 1e-7, "batch_stats")


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
def test_matches_flax(flax_run, port_run, dtype, tol):
    """Eval-mode logits within ``tol`` (f32: convolutions sum in another
    order on the two CPU backends; bf16: the JAX package's own s2d vs
    s2d_fused tolerance); train-mode logits no further from the f64 ones
    than twice the reference's own error, or ``tol``."""
    _, _, (logits, _, eval_logits) = flax_run(dtype)
    truth = flax_run("f64")[2][0]
    got, _, got_eval, _, _ = port_run(dtype)
    np.testing.assert_allclose(got_eval, eval_logits, rtol=tol, atol=tol)
    assert_rounds_like_reference(got, logits, truth, tol, "train logits")


def test_f32_statistics_of_the_well_conditioned_layers(flax_run, port_run):
    """The stem's and the first InceptionA's statistics (over 2 x 35 x 35
    and 2 x 7 x 7 samples a channel) within 1e-5 at f32."""
    _, _, (_, stats, _) = flax_run("f32")
    _, got_stats, _, _, _ = port_run("f32")
    keys = [f"ConvBN_{i}" for i in range(5)] + ["InceptionA_0"]
    assert_trees_close({k: got_stats[k] for k in keys},
                       {k: stats[k] for k in keys}, 1e-5, 1e-5,
                       "batch_stats")


def test_names_are_flax_paths(flax_run, port_run):
    v, _, _ = flax_run("f32")
    _, _, _, keys, names = port_run("f32")
    assert keys == set(convert.flax_to_state_dict(v))
    flax_names = [".".join(k.key for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(v["params"])[0]]
    assert names == flax_names
    # JAX flattens dict keys as strings: ConvBN_10 sorts before ConvBN_2.
    c = [n for n in names if n.startswith("InceptionC_0.ConvBN_")]
    assert c.index("InceptionC_0.ConvBN_1.BatchNorm_0.bias") < c.index(
        "InceptionC_0.ConvBN_2.BatchNorm_0.bias")
    assert "InceptionA_0.ConvBN_3.Conv_0.kernel" in names


JCONV = functools.partial(ji.ConvBN, dtype=jnp.float32, train=True)
TCONV = functools.partial(ti.ConvBN, dtype=torch.float32)
BLOCKS = {
    "A": (lambda: ji.InceptionA(pool_features=32, conv=JCONV),
          lambda: ti.InceptionA(192, 32, TCONV), (2, 7, 7, 192)),
    "B": (lambda: ji.InceptionB(conv=JCONV),
          lambda: ti.InceptionB(288, TCONV), (2, 7, 7, 288)),
    "C": (lambda: ji.InceptionC(channels_7x7=128, conv=JCONV),
          lambda: ti.InceptionC(768, 128, TCONV), (2, 5, 5, 768)),
    "D": (lambda: ji.InceptionD(conv=JCONV),
          lambda: ti.InceptionD(768, TCONV), (2, 5, 5, 768)),
    "E": (lambda: ji.InceptionE(conv=JCONV),
          lambda: ti.InceptionE(1280, TCONV), (2, 3, 3, 1280)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_f32_train_matches_flax(block):
    """Each block alone, train mode at f32, on NHWC input of its place in
    the network: outputs within 1e-4 and updated statistics within 1e-5
    (the grid reductions B and D: VALID 3x3/s2 convolutions and the max
    pool; C and E: the asymmetric 1x7/7x1 and 1x3/3x1 kernels)."""
    make_j, make_t, shape = BLOCKS[block]
    jm = make_j()
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    v = randomize_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           x))
    y, mut = jax.jit(functools.partial(jm.apply, mutable=["batch_stats"]))(
        v, x)
    tm = make_t()
    tm.load_state_dict(convert.flax_to_state_dict(v))
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-4, atol=1e-4)
    assert_trees_close(_snapshot(tm)["batch_stats"], mut["batch_stats"],
                       1e-5, 1e-5, "batch_stats")


def test_registry_and_the_smallest_image():
    m = treg.get_model("inceptionv3", num_classes=3, device="cpu",
                       dtype=torch.float32)
    assert isinstance(m, ti.InceptionV3)
    m.eval()
    with torch.no_grad():
        assert m(torch.zeros(1, SIZE, SIZE, 3)).shape == (1, 3)
