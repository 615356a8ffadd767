"""The port's VGG-BN against the flax model of the JAX package.

VGG-11 at 32x32, batch 2, with the global-average-pool head and with the
classic 4096-4096 head (its first dense layer reads the last stage
flattened in NHWC order), gets the flax variables, randomised from a
numpy seed and carried across by ``models/convert.py``.  Train-mode
logits, the updated BatchNorm statistics and eval-mode logits are
compared at f32, bf16 and f64 (JAX's 64-bit mode, where train mode
agrees to output rounding).  One jitted JAX program per head and dtype is
shared by the module.  The registry is held to the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import registry as jreg
from horovod_tpu.models import vgg as jv
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import registry as treg
from horovod_tpu_torch.models import vgg as tv
from torch_support import (assert_rounds_like_reference,
                           assert_trees_close, randomize_variables)

SIZE, BATCH, CLASSES = 32, 2, 5
HEADS = {"gap": False, "classic": True}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module")
def flax_run():
    """``(variables, x, (train logits, updated batch_stats, eval logits))``
    of the flax model for a head and dtype, each computed once (f64 with
    JAX's 64-bit mode on for the call)."""
    cache = {}

    def get(head, dtype):
        if (head, dtype) not in cache:
            with jax.enable_x64(dtype == "f64"):
                model = jv.VGG11(num_classes=CLASSES,
                                 dtype=DTYPES[dtype][0],
                                 classic_head=HEADS[head])
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

                cache[head, dtype] = (v, x, jax.tree_util.tree_map(
                    np.asarray, run(v, x)))
        return cache[head, dtype]

    return get


def _port(head, dtype, variables):
    m = tv.VGG11(num_classes=CLASSES, dtype=DTYPES[dtype][1],
                 classic_head=HEADS[head], image_size=SIZE, device="cpu")
    m.load_state_dict(convert.flax_to_state_dict(variables))
    return m


def _port_run(head, dtype, variables, x):
    """The port's (train logits, updated batch_stats, eval logits)."""
    m = _port(head, dtype, variables)
    m.train()
    with torch.no_grad():
        logits = m(torch.from_numpy(x))
    stats = convert.state_dict_to_flax(
        {k: t.clone() for k, t in m.state_dict().items()})["batch_stats"]
    m.load_state_dict(convert.flax_to_state_dict(variables))
    m.eval()
    with torch.no_grad():
        eval_logits = m(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, CLASSES)
    return logits.numpy(), stats, eval_logits.numpy()


@pytest.mark.parametrize("head", sorted(HEADS))
def test_f32_matches_flax(flax_run, head):
    """Train-mode logits within 1e-4, updated statistics within 1e-5,
    eval-mode logits within 1e-4 (convolutions sum in another order on the
    two CPU backends)."""
    v, x, (logits, stats, eval_logits) = flax_run(head, "f32")
    got, got_stats, got_eval = _port_run(head, "f32", v, x)
    np.testing.assert_allclose(got, logits, rtol=1e-4, atol=1e-4)
    assert_trees_close(got_stats, stats, 1e-5, 1e-5, "batch_stats")
    np.testing.assert_allclose(got_eval, eval_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_f64_train_mode_is_the_same_function(flax_run, head):
    """At f64 the rounding noise that train-mode BatchNorm amplifies is
    gone: the port's logits equal flax's to f32 output rounding and the
    updated statistics to f32 buffer rounding."""
    v, x, (logits, stats, eval_logits) = flax_run(head, "f64")
    got, got_stats, got_eval = _port_run(head, "f64", v, x)
    np.testing.assert_allclose(got, logits, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_eval, eval_logits, rtol=1e-6, atol=1e-6)
    assert_trees_close(got_stats, stats, 1e-7, 1e-7, "batch_stats")


@pytest.mark.parametrize("head", sorted(HEADS))
def test_bf16_matches_flax(flax_run, head):
    """bf16 compute, f32 params: eval-mode logits within 2e-2 (the JAX
    package's own s2d vs s2d_fused tolerance); running statistics within
    2e-2.  Train-mode logits: eight BatchNorms over a few samples each
    amplify every bf16 rounding, so the reference's own bf16 logits are
    about 0.03 from its f64 ones here; the port's are held to at most
    twice the reference's error (and pass 2e-2 where it does)."""
    v, x, (logits, stats, eval_logits) = flax_run(head, "bf16")
    truth = flax_run(head, "f64")[2][0]
    got, got_stats, got_eval = _port_run(head, "bf16", v, x)
    np.testing.assert_allclose(got_eval, eval_logits, rtol=2e-2, atol=2e-2)
    assert_trees_close(got_stats, stats, 2e-2, 2e-2, "batch_stats")
    assert_rounds_like_reference(got, logits, truth, 2e-2, "train logits")


@pytest.mark.parametrize("head", sorted(HEADS))
def test_names_are_flax_paths(flax_run, head):
    v, _, _ = flax_run(head, "f32")
    m = _port(head, "f32", v)
    assert set(m.state_dict()) == set(convert.flax_to_state_dict(v))
    names = [n for n, _ in convert.flax_ordered_parameters(m)]
    flax_names = [".".join(k.key for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(v["params"])[0]]
    assert names == flax_names
    if HEADS[head]:
        assert tuple(m.Dense_0.kernel.shape) == (4096, 512)


def test_classic_head_flattens_nhwc():
    """At 64x64 the last stage is 2x2x512: an NCHW flatten would feed
    Dense_0's rows in another order, so the flax logits catch it."""
    model = jv.VGG11(num_classes=CLASSES, dtype=jnp.float32,
                     classic_head=True)
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    v = randomize_variables(jax.eval_shape(functools.partial(
        model.init, train=False), jax.random.PRNGKey(0), x))
    want = np.asarray(jax.jit(functools.partial(model.apply, train=False))(
        v, x))
    m = tv.VGG11(num_classes=CLASSES, dtype=torch.float32, classic_head=True,
                 image_size=64, device="cpu")
    m.load_state_dict(convert.flax_to_state_dict(v))
    m.eval()
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _shape(ctor):
    """A registry entry's class name and its architecture keywords."""
    kw = getattr(ctor, "keywords", {})
    arch = {k: (getattr(v, "__name__", None) or
                tuple(tuple(s) if isinstance(s, (list, tuple)) else s
                      for s in v))
            for k, v in kw.items() if k in ("stage_sizes", "block_cls")}
    return getattr(ctor, "func", ctor).__name__, arch


def test_registry_matches_the_references():
    assert treg.list_models() == jreg.list_models()
    for name in jreg.list_models():
        assert _shape(treg._REGISTRY[name]) == _shape(jreg._REGISTRY[name]), \
            name
    with pytest.raises(ValueError, match="unknown model 'vgg17'"):
        treg.get_model("vgg17")
    m = treg.get_model("VGG11", num_classes=3, device="cpu")
    assert isinstance(m, tv.VGG) and m.head.kernel.shape == (3, 512)
