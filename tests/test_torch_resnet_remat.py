"""The port's ResNet ``remat`` against ``remat=None`` and the JAX package.

``"lean"`` (the post-BN/ReLU activations inside a block recomputed in
the backward from what BatchNorm's backward keeps, each once) and
``"full"`` (the whole block recomputed from its input) apply to every
residual block.  Recomputation repeats the same operations on the same
inputs, so the logits, the gradients and the running statistics after a
step are bitwise those of ``remat=None``; a recompute updates no
statistic, so they change once a step.  One step of
``horovod_tpu_torch.benchmark.make_train_step`` agrees with the JAX
package's step on the JAX ``remat`` model within the f32 limits of
``test_torch_train_step.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.benchmark import make_train_step as jax_make_train_step
from horovod_tpu.models import resnet as jrn
from horovod_tpu.topology import build_mesh as jax_build_mesh
from horovod_tpu_torch.benchmark import make_train_step
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as trn
from torch_support import (assert_trees_close, randomize_variables,  # noqa: F401
                           world1)

BLOCKS = {"bottleneck": trn.BottleneckBlock, "basic": trn.BasicBlock}
LR = 0.1
ATOL, RTOL = 2e-5, 1e-4


def _model(block, stem, dtype, remat, seed=0):
    return trn.ResNet(stage_sizes=[1, 2], block_cls=BLOCKS[block],
                      num_classes=5, num_filters=8, stem=stem, dtype=dtype,
                      remat=remat, generator=torch.Generator().manual_seed(
                          seed), device="cpu")


def _batch(stem, n=4, seed=1):
    g = torch.Generator().manual_seed(seed)
    shape = (n, 16, 16, 3) if stem == "conv7" else (n, 8, 8, 12)
    return torch.randn(shape, generator=g), torch.randint(0, 5, (n,),
                                                          generator=g)


def _step(block, stem, dtype, remat):
    """Logits, gradients and state after one train-mode forward and
    backward; the number of block forwards (a recompute runs one more)
    and of activations ``"lean"`` recomputed."""
    m = _model(block, stem, dtype, remat)
    calls = [0]
    for k in range(m.num_blocks):
        getattr(m, f"{m.block_name}_{k}").register_forward_pre_hook(
            lambda *_: calls.__setitem__(0, calls[0] + 1))
    x, y = _batch(stem)
    trn.act_recomputes.reset()
    m.train()
    logits = m(x)
    grads = torch.autograd.grad(F.cross_entropy(logits, y),
                                list(m.parameters()))
    state = {k: v.clone() for k, v in m.state_dict().items()}
    return (logits.detach(), grads, state, calls[0], m.num_blocks,
            trn.act_recomputes.count)


# Post-BN/ReLU activations inside one block: the reference's ``act`` tags
# other than the block's output.
ACTS_PER_BLOCK = {"bottleneck": 2, "basic": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("stem", ["s2d_fused", "conv7"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("remat", ["lean", "full"])
def test_remat_is_bitwise_none(remat, block, stem, dtype):
    logits, grads, state, calls, n, acts = _step(block, stem, dtype, None)
    r_logits, r_grads, r_state, r_calls, _, r_acts = _step(
        block, stem, dtype, remat)
    assert calls == n and acts == 0
    if remat == "full":                        # each block recomputed once
        assert r_calls == 2 * n and r_acts == 0
    else:                                      # each activation once
        assert r_calls == n and r_acts == ACTS_PER_BLOCK[block] * n
    assert torch.equal(r_logits, logits)
    for a, b in zip(r_grads, grads):
        assert torch.equal(a, b)
    assert r_state.keys() == state.keys()
    for k in state:                            # statistics updated once
        assert torch.equal(r_state[k], state[k]), k


def test_unknown_remat_raises_the_references_words():
    with pytest.raises(ValueError) as want:
        jrn.ResNet18(remat="half").init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError) as got:
        trn.ResNet18(remat="half", device="cpu")
    assert str(got.value) == str(want.value)


def _jax_step(remat):
    model = jrn.ResNet(stage_sizes=[1, 2], block_cls=jrn.BottleneckBlock,
                       num_classes=5, num_filters=8, stem="s2d_fused",
                       dtype=jnp.float32, remat=remat)
    x, y = _batch("s2d_fused")
    v = randomize_variables(jax.eval_shape(functools.partial(
        model.init, train=False), jax.random.PRNGKey(0), x.numpy()))
    opt = optax.sgd(LR, momentum=0.9)
    mesh = jax_build_mesh(axes=("data",), shape=(1,),
                          devices=jax.devices()[:1])
    step = jax_make_train_step(model, opt, mesh)
    params, stats, opt_state, loss = step(
        v["params"], v["batch_stats"], opt.init(v["params"]), x.numpy(),
        y.numpy().astype(np.int32))
    return _unprefix(v), float(loss), _unprefix(jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats}))


def _unprefix(tree):
    """flax's ``nn.remat`` names a block ``CheckpointBottleneckBlock_<k>``;
    the port keeps ``BottleneckBlock_<k>`` under every ``remat``, so one
    state dict serves them all."""
    if not isinstance(tree, dict):
        return tree
    return {k.removeprefix("Checkpoint"): _unprefix(t)
            for k, t in tree.items()}


@pytest.mark.parametrize("remat", ["lean", "full"])
def test_step_matches_the_jax_remat_step(world1, remat):  # noqa: F811
    v, jloss, jtree = _jax_step(remat)
    m = trn.ResNet(stage_sizes=[1, 2], block_cls=trn.BottleneckBlock,
                   num_classes=5, num_filters=8, stem="s2d_fused",
                   dtype=torch.float32, remat=remat, device="cpu")
    m.load_state_dict(convert.flax_to_state_dict(v))
    opt = torch.optim.SGD([p for _, p in convert.flax_ordered_parameters(m)],
                          lr=LR, momentum=0.9)
    x, y = _batch("s2d_fused")
    loss = make_train_step(m, opt, world1.mesh())(x, y)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL, atol=ATOL)
    got = convert.state_dict_to_flax(m.state_dict())
    for coll in ("params", "batch_stats"):
        assert_trees_close(got[coll], jtree[coll], ATOL, RTOL, coll)
