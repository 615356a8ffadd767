"""Decoder-only transformer LM, held against the JAX package's.

Counterpart of ``horovod_tpu/models/transformer.py``: ``TransformerConfig``
(``:36``), ``init_params`` (``:50``), the shared blocks ``_rmsnorm``
(``:101``), ``_mlp_block`` (``:111``), ``_qkv_proj`` (``:123``),
``_attn_out`` (``:137``), ``_logits_head`` (``:173``), the ``auto`` rule
``_flash_profitable`` (``:148``), ``_remat_wrap`` (``:179``),
``param_specs`` (``:81``), ``forward`` (``:200``), ``xent`` (``:272``),
``loss_fn`` (``:280``) and ``make_train_step`` (``:289``) over data x
tensor x sequence parallelism; the KV-cache decode ``init_kv_cache``
(``:452``), ``decode_step`` (``:462``) and ``generate`` (``:503``); and
the pipelined LM ``stack_layer_params`` (``:544``),
``stack_layer_params_interleaved`` (``:561``), ``forward_pipelined``
(``:585``), ``_embed_microbatches`` (``:619``), ``_pipe_stage_fn``
(``:632``), ``split_pipeline_params`` (``:666``) and
``make_train_step_pipelined`` (``:679``) over data x pipe parallelism.

The model is functional, as the reference's: ``forward(params, tokens,
cfg)`` over a parameter tree ``{"embed", "pos", "ln_f_scale", "layers":
[{ln1_scale, ln2_scale, wq, wk, wv, wo, w1, w2}, ...]}``.
:class:`TransformerLM` holds that tree as an ``nn.Module`` whose parameter
names are the JAX paths joined with dots (``layers.3.wq``), in the JAX
``[in, out]`` layout, since the model uses raw matmuls.

Numerics follow the reference where it rounds: f32 parameters cast to the
compute dtype at each matmul; the embedding and positions summed in f32,
then cast; RMSNorm statistics in f32, its output and scale in the input
dtype; tanh-approximate GELU (``jax.nn.gelu``'s default); a residual
stream in the compute dtype; logits from a compute-dtype matmul, cast to
f32.

Inside ``forward``, ``loss_fn`` and the ``parallel/`` functions an axis
is that axis's process group (``mesh.axis("model")``); ``make_train_step``
also takes axis names and resolves them through the mesh.  Under a
``model_axis`` the weights are this rank's Megatron shards
(:func:`param_specs`; ``TransformerLM(model_shards=...)`` allocates them,
``convert.lm_params_to_shards`` fills them); under a ``seq_axis`` the
tokens are this rank's contiguous chunk of the sequence.
``make_train_step(shard_optimizer=True)`` runs the ZeRO-1 update of pure
data parallelism (:mod:`horovod_tpu_torch.parallel.zero`), with
``compression`` as its wire codec.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from horovod_tpu_torch import config, resilience
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.ops.fusion import fused_pytree_mean
from horovod_tpu_torch.parallel import pipeline as pp
from horovod_tpu_torch.parallel import sequence as seq_mod
from horovod_tpu_torch.parallel import tensor as tp
from horovod_tpu_torch.topology import Mesh
from horovod_tpu_torch.utils.logging import get_logger

LAYER_LEAVES = ("ln1_scale", "ln2_scale", "wq", "wk", "wv", "wo", "w1",
                "w2")
# Routes the reference takes under a sequence axis (``auto`` upgrades to
# ``ring_flash`` where ``_flash_profitable``).
SEQUENCE_ROUTES = ("ring", "ring_flash", "ulysses", "auto")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _check_route(seq_axis, attention: str, remat: str) -> None:
    """Raise for a route the reference refuses.  Without a sequence axis
    every route name runs, as in the reference (``:200-260``): ``ring``,
    ``ulysses`` and any other name compute local attention, ``ring_flash``
    the flash kernels.  Under one, the single-device routes (``flash``,
    ``local``, any other name) raise: the reference never substitutes
    another algorithm."""
    if seq_axis is not None and attention not in SEQUENCE_ROUTES:
        raise ValueError(f"attention={attention!r} is not available with a "
                         f"sequence axis; choose 'ring', 'ring_flash' or "
                         f"'ulysses'")
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r}: expected 'none', 'dots' or "
                         f"'full'")


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # Statistics in f32; output and scale in the input dtype (reference
    # :106-108: without the cast every matmul input was promoted to f32).
    var = x.float().square().mean(dim=-1, keepdim=True)
    return ((x.float() * torch.rsqrt(var + 1e-6)).to(x.dtype) *
            scale.to(x.dtype))


def _mlp_block(x, layer, dt, model_axis=None):
    """rmsnorm -> gelu MLP (column- then row-parallel under
    ``model_axis``) -> residual."""
    h = _rmsnorm(x, layer["ln2_scale"])
    if model_axis is not None:
        h = tp.region_input(h, model_axis)
    u = F.gelu(h @ layer["w1"].to(dt), approximate="tanh")
    dn = u @ layer["w2"].to(dt)
    if model_axis is not None:
        dn = tp.psum(dn, model_axis)
    return x + dn


def _qkv_proj(x, layer, dt, head_dim: int, model_axis=None):
    """rmsnorm -> q/k/v projections (column-parallel under
    ``model_axis``: this rank's heads) -> head split ``[B, T, H_local,
    head_dim]``; returns ``(q, k, v, H_local * head_dim)``."""
    h = _rmsnorm(x, layer["ln1_scale"])
    if model_axis is not None:
        h = tp.region_input(h, model_axis)
    q = h @ layer["wq"].to(dt)
    k = h @ layer["wk"].to(dt)
    v = h @ layer["wv"].to(dt)
    dh = q.shape[-1]
    split = q.shape[:-1] + (dh // head_dim, head_dim)
    return q.reshape(split), k.reshape(split), v.reshape(split), dh


def _attn_out(o_flat, x, layer, dt, model_axis=None):
    """Output projection (row-parallel under ``model_axis``) + residual."""
    o = o_flat @ layer["wo"].to(dt)
    if model_axis is not None:
        o = tp.psum(o, model_axis)
    return x + o


_flash_declined_shapes: set = set()


def _flash_profitable(t: int) -> bool:
    """``attention="auto"``'s flash-or-local decision from the sequence
    length, the reference's rule and knob: flash from
    ``HOROVOD_FLASH_AUTO_MIN_T`` (default 1024) up, and never for a
    length the kernel's 128-row blocks cannot tile (``auto`` never raises
    on shape).  The 1024 threshold was measured on the TPU; the H100's
    crossover is not measured yet."""
    min_t = config.env_int("HOROVOD_FLASH_AUTO_MIN_T")
    if t >= min_t and t % 128 != 0:
        if t not in _flash_declined_shapes:
            _flash_declined_shapes.add(t)
            get_logger("horovod_tpu_torch").debug(
                "attention='auto': T=%d is not divisible by 128; using the "
                "local attention path (pad the sequence to enable the "
                "flash kernel)", t)
        return False
    return t >= min_t


def _logits_head(x, params, dt, embed=None):
    """Final rmsnorm + tied-embedding projection (shared by the forward,
    the decode and the pipelined step); ``embed`` replaces
    ``params["embed"]`` (``generate`` passes it cast once)."""
    x = _rmsnorm(x, params["ln_f_scale"])
    w = params["embed"] if embed is None else embed
    return (x @ w.t().to(dt)).float()


# The matmuls whose outputs ``remat="dots"`` saves (``checkpoint_dots``
# saves every dot_general): ``x @ w`` dispatches to mm (or addmm), the
# batched einsums of attention to bmm.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)
REMAT_POLICIES = ("none", "dots", "full")


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(body, remat: str):
    """Wrap a per-layer block in activation checkpointing per ``remat``
    (reference ``:179``):

    * ``"none"``: save every intermediate.
    * ``"dots"``: save matmul outputs only and recompute the elementwise
      work in the backward (``checkpoint_dots``): a selective checkpoint
      whose policy saves the outputs of ``aten.mm``/``addmm``/``bmm``.
    * ``"full"``: save only the layer's input and recompute the whole
      block in the backward.

    Both recompute the block's forward once in the backward, a flash
    autograd Function's included: its kernel is no aten op, so under
    either policy a layer launches the forward kernel twice a step and
    the dQ and dK/dV kernels once each.  Recomputation repeats the same
    operations on the same inputs, so no value changes.
    """
    if remat == "none":
        return body
    if remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
        return functools.partial(checkpoint, body, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=context_fn)
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False,
                                 preserve_rng_state=False)
    raise ValueError(f"remat={remat!r}: expected 'none', 'dots' or 'full'")


# Megatron sharding of each layer leaf: the dim split over the model axis
# (column-parallel outputs, row-parallel inputs), or None (replicated).
_LAYER_SPLIT = {"ln1_scale": None, "ln2_scale": None, "wq": 1, "wk": 1,
                "wv": 1, "wo": 0, "w1": 1, "w2": 0}


def param_specs(cfg: TransformerConfig, model_axis: Optional[str]):
    """The sharding tree of the parameters (reference ``:81``), each leaf
    a ``PartitionSpec``-like tuple of per-dim entries: ``(None, m)`` for
    column-parallel weights, ``(m, None)`` for row-parallel ones, ``()``
    for replicated leaves."""
    def spec(dim):
        if dim is None:
            return ()
        return (None, model_axis) if dim == 1 else (model_axis, None)

    layer = {name: spec(dim) for name, dim in _LAYER_SPLIT.items()}
    return {"embed": (), "pos": (), "ln_f_scale": (),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def _attention(q, k, v, seq_axis, attention: str, segment_ids):
    """The attention route of one layer (reference ``:228-260``)."""
    t = q.shape[1]
    if seq_axis is not None:
        if attention == "ring_flash" or (attention == "auto" and
                                         _flash_profitable(t)):
            # Auto upgrades when the LOCAL chunk clears the threshold.
            return seq_mod.ring_flash_attention(
                q, k, v, seq_axis, True, segment_ids=segment_ids)
        if attention in ("ring", "auto"):
            return seq_mod.ring_attention(q, k, v, seq_axis, causal=True,
                                          segment_ids=segment_ids)
        return seq_mod.ulysses_attention(q, k, v, seq_axis, causal=True,
                                         segment_ids=segment_ids)
    if attention in ("flash", "ring_flash") or (
            attention == "auto" and _flash_profitable(t)):
        return flash_attention(q, k, v, True, segment_ids=segment_ids)
    return seq_mod.local_attention(q, k, v, causal=True,
                                   segment_ids=segment_ids)


def forward(params: Mapping, tokens: torch.Tensor, cfg: TransformerConfig,
            model_axis=None, seq_axis=None, attention: str = "local",
            segment_ids: Optional[torch.Tensor] = None,
            remat: str = "none") -> torch.Tensor:
    """tokens ``[B, T_local]`` integer -> logits ``[B, T_local, vocab]``
    f32.

    Without a ``seq_axis``, ``attention`` is ``"flash"`` or
    ``"ring_flash"`` (the flash kernels; ``T`` must tile), ``"auto"``
    (flash where :func:`_flash_profitable`), or any other name
    (``"local"``, the reference's default ``"ring"``, ``"ulysses"``,
    ``"dense"``): plain attention in the compute dtype, as the reference
    computes every route without a sequence axis.  Under a ``seq_axis``
    (the sequence group; ``tokens`` are this rank's chunk, at position
    offset ``axis_index * T_local``) it is ``"ring_flash"``, ``"ring"``,
    ``"ulysses"`` or ``"auto"`` (``ring_flash`` where the local chunk is
    :func:`_flash_profitable`, else ``ring``).  Under a ``model_axis``
    (the model group) the weights are this rank's shards
    (:func:`param_specs`).  ``segment_ids`` (``[B, T_local]`` integer)
    packs sequences on every route.  ``remat`` is the per-layer
    rematerialization policy (:func:`_remat_wrap`).
    """
    _check_route(seq_axis, attention, remat)
    dt = cfg.dtype
    t = tokens.shape[1]
    off = seq_mod.axis_index(seq_axis) * t if seq_axis is not None else 0
    x = (params["embed"][tokens] + params["pos"][off:off + t][None]).to(dt)

    def layer_block(x, layer):
        q, k, v, dh = _qkv_proj(x, layer, dt, cfg.head_dim, model_axis)
        o = _attention(q, k, v, seq_axis, attention, segment_ids)
        x = _attn_out(o.reshape(q.shape[0], t, dh), x, layer, dt,
                      model_axis)
        return _mlp_block(x, layer, dt, model_axis)

    layer_block = _remat_wrap(layer_block, remat)
    for layer in params["layers"]:
        x = layer_block(x, layer)
    return _logits_head(x, params, dt)


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -ll.mean()


def loss_fn(params, tokens, labels, cfg: TransformerConfig,
            model_axis=None, seq_axis=None, attention: str = "local",
            segment_ids=None, remat: str = "none") -> torch.Tensor:
    """Mean next-token cross-entropy over this rank's shard."""
    return xent(forward(params, tokens, cfg, model_axis, seq_axis,
                        attention, segment_ids, remat), labels)


@torch.no_grad()
def _reset_lm(module, layers, generator=None) -> None:
    """The reference's ``init_params`` scales: normal times ``fan_in **
    -0.5`` for the dense weights (the whole weight's, also for a shard),
    0.02 for ``embed`` and ``pos``, RMSNorm scales one; drawn layer by
    layer, then ``embed`` and ``pos``."""
    def dense(w, scale):
        w.normal_(generator=generator)
        w.mul_(scale)

    d = module.cfg.d_model
    for layer in layers:
        layer.ln1_scale.fill_(1.0)
        layer.ln2_scale.fill_(1.0)
        for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
            fan_in = module.cfg.d_ff if name == "w2" else d
            dense(getattr(layer, name), fan_in ** -0.5)
    dense(module.embed, 0.02)
    dense(module.pos, 0.02)
    module.ln_f_scale.fill_(1.0)


class _Layer(nn.Module):
    def __init__(self, d: int, f: int, shards: int):
        super().__init__()
        full = {"ln1_scale": (d,), "ln2_scale": (d,), "wq": (d, d),
                "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, f),
                "w2": (f, d)}
        for name, shape in full.items():
            dim = _LAYER_SPLIT[name]
            if dim is not None:
                shape = tp.shard_dim(shape, shards, dim)
            setattr(self, name, nn.Parameter(torch.empty(shape)))


class TransformerLM(nn.Module):
    """The parameter tree of :func:`forward` as a module.

    Parameters are f32, initialised as the reference's ``init_params``
    does (normal, scaled by ``fan_in ** -0.5`` for the dense weights and
    0.02 for ``embed`` and ``pos``; RMSNorm scales one) from
    ``generator``, directly on ``device`` (default ``cuda:<local_rank>``;
    pass ``"cpu"`` to stay on the CPU).  The numbers differ from the JAX
    package's: the generators differ.  Weights cross with
    :func:`horovod_tpu_torch.models.convert.lm_params_to_torch`, or
    :func:`~horovod_tpu_torch.models.convert.lm_params_to_shards` for a
    model of ``model_shards > 1``, which holds this rank's Megatron
    shards (:func:`param_specs`) of every layer's weights.
    """

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None, device=None,
                 model_shards: int = 1):
        super().__init__()
        from horovod_tpu_torch.basics import resolve_device
        dev = resolve_device(device)
        self.cfg = cfg
        d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
        if cfg.n_heads % model_shards:
            raise ValueError(f"{cfg.n_heads} heads do not split over "
                             f"{model_shards} model shards")
        with torch.device(dev):
            self.embed = nn.Parameter(torch.empty(v, d))
            self.pos = nn.Parameter(torch.empty(cfg.max_seq, d))
            self.ln_f_scale = nn.Parameter(torch.empty(d))
            self.layers = nn.ModuleList(_Layer(d, f, model_shards)
                                        for _ in range(cfg.n_layers))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        _reset_lm(self, self.layers, generator)

    def tree(self) -> Dict:
        """The parameter tree :func:`forward` takes (the live parameters,
        not copies)."""
        return {
            "embed": self.embed, "pos": self.pos,
            "ln_f_scale": self.ln_f_scale,
            "layers": [{name: getattr(layer, name) for name in LAYER_LEAVES}
                       for layer in self.layers],
        }

    def forward(self, tokens, attention: str = "local", segment_ids=None):
        return forward(self.tree(), tokens, self.cfg, attention=attention,
                       segment_ids=segment_ids)


def init_abstract(cfg: TransformerConfig) -> Dict:
    """The parameter tree of :class:`TransformerLM` on the ``meta`` device
    (reference ``:439``, ``jax.eval_shape`` of ``init_params``): every
    leaf's shape and dtype without storage, to derive specs and sizes
    without materializing the weights."""
    return TransformerLM(cfg, device="meta").tree()


def _step_groups(mesh: Mesh, data_axis, model_axis, seq_axis):
    """The groups of the step: ``(model, seq, gradient mean, agreement)``.
    Without a model or seq axis, ``data_axis`` may be a group (default:
    the mesh's); with one, every axis is a name the mesh resolves: the
    gradient mean spans data x seq and the step guard's agreement every
    axis."""
    if model_axis is None and seq_axis is None:
        if isinstance(data_axis, str):
            data_axis = mesh.axis(data_axis)
        group = data_axis if data_axis is not None else mesh.group
        return None, None, group, group
    named = (data_axis, model_axis, seq_axis)
    if not all(a is None or isinstance(a, str) for a in named):
        raise TypeError("with a model or sequence axis, pass the step's "
                        "axes by name (the mesh resolves them)")
    if data_axis is None and "data" in mesh.axes:
        data_axis = "data"
    grad_axes = tuple(a for a in (data_axis, seq_axis) if a)
    if not grad_axes:
        raise ValueError("the step averages gradients over a data or a "
                         "sequence axis; give the mesh one (of size 1 if "
                         "need be)")
    agree = tuple(a for a in (data_axis, seq_axis, model_axis) if a)
    return (mesh.axis(model_axis) if model_axis else None,
            mesh.axis(seq_axis) if seq_axis else None,
            mesh.axis(grad_axes), mesh.axis(agree))


def make_train_step(model: TransformerLM, optimizer, mesh: Mesh,
                    data_axis=None, model_axis=None, seq_axis=None,
                    attention: str = "local", packed: bool = False,
                    remat: str = "none", steps_per_call: int = 1,
                    shard_optimizer: bool = False, compression=None):
    """One LM training step over data x tensor x sequence parallelism
    (reference ``:289``).

    Returns ``step(tokens, labels[, segment_ids]) -> mean loss``: the
    loss and its gradients on this rank's shard (rows of the data axis,
    the chunk of the sequence axis, the weight shards of the model axis),
    ``fused_pytree_mean`` over data x seq (default data axis: the mesh's
    ``"data"``, or its group for a one-axis mesh) with the leaves in the
    reference's pytree order, ``optimizer.step`` (an
    :class:`horovod_tpu_torch.optim.SGD` over the same order) and the
    step guard, which agrees over every axis, all in place.  The model
    axis needs no mean: Megatron's boundaries already settle it.
    ``remat`` is the per-layer rematerialization policy
    (:func:`_remat_wrap`).  ``steps_per_call`` steps run per call on the
    same batch.  The step-guard policy is read here, once.

    ``shard_optimizer=True`` runs the ZeRO-1 sharded update over the
    data axis instead of the mean and ``optimizer.step``: a
    ``ShardedOptimizer`` around ``optimizer.transform`` (its functional
    :func:`~horovod_tpu_torch.optim.sgd`), the updates added to the
    parameters.  Pure data parallelism only.  ``step.init()`` builds the
    sharded state (the first step does if it was not called),
    ``step.sharded.state`` holds it and ``step.optimizer`` is the
    ``ShardedOptimizer``.  ``compression`` is the wire codec (a name, a
    codec, or None for ``HOROVOD_COMPRESSION``); a codec other than none
    rides the ZeRO wire and needs ``shard_optimizer=True``.
    """
    from horovod_tpu_torch.models.convert import lm_ordered_parameters
    from horovod_tpu_torch.ops import compression as compression_mod
    from horovod_tpu_torch.parallel import zero

    _check_route(seq_axis, attention, remat)
    codec = compression_mod.resolve_codec(compression)
    if shard_optimizer:
        if model_axis or seq_axis:
            raise NotImplementedError(
                "shard_optimizer=True composes with pure data parallelism "
                "only (ZeRO-1 slices replicated params); got "
                f"model_axis={model_axis!r}, seq_axis={seq_axis!r}")
    elif not isinstance(codec, compression_mod.NoneCodec):
        raise NotImplementedError(
            f"compression={codec.name!r} rides the ZeRO reduce-scatter "
            f"wire; pass shard_optimizer=True (the plain path's fused "
            f"pmean has no per-bucket wire to compress)")
    model_g, seq_g, grad_g, agree_g = _step_groups(mesh, data_axis,
                                                   model_axis, seq_axis)
    params = [p for _, p in lm_ordered_parameters(model)]
    if list(map(id, params)) != list(map(id, optimizer.params)):
        raise ValueError("the optimizer must hold the model's parameters in "
                         "pytree order (convert.lm_ordered_parameters)")
    policy = resilience.guard_policy()
    cfg = model.cfg
    sharded = (zero.ShardedUpdate(zero.sharded_optimizer(
        optimizer.transform, grad_g, compression=codec), params)
        if shard_optimizer else None)

    def update(grads):
        if sharded is None:
            optimizer.step(fused_pytree_mean(list(grads), grad_g))
        else:
            # ZeRO-1: the mean happens on the reduce-scattered shard.
            sharded.update(grads)

    def one_step(tokens, labels, segment_ids=None):
        loss = loss_fn(model.tree(), tokens, labels, cfg, model_g, seq_g,
                       attention, segment_ids, remat)
        grads = torch.autograd.grad(loss, params)
        return resilience.apply_step_guard(
            lambda: update(grads), loss=loss.detach(), grads=grads,
            group=grad_g, agree_group=agree_g, policy=policy)

    def step(tokens, labels, *segment_ids):
        if len(segment_ids) != int(packed):
            raise TypeError(f"step takes tokens, labels"
                            f"{', segment_ids' if packed else ''} "
                            f"(packed={packed})")
        loss = None
        for _ in range(steps_per_call):
            loss = one_step(tokens, labels, *segment_ids)
        return loss

    if sharded is not None:
        step.init = sharded.init
        step.optimizer = sharded.optimizer
        step.sharded = sharded
    return step


# ---------------------------------------------------------------------------
# Inference: KV-cache decode and greedy generation
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  model_axis_size: int = 1, device=None) -> List[Dict]:
    """Per-layer K/V caches of shape ``[B, max_len, H_local, head_dim]`` in
    ``cfg.dtype`` (``H_local = n_heads / model_axis_size`` under tensor
    parallelism), zeros on ``device`` (default ``cuda:<local_rank>``; pass
    ``"cpu"`` for the CPU)."""
    from horovod_tpu_torch.basics import resolve_device
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_heads // model_axis_size, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _clamped(i: int, n: int) -> int:
    """The start ``lax.dynamic_slice`` and ``dynamic_update_slice`` use for
    a one-row slice at ``i`` of ``n`` rows."""
    return min(max(i, 0), n - 1)


def _decode_step(params, token, cache, pos: int, cfg: TransformerConfig,
                 model_axis, embed):
    dt, hd = cfg.dtype, cfg.head_dim
    x = (params["embed"][token] +
         params["pos"][_clamped(pos, params["pos"].shape[0])]).to(dt)
    for layer, c in zip(params["layers"], cache):
        q, k, v, dh = _qkv_proj(x, layer, dt, hd, model_axis)
        max_len = c["k"].shape[1]
        row = _clamped(pos, max_len)
        # Defensive cast: the cache keeps its dtype whatever a projection
        # upstream returns (reference :482-485).
        c["k"][:, row] = k.to(c["k"].dtype)
        c["v"][:, row] = v.to(c["v"].dtype)
        # Scores, softmax and the value product in f32 over the full
        # static cache, masked past ``pos`` (reference :491-497).
        s = torch.einsum("bhd,bthd->bht", q.float(),
                         c["k"].float()) * (hd ** -0.5)
        visible = torch.arange(max_len, device=s.device) <= pos
        s = s.masked_fill(~visible, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bht,bthd->bhd", p, c["v"].float()).to(dt)
        x = _attn_out(o.reshape(q.shape[0], dh), x, layer, dt, model_axis)
        x = _mlp_block(x, layer, dt, model_axis)
    return _logits_head(x, params, dt, embed), cache


def decode_step(params, token, cache, pos, cfg: TransformerConfig,
                model_axis=None):
    """One-token decode (reference ``:462``).  ``token``: ``[B]`` integer;
    ``pos``: the position (an int or a 0-dim integer tensor).

    Returns ``(logits [B, vocab] f32, cache)``.  Attention runs over the
    full static cache length with a position mask, in f32, so a step
    costs O(max_len).  The new K/V row is written into ``cache`` in
    place, and the cache returned is ``cache`` itself (the reference
    returns a new one): copy it first if the old one is still needed.  A
    position past the positional table or the cache takes its last row,
    as ``lax.dynamic_slice`` clamps.  Under ``model_axis`` (the model
    group) the weights are this rank's Megatron shards and the cache
    holds this rank's heads.
    """
    return _decode_step(params, token, cache, int(pos), cfg, model_axis,
                        None)


def _cast_once(params, dt) -> Dict:
    """``params`` with every leaf that the decode only reads through a
    cast to ``dt`` cast once: the layers and ``ln_f_scale``.  ``embed``
    and ``pos`` stay f32 for the embedding sum."""
    return dict(params, ln_f_scale=params["ln_f_scale"].to(dt),
                layers=[{k: w.to(dt) for k, w in layer.items()}
                        for layer in params["layers"]])


def generate(params, prompt, total_len: int, cfg: TransformerConfig,
             model_axis=None) -> torch.Tensor:
    """Greedy decode to ``total_len`` tokens, teacher-forcing ``prompt``
    (reference ``:503``).

    ``prompt``: ``[B, P]`` integer (P >= 1).  Returns ``[B, total_len]`` in
    the prompt's dtype, whose first P entries are the prompt: its first
    token, then ``total_len - 1`` decode steps, each step's token the
    prompt's next one while ``pos + 1 < P`` and the argmax after.  The
    reference scans the steps in one compiled program, where XLA casts
    the f32 weights to ``cfg.dtype`` once; this loop casts them once per
    call too (the same values a cast per step gives), and runs without
    autograd.
    """
    b, p_len = prompt.shape
    if total_len > cfg.max_seq:
        raise ValueError(
            f"total_len={total_len} exceeds the positional table "
            f"(max_seq={cfg.max_seq})")
    if p_len > total_len:
        raise ValueError(
            f"prompt length {p_len} exceeds total_len={total_len}; the "
            f"output must contain the whole prompt")
    n_model = (seq_mod.axis_size(model_axis) if model_axis is not None
               else 1)
    cache = init_kv_cache(cfg, b, total_len, n_model, device=prompt.device)
    toks = [prompt[:, :1]]
    with torch.no_grad():
        cast = _cast_once(params, cfg.dtype)
        embed = params["embed"].to(cfg.dtype)
        token = prompt[:, 0]
        for pos in range(total_len - 1):
            logits, cache = _decode_step(cast, token, cache, pos, cfg,
                                         model_axis, embed)
            if pos + 1 < p_len:
                token = prompt[:, min(pos + 1, p_len - 1)]
            else:
                token = torch.argmax(logits, dim=-1).to(prompt.dtype)
            toks.append(token[:, None])
    return torch.cat(toks, dim=1)


# ---------------------------------------------------------------------------
# Pipeline parallelism: the layer stack over a pipe axis
# ---------------------------------------------------------------------------

PIPELINE_SCHEDULES = pp.PIPELINE_SCHEDULES


def stack_layer_params(params, n_stages: int) -> Dict:
    """The layer list re-laid for pipelining (reference ``:544``): leaves
    ``[n_stages, layers_per_stage, ...]``; pipe rank p holds row p."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers not divisible into "
                         f"{n_stages} stages")
    lps = len(layers) // n_stages
    return pp.stack_stage_params(
        [pp.stack_stage_params(layers[s * lps:(s + 1) * lps])
         for s in range(n_stages)])


def stack_layer_params_interleaved(params, n_devices: int,
                                   virtual: int) -> Dict:
    """Round-robin (Megatron-interleave) re-layout (reference ``:561``):
    leaves ``[n_devices·virtual, layers_per_chunk, ...]`` ordered so that
    pipe rank p's rows ``[p·v, (p+1)·v)`` hold global chunks ``k·P + p``
    (global row ``j = p·v + k`` holds chunk ``(j % v)·P + j // v``)."""
    layers = params["layers"]
    n_chunks = n_devices * virtual
    if len(layers) % n_chunks:
        raise ValueError(f"{len(layers)} layers not divisible into "
                         f"{n_chunks} virtual chunks")
    lpc = len(layers) // n_chunks

    def chunk(c):
        return pp.stack_stage_params(layers[c * lpc:(c + 1) * lpc])

    order = [(j % virtual) * n_devices + j // virtual
             for j in range(n_chunks)]
    return pp.stack_stage_params([chunk(c) for c in order])


def stacked_layer_specs(pipe_axis: str):
    """The spec of every stacked-layer leaf (reference ``:580``): the stage
    dim over ``pipe_axis``, in :func:`param_specs`' per-dim form."""
    return (pipe_axis,)


def split_pipeline_params(params, n_stages: int, virtual: int = 1) -> Dict:
    """The parameter tree re-laid for the pipelined step (reference
    ``:666``): ``{"base": embed/pos/ln_f_scale, "stacked": ...}``, the
    stacked leaves from :func:`stack_layer_params`, or from
    :func:`stack_layer_params_interleaved` for ``virtual > 1``
    (``n_stages`` is then the pipe axis size).
    :func:`horovod_tpu_torch.models.convert.lm_pipeline_to_rank` cuts a
    pipe rank's :class:`PipelineLM` out of it."""
    base = {k: v for k, v in params.items() if k != "layers"}
    if virtual > 1:
        return {"base": base,
                "stacked": stack_layer_params_interleaved(params, n_stages,
                                                          virtual)}
    return {"base": base, "stacked": stack_layer_params(params, n_stages)}


def _embed_microbatches(base, tokens, cfg: TransformerConfig,
                        n_microbatches: int) -> torch.Tensor:
    """The embedding prologue of every schedule: tokens ``[B, T]`` ->
    activations ``[M, B/M, T, D]`` in the compute dtype."""
    b, t = tokens.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by "
                         f"{n_microbatches} microbatches")
    x = (base["embed"][tokens] + base["pos"][None, :t]).to(cfg.dtype)
    return x.reshape(n_microbatches, b // n_microbatches, t, cfg.d_model)


def _pipe_stage_fn(cfg: TransformerConfig):
    """``stage_fn`` of the pipeline schedules: this rank's stage (leaves
    ``[1, lps, ...]``) applied layer by layer, local causal attention,
    the activation cast to the compute dtype after each layer."""
    dt, hd = cfg.dtype, cfg.head_dim

    def one_layer(x, lp):
        q, k, v, dh = _qkv_proj(x, lp, dt, hd)
        bb, tt = q.shape[:2]
        o = seq_mod.local_attention(q, k, v, causal=True)
        x = _attn_out(o.reshape(bb, tt, dh), x, lp, dt)
        x = _mlp_block(x, lp, dt)
        # Pin the carried activation to the model dtype, so the
        # microbatch buffers keep one type (reference :643-646).
        return x.to(dt)

    def stage_fn(stage_params, act):
        # A local stage dim > 1 means n_stages exceeded the pipe axis
        # size: running only slice 0 would drop layers, so refuse.
        lead = {l.shape[0] for l in stage_params.values()}
        if lead != {1}:
            raise ValueError(
                f"each device must hold exactly one stage; got local "
                f"stage dims {sorted(lead)} — n_stages passed to "
                f"stack_layer_params must equal the pipe axis size")
        # unbind, not indexing: one gradient buffer per leaf, not one
        # per layer.
        rows = {name: l[0].unbind(0) for name, l in stage_params.items()}
        for i in range(len(next(iter(rows.values())))):
            act = one_layer(act, {name: r[i] for name, r in rows.items()})
        return act

    return stage_fn


def forward_pipelined(params, stacked_layers, tokens,
                      cfg: TransformerConfig, pipe_axis=None,
                      n_microbatches: int = 2,
                      virtual: int = 1) -> torch.Tensor:
    """Forward pass with the layer stack pipelined over ``pipe_axis``
    (reference ``:585``): the pipe group (None: the default group) or a
    ``VirtualRank``.

    ``params`` supplies ``embed``/``pos``/``ln_f_scale`` (replicated over
    the pipe axis); ``stacked_layers`` is this rank's share of
    :func:`stack_layer_params` (leaves ``[1, lps, ...]``), or of
    :func:`stack_layer_params_interleaved` for ``virtual > 1`` (leaves
    ``[v, lpc, ...]``).  The batch is split into ``n_microbatches`` and
    flows through :func:`~horovod_tpu_torch.parallel.pipeline.
    pipeline_apply` (or its interleaved form); the embedding and the
    logits head run on every rank.  Attention is local causal.
    Differentiable by an outer backward with a process group, or with
    virtual ranks on the CPU: the gradient reaches every stage's weights
    and, through stage 0's input, the embedding.
    """
    b, t = tokens.shape
    mb = _embed_microbatches(params, tokens, cfg, n_microbatches)
    if virtual > 1:
        y = pp.pipeline_apply_interleaved(_pipe_stage_fn(cfg),
                                          stacked_layers, mb, pipe_axis,
                                          virtual)
    else:
        y = pp.pipeline_apply(_pipe_stage_fn(cfg), stacked_layers, mb,
                              pipe_axis)
    return _logits_head(y.reshape(b, t, cfg.d_model), params, cfg.dtype)


class PipelineLM(nn.Module):
    """Pipe rank ``pipe_index``'s share of the LM, for
    :func:`make_train_step_pipelined`.

    It holds the base parameters (``embed``, ``pos``, ``ln_f_scale``),
    replicated over the pipe axis, and its chunks: ``chunks[k]`` is an
    ``nn.ModuleList`` of the layers of global chunk ``k·P + p`` (or of
    stage p when ``virtual`` is 1), named ``chunks.<k>.<i>.<leaf>``.
    :meth:`stacked` gives them in the reference's stacked layout.
    Parameters are f32, initialised from ``generator`` as
    :class:`TransformerLM` initialises its layers, on ``device`` (default
    ``cuda:<local_rank>``).  Weights cross with
    :func:`horovod_tpu_torch.models.convert.lm_pipeline_to_rank` and
    :func:`~horovod_tpu_torch.models.convert.lm_rank_to_pipeline`.
    """

    def __init__(self, cfg: TransformerConfig, n_stages: int,
                 pipe_index: int, virtual: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        from horovod_tpu_torch.basics import resolve_device
        dev = resolve_device(device)
        n_chunks = n_stages * virtual
        if cfg.n_layers % n_chunks:
            raise ValueError(f"{cfg.n_layers} layers not divisible over "
                             f"{n_chunks} pipe chunks")
        self.cfg, self.n_stages = cfg, n_stages
        self.pipe_index, self.virtual = pipe_index, virtual
        d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
        lpc = cfg.n_layers // n_chunks
        with torch.device(dev):
            self.embed = nn.Parameter(torch.empty(v, d))
            self.pos = nn.Parameter(torch.empty(cfg.max_seq, d))
            self.ln_f_scale = nn.Parameter(torch.empty(d))
            self.chunks = nn.ModuleList(
                nn.ModuleList(_Layer(d, f, 1) for _ in range(lpc))
                for _ in range(virtual))
        _reset_lm(self, [l for chunk in self.chunks for l in chunk],
                  generator)

    def base(self) -> Dict:
        """``embed``, ``pos`` and ``ln_f_scale`` (the live parameters)."""
        return {"embed": self.embed, "pos": self.pos,
                "ln_f_scale": self.ln_f_scale}

    def stacked(self) -> Dict:
        """This rank's stacked layer leaves ``[virtual, lpc, ...]`` (a
        differentiable stack of the live parameters)."""
        return {name: torch.stack([torch.stack([getattr(l, name)
                                                for l in chunk])
                                   for chunk in self.chunks])
                for name in LAYER_LEAVES}


def make_train_step_pipelined(model: PipelineLM, optimizer, mesh=None,
                              data_axis="data", pipe_axis="pipe",
                              n_microbatches: int = 2,
                              schedule: str = "gpipe", virtual: int = 2):
    """One DP x PP training step (reference ``:679``).

    ``model`` is this rank's :class:`PipelineLM` (pipe rank = its index
    on the pipe axis), ``optimizer`` an
    :class:`horovod_tpu_torch.optim.SGD` over
    :func:`~horovod_tpu_torch.models.convert.lm_pipeline_ordered_parameters`.
    Axes are names the ``mesh`` resolves (a ``build_mesh(axes=("data",
    "pipe"), shape=...)`` mesh) or the axes themselves: a process group,
    a ``VirtualRank`` for the pipe axis, None for no data axis.

    ``schedule``: ``"gpipe"`` (:func:`~horovod_tpu_torch.parallel.
    pipeline.pipeline_apply` and its reverse schedule), ``"1f1b"``
    (:func:`~horovod_tpu_torch.parallel.pipeline.pipeline_1f1b`: O(P)
    saved microbatches), ``"interleaved"`` (``virtual`` round-robin
    chunks a rank; requires ``n_microbatches % P == 0``) or
    ``"interleaved_1f1b"`` (also ``n_microbatches >= P``), through
    :func:`~horovod_tpu_torch.parallel.pipeline.make_pipeline_loss`.
    Every rank runs the schedule's own backward explicitly and no autograd node
    exchanges, so virtual ranks on one card take the same path.  The
    embedding gets its gradient from the head and, through
    ``d_microbatches``, from stage 0's input, once each.

    Returns ``step(tokens, labels) -> loss``: this data shard's rows
    ``[B, T]``, the loss averaged over the data axis, the gradients
    averaged over it with ``fused_pytree_mean`` (stage gradients stay
    with their pipe rank) and ``optimizer.step``, in place.  The
    reference's ``shardings`` places JAX arrays on a mesh and has no
    counterpart: each rank holds its own :class:`PipelineLM`.
    """
    from horovod_tpu_torch.models.convert import (
        lm_pipeline_ordered_parameters)

    cfg = model.cfg
    pipe = mesh.axis(pipe_axis) if isinstance(pipe_axis, str) else pipe_axis
    data = mesh.axis(data_axis) if isinstance(data_axis, str) else data_axis
    n_stages = seq_mod.axis_size(pipe)
    v_eff = (virtual if schedule in ("interleaved", "interleaved_1f1b")
             else 1)
    if cfg.n_layers % (n_stages * v_eff):
        raise ValueError(f"{cfg.n_layers} layers not divisible over "
                         f"{n_stages * v_eff} pipe chunks")
    stage_fn = _pipe_stage_fn(cfg)
    dt, m = cfg.dtype, n_microbatches

    def head_loss(y, tgt, base):
        # 1F1B: one microbatch [mb, T, D]; GPipe: every microbatch
        # [M, mb, T, D] at once, one mean over the rank's batch.
        return xent(_logits_head(y.reshape(tgt.shape + (cfg.d_model,)),
                                 base, dt), tgt)

    loss_of = pp.make_pipeline_loss(stage_fn, head_loss, axis_name=pipe,
                                    schedule=schedule, virtual=v_eff)
    held = (model.n_stages, model.pipe_index, model.virtual)
    want = (n_stages, seq_mod.axis_index(pipe), v_eff)
    if held != want:
        raise ValueError(f"the model holds (stages, pipe rank, virtual) = "
                         f"{held}; this step runs {want}")
    params = [p for _, p in lm_pipeline_ordered_parameters(model)]
    if list(map(id, params)) != list(map(id, optimizer.params)):
        raise ValueError("the optimizer must hold the model's parameters in "
                         "pytree order (convert.lm_pipeline_ordered_"
                         "parameters)")
    average = data is not None and seq_mod.axis_size(data) > 1

    def step(tokens, labels):
        base = model.base()
        b, t = tokens.shape
        mb = _embed_microbatches(base, tokens, cfg, m)
        loss = loss_of(model.stacked(), base, mb,
                       labels.reshape(m, b // m, t))
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        if average:
            grads = fused_pytree_mean(list(grads), data)
            loss = resilience.mean_across(loss, data)
        optimizer.step(grads)
        return loss

    return step
