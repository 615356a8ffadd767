"""Decoder-only transformer LM, held against the JAX package's.

Counterpart of ``horovod_tpu/models/transformer.py``: ``TransformerConfig``
(``:36``), ``init_params`` (``:50``), the shared blocks ``_rmsnorm``
(``:101``), ``_mlp_block`` (``:111``), ``_qkv_proj`` (``:123``),
``_attn_out`` (``:137``), ``_logits_head`` (``:173``), the ``auto`` rule
``_flash_profitable`` (``:148``), ``param_specs`` (``:81``), ``forward``
(``:200``), ``xent`` (``:272``), ``loss_fn`` (``:280``) and
``make_train_step`` (``:289``) over data x tensor x sequence parallelism.

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

Not ported yet: ``remat``, the KV-cache decode and ``generate``, and the
pipelined forward.  ``remat`` raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch import config, resilience
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.ops.fusion import fused_pytree_mean
from horovod_tpu_torch.parallel import sequence as seq_mod
from horovod_tpu_torch.parallel import tensor as tp
from horovod_tpu_torch.topology import Mesh

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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to horovod_tpu_torch yet (ROADMAP.md "
        f"Queue 1 {item})")


def _check_route(seq_axis, attention: str, remat: str) -> None:
    """Raise for a route the reference refuses and for what the port does
    not run.  Without a sequence axis every route name runs, as in the
    reference (``:200-260``): ``ring``, ``ulysses`` and any other name
    compute local attention, ``ring_flash`` the flash kernels.  Under
    one, the single-device routes (``flash``, ``local``, any other name)
    raise: the reference never substitutes another algorithm."""
    if seq_axis is not None and attention not in SEQUENCE_ROUTES:
        raise ValueError(f"attention={attention!r} is not available with a "
                         f"sequence axis; choose 'ring', 'ring_flash' or "
                         f"'ulysses'")
    if remat != "none":
        if remat not in ("dots", "full"):
            raise ValueError(f"remat={remat!r}: expected 'none', 'dots' or "
                             f"'full'")
        raise _not_ported(f"remat={remat!r}", "item 6")


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
            logging.getLogger("horovod_tpu_torch").debug(
                "attention='auto': T=%d is not divisible by 128; using the "
                "local attention path (pad the sequence to enable the "
                "flash kernel)", t)
        return False
    return t >= min_t


def _logits_head(x, params, dt):
    x = _rmsnorm(x, params["ln_f_scale"])
    return (x @ params["embed"].t().to(dt)).float()


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
    packs sequences on every route.
    """
    _check_route(seq_axis, attention, remat)
    dt = cfg.dtype
    t = tokens.shape[1]
    off = seq_mod.axis_index(seq_axis) * t if seq_axis is not None else 0
    x = (params["embed"][tokens] + params["pos"][off:off + t][None]).to(dt)
    for layer in params["layers"]:
        q, k, v, dh = _qkv_proj(x, layer, dt, cfg.head_dim, model_axis)
        o = _attention(q, k, v, seq_axis, attention, segment_ids)
        x = _attn_out(o.reshape(q.shape[0], t, dh), x, layer, dt,
                      model_axis)
        x = _mlp_block(x, layer, dt, model_axis)
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

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        def dense(w, scale):
            w.normal_(generator=generator)
            w.mul_(scale)

        d = self.cfg.d_model
        for layer in self.layers:
            layer.ln1_scale.fill_(1.0)
            layer.ln2_scale.fill_(1.0)
            for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
                # fan_in of the whole weight, also for a row shard.
                fan_in = self.cfg.d_ff if name == "w2" else d
                dense(getattr(layer, name), fan_in ** -0.5)
        dense(self.embed, 0.02)
        dense(self.pos, 0.02)
        self.ln_f_scale.fill_(1.0)

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
    ``steps_per_call`` steps run per call on the same batch.  The
    step-guard policy is read here, once.
    """
    from horovod_tpu_torch.models.convert import lm_ordered_parameters

    _check_route(seq_axis, attention, remat)
    if shard_optimizer:
        raise _not_ported("shard_optimizer=True (ZeRO-1)", "item 8")
    if compression not in (None, "none"):
        raise _not_ported(f"compression={compression!r}", "item 8")
    model_g, seq_g, grad_g, agree_g = _step_groups(mesh, data_axis,
                                                   model_axis, seq_axis)
    params = [p for _, p in lm_ordered_parameters(model)]
    if list(map(id, params)) != list(map(id, optimizer.params)):
        raise ValueError("the optimizer must hold the model's parameters in "
                         "pytree order (convert.lm_ordered_parameters)")
    policy = resilience.guard_policy()
    cfg = model.cfg

    def one_step(tokens, labels, segment_ids=None):
        loss = loss_fn(model.tree(), tokens, labels, cfg, model_g, seq_g,
                       attention, segment_ids)
        grads = torch.autograd.grad(loss, params)

        def do_update():
            optimizer.step(fused_pytree_mean(list(grads), grad_g))

        return resilience.apply_step_guard(
            do_update, loss=loss.detach(), grads=grads, group=grad_g,
            agree_group=agree_g, policy=policy)

    def step(tokens, labels, *segment_ids):
        if len(segment_ids) != int(packed):
            raise TypeError(f"step takes tokens, labels"
                            f"{', segment_ids' if packed else ''} "
                            f"(packed={packed})")
        loss = None
        for _ in range(steps_per_call):
            loss = one_step(tokens, labels, *segment_ids)
        return loss

    return step
