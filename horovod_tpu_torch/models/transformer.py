"""Decoder-only transformer LM, held against the JAX package's.

Counterpart of ``horovod_tpu/models/transformer.py``: ``TransformerConfig``
(``:36``), ``init_params`` (``:50``), the shared blocks ``_rmsnorm``
(``:101``), ``_mlp_block`` (``:111``), ``_qkv_proj`` (``:123``),
``_attn_out`` (``:137``), ``_logits_head`` (``:173``), the ``auto`` rule
``_flash_profitable`` (``:148``), ``forward`` (``:200``), ``xent``
(``:272``), ``loss_fn`` (``:280``) and ``make_train_step`` (``:289``) for
pure data parallelism.

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

Not ported yet: tensor parallelism (``model_axis``), sequence parallelism
(a ``seq_axis``; without one the ``ring``, ``ring_flash`` and ``ulysses``
routes run as in the reference), ``remat``, the KV-cache decode and
``generate``, and the pipelined forward.  Each raises
``NotImplementedError`` naming its ROADMAP item.
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
from horovod_tpu_torch.parallel.sequence import local_attention
from horovod_tpu_torch.topology import Mesh, data_axis as mesh_data_axis

LAYER_LEAVES = ("ln1_scale", "ln2_scale", "wq", "wk", "wv", "wo", "w1",
                "w2")
# Routes the reference takes under a sequence axis (``auto`` upgrades to
# ``ring_flash``), plus ``local``, the port's default, which stands for the
# reference's default ``ring``.  The port has no sequence axis yet.
SEQUENCE_ROUTES = ("local", "ring", "ring_flash", "ulysses", "auto")


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


def _check_route(model_axis, seq_axis, attention: str, remat: str) -> None:
    """Raise for what the port does not run.  Without a sequence axis
    every route name runs, as in the reference (``:200-260``): ``ring``,
    ``ulysses`` and any other name compute local attention, ``ring_flash``
    the flash kernels."""
    if model_axis is not None:
        raise _not_ported("tensor parallelism (model_axis)", "item 6")
    if seq_axis is not None:
        if attention not in SEQUENCE_ROUTES:
            raise ValueError(f"attention={attention!r} is not available "
                             f"with a sequence axis; choose 'ring', "
                             f"'ring_flash' or 'ulysses'")
        raise _not_ported(f"sequence parallelism (seq_axis={seq_axis!r}, "
                          f"attention={attention!r})", "item 7")
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


def _mlp_block(x, layer, dt):
    h = _rmsnorm(x, layer["ln2_scale"])
    u = F.gelu(h @ layer["w1"].to(dt), approximate="tanh")
    return x + u @ layer["w2"].to(dt)


def _qkv_proj(x, layer, dt, head_dim: int):
    """rmsnorm -> q/k/v projections -> head split ``[B, T, H, head_dim]``;
    returns ``(q, k, v, d_model)``."""
    h = _rmsnorm(x, layer["ln1_scale"])
    q = h @ layer["wq"].to(dt)
    k = h @ layer["wk"].to(dt)
    v = h @ layer["wv"].to(dt)
    dh = q.shape[-1]
    split = q.shape[:-1] + (dh // head_dim, head_dim)
    return q.reshape(split), k.reshape(split), v.reshape(split), dh


def _attn_out(o_flat, x, layer, dt):
    return x + o_flat @ layer["wo"].to(dt)


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


def forward(params: Mapping, tokens: torch.Tensor, cfg: TransformerConfig,
            model_axis=None, seq_axis=None, attention: str = "local",
            segment_ids: Optional[torch.Tensor] = None,
            remat: str = "none") -> torch.Tensor:
    """tokens ``[B, T]`` integer -> logits ``[B, T, vocab]`` f32.

    ``attention``: ``"flash"`` or ``"ring_flash"`` (the flash kernels;
    ``T`` must tile), ``"auto"`` (flash where :func:`_flash_profitable`),
    or any other name (``"local"``, the reference's default ``"ring"``,
    ``"ulysses"``, ``"dense"``): plain attention in the compute dtype, as
    the reference computes every route without a sequence axis.
    ``segment_ids`` ([B, T] integer) packs sequences on every route.
    """
    _check_route(model_axis, seq_axis, attention, remat)
    dt = cfg.dtype
    t = tokens.shape[1]
    x = (params["embed"][tokens] + params["pos"][:t][None]).to(dt)
    use_flash = attention in ("flash", "ring_flash") or (
        attention == "auto" and _flash_profitable(t))
    for layer in params["layers"]:
        q, k, v, dh = _qkv_proj(x, layer, dt, cfg.head_dim)
        b = q.shape[0]
        if use_flash:
            o = flash_attention(q, k, v, True, segment_ids=segment_ids)
        else:
            o = local_attention(q, k, v, causal=True,
                                segment_ids=segment_ids)
        x = _attn_out(o.reshape(b, t, dh), x, layer, dt)
        x = _mlp_block(x, layer, dt)
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
    def __init__(self, d: int, f: int):
        super().__init__()
        self.ln1_scale = nn.Parameter(torch.empty(d))
        self.ln2_scale = nn.Parameter(torch.empty(d))
        self.wq = nn.Parameter(torch.empty(d, d))
        self.wk = nn.Parameter(torch.empty(d, d))
        self.wv = nn.Parameter(torch.empty(d, d))
        self.wo = nn.Parameter(torch.empty(d, d))
        self.w1 = nn.Parameter(torch.empty(d, f))
        self.w2 = nn.Parameter(torch.empty(f, d))


class TransformerLM(nn.Module):
    """The parameter tree of :func:`forward` as a module.

    Parameters are f32, initialised as the reference's ``init_params``
    does (normal, scaled by ``fan_in ** -0.5`` for the dense weights and
    0.02 for ``embed`` and ``pos``; RMSNorm scales one) from
    ``generator``, directly on ``device`` (default ``cuda:<local_rank>``;
    pass ``"cpu"`` to stay on the CPU).  The numbers differ from the JAX
    package's: the generators differ.  Weights cross with
    :func:`horovod_tpu_torch.models.convert.lm_params_to_torch`.
    """

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        from horovod_tpu_torch.basics import resolve_device
        dev = resolve_device(device)
        self.cfg = cfg
        d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
        with torch.device(dev):
            self.embed = nn.Parameter(torch.empty(v, d))
            self.pos = nn.Parameter(torch.empty(cfg.max_seq, d))
            self.ln_f_scale = nn.Parameter(torch.empty(d))
            self.layers = nn.ModuleList(_Layer(d, f)
                                        for _ in range(cfg.n_layers))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        def dense(w, scale=None):
            w.normal_(generator=generator)
            w.mul_(scale if scale is not None else w.shape[0] ** -0.5)

        for layer in self.layers:
            layer.ln1_scale.fill_(1.0)
            layer.ln2_scale.fill_(1.0)
            for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
                dense(getattr(layer, name))
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


def make_train_step(model: TransformerLM, optimizer, mesh: Mesh,
                    data_axis=None, model_axis=None, seq_axis=None,
                    attention: str = "local", packed: bool = False,
                    remat: str = "none", steps_per_call: int = 1,
                    shard_optimizer: bool = False, compression=None):
    """One data-parallel LM training step (reference ``:289``, pure DP).

    Returns ``step(tokens, labels[, segment_ids]) -> mean loss``: the
    loss and its gradients on this rank's shard, ``fused_pytree_mean``
    over ``data_axis`` (default: the mesh's group) with the leaves in the
    reference's pytree order, ``optimizer.step`` (an
    :class:`horovod_tpu_torch.optim.SGD` over the same order) and the
    step guard, all in place.  ``steps_per_call`` steps run per call on
    the same batch.  The step-guard policy is read here, once.
    """
    from horovod_tpu_torch.models.convert import lm_ordered_parameters

    _check_route(model_axis, seq_axis, attention, remat)
    if shard_optimizer:
        raise _not_ported("shard_optimizer=True (ZeRO-1)", "item 8")
    if compression not in (None, "none"):
        raise _not_ported(f"compression={compression!r}", "item 8")
    group = data_axis if data_axis is not None else mesh_data_axis(mesh)
    params = [p for _, p in lm_ordered_parameters(model)]
    if list(map(id, params)) != list(map(id, optimizer.params)):
        raise ValueError("the optimizer must hold the model's parameters in "
                         "pytree order (convert.lm_ordered_parameters)")
    policy = resilience.guard_policy()
    cfg = model.cfg

    def one_step(tokens, labels, segment_ids=None):
        loss = loss_fn(model.tree(), tokens, labels, cfg,
                       attention=attention, segment_ids=segment_ids)
        grads = torch.autograd.grad(loss, params)

        def do_update():
            optimizer.step(fused_pytree_mean(list(grads), group))

        return resilience.apply_step_guard(
            do_update, loss=loss.detach(), grads=grads, group=group,
            policy=policy)

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

