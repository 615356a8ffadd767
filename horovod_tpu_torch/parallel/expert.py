"""Expert parallelism: a Mixture-of-Experts layer over an expert axis.

Counterpart of ``horovod_tpu/parallel/expert.py``: ``_slotify`` (``:22``),
``top1_routing`` (``:33``), ``top2_routing`` (``:51``), ``moe_layer``
(``:87``), ``load_balancing_loss`` (``:132``) and ``moe_layer_ragged``
(``:143``).  One expert a rank; tokens travel to their expert's rank and
back over the axis: a process group (None is the default group) or a
:class:`~horovod_tpu_torch.parallel.sequence.VirtualRank`.  Capacity is
static and a token past it is dropped (it contributes zero), as in the
reference.

The router's softmax is the one XLA's CPU code computes (Cephes' expf
with its fused multiply-adds, the row summed left to right), so the
routing (dispatch, combine, what capacity drops) equals the reference's
bit for bit on any device; its backward is softmax's usual
``y * (g - sum(y * g))``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from horovod_tpu_torch.parallel import sequence as seq


def _f32(c: float) -> float:
    """The constant as the f32 that XLA's code holds."""
    return torch.tensor(c, dtype=torch.float32).item()


_LOG2E = _f32(1.44269504088896341)
_LN2_HI, _LN2_LO = _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_P = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (the f32 product is exact in
    f64), as a fused multiply-add."""
    return (a.double() * b + c).float()


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``exp`` on the CPU: Cephes' range reduction and
    polynomial, each multiply-add fused as its compiled code fuses it."""
    x = x.float().clamp(-87.8, 88.8)
    n = torch.floor(_fma(x, _LOG2E, 0.5)).clamp(-127, 127)
    x = _fma(n, -_LN2_HI, x)
    x = _fma(n, -_LN2_LO, x)
    z = _fma(x, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = _fma(z, x, c)
    z = 1.0 + _fma(z, x * x, x)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z * pow2


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` over the last axis, f32, bit for bit."""

    @staticmethod
    def forward(ctx, logits):
        x = logits.float()
        u = _xla_exp(x - x.amax(dim=-1, keepdim=True))
        total = u[..., 0]
        for k in range(1, u.shape[-1]):
            total = total + u[..., k]
        y = u / total[..., None]
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return (y * (g - (y * g).sum(dim=-1, keepdim=True))).to(g.dtype)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    return _Softmax.apply(logits)


def _slotify(pos, gate, capacity: int):
    """Queue positions ``[T, E]`` (-1: not routed there) and the per-token
    gate -> (dispatch ``[T, E, C]`` one-hot f32, combine = dispatch *
    gate); a position at or past ``capacity`` is dropped.  Shared by both
    routers, so their capacity rules cannot drift apart."""
    in_cap = (pos >= 0) & (pos < capacity)
    dispatch = (F.one_hot(pos.clamp(0, capacity - 1), capacity).float()
                * in_cap[..., None])
    return dispatch, dispatch * gate[:, None, None]


def _positions(onehot: torch.Tensor, offset=0) -> torch.Tensor:
    """Each token's place in its expert's queue (first come, first
    served), -1 where it is not routed."""
    return (torch.cumsum(onehot, dim=0) + offset) * onehot - 1


def top1_routing(logits, capacity: int):
    """Switch-style top-1 routing with a fixed capacity: ``logits [T, E]``
    -> (dispatch ``[T, E, C]``, combine ``[T, E, C]``)."""
    probs = _softmax(logits)
    expert_idx = probs.argmax(dim=-1)
    gate = probs.gather(-1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, logits.shape[-1]).to(torch.int32)
    return _slotify(_positions(onehot), gate, capacity)


def top2_routing(logits, capacity: int):
    """GShard-style top-2 routing: each token to its best and second-best
    expert, the two gates renormalized to sum to 1; every first choice
    queues before any second choice at an expert, so a backup is dropped
    before a primary.  Returns (dispatch, combine), ``[T, E, C]`` each."""
    e = logits.shape[-1]
    probs = _softmax(logits)
    idx1 = probs.argmax(dim=-1)
    p1 = probs.gather(-1, idx1[:, None])[:, 0]
    masked = probs * (1.0 - F.one_hot(idx1, e).float())
    idx2 = masked.argmax(dim=-1)
    p2 = masked.gather(-1, idx2[:, None])[:, 0]
    denom = p1 + p2 + 1e-9
    g1, g2 = p1 / denom, p2 / denom
    oh1 = F.one_hot(idx1, e).to(torch.int32)
    oh2 = F.one_hot(idx2, e).to(torch.int32)
    d1, c1 = _slotify(_positions(oh1), g1, capacity)
    d2, c2 = _slotify(_positions(oh2, oh1.sum(dim=0)[None, :]), g2,
                      capacity)
    # A token's two choices are distinct experts: the slots never collide.
    return d1 + d2, c1 + c2


def _matmul(a, b):
    """``a @ b`` in the promoted dtype (bf16 tokens times an f32 router
    compute in f32), as ``jnp`` promotes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _capacity(capacity_factor: float, t: int, e: int) -> int:
    return max(int(capacity_factor * t / e), 1)


def moe_layer(x, router_w, expert_fn: Callable, expert_params, axis=None,
              capacity_factor: float = 1.25, router: str = "top1"):
    """A distributed MoE layer, one expert a rank of ``axis``.

    ``x``: ``[T_local, D]`` this rank's tokens; ``router_w``: ``[D, E]``
    with E the axis size; ``expert_params``: this rank's expert;
    ``expert_fn(params, tokens [N, D]) -> [N, D]``.  ``router`` is
    ``"top1"`` (Switch) or ``"top2"`` (GShard: twice the traffic at equal
    capacity factor, so users raise it).  The dispatch is the dense one:
    ``[E, C, D]`` buffers from the one-hot ``[T, E, C]`` dispatch, a
    differentiable tiled all-to-all each way, the combine weights back
    to token order.  Returns ``[T_local, D]``."""
    size = seq.axis_size(axis)
    t, _ = x.shape
    capacity = _capacity(capacity_factor, t, size)
    logits = _matmul(x, router_w)
    if router == "top1":
        dispatch, combine = top1_routing(logits, capacity)
    elif router == "top2":
        dispatch, combine = top2_routing(logits, capacity)
    else:
        raise ValueError(f"router={router!r}: expected 'top1' or 'top2'")
    dt = torch.promote_types(x.dtype, dispatch.dtype)
    buffers = torch.einsum("td,tec->ecd", x.to(dt), dispatch)
    received = seq._all_to_all(buffers, axis, 0, 0)       # [S, C, D]
    out = expert_fn(expert_params, received.reshape(size * capacity, -1))
    returned = seq._all_to_all(out.reshape(size, capacity, -1), axis, 0, 0)
    dt = torch.promote_types(returned.dtype, combine.dtype)
    return torch.einsum("ecd,tec->td", returned.to(dt), combine.to(dt))


def load_balancing_loss(logits, axis=None):
    """Switch-Transformer auxiliary loss: E times the sum over experts of
    the mean fraction of tokens routed there and the mean router
    probability, both averaged over the axis."""
    probs = _softmax(logits)
    e = probs.shape[-1]
    hard = F.one_hot(probs.argmax(dim=-1), e).float()
    frac = seq.axis_mean(hard.mean(dim=0), axis)
    prob = seq.axis_mean(probs.mean(dim=0), axis)
    return e * torch.sum(frac * prob)


def _grants(m, buf: int):
    """``landed[s][d]``: how many of the rows source ``d`` sent to expert
    ``s`` fit its buffer (granted in source-rank order)."""
    size = len(m)
    out = []
    for s in range(size):
        used, row = 0, []
        for d in range(size):
            row.append(max(0, min(buf - used, m[d][s])))
            used += m[d][s]
        out.append(row)
    return out


def moe_layer_ragged(x, router_w, expert_fn: Callable, expert_params,
                     axis=None, capacity_factor: float = 1.25,
                     use_primitive=None):
    """Top-1 MoE whose dispatch is the ragged exchange
    (:func:`~horovod_tpu_torch.ops.collective.alltoall_ragged`) instead of
    :func:`moe_layer`'s dense ``[T, E, C]`` einsum: the routed rows travel
    sorted by destination, so dispatch memory is O(T·D).

    The routing decision is ``moe_layer(router="top1")``'s.  At overflow
    the capacity differs: expert j's buffer of ``size · capacity`` rows is
    granted to source ranks in rank order (lower ranks first), and within
    a source in token order; without overflow the two layers agree.
    Dropped tokens contribute zero.  ``expert_fn`` must treat rows
    independently (it sees zero padding rows).  One all-gather of the
    split matrix serves both exchanges and the bookkeeping.  Returns
    ``[T_local, D]``."""
    size, me = seq.axis_size(axis), seq.axis_index(axis)
    t, d = x.shape
    buf = size * _capacity(capacity_factor, t, size)
    probs = _softmax(_matmul(x, router_w))
    dest = probs.argmax(dim=-1)
    gate = probs.gather(1, dest[:, None])[:, 0]
    # Stable: ties keep token order, the dense router's first come, first
    # served.
    order = torch.argsort(dest, stable=True)
    splits = torch.bincount(dest, minlength=size)
    m = seq.gather_splits(splits, axis, x.device)
    primitive = (x.is_cuda if use_primitive is None else bool(use_primitive))
    out_buf = seq.ragged_all_to_all(x[order], m, me, buf, axis, primitive)
    expert_out = expert_fn(expert_params, out_buf)             # [buf, D]
    # The return trip: from each source only what landed in the buffer.
    back = seq.ragged_all_to_all(expert_out, _grants(m, buf), me, t, axis,
                                 primitive)                        # [T, D]
    # Which of my sorted rows survived their expert's buffer: my block at
    # expert j starts after every lower rank's; the returned rows come
    # back in my sorted order with the dropped ones removed.
    mine = m[me]
    start = [sum(m[k][j] for k in range(me)) for j in range(size)]
    survived, pos, kept = [], [], 0
    for j in range(size):
        for r in range(mine[j]):
            ok = start[j] + r < buf
            survived.append(ok)
            pos.append(kept if ok else 0)
            kept += ok
    ok = torch.tensor(survived, dtype=torch.bool, device=x.device)
    gathered = torch.where(ok[:, None], back[torch.tensor(
        pos, dtype=torch.long, device=x.device)], 0.0)
    y = x.new_zeros((t, d)).index_copy(0, order, gathered.to(x.dtype))
    return y * gate[:, None].to(x.dtype)
