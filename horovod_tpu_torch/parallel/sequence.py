"""Sequence parallelism: ring, ring-flash and Ulysses attention.

Counterpart of ``horovod_tpu/parallel/sequence.py``: ``_block_attention``
(``:30``), ``ring_attention`` (``:62``), ``_merge_online`` (``:127``),
``ring_flash_attention`` (``:225``, with ``_ring_flash_fwd`` ``:257`` and
``_ring_flash_bwd`` ``:338``), ``ulysses_attention`` (``:410``) and
``local_attention`` (``:501``).

Tensors are ``[B, T_local, H, D]``, this rank's contiguous chunk of the
sequence: shard i owns global positions ``[i*T, (i+1)*T)``.  The axis is
the sequence axis's process group (``mesh.axis("seq")``; None is the
default group) or a :class:`VirtualRank`.

The reference differentiates through ``lax.ppermute`` and
``lax.all_to_all``.  Torch has no autograd for point-to-point sends, so
here the neighbour shift is an autograd Function (forward: send to rank+1,
receive from rank-1; backward: the reverse shift), and so is the
all-to-all (backward: the reverse all-to-all).  ``ring_flash_attention``
is one Function whose backward is a second ring pass, as the reference's
``custom_vjp``.  Every exchange with the group goes through
:func:`_start_shift`, :func:`_all_to_all` and :func:`all_gather`.

:class:`VirtualAxis` runs the ranks of an axis as threads of one process
on one device (NCCL refuses two ranks on one card).  Its exchange swaps
the tensors themselves, so autograd follows a tensor from one virtual
rank to the next with no Function at all: the backward of ``ring`` and
``ulysses`` is one ``torch.autograd.grad`` over every rank's output, from
one thread.  A Function whose backward exchanges cannot run that way
(autograd runs every CUDA node of every thread on the one device's
thread), so ``ring_flash``'s two passes are called directly there
(:func:`_ring_flash_fwd`, :func:`_ring_flash_bwd`).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch import config
from horovod_tpu_torch.ops import flash_attention as fa

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# The exchanges: the one place that talks to the group
# ---------------------------------------------------------------------------

class VirtualAxis:
    """An axis of ``size`` ranks that are threads of this process.
    :meth:`run` calls ``fn(VirtualRank)`` in each thread; every exchange
    is a barrier, a swap of Python objects and a second barrier."""

    def __init__(self, size: int, timeout: float = 300.0):
        self.size = size
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._slots: list = [None] * size

    def exchange(self, index: int, value) -> list:
        """Every rank's ``value``, by rank."""
        self._slots[index] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()
        return out

    def run(self, fn: Callable[["VirtualRank"], object]) -> list:
        """``fn(rank)`` in one thread per rank; the results by rank.  A
        rank that raises breaks the barrier, so the others stop too, and
        its error is raised here."""
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(i):
            try:
                results[i] = fn(VirtualRank(self, i))
            except BaseException as e:   # re-raised below, in the caller
                errors[i] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,),
                                    name=f"virtual-rank-{i}")
                   for i in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._barrier.reset()
        first = next((e for e in errors if e is not None and
                      not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return results


@dataclass(frozen=True)
class VirtualRank:
    """Rank ``index`` of a :class:`VirtualAxis`, passed as the axis."""
    axis: VirtualAxis
    index: int


def axis_size(axis) -> int:
    """The number of ranks of ``axis``."""
    if isinstance(axis, VirtualRank):
        return axis.axis.size
    return dist.get_world_size(axis)


def axis_index(axis) -> int:
    """This rank's position on ``axis`` (its sequence shard)."""
    if isinstance(axis, VirtualRank):
        return axis.index
    return dist.get_rank(axis)


def _global(axis, group_rank: int) -> int:
    return dist.get_global_rank(axis or dist.group.WORLD, group_rank)


def _start_shift(tensors: Sequence[torch.Tensor], axis, reverse=False,
                 tag: int = 0) -> Callable[[], List[torch.Tensor]]:
    """Start sending each tensor to rank+1 (rank-1 if ``reverse``) and
    receiving rank-1's (rank+1's); returns ``wait() -> received``.  The
    send and the receive go out together (``batch_isend_irecv``: no
    deadlock at size 2, where both neighbours are one rank) and run on
    the collective library's own stream, so work queued before ``wait``
    overlaps the transfer.  ``tag`` tells apart the gloo transfers that
    are in flight at once."""
    tensors = list(tensors)
    n = axis_size(axis)
    if n == 1:
        return lambda: tensors
    i = axis_index(axis)
    src = (i + 1) % n if reverse else (i - 1) % n
    if isinstance(axis, VirtualRank):
        got = axis.axis.exchange(i, tensors)[src]
        return lambda: list(got)
    dst = (i - 1) % n if reverse else (i + 1) % n
    sent = [t.contiguous() for t in tensors]
    bufs = [torch.empty_like(t) for t in sent]
    ops = []
    for j, (t, b) in enumerate(zip(sent, bufs)):
        ops.append(dist.P2POp(dist.isend, t, _global(axis, dst), axis,
                              tag + j))
        ops.append(dist.P2POp(dist.irecv, b, _global(axis, src), axis,
                              tag + j))
    works = dist.batch_isend_irecv(ops)

    def wait():
        for w in works:
            w.wait()
        del sent[:]
        return bufs

    return wait


class _Shift(torch.autograd.Function):
    """The neighbour shift: forward to rank+1, gradients back to rank-1."""

    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis = axis
        return tuple(_start_shift(tensors, axis)())

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_start_shift(grads, ctx.axis, reverse=True)())


def _shift(tensors: Sequence[torch.Tensor], axis) -> List[torch.Tensor]:
    """Differentiable shift of floating tensors to rank+1."""
    if axis_size(axis) == 1 or isinstance(axis, VirtualRank):
        return _start_shift(tensors, axis)()
    return list(_Shift.apply(axis, *tensors))


def _exchange_chunks(x: torch.Tensor, axis, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """All-to-all: chunk j of ``x`` along ``split_dim`` goes to rank j;
    what arrives is concatenated along ``concat_dim`` in rank order."""
    n, i = axis_size(axis), axis_index(axis)
    chunks = x.chunk(n, dim=split_dim)
    if isinstance(axis, VirtualRank):
        every = axis.axis.exchange(i, chunks)
        return torch.cat([every[j][i] for j in range(n)], dim=concat_dim)
    inp = torch.stack(chunks).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=axis)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return _exchange_chunks(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_exchange_chunks(g, ctx.axis, concat_dim, split_dim), None,
                None, None)


def _all_to_all(x, axis, split_dim: int, concat_dim: int):
    """Differentiable tiled all-to-all (``lax.all_to_all(tiled=True)``)."""
    if axis_size(axis) == 1:
        return x
    if isinstance(axis, VirtualRank):
        return _exchange_chunks(x, axis, split_dim, concat_dim)
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (no gradient)."""
    n = axis_size(axis)
    if n == 1:
        return x
    if isinstance(axis, VirtualRank):
        return torch.cat(axis.axis.exchange(axis.index, x), dim=dim)
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x.contiguous(), group=axis)
    return torch.cat(out, dim=dim)


class _AxisMean(torch.autograd.Function):
    """The mean over a process group; the backward averages the
    cotangents too (the gradient of the sum of every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _group_mean(x, group)

    @staticmethod
    def backward(ctx, g):
        return _group_mean(g, ctx.group), None


def _group_mean(x, group):
    out = x.detach().clone().reshape(-1)
    dist.all_reduce(out, group=group)
    return (out / dist.get_world_size(group)).reshape(x.shape)


def axis_mean(x: torch.Tensor, axis) -> torch.Tensor:
    """``pmean``: the mean of ``x`` over ``axis``; differentiable."""
    if axis_size(axis) == 1:
        return x
    if isinstance(axis, VirtualRank):
        every = axis.axis.exchange(axis.index, x)
        return torch.stack(every).mean(dim=0)
    return _AxisMean.apply(x, axis)


# ---------------------------------------------------------------------------
# The ragged all-to-all (reference ``ops/collective.py:916-1000``)
# ---------------------------------------------------------------------------

class _AllToAllV(torch.autograd.Function):
    """``all_to_all_single`` with per-peer row counts on a process group;
    the backward is the same exchange with the counts swapped."""

    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.sizes = group, (send, recv)
        return _exchange_v(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        send, recv = ctx.sizes
        return _exchange_v(g, ctx.group, recv, send), None, None, None


def _exchange_v(x, group, send, recv):
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), list(recv), list(send),
                           group=group)
    return out


def _ragged_exchange(x, axis, send: List[int], recv: List[int]):
    """Rows ``x`` grouped by destination (``send[j]`` rows for peer j)
    out, the rows each source sent in (``recv[i]`` from peer i)
    concatenated in source order back; differentiable.  A virtual rank
    swaps the blocks themselves, so autograd follows them with no
    Function."""
    if isinstance(axis, VirtualRank):
        every = axis.axis.exchange(axis.index, list(x.split(send)))
        return torch.cat([every[i][axis.index] for i in range(len(recv))])
    return _AllToAllV.apply(x, axis, tuple(send), tuple(recv))


def gather_splits(splits, axis, device) -> List[List[int]]:
    """``m[s][d]``: the rows rank s sends to rank d, for every pair (one
    all-gather of every rank's splits)."""
    sp = torch.as_tensor(splits).reshape(1, -1).to(device=device,
                                                   dtype=torch.int64)
    if sp.shape[1] != axis_size(axis):
        raise ValueError(f"alltoall_ragged: {sp.shape[1]} splits for an "
                         f"axis of {axis_size(axis)} ranks")
    return all_gather(sp, axis, dim=0).tolist()


def _offsets(counts: Sequence[int]) -> List[int]:
    out, acc = [], 0
    for c in counts:
        out.append(acc)
        acc += c
    return out


def ragged_all_to_all(tensor, m, me: int, output_size: int, axis,
                      primitive: bool):
    """:func:`alltoall_ragged` on the gathered split matrix ``m``."""
    size = len(m)
    n, trailing = tensor.shape[0], tuple(tensor.shape[1:])
    sp = list(m[me])
    recv = [m[i][me] for i in range(size)]
    in_off = _offsets(sp)
    if sum(sp) > n:
        raise ValueError(f"alltoall_ragged: splits {sp} sum past the "
                         f"{n} rows of the tensor")
    dev = tensor.device
    if primitive:
        # My block lands at each receiver after every lower rank's block;
        # clamp it to the room left there (every rank derives the same
        # clamps from the same matrix), so nothing past the static
        # capacity crosses the wire.
        out_off = [sum(m[k][j] for k in range(me)) for j in range(size)]
        send = [max(0, min(output_size - out_off[j], sp[j]))
                for j in range(size)]
        at_me = _offsets(recv)
        land = [max(0, min(output_size - at_me[i], recv[i]))
                for i in range(size)]
        rows = torch.tensor([in_off[j] + r for j in range(size)
                             for r in range(send[j])], dtype=torch.long,
                            device=dev)
        got = _ragged_exchange(tensor.index_select(0, rows), axis, send,
                               land)
        out = torch.cat([got, got.new_zeros((output_size - got.shape[0],)
                                            + trailing)])
        return out
    # The dense twin: each destination's block padded to n rows (the
    # worst case, one peer gets everything), a regular exchange, then a
    # compaction into the capacity buffer.
    src = [in_off[j] + r for j in range(size) for r in range(sp[j])]
    slot = [j * n + r for j in range(size) for r in range(sp[j])]
    buf = tensor.new_zeros((size * n,) + trailing).index_copy(
        0, torch.tensor(slot, dtype=torch.long, device=dev),
        tensor.index_select(0, torch.tensor(src, dtype=torch.long,
                                            device=dev)))
    ex = _ragged_exchange(buf, axis, [n] * size, [n] * size)
    at_me = _offsets(recv)
    take, put = [], []
    for i in range(size):
        for r in range(recv[i]):
            if at_me[i] + r < output_size:
                take.append(i * n + r)
                put.append(at_me[i] + r)
    idx = torch.tensor(take, dtype=torch.long, device=dev)
    return ex.new_zeros((output_size,) + trailing).index_copy(
        0, torch.tensor(put, dtype=torch.long, device=dev),
        ex.index_select(0, idx))


def alltoall_ragged(tensor, splits, output_size: int, axis=None,
                    use_primitive=None):
    """Uneven all-to-all on the SPMD plane, with a static output capacity
    (reference ``alltoall_ragged``): the MoE dispatch's exchange.

    ``tensor``: ``[N, ...]`` this rank's rows grouped by destination
    (rows for peer 0 first, then peer 1, ...); ``splits``: ``[S]`` rows
    for each peer; ``output_size``: the row capacity of the result.
    Returns ``(out, received)``: ``out[output_size, ...]`` holds each
    source's rows in source order (zeros after them), and rows beyond
    ``output_size`` are dropped (capacity goes to sources in rank
    order); ``received[S]`` counts the rows each peer sent, before any
    drop.  One all-gather exchanges the split matrix.

    ``axis`` is a process group (None: the default group) or a
    :class:`VirtualRank`.  The
    exchange: on CUDA tensors ``all_to_all_single`` with per-peer row
    counts, each block clamped to the room left at its receiver; on the
    CPU the reference's dense twin (each block padded to ``N`` rows, a
    regular exchange, then a compaction).  ``use_primitive`` forces one
    (False: the dense twin anywhere).  Differentiable: the backward is
    the reverse exchange, and dropped and slack rows get zero gradient.
    It is collective over ``axis`` but not negotiated by name: every
    rank calls it at the same point, as the reference's ``shard_map``
    code does."""
    m = gather_splits(splits, axis, tensor.device)
    me = axis_index(axis)
    primitive = (tensor.is_cuda if use_primitive is None
                 else bool(use_primitive))
    out = ragged_all_to_all(tensor, m, me, output_size, axis, primitive)
    received = torch.tensor([m[i][me] for i in range(len(m))],
                            dtype=torch.int64, device=tensor.device)
    return out, received


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------

def _block_attention(q, k, v, m, l, o, q_seg=None, k_seg=None, *,
                     q_offset, k_offset, causal, scale):
    """One q-block x k-block update of the online-softmax state, in the
    inputs' dtype.  ``m``, ``l``: ``[B, H, Tq]``; ``o``: ``[B, Tq, H,
    D]``, the running numerator."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
        kpos = k_offset + torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(~(qpos >= kpos), NEG_INF)
    if q_seg is not None:
        s = s.masked_fill(q_seg[:, None, :, None] != k_seg[:, None, None, :],
                          NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # Guard fully masked rows: exp(-inf - -inf) is NaN without the select.
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)
    corr = torch.exp(torch.where(torch.isneginf(m), m_new, m) - safe_m)
    corr = torch.where(torch.isneginf(m), 0.0, corr)
    l_new = l * corr + p.sum(dim=-1)
    o_new = (o * corr.transpose(1, 2)[..., None] +
             torch.einsum("bhqk,bkhd->bqhd", p, v))
    return m_new, l_new, o_new


def ring_attention(q, k, v, axis_name=None, causal: bool = True,
                   scale: Optional[float] = None, segment_ids=None):
    """Exact attention over a sequence sharded across ``axis_name``.

    K/V blocks rotate around the ring while each rank accumulates its
    queries' online softmax; after axis-size steps every query has seen
    every key.  ``segment_ids`` (``[B, T_local]``, this shard's slice of
    the global packing) rotate with their block.  Gradients flow back
    through the shifts.  Each step's block math is recomputed in the
    backward (activation checkpointing), so memory holds one step's
    ``[B, H, T_local, T_local]`` scores at a time, not axis-size of them;
    the values are the same.
    """
    axis = axis_name
    size, idx = axis_size(axis), axis_index(axis)
    b, t, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    m = torch.full((b, h, t), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, t), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    k_blk, v_blk, k_seg = k, v, segment_ids
    for s in range(size):
        # Block s arrived from rank (idx - s) mod size.
        block = functools.partial(
            _block_attention, q_offset=idx * t,
            k_offset=((idx - s) % size) * t, causal=causal, scale=scale)
        m, l, o = checkpoint(block, q, k_blk, v_blk, m, l, o, segment_ids,
                             k_seg, use_reentrant=False,
                             preserve_rng_state=False)
        if s < size - 1:
            k_blk, v_blk = _shift([k_blk, v_blk], axis)
            if segment_ids is not None:
                (k_seg,) = _start_shift([k_seg], axis, tag=2)()
    denom = torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]
    return o / denom


# ---------------------------------------------------------------------------
# Ring attention with the flash kernels as the block math
# ---------------------------------------------------------------------------

def _row(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """``[B*H, 1, T]`` softmax state -> ``[B, T, H, 1]``, to scale a
    ``[B, T, H, D]`` block."""
    return x.reshape(b, h, -1).transpose(1, 2)[..., None]


def _merge_online(m, l, acc, m_b, l_b, o_b, b, h):
    """Merge a block's ``(m_b, l_b, o_b)`` (``o_b`` normalised) into the
    running ``(m, l, acc)`` (``acc`` unnormalised, f32, updated in
    place).  ``m``/``l`` are ``[B*H, 1, T]`` f32."""
    m_new = torch.maximum(m, m_b)
    safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    c1 = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe))
    c2 = torch.where(torch.isneginf(m_b), 0.0, torch.exp(m_b - safe))
    l_new = l * c1 + l_b * c2
    acc.mul_(_row(c1, b, h)).add_(o_b.float() * _row(l_b * c2, b, h))
    return m_new, l_new, acc


def _check_flash(q, k, v, segment_ids):
    bq, bk = fa._eff_blocks(q.shape[1], None, None, q.shape[-1])
    b, t, _, _ = fa._check_shapes(q, k, v, bq, bk)
    if fa._route(q) == "cuda":
        # What the kernels refuse raises here, before any block moves.
        fa._kernel_plan(q.dtype, q.shape[-1])
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, t):
            raise ValueError(
                f"segment_ids must be [B, T_local] = {(b, t)} matching "
                f"this shard's q/k/v, got {tuple(segment_ids.shape)}")
        if segment_ids.is_floating_point() or segment_ids.is_complex():
            raise ValueError(
                f"segment_ids must be integer, got {segment_ids.dtype}")


def _visible(causal: bool, s: int, idx: int) -> bool:
    """Whether ring step ``s`` has keys the queries may see: under
    ``causal`` the block from rank ``idx - s`` is fully visible when it
    lies left of this rank's chunk (``s <= idx``) and fully masked when
    it wraps around from the right.  A masked step launches nothing."""
    return not causal or s <= idx


def _ring_flash_fwd(q, k, v, axis, causal: bool, scale: float,
                    segment_ids=None):
    """The forward ring pass on ``[B, T, H, D]``: the causal kernel on the
    diagonal step, the non-causal kernel on every visible arriving block
    (k-side ids rotated in, so ``qseg != kseg``), the kernels' ``(o, m,
    l)`` merged across steps.  The next block's transfer is started
    before this step's kernel and awaited after it.  Returns ``o`` and
    what the backward needs."""
    size, idx = axis_size(axis), axis_index(axis)
    b, _, h, _ = q.shape
    seg = segment_ids
    blocks = [k, v] + ([seg] if seg is not None else [])
    pending = _start_shift(blocks, axis) if size > 1 else None
    o0, m, l = fa._fwd_parts(q, k, v, seg, seg, causal, scale)
    acc = o0.float() * _row(l, b, h)
    for s in range(1, size):
        got = pending()
        if s < size - 1:
            pending = _start_shift(got, axis)
        if not _visible(causal, s, idx):
            continue
        kseg = got[2] if seg is not None else None
        o_b, m_b, l_b = fa._fwd_parts(q, got[0], got[1], seg, kseg, False,
                                      scale)
        m, l, acc = _merge_online(m, l, acc, m_b, l_b, o_b, b, h)
    denom = torch.where(l == 0.0, 1.0, l)
    o = (acc / _row(denom, b, h)).to(q.dtype)
    return o, (q, k, v, seg, o, m, l)


def _ring_flash_bwd(axis, causal: bool, scale: float, res, do):
    """The backward ring pass: on every visible block the dQ and dK/dV
    kernels run with the GLOBAL ``(m, l)`` rows, so each block's share is
    exactly its part of the global gradient.  dQ accumulates here; dK/dV
    accumulate in f32 on the rotating block and arrive home after the
    full cycle."""
    q, k, v, seg, o, m, l = res
    size, idx = axis_size(axis), axis_index(axis)
    do = do.contiguous()
    blocks = [k, v] + ([seg] if seg is not None else [])
    pending = _start_shift(blocks, axis) if size > 1 else None
    dq0, dk0, dv0 = fa._bwd_parts(q, k, v, o, do, m, l, seg, seg, causal,
                                  scale)
    if size == 1:
        return dq0, dk0, dv0
    dq = dq0.float()
    grads = _start_shift([dk0.float(), dv0.float()], axis, tag=3)
    for s in range(1, size):
        got = pending()
        if s < size - 1:
            pending = _start_shift(got, axis)
        dk_rot, dv_rot = grads()
        if _visible(causal, s, idx):
            kseg = got[2] if seg is not None else None
            dq_b, dk_b, dv_b = fa._bwd_parts(q, got[0], got[1], o, do, m,
                                             l, seg, kseg, False, scale)
            # The received accumulators belong to this rank until they
            # are sent on: adding in place is safe.
            dq.add_(dq_b.float())
            dk_rot.add_(dk_b.float())
            dv_rot.add_(dv_b.float())
        grads = _start_shift([dk_rot, dv_rot], axis, tag=3)
    dk, dv = grads()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, axis, causal, scale):
        o, res = _ring_flash_fwd(q, k, v, axis, causal, scale, seg)
        ctx.save_for_backward(*res)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _ring_flash_bwd(ctx.axis, ctx.causal, ctx.scale,
                                     ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None


def ring_flash_attention(q, k, v, axis_name=None, causal: bool = True,
                         scale: Optional[float] = None, segment_ids=None):
    """Ring attention with the flash kernels as the per-step block math.

    The same semantics as :func:`ring_attention`.  On CUDA tensors every
    step launches the flash kernels of ``fa._kernel_plan`` (bf16, f16 or
    f32 at any head dim up to 256, padded to a kernel head dim; f64 and
    wider heads raise before any exchange, as ``flash_attention`` does);
    on CPU tensors their plain versions run.  Under ``causal`` the steps whose arriving block is
    fully masked launch nothing: per rank ``idx``, ``1 + idx`` forward
    launches and as many dQ and dK/dV launches (``size`` each without
    ``causal``).
    """
    _check_flash(q, k, v, segment_ids)
    d = q.shape[-1]
    scale_ = d ** -0.5 if scale is None else float(scale)
    return _RingFlash.apply(q, k, v, segment_ids, axis_name, bool(causal),
                            scale_)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def ulysses_attention(q, k, v, axis_name=None, causal: bool = True,
                      scale: Optional[float] = None, segment_ids=None,
                      use_flash: Optional[bool] = None):
    """DeepSpeed-Ulysses: all-to-all from sequence-sharded to
    head-sharded, attention over the whole sequence for this rank's
    heads, all-to-all back.  Heads must divide by the axis size.

    ``segment_ids`` (this shard's slice) are all-gathered.  ``use_flash``
    None picks the flash kernel on a CUDA tensor when ``T_global`` tiles
    by 128 and is at least ``HOROVOD_FLASH_AUTO_MIN_T`` (as
    ``attention="auto"``); otherwise plain attention, the reference's
    non-flash route.
    """
    axis = axis_name
    size = axis_size(axis)
    b, t, h, d = q.shape
    if h % size != 0:
        raise ValueError(f"heads ({h}) must be divisible by axis size "
                         f"({size}) for Ulysses attention")
    qg, kg, vg = (_all_to_all(x, axis, 2, 1) for x in (q, k, v))
    scale_ = (d ** -0.5) if scale is None else scale
    tg = qg.shape[1]
    seg_g = (all_gather(segment_ids, axis, 1)
             if segment_ids is not None else None)
    if use_flash is None:
        use_flash = (qg.device.type == "cuda" and tg % 128 == 0 and
                     tg >= config.env_int("HOROVOD_FLASH_AUTO_MIN_T"))
    if use_flash:
        out = fa.flash_attention(qg, kg, vg, causal, scale_,
                                 segment_ids=seg_g)
    else:
        out = local_attention(qg, kg, vg, causal, scale_, seg_g)
    return _all_to_all(out, axis, 1, 2)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain single-device attention over ``[B, T, H, D]``, computed in the
    inputs' dtype as the reference does (scores, softmax and the value
    product all in ``q.dtype``).

    ``segment_ids`` ([B, T] integer) enables sequence packing: tokens
    attend only within their own segment (composes with ``causal``).
    """
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    t = q.shape[1]
    allowed = None
    if causal:
        allowed = torch.ones((t, t), dtype=torch.bool,
                             device=q.device).tril()[None, None]
    if segment_ids is not None:
        seg_ok = (segment_ids[:, None, :, None] ==
                  segment_ids[:, None, None, :])
        allowed = seg_ok if allowed is None else (allowed & seg_ok)
    if allowed is not None:
        s = s.masked_fill(~allowed, float("-inf"))
    if segment_ids is not None:
        # Fully masked rows yield zeros with zero gradients: guard before
        # the softmax, whose all -inf row is NaN both ways (reference
        # :522-530).
        row_valid = allowed.any(dim=-1, keepdim=True)
        s = torch.where(row_valid, s, torch.zeros((), dtype=s.dtype,
                                                  device=s.device))
        p = torch.where(row_valid, torch.softmax(s, dim=-1),
                        torch.zeros((), dtype=s.dtype, device=s.device))
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
