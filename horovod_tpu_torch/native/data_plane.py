"""Launching negotiated collectives on the runtime's data groups.

Counterpart of ``horovod_tpu/native/cc/src/data_plane.cc``: one function
per op type takes a response and, per name, the tensor this rank holds
(or None: a joined rank, or a rank that joined before submitting that
name, takes part with zeros of the response's sizes), starts the
``torch.distributed`` collective on the set's data group and returns the
works to wait on and, per name, a function that gives the raw result.
Those functions run on the caller's thread after the works, so the
caller's stream reads only what the collective wrote.

The arithmetic is the reference's, whose eager plane computes in numpy:
``promoted`` is numpy's promotion of ``t * python_scalar`` (integers to
float64, bfloat16 to float32), ``Average`` is a sum that the caller
divides by the set size.  ``adasum`` is the native runtime's
scaled-projection butterfly (``data_plane.cc:854-928``) on point-to-point
sends.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.native.message import ReduceOp, Response
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops._build import CallCounter

# One count per torch.distributed collective (or point-to-point exchange)
# launched here, so a run can show what reached the wire.  Allreduces
# count in fusion.allreduce_calls instead, as every fused all-reduce does.
calls = CallCounter("collective.calls")

TORCH_OPS = {ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX}

Output = Callable[[], torch.Tensor]


class DataGroup:
    """A process group of the runtime and the hvd ranks in it."""

    def __init__(self, group, members: Sequence[int], rank: int,
                 global_ranks: Sequence[int], device: torch.device):
        self.group = group
        self.members = list(members)
        self.pos = self.members.index(rank) if rank in self.members else -1
        self.peers = [global_ranks[m] for m in self.members]
        # A process outside the set holds no group to ask.
        self.nccl = self.pos >= 0 and dist.get_backend(group) == "nccl"
        self.device = device if self.nccl else torch.device("cpu")

    @property
    def size(self) -> int:
        return len(self.members)


def promoted(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype numpy gives ``t * python_scalar``: integers
    become float64 and bfloat16 float32 (ml_dtypes' promotion); the
    other floats keep their dtype."""
    if not (t.is_floating_point() or t.is_complex()):
        return t.to(torch.float64)
    if t.dtype == torch.bfloat16:
        return t.float()
    return t


def divide(t: torch.Tensor, n: int) -> torch.Tensor:
    return promoted(t) / n


def scaled(t: torch.Tensor, factor: float) -> torch.Tensor:
    """``t * factor`` as numpy computes it (see :func:`promoted`)."""
    return fusion._times(t, factor, promoted)


def to_wire(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A fresh contiguous copy of ``t`` on the wire device."""
    return t.to(dev, memory_format=torch.contiguous_format, copy=True)


def on_caller(t: torch.Tensor) -> torch.Tensor:
    """``t``, made on the runtime's stream, is read on the caller's:
    keep its memory from being reused before the caller is done."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def _zeros(n: int, dtype: str, g: DataGroup) -> torch.Tensor:
    return torch.zeros(n, dtype=getattr(torch, dtype), device=g.device)


class _Once:
    """A bucket's ``finish``, run once by whichever caller needs it
    first; every name of the bucket takes its part."""

    def __init__(self, finish):
        self._finish = finish
        self._parts = None
        self._lock = threading.Lock()

    def part(self, i: int) -> torch.Tensor:
        with self._lock:
            if self._parts is None:
                self._parts = self._finish()
            return self._parts[i]


# ---------------------------------------------------------------------------
# Adasum
# ---------------------------------------------------------------------------

def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ac * a + bc * b`` in float64, rounded to a's dtype; ``a`` is the
    lower position's vector on both members of a pair, so both compute
    the same expression on the same operands."""
    x, y = a.double(), b.double()
    dot, na, nb = torch.dot(x, y), torch.dot(x, x), torch.dot(y, y)
    # Zero-norm guards: a zero vector is an identity, adasum(a, 0) = a.
    one = torch.ones((), dtype=torch.float64, device=x.device)
    ac = torch.where(na > 0, 1.0 - dot / (2.0 * na), one)
    bc = torch.where(nb > 0, 1.0 - dot / (2.0 * nb), one)
    return (ac * x + bc * y).to(a.dtype)


def adasum(buf: torch.Tensor, g: DataGroup) -> torch.Tensor:
    """The butterfly over the group's members.  Extras past the largest
    power of two fold into ``[0, p2)`` first and get the result back at
    the end; 16-bit inputs are staged through float32."""
    n, me = g.size, g.pos
    if n == 1 or buf.numel() == 0:
        return buf
    vec = buf.reshape(-1).float() if buf.element_size() == 2 else (
        buf.reshape(-1))
    peer = g.peers
    other = torch.empty_like(vec)
    p2 = 1
    while p2 * 2 <= n:
        p2 *= 2
    extra = me >= p2
    fold = me - p2 if extra else (me + p2 if me + p2 < n else -1)
    calls.add()
    if extra:
        dist.send(vec, peer[fold], group=g.group)
        dist.recv(vec, peer[fold], group=g.group)
        return vec.reshape(buf.shape).to(buf.dtype)
    if fold >= 0:
        dist.recv(other, peer[fold], group=g.group)
        vec = adasum_combine(vec, other)
    d = 1
    while d < p2:
        partner = me ^ d
        # The lower member sends first, the higher receives first: a pair
        # of plain sends and receives, which NCCL runs on a communicator of
        # the two (a batched exchange would need every member of the set
        # in the group's first call).
        if me < partner:
            dist.send(vec, peer[partner], group=g.group)
            dist.recv(other, peer[partner], group=g.group)
            vec = adasum_combine(vec, other)
        else:
            dist.recv(other, peer[partner], group=g.group)
            dist.send(vec, peer[partner], group=g.group)
            vec = adasum_combine(other, vec)
        d *= 2
    if fold >= 0:
        dist.send(vec, peer[fold], group=g.group)
    return vec.reshape(buf.shape).to(buf.dtype)


# ---------------------------------------------------------------------------
# One function per op type: (works, per-name outputs)
# ---------------------------------------------------------------------------

Launched = Tuple[list, List[Output]]


def allreduce(resp: Response, held: List[Optional[torch.Tensor]],
              g: DataGroup, mark=None) -> Launched:
    """One flat buffer for every name of a (fused) response through
    :func:`fusion.start_bucket`; the caller divides an Average and
    applies its postscale.  Adasum responses hold one name.  ``mark``
    is called once the buffer is filled."""
    parts = [t if t is not None else _zeros(n, resp.dtype, g)
             for t, n in zip(held, resp.first_dims)]
    if resp.arg == ReduceOp.ADASUM:
        out = adasum(to_wire(parts[0], g.device), g)
        return [], [lambda: on_caller(out)]
    work, finish = fusion.start_bucket(parts, g.group, g.size,
                                       op=TORCH_OPS[resp.arg],
                                       device=g.device, after_copy=mark)
    once = _Once(finish)
    return [work], [lambda i=i: on_caller(once.part(i))
                    for i in range(len(parts))]


def allgather(resp: Response, t: Optional[torch.Tensor],
              g: DataGroup) -> Launched:
    """Every member's tensor, flat, padded to the largest member's
    element count for the fixed-size gather, cut back by the caller;
    the output is ``(flat, counts)``, counts in elements per member."""
    counts = list(resp.first_dims)
    most = max(counts) if counts else 0
    buf = _zeros(most, resp.dtype, g)
    if t is not None and t.numel():
        buf[:t.numel()] = t.reshape(-1).to(g.device)
    out = buf.new_empty(most * g.size)
    work = None
    if out.numel():
        calls.add()
        if g.nccl:
            work = dist.all_gather_into_tensor(out, buf, group=g.group,
                                               async_op=True)
        else:
            work = dist.all_gather(list(out.chunk(g.size)), buf,
                                   group=g.group, async_op=True)

    def output():
        flat = on_caller(out)
        if any(c != most for c in counts):
            flat = torch.cat([flat[i * most:i * most + c]
                              for i, c in enumerate(counts)])
        return flat, counts

    return [work], [output]


def broadcast(resp: Response, t: Optional[torch.Tensor],
              g: DataGroup) -> Launched:
    buf = (to_wire(t, g.device) if t is not None
           else _zeros(resp.first_dims[0], resp.dtype, g))
    work = None
    if buf.numel():
        calls.add()
        work = dist.broadcast(buf, src=g.peers[g.members.index(resp.arg)],
                              group=g.group, async_op=True)
    return [work], [lambda: on_caller(buf)]


def alltoall(resp: Response, t: Optional[torch.Tensor],
             g: DataGroup) -> Launched:
    """Flat blocks: with splits, the response's member x member matrix
    of element counts gives what this rank sends and receives; without,
    equal blocks.  The output is ``(flat, received)``, received in
    elements per source member."""
    n, pos = g.size, g.pos
    dims = resp.first_dims
    buf = (to_wire(t, g.device).reshape(-1) if t is not None
           else _zeros(dims[0], resp.dtype, g))
    if len(dims) == n * n:
        send = [dims[pos * n + d] for d in range(n)]
        recv = [dims[s * n + pos] for s in range(n)]
    else:
        send = recv = [dims[0] // n] * n
    out = buf.new_empty(sum(recv))
    work = None
    if buf.numel() or out.numel():
        calls.add()
        work = dist.all_to_all_single(out, buf, output_split_sizes=recv,
                                      input_split_sizes=send, group=g.group,
                                      async_op=True)
    return [work], [lambda: (on_caller(out), recv)]


def reducescatter(resp: Response, t: Optional[torch.Tensor],
                  g: DataGroup) -> Launched:
    """Sum, then this member's block of the flat buffer; the caller
    divides an Average."""
    buf = (to_wire(t, g.device).reshape(-1) if t is not None
           else _zeros(resp.first_dims[0], resp.dtype, g))
    k = buf.numel() // g.size
    work = None
    if g.nccl:
        out = buf.new_empty(k)
        if buf.numel():
            calls.add()
            work = dist.reduce_scatter_tensor(out, buf, op=dist.ReduceOp.SUM,
                                              group=g.group, async_op=True)
    else:
        # gloo's reduce-scatter is missing from some torch releases: the
        # sum of the whole buffer, then this member's block.
        out = buf[g.pos * k:(g.pos + 1) * k]
        if buf.numel():
            calls.add()
            work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g.group,
                                   async_op=True)
    return [work], [lambda: on_caller(out)]
