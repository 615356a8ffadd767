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

The two-level plane (``HierarchicalAllreduce`` and
``HierarchicalAllgather``, ``data_plane.cc:974-976``, ``:1015-1076``,
``:1146-1238``) runs on a :class:`Hierarchy`: the local group of this
rank's host and the cross group of the ranks at the same local position
on every host, made from a homogeneous block mapping (rank = host *
local_size + local_rank) that every rank agreed on at ``init``
(:func:`agree_hierarchy`, ``operations.cc:661-737``).  The allreduce is a
local reduce-scatter, an all-reduce of each rank's chunk across hosts
and a local all-gather, so the cross links carry each byte once per host
instead of once per rank; the allgather exchanges each rank's block
across hosts first, then fans the per-host columns out locally.  The
runtime routes only the global set's fused allreduce and allgather
through it, at or above the agreed threshold, identically on every rank.
The counters are the reference's (``runtime.py:252-256``): payload bytes
per level (an allreduce books the whole tensor locally and its chunk
across hosts, so summed over the ranks the cross bytes are the flat
plane's over ``local_size``; an allgather books its sends), host seconds
per level (on the card the time to issue a phase, not its device time),
and the ops of each path.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import config, telemetry
from horovod_tpu_torch.native.message import ReduceOp, Response
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops._build import CallCounter
from horovod_tpu_torch.utils.logging import get_logger

log = get_logger("horovod_tpu_torch.runtime")

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
    fusion.record_buckets("eager", parts, [range(len(parts))])
    fusion.record_collective_bytes(
        "allreduce", "none", sum(t.numel() * t.element_size() for t in parts),
        level="flat", plane="eager")
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


# ---------------------------------------------------------------------------
# The two-level plane
# ---------------------------------------------------------------------------

# The reference's native counters (``runtime.py:252-256``), by symbol.
HIER_COUNTERS = ("hier_local_bytes", "hier_cross_bytes", "hier_local_us",
                 "hier_cross_us", "hier_allreduce_ops",
                 "flat_allreduce_bytes", "flat_allreduce_ops",
                 "hier_ag_local_bytes", "hier_ag_cross_bytes", "hier_ag_ops")

_BYTES_HELP = ("Per-level payload bytes of eager hierarchical collectives "
               "(allreduce: logical payload; allgather: wire sends)")
_SECS_HELP = "Per-level wall seconds inside eager hierarchical ops"


class Hierarchy:
    """The agreed two-level plane of a job: ``local_size`` ranks on each
    of ``nhosts`` hosts in blocks, this rank's ``local`` and ``cross``
    groups, the agreed ``threshold`` in bytes, and whether each op is
    routed through it now (``allreduce``, ``allgather``: the agreement's
    answer, then the tuner's).  ``counters`` holds the reference's ten
    counters, the flat path's included."""

    def __init__(self, rank: int, local_size: int, nhosts: int, local,
                 cross, threshold: int, allreduce: bool, allgather: bool):
        self.rank = rank
        self.local_size, self.nhosts = local_size, nhosts
        self.local_rank = rank % local_size
        self.local, self.cross = local, cross
        self.threshold = int(threshold)
        self.allreduce, self.allgather = allreduce, allgather
        self.counters: Dict[str, int] = dict.fromkeys(HIER_COUNTERS, 0)


def agree_hierarchy(rank: int, size: int, local_rank: int, local_size: int,
                    group, backend: str) -> Optional[Hierarchy]:
    """The bootstrap agreement (``operations.cc:661-737``), run by every
    rank whatever its environment says, so that the bootstrap traffic
    stays in step: one MIN all-reduce over ``group`` agrees eight values
    (each flag's local_size view and its negation, the threshold and
    its negation, the topology's availability and its negation).  An op
    is enabled only where every rank asked for it on the same block
    mapping; the threshold is the smallest any rank set, so a payload
    between two ranks' thresholds routes the same way everywhere.  Rank
    0 logs the reference's two warnings.  Returns the plane when the
    topology is available (the tuner may turn it on later), creating
    every host's local group and every cross group in the same order
    on every rank, else None."""
    # This rank's view: a homogeneous block mapping, with more than one
    # rank a host and more than one host.
    topo_ok = (local_size > 1 and size > local_size
               and size % local_size == 0
               and local_rank == rank % local_size)
    ok = (local_size if config.env_bool("HOROVOD_HIERARCHICAL_ALLREDUCE")
          and topo_ok else 0)
    ok_ag = (local_size
             if config.env_bool("HOROVOD_HIERARCHICAL_ALLGATHER")
             and topo_ok else 0)
    thr = config.env_int("HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD")
    topo = local_size if topo_ok else 0
    agree = torch.tensor([ok, -ok, ok_ag, -ok_ag, thr, -thr, topo, -topo],
                         dtype=torch.int64)
    dist.all_reduce(agree, op=dist.ReduceOp.MIN, group=group)
    mn, mx, mn_ag, mx_ag, thr, thr_max, topo_mn, topo_mx = (
        int(v) * (1 if i % 2 == 0 else -1)
        for i, v in enumerate(agree.tolist()))
    enable = mn == mx and mn > 1
    enable_ag = mn_ag == mx_ag and mn_ag > 1
    available = topo_mn == topo_mx and topo_mn > 1
    if rank == 0:
        if available and thr != thr_max:
            log.warning("HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD differs "
                        "across ranks (min/max %d/%d); using the agreed "
                        "min %d", thr, thr_max, thr)
        if not enable and mx > 0:
            log.warning("HOROVOD_HIERARCHICAL_ALLREDUCE requested but the "
                        "topology is not a homogeneous block mapping or the "
                        "flag is not set on every rank (min/max local_size "
                        "view %d/%d); using the flat ring", mn, mx)
        if not enable_ag and mx_ag > 0:
            log.warning("HOROVOD_HIERARCHICAL_ALLGATHER requested but the "
                        "topology is not a homogeneous block mapping or the "
                        "flag is not set on every rank (min/max local_size "
                        "view %d/%d); using the flat exchange", mn_ag, mx_ag)
    if not available:
        return None
    ls, nhosts = local_size, size // local_size
    local = cross = None
    for h in range(nhosts):
        grp = dist.new_group([h * ls + j for j in range(ls)], backend=backend)
        if rank // ls == h:
            local = grp
    for j in range(ls):
        grp = dist.new_group([h * ls + j for h in range(nhosts)],
                             backend=backend)
        if rank % ls == j:
            cross = grp
    return Hierarchy(rank, ls, nhosts, local, cross, thr, enable, enable_ag)


def chunk_offsets(count: int, parts: int) -> List[int]:
    """``ChunkOffsets`` (``data_plane.cc:701``): the first ``count %
    parts`` chunks take one element more."""
    base, rem = divmod(count, parts)
    off = [0]
    for c in range(parts):
        off.append(off[-1] + base + (1 if c < rem else 0))
    return off


def _count(name: str, help_text: str, value: float, **labels) -> None:
    if value and telemetry.enabled():
        telemetry.counter(name, help_text, **labels).inc(value)


def book_flat_allreduce(counters: Dict[str, int], nbytes: int) -> None:
    """A global allreduce that took the flat path: the baseline the
    cross bytes are held to."""
    counters["flat_allreduce_bytes"] += int(nbytes)
    counters["flat_allreduce_ops"] += 1
    _count("hvd_flat_allreduce_ops_total",
           "Eager allreduces that took the flat O(world) ring", 1)


def _gather(out: torch.Tensor, buf: torch.Tensor, group, nccl: bool,
            parts: int):
    calls.add()
    if nccl:
        return dist.all_gather_into_tensor(out, buf, group=group,
                                           async_op=True)
    return dist.all_gather(list(out.chunk(parts)), buf, group=group,
                           async_op=True)


def _wait(work) -> None:
    if work is not None:
        work.wait()


def hierarchical_allreduce(resp: Response, held: List[Optional[torch.Tensor]],
                           g: DataGroup, h: Hierarchy, mark=None) -> Launched:
    """The fused response's buffer through the three phases: its chunks
    (:func:`chunk_offsets` over the host's ranks, each padded to the
    largest in a row of its own) reduce-scattered over the host, this
    rank's chunk all-reduced across hosts, the chunks all-gathered over
    the host.  The output contract is :func:`allreduce`'s."""
    parts = [t if t is not None else _zeros(n, resp.dtype, g)
             for t, n in zip(held, resp.first_dims)]
    flat = torch.cat([t.reshape(-1).to(g.device) for t in parts])
    if mark is not None:
        mark()
    fusion.record_buckets("eager", parts, [range(len(parts))])
    ls, lr = h.local_size, h.local_rank
    n, esize = flat.numel(), flat.element_size()
    off = chunk_offsets(n, ls)
    width = off[1] - off[0]
    rows = flat.new_zeros(ls, width)
    for j in range(ls):
        rows[j, :off[j + 1] - off[j]] = flat[off[j]:off[j + 1]]
    op = TORCH_OPS[resp.arg]
    # One fused all-reduce, in three phases (each counts in ``calls``).
    fusion.allreduce_calls.add()
    t0 = time.perf_counter()
    # A. The host's reduce-scatter (gloo's is missing from some torch
    # releases: the sum of every row, then this rank's).
    calls.add()
    if g.nccl:
        mine = rows.new_empty(width)
        _wait(dist.reduce_scatter_tensor(mine, rows.reshape(-1), op=op,
                                         group=h.local, async_op=True))
    else:
        _wait(dist.all_reduce(rows, op=op, group=h.local, async_op=True))
        mine = rows[lr].clone()
    t1 = time.perf_counter()
    # B. This rank's chunk across hosts, among the ranks at its local
    # position (the same chunk index, so the same count, on every host).
    chunk = mine[:off[lr + 1] - off[lr]]
    if chunk.numel():
        calls.add()
        _wait(dist.all_reduce(chunk, op=op, group=h.cross, async_op=True))
    t2 = time.perf_counter()
    # C. The host's all-gather of the chunks.
    out = rows.new_empty(ls * width)
    work = _gather(out, mine, h.local, g.nccl, ls)
    t3 = time.perf_counter()
    nbytes, cross = n * esize, chunk.numel() * esize
    for key, v in (("hier_local_bytes", nbytes), ("hier_cross_bytes", cross),
                   ("hier_local_us", int((t1 - t0 + t3 - t2) * 1e6)),
                   ("hier_cross_us", int((t2 - t1) * 1e6)),
                   ("hier_allreduce_ops", 1)):
        h.counters[key] += v
    _count("hvd_hier_bytes_total", _BYTES_HELP, nbytes, level="local",
           op="allreduce")
    _count("hvd_hier_bytes_total", _BYTES_HELP, cross, level="cross",
           op="allreduce")
    _count("hvd_hier_seconds_total", _SECS_HELP, t1 - t0 + t3 - t2,
           level="local")
    _count("hvd_hier_seconds_total", _SECS_HELP, t2 - t1, level="cross")
    _count("hvd_hier_allreduce_ops_total",
           "Eager allreduces routed through the 2-level path", 1)
    fusion.record_collective_bytes("allreduce", "none", cross, level="cross",
                                   plane="eager")

    def finish() -> List[torch.Tensor]:
        full = out.view(ls, width)
        r = torch.cat([full[j, :off[j + 1] - off[j]] for j in range(ls)])
        return [p.view(t.shape) for p, t in
                zip(r.split([t.numel() for t in parts]), parts)]

    once = _Once(finish)
    return [work], [lambda i=i: on_caller(once.part(i))
                    for i in range(len(parts))]


def hierarchical_allgather(resp: Response, t: Optional[torch.Tensor],
                           g: DataGroup, h: Hierarchy) -> Launched:
    """Every rank's block (padded to the largest, as :func:`allgather`'s)
    across hosts among the ranks at this local position, then the
    per-host columns over the host; the output contract is
    :func:`allgather`'s."""
    counts = list(resp.first_dims)
    most = max(counts) if counts else 0
    ls, nh = h.local_size, h.nhosts
    buf = _zeros(most, resp.dtype, g)
    if t is not None and t.numel():
        buf[:t.numel()] = t.reshape(-1).to(g.device)
    esize = buf.element_size()
    col = buf.new_empty(nh * most)
    out = buf.new_empty(ls * nh * most)
    work = None
    if out.numel():
        _wait(_gather(col, buf, h.cross, g.nccl, nh))
        work = _gather(out, col, h.local, g.nccl, ls)
    mine = counts[h.rank] * esize
    column = sum(counts[k * ls + h.local_rank] for k in range(nh)) * esize
    h.counters["hier_ag_cross_bytes"] += mine * (nh - 1)
    h.counters["hier_ag_local_bytes"] += column * (ls - 1)
    h.counters["hier_ag_ops"] += 1
    _count("hvd_hier_bytes_total", _BYTES_HELP, column * (ls - 1),
           level="local", op="allgather")
    _count("hvd_hier_bytes_total", _BYTES_HELP, mine * (nh - 1),
           level="cross", op="allgather")
    _count("hvd_hier_allgather_ops_total",
           "Eager allgathers routed through the 2-level path", 1)
    fusion.record_collective_bytes("allgather", "none", mine * (nh - 1),
                                   level="cross", plane="eager")

    def output():
        # [local position, host, block] -> rank order (host, position).
        flat = on_caller(out).view(ls, nh, most).transpose(0, 1).reshape(-1)
        if any(c != most for c in counts):
            flat = torch.cat([flat[i * most:i * most + c]
                              for i, c in enumerate(counts)])
        return flat, counts

    return [work], [output]
