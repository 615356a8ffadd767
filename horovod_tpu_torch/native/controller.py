"""The coordinator: which named collectives are ready, validated, in what
order, and fused how.

Counterpart of ``horovod_tpu/native/cc/src/controller.cc``: ``Ingest``
and ``IsReady`` (``:633-720``), the master cycle (``:480-631``),
``ConstructResponse``'s validation (``:889-1204``) and ``Fuse``
(``:1206``), with the reference's rules and error words.  Rank 0's
runtime feeds it every rank's :class:`RequestList` each cycle and
broadcasts the :class:`ResponseList` it returns; every rank then fuses
that list with :func:`fuse`, the same walk everywhere.

A name is ready when every rank has submitted it or joined; a process
set's name when every member has submitted it; a join or a process-set
registration when every rank has.  Names are scoped per process set.
Joins come last in a cycle, and a completed join clears the joined
state.  The stall inspector bounds a name that some rank never submits.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.native.message import (OP_NAMES, OpType, ReduceOp,
                                              Request, RequestList,
                                              Response, ResponseList)
from horovod_tpu_torch.native.response_cache import ResponseCache
from horovod_tpu_torch.native.stall_inspector import StallInspector

STALL_ERROR_FMT = (
    "Stalled collective: tensor %s exceeded "
    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS without being submitted on all "
    "ranks.")


def shape_str(shape: Sequence[int]) -> str:
    return "[" + ", ".join(str(d) for d in shape) + "]"


def num_elements(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@functools.lru_cache(maxsize=None)
def dtype_size(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


class _PendingName:
    """One name's submissions so far (``PendingTensor``)."""
    __slots__ = ("submitted", "requests", "count", "queued", "first_seen")

    def __init__(self, size: int, now: float):
        self.submitted = [False] * size
        self.requests: List[Request] = []
        self.count = 0
        self.queued = False
        self.first_seen = now


class Controller:
    def __init__(self, size: int, cache: Optional[ResponseCache],
                 stall: StallInspector):
        self.size = size
        self.cache = cache
        self.stall = stall
        self.table: Dict[Tuple[int, str], _PendingName] = {}
        self.ready: collections.deque = collections.deque()
        self.joined = [False] * size
        self.shutdown_ranks = [False] * size
        self.process_sets: Dict[int, List[int]] = {}
        self.next_set_id = 1

    # -- groups -------------------------------------------------------------

    def _group(self, set_id: int) -> Tuple[Optional[List[int]], int]:
        """(members or None, group size): the global set is every rank,
        an unknown set counts as the world (``ResolveGroup``)."""
        if set_id == 0:
            return list(range(self.size)), self.size
        members = self.process_sets.get(set_id)
        return members, len(members) if members else self.size

    # -- readiness ------------------------------------------------------------

    def is_ready(self, p: _PendingName, op: OpType) -> bool:
        if op in (OpType.JOIN, OpType.PROCESS_SET):
            return p.count == self.size
        if p.count == 0:
            return False
        set_id = p.requests[0].set_id
        if set_id != 0:
            members = self.process_sets.get(set_id)
            if members is None:
                return True    # answered with an error
            return all(p.submitted[r] for r in members)
        return all(s or j for s, j in zip(p.submitted, self.joined))

    def ingest(self, rl: RequestList, from_rank: int) -> None:
        if rl.shutdown:
            self.shutdown_ranks[from_rank] = True
        expanded = []
        if self.cache is not None and rl.cache_hits:
            expanded = self.cache.expand(rl.cache_hits, from_rank)
        join_arrived = False
        for req in list(rl.requests) + expanded:
            if req.op_type == OpType.JOIN and not self.joined[from_rank]:
                self.joined[from_rank] = True
                join_arrived = True
            key = (req.set_id, req.name)
            p = self.table.get(key)
            if p is None:
                p = self.table[key] = _PendingName(self.size,
                                                   self.stall.clock())
            if p.submitted[from_rank]:
                continue
            p.submitted[from_rank] = True
            p.requests.append(req)
            p.count += 1
            if not p.queued and self.is_ready(p, req.op_type):
                p.queued = True
                self.ready.append(key)
        if join_arrived:
            # A join may complete every name that waited only on the
            # joined rank: queue them in first-seen order.
            newly = []
            for key, p in self.table.items():
                if (not p.queued and p.requests
                        and self.is_ready(p, p.requests[0].op_type)):
                    p.queued = True
                    newly.append((p.first_seen, key))
            self.ready.extend(key for _, key in sorted(newly))

    # -- the master cycle -------------------------------------------------------

    def cycle(self, lists: Sequence[RequestList]) -> ResponseList:
        """Ingest every rank's list (rank order), answer every ready name,
        joins last, then the stalled ones; set the shutdown bit once
        every rank has asked for it."""
        for rank, rl in enumerate(lists):
            self.ingest(rl, rank)
        out = ResponseList()
        joins = []
        while self.ready:
            key = self.ready.popleft()
            resp = self.construct_response(key)
            del self.table[key]
            if not resp.error and resp.op_type == OpType.JOIN:
                joins.append(resp)
            else:
                out.responses.append(resp)
        out.responses += joins
        if joins:
            self.joined = [False] * self.size
        stalled = []
        for key, p in self.table.items():
            name = p.requests[0].name if p.requests else key[1]
            expected = list(p.submitted)
            if p.requests and p.requests[0].set_id != 0:
                members = self.process_sets.get(p.requests[0].set_id)
                if members is not None:
                    expected = [s or r not in members
                                for r, s in enumerate(expected)]
            if self.stall.check(name, expected, p.first_seen):
                stalled.append(key)
        for key in stalled:
            p = self.table.pop(key)
            first = p.requests[0] if p.requests else None
            name = first.name if first else key[1]
            out.responses.append(Response(
                op_type=first.op_type if first else OpType.ALLREDUCE,
                names=[name], set_id=first.set_id if first else 0,
                error=True, error_message=STALL_ERROR_FMT % name))
        out.shutdown = all(self.shutdown_ranks)
        return out

    # -- validation -------------------------------------------------------------

    def construct_response(self, key) -> Response:
        p = self.table[key]
        first = p.requests[0]
        name = first.name
        resp = Response(op_type=first.op_type, names=[name],
                        dtype=first.dtype, arg=first.arg,
                        set_id=first.set_id, cacheable=p.count == self.size)

        def fail(msg: str) -> Response:
            resp.error = True
            resp.error_message = msg
            return resp

        op_name = OP_NAMES[first.op_type]
        if first.op_type == OpType.PROCESS_SET:
            for r in p.requests:
                if r.splits != first.splits:
                    return fail(
                        f"Mismatched process-set registration: rank "
                        f"{r.rank} proposed a different member list than "
                        f"rank {first.rank} ({name}).")
            if not first.splits:
                return fail(f"Process set must have at least one member "
                            f"({name}).")
            prev = -1
            for v in first.splits:
                if v < 0 or v >= self.size:
                    return fail(f"Process-set member rank {v} out of range "
                                f"for job size {self.size} ({name}).")
                if v <= prev:
                    return fail(f"Process-set member ranks must be strictly "
                                f"increasing ({name}).")
                prev = v
            members = list(first.splits)
            resp.first_dims = members
            for set_id, have in self.process_sets.items():
                if have == members:
                    resp.arg = set_id
                    return resp
            resp.arg = self.next_set_id
            self.process_sets[resp.arg] = members
            self.next_set_id += 1
            return resp

        if first.set_id != 0:
            members = self.process_sets.get(first.set_id)
            if members is None:
                return fail(
                    f"Unknown process set id {first.set_id} for tensor "
                    f"{name} (register it with add_process_set on every "
                    f"rank first).")
            # Only members hold entries, so only they could refresh the
            # cache replicas: a subset response is never cacheable.
            resp.cacheable = False
            for r in p.requests:
                if r.rank not in members:
                    return fail(
                        f"Rank {r.rank} submitted tensor {name} for process "
                        f"set {first.set_id} but is not a member of it.")

        for r in p.requests:
            if r.op_type != first.op_type:
                return fail(
                    f"Mismatched collective operations: rank {first.rank} "
                    f"requested {op_name} but rank {r.rank} requested "
                    f"{OP_NAMES[r.op_type]} for tensor {name}.")
            if r.dtype != first.dtype:
                return fail(
                    f"Mismatched data types: rank {first.rank} has "
                    f"{first.dtype} but rank {r.rank} has {r.dtype} for "
                    f"tensor {name}.")
            if r.arg != first.arg:
                if first.op_type == OpType.BROADCAST:
                    return fail(f"Mismatched broadcast root ranks for tensor "
                                f"{name}.")
                return fail(f"Mismatched reduction operations for tensor "
                            f"{name}.")

        any_joined = any(self.joined)
        op = first.op_type
        if op == OpType.ALLREDUCE:
            resp.first_dims = [num_elements(first.shape)]
            rop = first.arg
            if any_joined and rop not in (ReduceOp.SUM, ReduceOp.ADASUM):
                why = ("Average would divide the partial sum by the full "
                       "world size" if rop == ReduceOp.AVERAGE
                       else "zeros corrupt Min/Max")
                return fail(
                    f"Allreduce with joined ranks supports only the Sum "
                    f"reduction (joined ranks contribute zeros; {why}) for "
                    f"tensor {name}.")
        if op in (OpType.ALLREDUCE, OpType.BROADCAST, OpType.BARRIER,
                  OpType.JOIN):
            for r in p.requests:
                if r.shape != first.shape:
                    return fail(
                        f"Mismatched {op_name} tensor shapes: rank "
                        f"{first.rank} has {shape_str(first.shape)} but "
                        f"rank {r.rank} has {shape_str(r.shape)} for tensor "
                        f"{name}.")
            if op == OpType.BROADCAST:
                if first.arg < 0 or first.arg >= self.size:
                    return fail(
                        f"Broadcast root rank {first.arg} out of range for "
                        f"job size {self.size} (tensor {name}).")
                if first.set_id != 0 and first.arg not in (
                        self.process_sets.get(first.set_id) or ()):
                    return fail(
                        f"Broadcast root rank {first.arg} is not a member of "
                        f"process set {first.set_id} (tensor {name}).")
                if self.joined[first.arg]:
                    return fail(
                        f"Broadcast root rank {first.arg} has already joined "
                        f"and holds no data for tensor {name}.")
                resp.first_dims = [num_elements(first.shape)]
            if op == OpType.JOIN:
                resp.arg = p.requests[-1].rank
        elif op == OpType.ALLGATHER:
            for r in p.requests:
                if len(r.shape) != len(first.shape) or not r.shape:
                    return fail(f"Mismatched allgather tensor ranks for "
                                f"tensor {name}.")
                if r.shape[1:] != first.shape[1:]:
                    return fail(
                        f"Mismatched allgather trailing dimensions: rank "
                        f"{first.rank} has {shape_str(first.shape)} but rank "
                        f"{r.rank} has {shape_str(r.shape)} for tensor "
                        f"{name}.")
            members, gsize = self._group(first.set_id)
            resp.first_dims = [0] * gsize
            for r in p.requests:
                if members is not None and r.rank in members:
                    resp.first_dims[members.index(r.rank)] = num_elements(
                        r.shape)
        elif op in (OpType.ALLTOALL, OpType.REDUCESCATTER):
            if any_joined and op == OpType.ALLTOALL:
                return fail(f"Alltoall is not supported while any rank has "
                            f"joined (tensor {name}).")
            if op == OpType.REDUCESCATTER and first.arg == ReduceOp.ADASUM:
                return fail(f"Reducescatter does not support the Adasum "
                            f"reduction (tensor {name}).")
            if (any_joined and op == OpType.REDUCESCATTER
                    and first.arg != ReduceOp.SUM):
                return fail(f"Reducescatter with joined ranks supports only "
                            f"the Sum reduction (tensor {name}).")
            members, gsize = self._group(first.set_id)
            if op == OpType.ALLTOALL and any(r.splits for r in p.requests):
                for r in p.requests:
                    if len(r.splits) != gsize:
                        return fail(
                            f"Mismatched alltoall splits: rank {r.rank} "
                            f"supplied {len(r.splits)} splits for group size "
                            f"{gsize} (tensor {name}; all ranks must pass "
                            f"splits, or none).")
                    if (not r.shape or len(r.shape) != len(first.shape)
                            or r.shape[1:] != first.shape[1:]):
                        return fail(
                            f"Mismatched alltoall trailing dimensions: rank "
                            f"{first.rank} has {shape_str(first.shape)} but "
                            f"rank {r.rank} has {shape_str(r.shape)} for "
                            f"tensor {name}.")
                    if any(v < 0 for v in r.splits):
                        return fail(f"Negative alltoall split on rank "
                                    f"{r.rank} (tensor {name}).")
                    if sum(r.splits) != r.shape[0]:
                        return fail(
                            f"Alltoall splits of rank {r.rank} sum to "
                            f"{sum(r.splits)} but its first dimension is "
                            f"{r.shape[0]} (tensor {name}).")
                trailing = num_elements(first.shape[1:])
                resp.first_dims = [0] * (gsize * gsize)
                for r in p.requests:
                    if members is None or r.rank not in members:
                        continue
                    pos = members.index(r.rank)
                    for dst in range(gsize):
                        resp.first_dims[pos * gsize + dst] = (
                            r.splits[dst] * trailing)
                return resp
            for r in p.requests:
                if r.shape != first.shape or r.splits:
                    return fail(f"Mismatched {op_name} tensor shapes for "
                                f"tensor {name}.")
            if not first.shape or first.shape[0] % gsize:
                dim = str(first.shape[0]) if first.shape else "scalar"
                return fail(
                    f"{op_name} requires the first dimension ({dim}) to be "
                    f"divisible by the group size {gsize} (tensor {name}).")
            resp.first_dims = [num_elements(first.shape)]
        return resp


def fuse(responses: Sequence[Response], threshold: int) -> List[Response]:
    """Batch consecutive allreduces of one dtype, reduce op and process
    set into one response up to ``threshold`` bytes (``Fuse``,
    ``controller.cc:1206``); ``first_dims`` stays per name.  Adasum never
    fuses: its projection is per tensor.  The scale factors never reach
    the buffer (the caller scales before it submits and after the
    result, each tensor by its own factors), so they do not split it."""
    fused: List[Response] = []
    for r in responses:
        fusible = (not r.error and r.op_type == OpType.ALLREDUCE
                   and r.arg != ReduceOp.ADASUM)
        if fusible and fused:
            prev = fused[-1]
            if (not prev.error and prev.op_type == OpType.ALLREDUCE
                    and prev.set_id == r.set_id and prev.dtype == r.dtype
                    and prev.arg == r.arg
                    and len(prev.first_dims) == len(prev.names)
                    and len(r.first_dims) == 1
                    and (sum(prev.first_dims) + r.first_dims[0])
                    * dtype_size(r.dtype) <= threshold):
                prev.names.append(r.names[0])
                prev.first_dims.append(r.first_dims[0])
                prev.cacheable = prev.cacheable and r.cacheable
                continue
        fused.append(dataclasses.replace(r, names=list(r.names),
                                         first_dims=list(r.first_dims)))
    return fused
