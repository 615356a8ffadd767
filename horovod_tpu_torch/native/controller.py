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

Under ``HOROVOD_SCHEDULE_CHECK`` the coordinator also verifies every
rank's submission stream (``VerifySchedule``, ``CheckScheduleProgress``
and ``ResetSchedule``, ``controller.cc:721-877``): records are matched
by name, first in first out, per process set.  A record whose fields
differ from its match poisons that name's response, so the report rides
the normal per-tensor error; when every rank holds a record no peer
matched and nothing new arrives for the quiet window
(``HOROVOD_SCHEDULE_CHECK_QUIET_SECONDS``), the cycle answers with an
abort naming each rank's unmatched call.  A rank's join ends its stream
and suspends the detector until the join completes.  In tree mode
(``tree=True``) a list may hold several ranks' requests, each
attributed by its stamped rank.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.native.message import (OP_NAMES, OpType, ReduceOp,
                                              Request, RequestList,
                                              Response, ResponseList)
from horovod_tpu_torch.native.response_cache import ResponseCache
from horovod_tpu_torch.native.stall_inspector import StallInspector

log = logging.getLogger("horovod_tpu_torch.controller")

STALL_ERROR_FMT = (
    "Stalled collective: tensor %s exceeded "
    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS without being submitted on all "
    "ranks.")
# Appended to the stall error while the schedule check is off.
STALL_SCHEDULE_HINT = (
    " Rerun with HOROVOD_SCHEDULE_CHECK=1 to pinpoint the first diverging "
    "submission (rank, call index, field).")
HVDLINT_HINT = "run `python -m tools.hvdlint` to locate the rank-divergent"


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


def sched_describe(r: Request) -> str:
    """One line for a submission record (``SchedDescribe``)."""
    out = (f"{OP_NAMES[r.op_type]}('{r.name}', {r.dtype}, "
           f"shape={shape_str(r.shape)}")
    if r.op_type == OpType.BROADCAST:
        out += f", root={r.arg}"
    if r.splits:
        out += f", splits={shape_str(r.splits)}"
    return out + ")"


def sched_mismatch(a: Request, b: Request) -> str:
    """The first field in which two records of one name differ, or ""
    (``SchedMismatch``): fields that may differ by rank (an allgather's
    or alltoall's first dimension, alltoall split values) are not
    compared."""
    if a.op_type != b.op_type:
        return "operation type"
    if a.name != b.name:
        return "tensor name"
    if a.dtype != b.dtype:
        return "dtype"
    if a.arg != b.arg:
        return ("root rank" if a.op_type == OpType.BROADCAST
                else "reduce-op argument")
    if a.op_type in (OpType.ALLGATHER, OpType.ALLTOALL):
        if len(a.shape) != len(b.shape):
            return "tensor rank (ndims)"
        if a.shape[1:] != b.shape[1:]:
            return "non-first shape dims"
        if a.op_type == OpType.ALLTOALL and (not a.splits) != (not b.splits):
            return "splits presence"
    elif a.op_type == OpType.PROCESS_SET:
        if a.splits != b.splits:
            return "process-set member list"
    elif a.shape != b.shape:
        return "shape"
    return ""


class _SchedRef:
    """A record waiting for the other participants' (``SchedRef``)."""
    __slots__ = ("req", "owner", "idx", "seen", "seen_count")

    def __init__(self, req: Request, owner: int, idx: int, size: int):
        self.req, self.owner, self.idx = req, owner, idx
        self.seen = [False] * size
        self.seen[owner] = True
        self.seen_count = 1


class Controller:
    def __init__(self, size: int, cache: Optional[ResponseCache],
                 stall: StallInspector, schedule_check: bool = False,
                 sched_quiet_s: float = 2.0, tree: bool = False,
                 clock=time.monotonic):
        self.size = size
        self.cache = cache
        self.stall = stall
        self.tree = tree
        self.schedule_check = schedule_check
        self.sched_quiet_s = sched_quiet_s
        self.sched_clock = clock
        self.sched_abort = ""
        self.reset_schedule()
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
        # A leader's list names its shutdown ranks and its members' cache
        # bits explicitly (``Ingest``, ``controller.cc:657-682``).
        for r in rl.shutdown_ranks:
            if 0 <= r < self.size:
                self.shutdown_ranks[r] = True
        expanded = []
        if self.cache is not None and rl.cache_hits:
            expanded = self.cache.expand(rl.cache_hits, from_rank)
        if self.cache is not None:
            for r, bits in rl.member_cache_hits:
                if 0 <= r < self.size:
                    expanded += self.cache.expand(bits, r)
        join_arrived = False
        for req in list(rl.requests) + expanded:
            # Flat mode attributes by sender; a tree list holds several
            # ranks' requests, each stamped with its rank.
            src = from_rank
            if self.tree and 0 <= req.rank < self.size:
                src = req.rank
            if req.op_type == OpType.JOIN and not self.joined[src]:
                self.joined[src] = True
                join_arrived = True
            key = (req.set_id, req.name)
            p = self.table.get(key)
            if p is None:
                p = self.table[key] = _PendingName(self.size,
                                                   self.stall.clock())
            if p.submitted[src]:
                continue
            p.submitted[src] = True
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

    def cycle(self, lists: Sequence[RequestList],
                  ranks: Optional[Sequence[int]] = None) -> ResponseList:
        """Ingest every list (rank order; ``ranks`` names each list's
        sender when they are not 0, 1, ...), answer every ready name,
        joins last, then the stalled ones; set the shutdown bit once
        every rank has asked for it.  Under the schedule check a
        divergence found this cycle answers with its report alone."""
        for rank, rl in zip(ranks if ranks is not None else range(
                len(lists)), lists):
            # Verify before ingesting: a diverged submission is reported,
            # never negotiated.
            if self.schedule_check:
                self.verify_schedule(rl, rank)
            self.ingest(rl, rank)
        out = ResponseList()
        if self.schedule_check:
            self.check_schedule_progress()
            if self.sched_abort:
                log.error("%s", self.sched_abort)
                out.abort_message = self.sched_abort
                return out
        joins = []
        while self.ready:
            key = self.ready.popleft()
            resp = self.construct_response(key)
            if self.schedule_check and key in self.sched_poison:
                resp.error = True
                resp.cacheable = False
                poison = self.sched_poison.pop(key)
                resp.error_message = (resp.error_message + " " + poison
                                      if resp.error_message else poison)
            del self.table[key]
            if not resp.error and resp.op_type == OpType.JOIN:
                joins.append(resp)
            else:
                out.responses.append(resp)
        out.responses += joins
        if joins:
            self.joined = [False] * self.size
            # The schedule streams start again with the join's epoch.
            if self.schedule_check:
                self.reset_schedule()
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
            message = STALL_ERROR_FMT % name
            if not self.schedule_check:
                message += STALL_SCHEDULE_HINT
            out.responses.append(Response(
                op_type=first.op_type if first else OpType.ALLREDUCE,
                names=[name], set_id=first.set_id if first else 0,
                error=True, error_message=message))
        out.shutdown = all(self.shutdown_ranks)
        return out

    # -- the schedule verifier ------------------------------------------------

    def reset_schedule(self) -> None:
        """``ResetSchedule`` (``controller.cc:877``)."""
        # set id -> name -> records waiting for a match, oldest first;
        # set id -> each rank's next call index.
        self.sched_streams: Dict[int, Dict[str, List[_SchedRef]]] = {}
        self.sched_next_idx: Dict[int, List[int]] = {}
        self.sched_poison: Dict[Tuple[int, str], str] = {}
        self.sched_joined = [False] * self.size
        self.sched_unmatched = [0] * self.size
        self.sched_seq_seen = [0] * self.size
        self.sched_digest_seen = [0] * self.size
        self.sched_epoch_mixed = False
        self.sched_reported = False
        self.sched_cycle_records = False
        self.sched_quiet_since = self.sched_clock()

    def verify_schedule(self, rl: RequestList, from_rank: int) -> None:
        """Match ``from_rank``'s records of this cycle
        (``VerifySchedule``, ``controller.cc:721-798``)."""
        # A join travels in the requests, never in the records: it ends
        # the rank's stream and suspends the detector until the epoch
        # turns over.
        for r in rl.requests:
            if r.op_type == OpType.JOIN and not self.sched_joined[from_rank]:
                self.sched_joined[from_rank] = True
                self.sched_epoch_mixed = True
        if rl.sched:
            self.sched_cycle_records = True
        for req in rl.sched:
            by_name = self.sched_streams.setdefault(req.set_id, {})
            nexts = self.sched_next_idx.setdefault(req.set_id,
                                                   [0] * self.size)
            idx = nexts[from_rank]
            nexts[from_rank] += 1
            q = by_name.setdefault(req.name, [])
            # The oldest record of this name that this rank has not
            # matched yet (first in, first out).
            ref = next((x for x in q if not x.seen[from_rank]), None)
            if ref is None:
                ref = _SchedRef(req, from_rank, idx, self.size)
                q.append(ref)
            else:
                field_ = sched_mismatch(ref.req, req)
                key = (req.set_id, req.name)
                if field_ and key not in self.sched_poison:
                    where = (f" of process set {req.set_id}"
                             if req.set_id != 0 else "")
                    self.sched_poison[key] = (
                        f"HOROVOD_SCHEDULE_CHECK: collective schedule "
                        f"divergence at call #{ref.idx}{where}: rank "
                        f"{ref.owner} submitted {sched_describe(ref.req)} "
                        f"but rank {from_rank} (call #{idx}) submitted "
                        f"{sched_describe(req)} -- mismatched field: "
                        f"{field_}. Every rank must submit each named "
                        f"collective with matching ops, dtypes and "
                        f"arguments; {HVDLINT_HINT} call site.")
                    self.sched_reported = True
                ref.seen[from_rank] = True
                ref.seen_count += 1
            self.sched_unmatched[from_rank] += 1
            # Complete once every participant has contributed.
            if ref.seen_count >= self._group(req.set_id)[1]:
                for r2 in range(self.size):
                    if ref.seen[r2]:
                        self.sched_unmatched[r2] -= 1
                q.remove(ref)
                if not q:
                    del by_name[req.name]
        self.sched_seq_seen[from_rank] = rl.sched_seq
        self.sched_digest_seen[from_rank] = rl.sched_digest

    def check_schedule_progress(self) -> None:
        """The quiescence detector and the digest backstop
        (``CheckScheduleProgress``, ``controller.cc:800-875``)."""
        now = self.sched_clock()
        stuck = (not self.sched_cycle_records and not self.sched_epoch_mixed
                 and all(u > 0 for u in self.sched_unmatched))
        if not stuck:
            self.sched_quiet_since = now
        elif (not self.sched_abort
              and now - self.sched_quiet_since >= self.sched_quiet_s):
            parts = []
            for set_id, by_name in self.sched_streams.items():
                members = self._group(set_id)[0] or range(self.size)
                for refs in by_name.values():
                    for ref in refs:
                        if len(parts) >= 4:
                            break
                        where = (f" of process set {set_id}" if set_id
                                 else "")
                        missing = "".join(f" {m}" for m in members
                                          if not ref.seen[m])
                        parts.append(
                            f"rank {ref.owner} submitted "
                            f"{sched_describe(ref.req)} at call "
                            f"#{ref.idx}{where}, never matched by "
                            f"rank(s){missing}")
            self.sched_abort = (
                f"HOROVOD_SCHEDULE_CHECK: collective schedule divergence: "
                f"every rank is blocked on a collective no peer submitted "
                f"(job quiet for {self.sched_quiet_s:g}s)"
                + "".join((": " if i == 0 else "; ") + p
                          for i, p in enumerate(parts))
                + f". Every rank must submit the same set of named "
                f"collectives; {HVDLINT_HINT} call site (window: "
                f"HOROVOD_SCHEDULE_CHECK_QUIET_SECONDS).")
        self.sched_cycle_records = False
        # Once shutdown is agreed, every rank's set-0 multiset must match;
        # a warning only (abandoned async handles are leaky, not wrong).
        if (not self.sched_abort and not self.sched_epoch_mixed
                and not self.sched_reported and all(self.shutdown_ranks)):
            for r in range(1, self.size):
                if (self.sched_seq_seen[r] == self.sched_seq_seen[0]
                        and self.sched_digest_seen[r]
                        == self.sched_digest_seen[0]):
                    continue
                log.warning(
                    "HOROVOD_SCHEDULE_CHECK: schedule digests differ at "
                    "shutdown: rank 0 folded %d submissions (digest 0x%x) "
                    "but rank %d folded %d (digest 0x%x) -- the ranks did "
                    "not submit the same set of collectives (e.g. "
                    "abandoned async handles).", self.sched_seq_seen[0],
                    self.sched_digest_seen[0], r, self.sched_seq_seen[r],
                    self.sched_digest_seen[r])
                break

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
