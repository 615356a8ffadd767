"""What the ranks tell the coordinator each cycle, and its answer.

Counterpart of ``horovod_tpu/native/cc/include/message.h`` and
``src/message.cc``.  The reference frames these by hand for its TCP
controller; here they are plain objects that the runtime pickles over
its gloo control group.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class OpType(enum.IntEnum):
    """Collective kinds (``hvd_common.h:77-88``)."""
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ALLTOALL = 3
    REDUCESCATTER = 4
    BARRIER = 5
    JOIN = 6
    PROCESS_SET = 7


# OpTypeName (hvd_common.h:90-102): the words of the error messages.
OP_NAMES = {OpType.ALLREDUCE: "allreduce", OpType.ALLGATHER: "allgather",
            OpType.BROADCAST: "broadcast", OpType.ALLTOALL: "alltoall",
            OpType.REDUCESCATTER: "reducescatter",
            OpType.BARRIER: "barrier", OpType.JOIN: "join",
            OpType.PROCESS_SET: "process_set"}


class ReduceOp(enum.IntEnum):
    """Reduction codes (``hvd_common.h:105-111``); Average travels as a
    Sum and the caller divides."""
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4


@dataclass
class Request:
    """One rank's announcement of one named collective (``message.h``
    ``Request``).  ``dtype`` is numpy's name of the tensor's dtype as it
    goes on the wire (after the prescale, as the reference's caller
    scales before it submits); ``arg`` is the reduce-op code or the
    broadcast root; ``splits`` are an alltoall's rows per destination,
    or a process-set registration's proposed members."""
    rank: int
    op_type: OpType
    name: str
    dtype: str = "int32"
    arg: int = 0
    set_id: int = 0
    shape: Tuple[int, ...] = ()
    splits: Tuple[int, ...] = ()

    def same_params(self, other: "Request") -> bool:
        """Everything but the rank agrees (``response_cache.cc``
        ``SameParams``)."""
        return (self.op_type == other.op_type and self.dtype == other.dtype
                and self.arg == other.arg and self.set_id == other.set_id
                and self.shape == other.shape
                and self.splits == other.splits)


@dataclass
class RequestList:
    """Everything one rank tells the coordinator in one cycle: its new
    requests, the cache slots of the names it announces by bit (an int
    used as a bit set), and whether it wants to shut down.

    Tree coordination: a host leader sends its host's lists upstream as
    one, whose requests carry their ranks; ``shutdown_ranks`` and
    ``member_cache_hits`` (``(rank, bits)`` pairs) carry the list-level
    state that a flat exchange tells by which rank sent the list.

    The schedule verifier (``HOROVOD_SCHEDULE_CHECK``): ``sched`` holds
    this rank's submissions of the cycle as they were made, before the
    cache turned any into bits; ``sched_seq`` and ``sched_digest`` count
    and fold (order-insensitively) every global-set submission since
    init or this rank's last join."""
    requests: List[Request] = field(default_factory=list)
    cache_hits: int = 0
    shutdown: bool = False
    shutdown_ranks: List[int] = field(default_factory=list)
    member_cache_hits: List[Tuple[int, int]] = field(default_factory=list)
    sched: List[Request] = field(default_factory=list)
    sched_seq: int = 0
    sched_digest: int = 0


# The schedule digest (``message.h`` ``kSchedDigestInit``, ``SchedFold``
# in ``message.cc:89``): each record is hashed on its own with FNV-1a and
# XORed into the running digest, so equal multisets of submissions give
# equal digests whatever their order.  The port folds a dtype's name
# where the reference folds its enum code: the digests are compared only
# among the port's ranks.
SCHED_DIGEST_INIT = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def sched_fold(digest: int, r: Request) -> int:
    h = SCHED_DIGEST_INIT

    def word(v: int) -> None:
        nonlocal h
        v &= _MASK64
        for i in range(8):
            h = ((h ^ ((v >> (i * 8)) & 0xFF)) * _FNV_PRIME) & _MASK64

    def text(t: str) -> None:
        nonlocal h
        for b in t.encode():
            h = ((h ^ b) * _FNV_PRIME) & _MASK64

    word(int(r.op_type))
    text(r.dtype)
    word(r.arg)
    word(r.set_id)
    text(r.name)
    # The first dimension of an allgather or alltoall may differ by rank.
    start = 1 if r.op_type in (OpType.ALLGATHER, OpType.ALLTOALL) else 0
    word(len(r.shape))
    for d in r.shape[start:]:
        word(d)
    word((1 if r.splits else 0) if r.op_type == OpType.ALLTOALL
         else len(r.splits))
    return digest ^ h


@dataclass
class Response:
    """The coordinator's verdict on one name, or on several fused
    allreduces (``message.h`` ``Response``).  ``first_dims``: per name,
    the element count of an allreduce, broadcast or reducescatter (what
    a joined rank's zeros are sized by); per member, the element count
    of an allgather; an alltoall's member x member matrix of element
    counts, source-major, when splits were given; a process set's
    members.  For a process set ``arg`` is its id, for a join the last
    rank to join."""
    op_type: OpType
    names: List[str]
    dtype: str = "int32"
    arg: int = 0
    set_id: int = 0
    error: bool = False
    error_message: str = ""
    cacheable: bool = True
    first_dims: List[int] = field(default_factory=list)


@dataclass
class TunedParams:
    """What rank 0's autotuner attaches to every response list while it
    runs (``autotune.h`` ``TunedParams``, the dimensions the port has;
    the two routing booleans are ``message.cc:193-194``, ``:243-244``):
    every rank applies them before it fuses that list, the booleans only
    where the two-level plane is available."""
    tuning: bool = False
    cycle_time_ms: float = 1.0
    fusion_threshold: int = 64 * 1024 * 1024
    cache_enabled: bool = True
    hier_allreduce: bool = False
    hier_allgather: bool = False


@dataclass
class ResponseList:
    """The coordinator's answer of one cycle.  A non-empty
    ``abort_message`` is the schedule verifier's report of a divergence:
    every rank fails its pending work with it and stops."""
    responses: List[Response] = field(default_factory=list)
    shutdown: bool = False
    params: Optional[TunedParams] = None
    abort_message: str = ""
