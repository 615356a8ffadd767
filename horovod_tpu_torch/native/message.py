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
    used as a bit set), and whether it wants to shut down."""
    requests: List[Request] = field(default_factory=list)
    cache_hits: int = 0
    shutdown: bool = False


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
    runs (``autotune.h`` ``TunedParams``, the dimensions the port has):
    every rank applies them before it fuses that list."""
    tuning: bool = False
    cycle_time_ms: float = 1.0
    fusion_threshold: int = 64 * 1024 * 1024
    cache_enabled: bool = True


@dataclass
class ResponseList:
    responses: List[Response] = field(default_factory=list)
    shutdown: bool = False
    params: Optional[TunedParams] = None
