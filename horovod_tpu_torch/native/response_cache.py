"""The response cache: names negotiated before travel as one bit.

Counterpart of ``horovod_tpu/native/cc/src/response_cache.cc``.  Every
rank keeps a replica and updates it from the same response stream in the
same order, so a name has the same slot everywhere.  A rank whose request
equals its cached one announces the slot's bit instead of the request;
the coordinator expands the bit from its own replica.  A changed shape
(or any other parameter) misses the cache, is negotiated in full again
and refreshes its slot in place.  When the cache is full, the oldest
slot is evicted, the same one on every rank.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

from horovod_tpu_torch.native.message import OpType, Request, Response


class _Slot:
    __slots__ = ("params", "resp")

    def __init__(self, params: Request, resp: Response):
        self.params = params
        self.resp = resp


class ResponseCache:
    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 0)
        self.clear()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def clear(self) -> None:
        self._slots: List[Optional[_Slot]] = [None] * self.capacity
        self._fifo: collections.deque = collections.deque()
        self._by_name: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._by_name)

    def lookup(self, r: Request) -> int:
        """The slot of ``r``'s name when its parameters are unchanged,
        else -1."""
        slot = self._by_name.get(r.name, -1) if self.enabled else -1
        if slot >= 0 and self._slots[slot].params.same_params(r):
            return slot
        return -1

    def put(self, params: Request, resp: Response) -> None:
        if not self.enabled:
            return
        slot = self._by_name.get(params.name)
        if slot is None:
            if len(self._by_name) < self.capacity:
                slot = self._slots.index(None)
            else:
                slot = self._fifo.popleft()
                del self._by_name[self._slots[slot].params.name]
            self._by_name[params.name] = slot
            self._fifo.append(slot)
        self._slots[slot] = _Slot(params, resp)

    def expand(self, bits: int, rank: int) -> List[Request]:
        """The full requests behind ``rank``'s bits.  This replica holds
        this rank's own dimensions; an allgather's first dimension and an
        alltoall's splits differ by rank and come from the cached
        response instead (``response_cache.cc`` ``Expand``)."""
        out = []
        slot = 0
        while bits:
            if bits & 1 and slot < self.capacity and self._slots[slot]:
                s = self._slots[slot]
                r = dataclasses.replace(s.params, rank=rank)
                trailing = 1
                for d in s.params.shape[1:]:
                    trailing *= d
                dims = s.resp.first_dims
                if (r.op_type == OpType.ALLGATHER and r.shape and trailing
                        and rank < len(dims)):
                    r.shape = (dims[rank] // trailing,) + r.shape[1:]
                elif (r.op_type == OpType.ALLTOALL and r.splits and r.shape
                      and trailing):
                    n = len(r.splits)
                    if len(dims) == n * n and rank < n:
                        r.splits = tuple(dims[rank * n + d] // trailing
                                         for d in range(n))
                        r.shape = (sum(r.splits),) + r.shape[1:]
                out.append(r)
            bits >>= 1
            slot += 1
        return out
