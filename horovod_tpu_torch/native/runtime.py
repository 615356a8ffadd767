"""The background runtime: negotiate by name, fuse, launch.

Counterpart of the reference's background loop
(``horovod_tpu/native/cc/src/operations.cc`` ``BackgroundThread`` and
``ExecuteResponse``, behind ``horovod_tpu/native/runtime.py``).  Every
eager ``hvd.*`` collective becomes a :class:`TensorEntry` in this rank's
:class:`TensorQueue`.  One thread per process runs lock-step cycles, at
most one every ``HOROVOD_CYCLE_TIME`` ms (at once while entries wait):

1. take the entries submitted since the last cycle and turn them into
   requests, or into response-cache bits for names negotiated before;
2. exchange them over the control group, a gloo group of its own: rank 0
   gathers every rank's list, runs the :class:`Controller` and broadcasts
   its :class:`ResponseList` (at size 1 there is nothing to exchange);
3. refresh the cache, fuse the list (the same walk on every rank) and
   launch each response on its data group, in that order.

The data groups are the runtime's own (``dist.new_group``: a communicator
no other thread issues onto), one for the job and one per process set,
NCCL on the card and gloo when the caller asked for the CPU.  On the card
the thread runs on its own stream, which waits on each entry's ready
event; the caller's stream waits on the collective and on the thread's
stream before it reads a result.

A rank that has joined takes part in every global collective it holds no
entry for, with zeros of the response's sizes.  An error response fails
its names with ``RuntimeError(<message>)`` and the runtime goes on.  If
the thread dies (an exchange fails because a peer left, or anything
else raises), every pending and later entry fails with that error:
nothing falls back to another route.
"""

from __future__ import annotations

import datetime
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import config
from horovod_tpu_torch.native import data_plane
from horovod_tpu_torch.native.controller import Controller, fuse
from horovod_tpu_torch.native.message import (OpType, RequestList,
                                              Response, ResponseList)
from horovod_tpu_torch.native.response_cache import ResponseCache
from horovod_tpu_torch.native.stall_inspector import StallInspector
from horovod_tpu_torch.native.tensor_queue import (SHUTDOWN_ERROR,
                                                   TensorEntry, TensorQueue)
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops._build import CallCounter

log = logging.getLogger("horovod_tpu_torch.runtime")

# One count per entry submitted to any runtime of this process: the
# direct path (fused_psum, the train steps) never adds to it.
requests = CallCounter("runtime.requests")

# How long shutdown waits for every rank to agree before it gives up on
# the thread (a peer that never shuts down, or one that died).
SHUTDOWN_TIMEOUT_S = 30.0
# The control group's timeout: every rank's thread cycles all the time,
# whatever its main thread does, so an exchange that waits this long
# means a peer's runtime is gone; the exchange then raises.
CONTROL_TIMEOUT = datetime.timedelta(seconds=60)


class Runtime:
    """This process's control plane over ``ctrl_group`` (gloo) and
    ``data_group``, for hvd rank ``rank`` of ``size``.  ``global_ranks``
    maps hvd ranks to ``torch.distributed`` ranks."""

    def __init__(self, rank: int, size: int, ctrl_group, data_group,
                 global_ranks: Sequence[int], device: torch.device):
        self.rank, self.size = rank, size
        self.device = device
        self.ctrl_group = ctrl_group
        self.global_ranks = list(global_ranks)
        self.queue = TensorQueue()
        self.cache = ResponseCache(config.cache_capacity())
        self.fusion_threshold = fusion.fusion_threshold_bytes()
        self.cycle_time_s = config.cycle_time_ms() / 1000.0
        self.controller = Controller(size, self.cache, StallInspector(
            config.stall_check_seconds(), config.stall_shutdown_seconds()))
        self.groups: Dict[int, data_plane.DataGroup] = {
            0: data_plane.DataGroup(data_group, range(size), rank,
                                    self.global_ranks, device)}
        self.joined = False
        self.cycles = 0
        self.cycle_seconds = 0.0
        self._shutting_down = False
        self._wake = threading.Event()
        self._stream = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="hvd-torch-runtime")

    # -- caller side ------------------------------------------------------------

    def start(self) -> None:
        self.thread.start()

    def submit(self, entries: Sequence[TensorEntry], kind: str) -> None:
        """File ``entries`` for the next cycle (a short append)."""
        self.queue.add(entries, kind)
        requests.count += len(entries)
        self._wake.set()

    def has_set(self, set_id: int) -> bool:
        return set_id in self.groups

    def stop(self, timeout: float = SHUTDOWN_TIMEOUT_S) -> None:
        """Ask every rank to shut down and wait for the thread to end;
        after ``timeout`` seconds give up on it (it is a daemon)."""
        self._shutting_down = True
        self._wake.set()
        self.thread.join(timeout)
        if self.thread.is_alive():
            log.warning("horovod_tpu_torch runtime: the ranks did not agree "
                        "to shut down within %s s; leaving the thread",
                        timeout)
            self.queue.close(RuntimeError(SHUTDOWN_ERROR))

    # -- the thread -------------------------------------------------------------

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                self._stream = torch.cuda.Stream(self.device)
            while not self._cycle():
                pass
            error: BaseException = RuntimeError(SHUTDOWN_ERROR)
        except Exception as e:  # the thread's boundary: fail, never hang
            log.exception("horovod_tpu_torch runtime: the control plane "
                          "stopped")
            error = RuntimeError(
                f"horovod_tpu_torch runtime stopped: {type(e).__name__}: "
                f"{e}")
        self.queue.close(error)

    def _cycle(self) -> bool:
        """One cycle; True once every rank has agreed to shut down."""
        start = time.perf_counter()
        mine = RequestList(shutdown=self._shutting_down)
        for e in self.queue.pop_announcements():
            r = e.request(self.rank)
            if r.op_type == OpType.JOIN:
                self.joined = True
            slot = self.cache.lookup(r)
            if slot >= 0:
                mine.cache_hits |= 1 << slot
            else:
                mine.requests.append(r)
        out = self._exchange(mine)
        for resp in fuse(out.responses, self.fusion_threshold):
            self._execute(resp)
        self.cycles += 1
        self.cycle_seconds += time.perf_counter() - start
        if out.shutdown:
            return True
        left = self.cycle_time_s - (time.perf_counter() - start)
        if left > 0 and self.queue.num_pending() == 0:
            self._wake.wait(left)
        self._wake.clear()
        return False

    def _exchange(self, mine: RequestList) -> ResponseList:
        if self.size == 1:
            return self.controller.cycle([mine])
        root = self.global_ranks[0]
        if self.rank == 0:
            lists = [None] * self.size
            dist.gather_object(mine, lists, dst=root, group=self.ctrl_group)
            box = [self.controller.cycle(lists)]
        else:
            dist.gather_object(mine, None, dst=root, group=self.ctrl_group)
            box = [None]
        dist.broadcast_object_list(box, src=root, group=self.ctrl_group)
        return box[0]

    def _execute(self, resp: Response) -> None:
        taken = self.queue.take(resp.names, resp.set_id)
        if resp.error:
            for _, e in taken:
                e.fail(RuntimeError(resp.error_message))
            return
        # Every rank puts the entries it holds for a cacheable response,
        # in the response order, so the replicas stay identical
        # (operations.cc:306-328).
        if resp.cacheable and resp.op_type not in (
                OpType.BARRIER, OpType.JOIN, OpType.PROCESS_SET):
            for _, e in taken:
                self.cache.put(e.request(self.rank), resp)
        if resp.op_type == OpType.PROCESS_SET:
            self._install_set(resp, [e for _, e in taken])
            return
        if resp.op_type == OpType.JOIN:
            self.joined = False
            for _, e in taken:
                e.launch([], lambda arg=resp.arg: arg)
            return
        if not taken and not (self.joined and resp.set_id == 0):
            return
        try:
            works, outputs, done = self._launch(resp, taken)
        except Exception as exc:  # a data group failed: fail these names
            log.exception("horovod_tpu_torch runtime: %s of %s failed",
                          resp.op_type.name.lower(), resp.names)
            for _, e in taken:
                e.fail(RuntimeError(f"{type(exc).__name__}: {exc}"))
            return
        for i, e in taken:
            e.launch(works, outputs[i], done)

    def _launch(self, resp: Response, taken):
        g = self.groups[resp.set_id]
        held: List[Optional[torch.Tensor]] = [None] * len(resp.names)
        for i, e in taken:
            held[i] = e.tensor
        if resp.op_type == OpType.BARRIER:   # the negotiation was the barrier
            return [], [lambda: None] * len(held), None
        op = getattr(data_plane, resp.op_type.name.lower())
        arg = held if resp.op_type == OpType.ALLREDUCE else held[0]
        if self._stream is None:
            works, outputs = op(resp, arg, g)
            return works, outputs, None
        with torch.cuda.stream(self._stream):
            for t in held:
                if t is not None and t.is_cuda:
                    t.record_stream(self._stream)
            for _, e in taken:
                if e.ready is not None:
                    self._stream.wait_event(e.ready)
            works, outputs = op(resp, arg, g)
            done = torch.cuda.Event()
            done.record(self._stream)
        return works, outputs, done

    def _install_set(self, resp: Response, taken: List[TensorEntry]) -> None:
        """Register the set the coordinator numbered, on every rank at the
        same point of the response stream: its data group (creating a
        group is collective over the whole job) and a cleared cache."""
        self.cache.clear()
        if resp.arg not in self.groups:
            members = list(resp.first_dims)
            group = dist.new_group([self.global_ranks[m] for m in members])
            self.groups[resp.arg] = data_plane.DataGroup(
                group, members, self.rank, self.global_ranks, self.device)
        for e in taken:
            e.launch([], lambda arg=resp.arg: arg)
