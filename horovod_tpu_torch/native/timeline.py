"""The control plane's timeline: a chrome-tracing record of every named
collective, and the thread that stamps when the card finished one.

Counterpart of ``horovod_tpu/native/cc/src/timeline.cc`` and
``include/timeline.h``.  Only rank 0 writes, to ``HOROVOD_TIMELINE``,
in the reference's dialect: the file opens with ``[``, holds one event
per line (a ``thread_name`` row per tensor, then ``B``/``E`` pairs and
``i`` markers, names JSON-escaped) and ends with a ``SHUTDOWN`` marker
and ``]``.  Per tensor: ``NEGOTIATE_<OP>`` from the cycle that
announced the name to the response that answered it, then ``<OP>``
around the execution with the activities inside it, and a
``CYCLE_START`` marker per cycle under ``HOROVOD_TIMELINE_MARK_CYCLES``.

The activities name what the port runs: ``NCCL_<OP>`` or ``GLOO_<OP>``
(``NCCL_ALLTOALLV`` with splits) where the reference writes
``TCP_<OP>``, on every name of a fused response, and
``MEMCPY_IN_FUSION_BUFFER`` while a fused response's tensors are copied
into one buffer.  The port reads each result out of that buffer as a
view, so there is no ``MEMCPY_OUT_FUSION_BUFFER``.

The runtime's thread only enqueues work on the card, so its clock says
nothing of when the card finished.  An event that ends with device work
carries a probe; :class:`Completions`, one thread, takes the events in
order and polls each probe until it holds.  On the card the probe is a
:class:`DeviceStamp`, a timing CUDA event recorded after the work, and
the event's time is the card's, put on the host clock by
:class:`DeviceClock`; on the CPU it is the works' ``is_completed``, and
the time is when the poll saw it.  The runtime's thread never
synchronizes a stream.  The autotuner takes the same stamps for its
scores.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Optional
from horovod_tpu_torch.utils.logging import get_logger

log = get_logger("horovod_tpu_torch.timeline")

Probe = Optional[Callable[[], bool]]

# How often a pending probe is polled, and how long a stopping thread
# waits for probes that never hold (a peer that died mid-collective).
POLL_S = 1e-4
DRAIN_S = 10.0


# A CUDA event's elapsed time is a float32 count of milliseconds: read
# from one fixed reference, stamps would step by about 2 us after 16 s of
# a run and by 1 ms after 2.3 hours, and a wire shorter than a step would
# read 0.  The clock moves its reference up to a stamp it reads once that
# stamp is this far past it, so a reading never spans more.
REBASE_MS = 1000.0


class DeviceClock:
    """The card's event clock on the host's: one timing event, waited for
    once, read with the host time just after (a few microseconds late);
    later stamps move the reference (see :data:`REBASE_MS`)."""

    def __init__(self, stream):
        import torch
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        event.synchronize()
        self.reference = (event, time.perf_counter())

    def stamp(self, stream) -> "DeviceStamp":
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return DeviceStamp(ev, self)

    def seconds(self, event) -> float:
        """The host time at which the card passed ``event``, an event the
        card has passed.  Read from the completions thread, in order."""
        ref, host = self.reference
        ms = ref.elapsed_time(event)
        at = host + ms / 1e3
        if ms > REBASE_MS:
            self.reference = (event, at)
        return at


class DeviceStamp:
    """A probe that holds once the card passed ``event``, and the host
    time at which it did."""

    def __init__(self, event, clock: DeviceClock):
        self.event, self.clock = event, clock

    def __call__(self) -> bool:
        return self.event.query()

    def seconds(self) -> float:
        return self.clock.seconds(self.event)


class AllOf:
    """A probe that holds when all of ``probes`` hold; its time is the
    last of theirs where each has one."""

    def __init__(self, probes):
        self.probes = list(probes)
        if all(hasattr(p, "seconds") for p in self.probes):
            self.seconds = lambda: max(p.seconds() for p in self.probes)

    def __call__(self) -> bool:
        return all(p() for p in self.probes)


class Completions:
    """One thread that calls each queued ``fn(now)`` in order, once its
    probe holds (at once without one); ``now`` is ``time.perf_counter()``
    when the probe was seen to hold, or the time ``at`` given with it."""

    def __init__(self, on_idle: Optional[Callable[[], None]] = None):
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._stopping = False
        self.on_idle = on_idle
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="hvd-torch-completions")
        self.thread.start()

    def add(self, fn: Callable[[float], None], probe: Probe = None,
            at: Optional[float] = None) -> None:
        with self._cv:
            self._queue.append((probe, at, fn))
            self._cv.notify()

    def _held(self, probe: Probe, give_up: float) -> bool:
        try:
            if probe():
                return True
        except Exception:   # a failed work has completed too
            return True
        return self._stopping and time.perf_counter() >= give_up

    def _run(self) -> None:
        give_up = float("inf")
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    if self.on_idle is not None:
                        self.on_idle()
                    self._cv.wait()
                if not self._queue:
                    break
                if self._stopping and give_up == float("inf"):
                    give_up = time.perf_counter() + DRAIN_S
                probe, at, fn = self._queue[0]
            if probe is not None:
                while not self._held(probe, give_up):
                    time.sleep(POLL_S)
            now = at
            if now is None and hasattr(probe, "seconds"):
                try:
                    now = probe.seconds()
                except Exception:   # an event never reached
                    now = None
            if now is None:
                now = time.perf_counter()
            with self._cv:
                self._queue.popleft()
            try:
                fn(now)
            except Exception:   # an instrument must never stop the plane
                log.exception("horovod_tpu_torch: a completion callback "
                              "failed")
        if self.on_idle is not None:
            self.on_idle()

    def stop(self) -> None:
        """Run what is queued (giving up on probes after ``DRAIN_S``) and
        end the thread."""
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self.thread.join()


def _escape(s: str) -> str:
    return json.dumps(s, ensure_ascii=False)


class Timeline:
    """Rank 0's writer.  Every hook stamps its event now (or at ``at``,
    or when ``probe`` holds) and hands it to ``completions``, whose
    thread writes it."""

    def __init__(self, path: str, mark_cycles: bool,
                 completions: Completions):
        # Opening fails loudly: a timeline that was asked for and cannot
        # be written is an error, not a silent "off".
        self._file = open(path, "w")
        self._file.write("[\n")
        self.mark_cycles = mark_cycles
        self.completions = completions
        completions.on_idle = self._file.flush
        self.start_s = time.perf_counter()
        self._tids: dict = {}
        self._last_ts: dict = {}

    def _tid(self, tensor: str) -> int:
        tid = self._tids.get(tensor)
        if tid is None:
            tid = self._tids[tensor] = len(self._tids) + 1
            self._file.write(
                f'{{"name": "thread_name", "ph": "M", "pid": 0, "tid": {tid}'
                f', "args": {{"name": {_escape(tensor)}}}}},\n')
        return tid

    def _emit(self, ph: str, name: str, tensor: str, probe: Probe = None,
              at: Optional[float] = None, args: Optional[dict] = None
              ) -> None:
        if probe is None and at is None:
            at = time.perf_counter()

        def write(now: float) -> None:
            tid = self._tid(tensor) if tensor else 0
            # A tensor's events are stamped in order; a card time read a
            # few microseconds early must not step back before its B.
            ts = max(round((now - self.start_s) * 1e6, 3),
                     self._last_ts.get(tid, 0))
            if tid:
                self._last_ts[tid] = ts
            tail = ', "s": "g"' if ph == "i" else ""
            if args:
                tail += f', "args": {json.dumps(args)}'
            self._file.write(
                f'{{"name": {_escape(name)}, "ph": "{ph}", "pid": 0, '
                f'"tid": {tid}, "ts": {ts}{tail}}},\n')

        self.completions.add(write, probe, at)

    # -- the reference's hooks: NegotiateStart/End, then Start and
    # ActivityStart (both ``begin``), ActivityEnd and End (both ``end``) --

    def negotiate_start(self, tensor: str, op_name: str) -> None:
        self._emit("B", f"NEGOTIATE_{op_name.upper()}", tensor)

    def negotiate_end(self, tensor: str) -> None:
        self._emit("E", "", tensor)

    def begin(self, tensor: str, name: str, probe: Probe = None,
              at: Optional[float] = None) -> None:
        self._emit("B", name, tensor, probe, at)

    def end(self, tensor: str, probe: Probe = None,
            at: Optional[float] = None) -> None:
        self._emit("E", "", tensor, probe, at)

    def mark_cycle_start(self) -> None:
        if self.mark_cycles:
            self._emit("i", "CYCLE_START", "")

    def close(self) -> None:
        """Finish the file; call after ``completions`` has stopped.  The
        closing marker has no comma, so the file is one JSON list."""
        if self._file.closed:
            return
        self._file.write('{"name": "SHUTDOWN", "ph": "i", "pid": 0, '
                         '"tid": 0, "ts": 0, "s": "g"}\n]\n')
        self._file.close()
