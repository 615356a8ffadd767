"""This rank's submitted collectives.

Counterpart of ``horovod_tpu/native/cc/src/tensor_queue.cc``: the table
of submitted entries by name, the names to announce in the next cycle,
and the completion of each entry.  Submission is a short append under a
lock (it may run on autograd's device thread); the runtime's thread takes
the announcements each cycle and the entries of each response it
executes.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch.native.message import OpType, Request

# Error-message contract (reference horovod/common/common.h:155-158).
DUPLICATE_NAME_ERROR_FMT = (
    "Requested to %s a tensor with the same name as another tensor that is "
    "currently being processed.  If you want to request another tensor, use "
    "a different tensor name. Tensor name: %s"
)
SHUTDOWN_ERROR = (
    "Horovod has been shut down. This was caused by an exception on one "
    "of the ranks or an attempt to enqueue after shutdown.")


class TensorEntry:
    """One submitted collective: what it announces, the tensor it sends
    and, once the runtime has launched it, the work to wait on and the
    function that gives its raw result.

    ``ready`` is a CUDA event recorded on the submitter's stream after the
    tensor was produced; the runtime's stream waits on it.  ``done`` is
    recorded on the runtime's stream after the launch; the caller's
    stream waits on it (and on each work) before it reads the result.
    """

    def __init__(self, op_type: OpType, name: str,
                 tensor: Optional[torch.Tensor] = None, arg: int = 0,
                 set_id: int = 0, splits: Sequence[int] = ()):
        self.op_type = op_type
        self.name = name
        self.tensor = tensor
        self.arg = int(arg)
        self.set_id = int(set_id)
        self.splits = tuple(int(v) for v in splits)
        self.ready: Optional[torch.cuda.Event] = None
        if tensor is not None and tensor.is_cuda:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(tensor.device))
        self._launched = threading.Event()
        self.works: list = []
        self.output: Optional[Callable[[], object]] = None
        self.done_event: Optional[torch.cuda.Event] = None
        self.error: Optional[BaseException] = None
        # What a failed wait raises in place of the work's own error, or
        # None to keep it (the runtime sets it under a shrink policy: a
        # peer left).
        self.on_error: Optional[Callable[[BaseException],
                                         Optional[BaseException]]] = None
        # The eager-op deadline (HOROVOD_EAGER_OP_TIMEOUT): after
        # ``timeout`` seconds of waiting, ``result`` raises what
        # ``on_timeout(name, seconds)`` returns.  None waits for ever.
        self.timeout: Optional[float] = None
        self.on_timeout: Optional[Callable[[str, float],
                                           BaseException]] = None
        self.submitted_at = 0.0
        # With telemetry on, the runtime that records this entry's wait
        # (``op_done``/``op_failed``), when it was filed and its trace
        # occurrence; None costs a wait one identity test.
        self.telemetry = None
        self.enqueued_at = 0.0
        self.trace_seq = -1

    def request(self, rank: int) -> Request:
        t = self.tensor
        return Request(
            rank=rank, op_type=self.op_type, name=self.name,
            dtype=(str(t.dtype).removeprefix("torch.") if t is not None
                   else "int32"),
            arg=self.arg, set_id=self.set_id,
            shape=tuple(t.shape) if t is not None else (1,),
            splits=self.splits)

    # -- completion (runtime's thread) ---------------------------------------

    def launch(self, works, output, done_event=None) -> None:
        self.works = [w for w in works if w is not None]
        self.output = output
        self.done_event = done_event
        self._launched.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._launched.set()

    # -- completion (caller's thread) ----------------------------------------

    def done(self) -> bool:
        if not self._launched.is_set():
            return False
        if self.error is not None:
            return True
        return (all(w.is_completed() for w in self.works)
                and (self.done_event is None or self.done_event.query()))

    def _wait_bounded(self) -> None:
        """Poll :meth:`done` (never a blocking wait: on the card that is the
        works' ``is_completed`` and the launch event's ``query``) until it
        holds or the deadline passes: a brief spin for the common quick
        completion, then sleeps from 1 ms doubling to 50 ms (reference
        ``native/runtime.py:927-953``)."""
        for _ in range(200):
            if self.done():
                return
        start = time.monotonic()
        deadline = start + self.timeout
        sleep = 0.001
        while not self.done():
            now = time.monotonic()
            if now >= deadline:
                raise self.on_timeout(self.name, now - start)
            time.sleep(min(sleep, max(deadline - now, 0.001)))
            sleep = min(sleep * 2.0, 0.05)

    def result(self):
        """Wait for the collective and return its raw result; the caller's
        current stream is ordered after it.  Under a deadline the wait
        raises when it passes; the entry stays with the runtime, and its
        late result goes into buffers of the runtime's own (the data
        plane copies every input), never into a tensor of the caller."""
        hook = self.telemetry
        t_wait = time.monotonic() if hook is not None else 0.0
        if self.timeout is not None:
            self._wait_bounded()
        self._launched.wait()
        if self.error is not None:
            if hook is not None:
                hook.op_failed(self)
            raise self.error
        try:
            for w in self.works:
                w.wait()
        except Exception as exc:
            if hook is not None:
                hook.op_failed(self)
            changed = None if self.on_error is None else self.on_error(exc)
            if changed is None:
                raise
            raise changed from exc
        if self.done_event is not None:
            torch.cuda.current_stream().wait_event(self.done_event)
        if hook is not None:
            hook.op_done(self, t_wait, time.monotonic())
        return self.output()


class TensorQueue:
    def __init__(self):
        self._lock = threading.Lock()
        self._by_name: Dict[str, TensorEntry] = {}
        self._to_announce: List[TensorEntry] = []
        self._closed: Optional[BaseException] = None

    def add(self, entries: Sequence[TensorEntry], kind: str) -> None:
        """File ``entries`` together, or none of them: a name that is
        still being processed raises the reference's duplicate error."""
        with self._lock:
            if self._closed is not None:
                raise type(self._closed)(str(self._closed)) from self._closed
            seen = set()
            for e in entries:
                if e.name in self._by_name or e.name in seen:
                    raise ValueError(DUPLICATE_NAME_ERROR_FMT % (kind,
                                                                 e.name))
                seen.add(e.name)
            for e in entries:
                self._by_name[e.name] = e
            self._to_announce.extend(entries)

    def pop_announcements(self) -> List[TensorEntry]:
        with self._lock:
            out, self._to_announce = self._to_announce, []
        return out

    def take(self, names: Sequence[str], set_id: int) -> List[
            Tuple[int, TensorEntry]]:
        """Remove and return (position, entry) for the names of one
        response that this rank holds in that process set."""
        out = []
        with self._lock:
            for i, name in enumerate(names):
                e = self._by_name.get(name)
                if e is not None and e.set_id == set_id:
                    del self._by_name[name]
                    out.append((i, e))
        return out

    def num_pending(self) -> int:
        with self._lock:
            return len(self._by_name)

    def close(self, error: BaseException) -> None:
        """Refuse new entries and fail every pending one with ``error``."""
        with self._lock:
            self._closed = error
            pending = list(self._by_name.values())
            self._by_name.clear()
            self._to_announce = []
        for e in pending:
            e.fail(error)
