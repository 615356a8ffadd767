"""The eager plane's Chrome-tracing timeline (``HOROVOD_EAGER_TIMELINE``).

Counterpart of ``horovod_tpu/telemetry/eager_timeline.py``.  Every rank,
not only the coordinator, writes per-tensor SUBMIT / WAIT / FINISH rows
from the Python boundary of its ops, in the dialect of the native
timeline (``horovod_tpu_torch/native/timeline.py``, which stays rank 0's
view of the control plane): the file opens with ``[``, one event object
per line, a ``tid`` per tensor announced by ``thread_name`` metadata,
microseconds from the writer's epoch.

* The trailing ``]`` is optional, as in Chrome's own tracer: a file cut
  by a crashed rank still loads (``close()`` writes the terminator).
* ``pid`` is the Horovod rank.
* Phases: ``X`` (complete, with ``dur``) for SUBMIT and WAIT, ``i``
  (instant) for FINISH.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional


class EagerTimelineWriter:
    """Append-only, thread-safe Chrome-tracing writer for eager ops."""

    def __init__(self, path: str, rank: int = 0):
        self.path = path
        self.rank = rank
        self._lock = threading.Lock()
        self._tids: Dict[str, int] = {}
        self._next_tid = 1
        self._epoch = time.monotonic()
        self._file = open(path, "w", buffering=1)
        self._closed = False
        self._file.write("[\n")
        self._emit({"name": "process_name", "ph": "M", "pid": rank,
                    "args": {"name": f"eager rank {rank}"}})

    # -- low level ---------------------------------------------------------

    def _emit(self, event: dict) -> None:
        # Caller holds the lock (or is the constructor, pre-sharing).
        self._file.write(json.dumps(event) + ",\n")

    def _tid_for(self, tensor: str) -> int:
        tid = self._tids.get(tensor)
        if tid is None:
            tid = self._next_tid
            self._next_tid += 1
            self._tids[tensor] = tid
            self._emit({"name": "thread_name", "ph": "M", "pid": self.rank,
                        "tid": tid, "args": {"name": tensor}})
        return tid

    def _us(self, t_monotonic: float) -> int:
        return int((t_monotonic - self._epoch) * 1e6)

    # -- op rows -----------------------------------------------------------

    def span(self, tensor: str, name: str, t0: float, t1: float,
             args: Optional[dict] = None) -> None:
        """A complete (``ph=X``) event on the tensor's row; ``t0``/``t1``
        are ``time.monotonic()`` seconds."""
        if self._closed:
            return
        with self._lock:
            if self._closed:
                return
            tid = self._tid_for(tensor)
            ev = {"name": name, "ph": "X", "pid": self.rank, "tid": tid,
                  "ts": self._us(t0),
                  "dur": max(self._us(t1) - self._us(t0), 1)}
            if args:
                ev["args"] = args
            self._emit(ev)

    def instant(self, tensor: str, name: str, t: float,
                args: Optional[dict] = None) -> None:
        if self._closed:
            return
        with self._lock:
            if self._closed:
                return
            tid = self._tid_for(tensor)
            ev = {"name": name, "ph": "i", "pid": self.rank, "tid": tid,
                  "ts": self._us(t), "s": "t"}
            if args:
                ev["args"] = args
            self._emit(ev)

    def record_op(self, tensor: str, op: str, t_submit: float,
                  t_wait: float, t_done: float, nbytes: int = 0) -> None:
        """The canonical submit/wait/finish triple for one eager op.

        ``t_submit``: enqueue began; ``t_wait``: enqueue returned / wait
        began; ``t_done``: result available.  For a local (1-rank) op the
        three collapse — the SUBMIT span covers the whole computation.
        """
        upper = op.upper()
        self.span(tensor, f"SUBMIT_{upper}", t_submit, t_wait,
                  args={"op": op, "bytes": nbytes})
        if t_done > t_wait:
            self.span(tensor, f"WAIT_{upper}", t_wait, t_done)
        self.instant(tensor, "FINISH", t_done, args={"op": op})

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # Terminator matching the native writer's shutdown record
            # (timeline.cc writes a SHUTDOWN instant, then "]").
            self._file.write(json.dumps(
                {"name": "SHUTDOWN", "ph": "i", "pid": self.rank, "tid": 0,
                 "ts": self._us(time.monotonic()), "s": "g"}) + "\n]\n")
            self._file.close()


def per_rank_path(path: str) -> str:
    """De-conflict the artifact path in a multi-process job: each rank
    appends ``.rank<k>`` before the extension unless the caller (or the
    launcher) already embedded a rank marker."""
    rank = int(os.environ.get("HOROVOD_RANK", "0") or 0)
    size = int(os.environ.get("HOROVOD_SIZE", "1") or 1)
    if size <= 1 or f".rank{rank}" in os.path.basename(path):
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext or '.json'}"
