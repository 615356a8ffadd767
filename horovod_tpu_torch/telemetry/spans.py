"""Per-rank distributed span recorder (``HOROVOD_TRACE``).

Counterpart of ``horovod_tpu/telemetry/spans.py``; its documents are
merged by the reference launcher's ``trace_merge`` and ``critical_path``
unchanged.  Every collective gets a correlation key ``(trace_id,
span_id)`` that is the same on every rank without any wire change: the
collective-schedule contract (which ``HOROVOD_SCHEDULE_CHECK`` verifies)
has every rank submit the same names in the same order, so the pair
(tensor name, occurrence index of that name) names one step of one
collective everywhere.  ``trace_id`` is FNV-1a of the name xor the mixed
index, bit for bit the reference's.

The recorder is a bounded buffer under one lock taken only when tracing
is on.  Off, ``telemetry.spans()`` returns None and a call site costs a
call and an identity test::

    sp = telemetry.spans()
    if sp is not None:
        sp.record(name, "wait", seq, t0, t1, nbytes)

``HOROVOD_TRACE_SAMPLE=N`` keeps every Nth occurrence of each name, a
pure function of the index, so every rank keeps the same steps.
Timestamps are ``time.monotonic()`` seconds; the launcher corrects
cross-host skew with the offset each rank measures at exit
(``runner/rpc.py:measure_clock_offset``), carried as ``clock_offset``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Dict, List, Optional, Tuple

SCHEMA = "horovod_tpu.trace.v1"

# Request-scoped spans (serving, RPC) have no occurrence stream — they
# correlate by unique name alone and use this fixed sequence number.
REQUEST_SEQ = 0

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
# Fibonacci multiplier spreads small sequence numbers across the id
# space so trace ids never collide on low bits alone.
_SEQ_MIX = 0x9E3779B97F4A7C15


def trace_id(name: str, seq: int) -> str:
    """Deterministic 64-bit correlation id for occurrence ``seq`` of
    tensor ``name`` — identical on every rank by construction (FNV-1a of
    the name xor the mixed occurrence index)."""
    h = _FNV_OFFSET
    for b in name.encode("utf-8", "replace"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return f"{(h ^ ((seq * _SEQ_MIX) & _MASK64)) & _MASK64:016x}"


class SpanRecorder:
    """Bounded, thread-safe span buffer for one rank."""

    def __init__(self, rank: int = 0, sample: int = 1,
                 capacity: int = 65536):
        self.rank = rank
        self.sample = max(int(sample), 1)
        self.capacity = max(int(capacity), 1)
        self.dropped = 0
        self.clock_offset: Optional[float] = None
        self.clock_rtt: Optional[float] = None
        self._lock = threading.Lock()
        self._seq: Dict[str, int] = {}
        # (name, phase, seq, t0, t1, bytes) tuples; dict-ified at export.
        self._spans: List[Tuple[str, str, int, float, float, int]] = []
        self._closed = False

    # -- hot path ----------------------------------------------------------

    def next_seq(self, name: str) -> int:
        """Allocate the next occurrence index for ``name`` (0-based).
        Counts EVERY occurrence, sampled or not, so the stream stays
        aligned with the other ranks' counters."""
        with self._lock:
            s = self._seq.get(name, -1) + 1
            self._seq[name] = s
        return s

    def sampled(self, seq: int) -> bool:
        """Record occurrence ``seq``?  Pure function of the index, hence
        identical on every rank (HOROVOD_TRACE_SAMPLE=N keeps seq%N==0)."""
        return self.sample <= 1 or (seq % self.sample) == 0

    def record(self, name: str, phase: str, seq: int, t0: float,
               t1: float, nbytes: int = 0) -> None:
        """Append one span; silently dropped (and counted) past
        capacity, after close, or when the occurrence is sampled out."""
        if self._closed or not self.sampled(seq):
            return
        with self._lock:
            if self._closed:
                return
            if len(self._spans) >= self.capacity:
                self.dropped += 1
                return
            self._spans.append((str(name), str(phase), int(seq),
                                float(t0), float(t1), int(nbytes)))

    def event(self, name: str, phase: str, t0: float, t1: float,
              nbytes: int = 0) -> None:
        """Request-scoped span: correlated by unique name alone (serving
        requests, RPC rounds), recorded under :data:`REQUEST_SEQ`."""
        self.record(name, phase, REQUEST_SEQ, t0, t1, nbytes)

    # -- export ------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def document(self) -> dict:
        """The rank's span log (``horovod_tpu.trace.v1``): every span
        with its computed correlation ids, plus the attribution and
        clock metadata the merger needs."""
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped
        spans.sort(key=lambda s: s[3])
        return {
            "schema": SCHEMA,
            "rank": self.rank,
            "size": int(os.environ.get("HOROVOD_SIZE", "1") or 1),
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "clock": "monotonic",
            # launcher_clock - rank_clock seconds (None = unmeasured;
            # merger treats it as 0, which is exact for same-host jobs).
            "clock_offset": self.clock_offset,
            "clock_sync_rtt": self.clock_rtt,
            "sample": self.sample,
            "dropped": dropped,
            "spans": [
                {"name": n, "phase": ph, "seq": sq,
                 "trace_id": trace_id(n, sq), "span_id": i,
                 "t0": t0, "t1": t1, "bytes": b}
                for i, (n, ph, sq, t0, t1, b) in enumerate(spans)
            ],
        }

    def close(self) -> None:
        with self._lock:
            self._closed = True


# ---------------------------------------------------------------------------
# At-exit export (mirrors the metrics exporter's push + file fallback)
# ---------------------------------------------------------------------------

def rank_log_path(dir_path: str, rank: int) -> str:
    return os.path.join(dir_path, f"spans.rank{rank}.json")


def write_rank_log(recorder: SpanRecorder, dir_path: str) -> str:
    """Atomic per-rank span-log dump (the launcher's fallback source for
    ranks whose RPC push never arrived)."""
    os.makedirs(dir_path, exist_ok=True)
    path = rank_log_path(dir_path, recorder.rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(recorder.document(), f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def push_to_launcher(recorder: SpanRecorder, endpoint: str) -> bool:
    """Push the span log to ``hvdrun``'s trace collector over the
    authenticated RPC plane.  Collection failures are swallowed — the
    file fallback (and the job's exit code) must survive a dead
    launcher."""
    try:
        from horovod_tpu_torch.runner import rpc
        addr, port = endpoint.rsplit(":", 1)
        key = rpc.job_key_bytes(os.environ.get("HOROVOD_SECRET_KEY"))
        reply = rpc.rpc_call(addr, int(port),
                             {"kind": "trace_report",
                              "report": recorder.document()},
                             key, timeout=10.0, retries=1)
        return bool(isinstance(reply, dict) and reply.get("ok"))
    except Exception:
        return False


def export_at_exit(recorder: SpanRecorder) -> None:
    """The recorder's exit hook: measure this rank's clock offset
    against the launcher (RTT-halving handshake), mirror the recorder
    totals into telemetry counters, push the span log over RPC, and
    always leave the file fallback behind."""
    from horovod_tpu_torch import telemetry

    endpoint = os.environ.get("HOROVOD_TRACE_RPC", "").strip()
    if endpoint:
        try:
            from horovod_tpu_torch.runner import rpc
            addr, port = endpoint.rsplit(":", 1)
            key = rpc.job_key_bytes(os.environ.get("HOROVOD_SECRET_KEY"))
            sync = rpc.measure_clock_offset(addr, int(port), key)
            if sync is not None:
                recorder.clock_offset, recorder.clock_rtt = sync
        except Exception:
            pass
    if telemetry.enabled():
        n = len(recorder)
        if n:
            telemetry.counter(
                "hvd_trace_spans_total",
                "Span records captured by this rank's trace recorder",
            ).inc(n)
        if recorder.dropped:
            telemetry.counter(
                "hvd_trace_spans_dropped_total",
                "Span records dropped at the recorder's capacity bound",
            ).inc(recorder.dropped)
    pushed = endpoint and push_to_launcher(recorder, endpoint)
    dir_path = os.environ.get("HOROVOD_TRACE_DIR", "").strip()
    if dir_path:
        try:
            write_rank_log(recorder, dir_path)
        except OSError:
            pass  # exit path: an unwritable target must not mask the rc
    elif not pushed:
        pass  # nowhere to export; the in-process document remains readable
    recorder.close()


def configured_recorder() -> Optional[SpanRecorder]:
    """Build a recorder from the environment, or None when tracing is
    off (the telemetry front door calls this once at configure time)."""
    enabled = os.environ.get("HOROVOD_TRACE", "").strip() not in (
        "", "0", "false")
    if not (enabled or os.environ.get("HOROVOD_TRACE_DIR", "").strip()
            or os.environ.get("HOROVOD_TRACE_RPC", "").strip()):
        return None
    try:
        sample = int(os.environ.get("HOROVOD_TRACE_SAMPLE", "1") or 1)
    except ValueError:
        sample = 1
    try:
        cap = int(os.environ.get("HOROVOD_TRACE_BUFFER", "65536") or 65536)
    except ValueError:
        cap = 65536
    return SpanRecorder(
        rank=int(os.environ.get("HOROVOD_RANK", "0") or 0),
        sample=sample, capacity=cap)


__all__ = ["SCHEMA", "REQUEST_SEQ", "SpanRecorder", "trace_id",
           "rank_log_path", "write_rank_log", "push_to_launcher",
           "export_at_exit", "configured_recorder"]
