"""Merge per-rank span logs into one skew-corrected Chrome/Perfetto trace.

Counterpart of ``horovod_tpu/telemetry/trace_merge.py``, over the port's
own :mod:`horovod_tpu_torch.telemetry.spans` (whose schema keeps the
reference's name).  The launcher (``hvdrun --trace``) collects one
``horovod_tpu.trace.v1`` document per rank (RPC push, file fallback for
dead ranks) and this module folds them into a single
``chrome://tracing`` JSON file: ``pid``
is the rank, ``tid`` is a per-(rank, tensor) row announced with
``thread_name`` metadata, and every event carries the cross-rank
``trace_id`` in its args so clicking occurrence 17 of ``grad/dense0`` on
rank 0 finds the same id on rank 3.

Skew correction: each document carries ``clock_offset`` — launcher
monotonic clock minus the rank's, measured by the RTT-halving handshake
(``runner/rpc.py:measure_clock_offset``) — so adding it maps every
rank's timestamps onto the launcher's clock.  Same-host ranks share
CLOCK_MONOTONIC and measure ~0; cross-host offsets are bounded by half
the handshake RTT.

The loader side is deliberately tolerant: the eager/native timeline
dialect keeps the trailing ``]`` optional (a crashed rank truncates
mid-line), so :func:`tolerant_load_events` falls back to per-line
parsing when the strict ``json.load`` fails.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, Iterable, List, Optional

# importlib, not ``from horovod_tpu_torch.telemetry import spans``: the
# package's ``spans()`` accessor shadows the submodule attribute, so the
# attribute-based import form would return the function.
spans_mod = importlib.import_module("horovod_tpu_torch.telemetry.spans")


def tolerant_load_events(path: str) -> List[dict]:
    """Load a Chrome-tracing JSON file, surviving truncation.

    Accepts the three shapes in the wild: a plain event array, the
    ``{"traceEvents": [...]}`` wrapper, and the streaming one-object-
    per-line dialect of ``eager_timeline.py``/``timeline.cc`` (leading
    ``[``, trailing comma per line, terminator optional).  A final line
    cut mid-object is dropped, not fatal.
    """
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, dict):
            return list(doc.get("traceEvents", []))
        return list(doc)
    except ValueError:
        pass
    events: List[dict] = []
    for line in text.splitlines():
        line = line.strip().rstrip(",")
        if not line or line in ("[", "]"):
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            continue   # truncated tail of a crashed writer
        if isinstance(ev, dict):
            events.append(ev)
    return events


def spans_doc_to_events(doc: dict, apply_offset: bool = True,
                        tid_base: Optional[Dict[str, int]] = None
                        ) -> List[dict]:
    """One rank's ``trace.v1`` document as Chrome events.

    ``ts``/``dur`` are microseconds on the launcher clock (rank clock
    plus the document's measured ``clock_offset``; unmeasured = 0, which
    is exact for same-host jobs).
    """
    rank = int(doc.get("rank", 0))
    offset = float(doc.get("clock_offset") or 0.0) if apply_offset else 0.0
    host = doc.get("host", "")
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": rank,
        "args": {"name": f"rank {rank}" + (f" ({host})" if host else "")},
    }]
    tids: Dict[str, int] = dict(tid_base or {})
    next_tid = max(tids.values(), default=0) + 1
    for s in doc.get("spans", []):
        name = s.get("name", "?")
        tid = tids.get(name)
        if tid is None:
            tid = next_tid
            next_tid += 1
            tids[name] = tid
            events.append({"name": "thread_name", "ph": "M", "pid": rank,
                           "tid": tid, "args": {"name": name}})
        t0 = float(s.get("t0", 0.0)) + offset
        t1 = float(s.get("t1", t0)) + offset
        events.append({
            "name": f"{name}:{s.get('phase', '?')}",
            "ph": "X", "pid": rank, "tid": tid,
            "ts": int(t0 * 1e6),
            "dur": max(int((t1 - t0) * 1e6), 1),
            "args": {"trace_id": s.get("trace_id"),
                     "phase": s.get("phase"), "seq": s.get("seq"),
                     "bytes": s.get("bytes", 0)},
        })
    return events


def merge_span_docs(docs: Iterable[dict]) -> List[dict]:
    """Merge several ranks' documents into one event list, sorted by
    corrected timestamp (metadata events first, as viewers expect)."""
    meta: List[dict] = []
    body: List[dict] = []
    for doc in docs:
        for ev in spans_doc_to_events(doc):
            (meta if ev.get("ph") == "M" else body).append(ev)
    body.sort(key=lambda e: e.get("ts", 0))
    return meta + body


def merge_chrome_traces(paths: Iterable[str],
                        offsets: Optional[Dict[int, float]] = None
                        ) -> List[dict]:
    """Merge per-rank Chrome-tracing files (eager/native timelines) into
    one event list, shifting each event by its ``pid``'s offset from
    ``offsets`` (seconds to ADD — e.g. the measured launcher-minus-rank
    clock offset).  Events keep their pid (already the rank in both
    writer dialects)."""
    offsets = offsets or {}
    meta: List[dict] = []
    body: List[dict] = []
    for path in paths:
        for ev in tolerant_load_events(path):
            if ev.get("ph") == "M":
                meta.append(ev)
                continue
            off = offsets.get(int(ev.get("pid", 0)))
            if off and "ts" in ev:
                ev = dict(ev)
                ev["ts"] = int(ev["ts"] + off * 1e6)
            body.append(ev)
    body.sort(key=lambda e: e.get("ts", 0))
    return meta + body


def write_chrome(events: List[dict], path: str) -> str:
    """Atomic write in the ``traceEvents`` wrapper (loads in Perfetto
    and chrome://tracing alike)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  indent=None, separators=(",", ":"))
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_rank_docs(dir_path: str) -> Dict[int, dict]:
    """The per-rank ``spans.rank<k>.json`` fallback files of a trace
    directory, keyed by rank (skipping unparsable ones)."""
    docs: Dict[int, dict] = {}
    try:
        names = sorted(os.listdir(dir_path))
    except OSError:
        return docs
    for name in names:
        if not (name.startswith("spans.rank") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dir_path, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and doc.get("schema") == spans_mod.SCHEMA:
            docs[int(doc.get("rank", 0))] = doc
    return docs


__all__ = ["tolerant_load_events", "spans_doc_to_events",
           "merge_span_docs", "merge_chrome_traces", "write_chrome",
           "load_rank_docs"]
