"""Metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``horovod_tpu/telemetry/registry.py``, line for line: a
stdlib-only, thread-safe store that the per-rank exporters render as
Prometheus text or as the ``horovod_tpu.metrics.v1`` JSON snapshot.

* Every mutation happens under a per-metric lock: the runtime's thread,
  the callers' threads, the watchdog and the heartbeat record at once.
* Histograms take fixed bucket bounds at creation (Prometheus ``le``
  semantics, an implicit ``+Inf``), the reference's own bounds: the
  launcher's merge (``horovod_tpu/telemetry/aggregate.py``) needs every
  rank's histogram of one name to share them.
* Labels are ``str -> str`` dicts; a (name, label set) pair names one
  child series.

The no-op path when telemetry is off lives in the package's front door
(``telemetry/__init__.py``); this module is always on.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Default latency buckets (seconds): spans sub-millisecond eager completions
# through multi-second stalls.  Shared by every *_seconds histogram so
# cross-rank merges always line up.
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)

# Default byte-size buckets: 256 B .. 1 GiB in ~16x steps.
DEFAULT_BYTE_BUCKETS = (
    256.0, 4096.0, 65536.0, 1048576.0, 16777216.0, 268435456.0, 1073741824.0)

# Default bandwidth buckets (bytes/second): 1 MB/s .. 100 GB/s.
DEFAULT_BANDWIDTH_BUCKETS = (
    1e6, 1e7, 1e8, 1e9, 1e10, 1e11)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Value that can go up and down (queue depths, inflight counts)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` (<=) semantics.

    ``bucket_counts[i]`` counts observations ``<= bounds[i]``
    (NON-cumulative internally; the Prometheus renderer cumulates).  The
    final slot counts the ``+Inf`` overflow.
    """

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float]):
        bounds = tuple(float(b) for b in bounds)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if list(bounds) != sorted(bounds):
            raise ValueError(f"bucket bounds must be ascending: {bounds}")
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # + the +Inf slot
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        # bisect_left gives the first bound >= value, i.e. the Prometheus
        # "le" bucket; values beyond every bound land in the +Inf slot.
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def buckets(self) -> Dict[str, int]:
        """Non-cumulative per-bucket counts keyed by upper bound (the JSON
        form; ``+Inf`` key for the overflow slot)."""
        with self._lock:
            counts = list(self._counts)
        out = {repr(b): counts[i] for i, b in enumerate(self.bounds)}
        out["+Inf"] = counts[-1]
        return out


class _Family:
    """All children (label sets) of one metric name."""

    __slots__ = ("kind", "help", "bounds", "children")

    def __init__(self, kind: str, help_text: str,
                 bounds: Optional[Sequence[float]] = None):
        self.kind = kind
        self.help = help_text
        self.bounds = tuple(bounds) if bounds else None
        self.children: Dict[_LabelKey, object] = {}


_VALID_NAME = __import__("re").compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricsRegistry:
    """Thread-safe registry of metric families.

    ``counter``/``gauge``/``histogram`` are get-or-create: the first call
    for a (name, labels) pair creates the child, later calls return the
    same object — call sites can therefore re-resolve on the hot path
    without caching (one dict lookup under the registry lock).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get(self, kind: str, name: str, help_text: str,
             labels: Optional[Dict[str, str]],
             bounds: Optional[Sequence[float]] = None):
        if not _VALID_NAME.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(kind, help_text, bounds)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot re-register as {kind}")
            child = fam.children.get(key)
            if child is None:
                if kind == "counter":
                    child = Counter()
                elif kind == "gauge":
                    child = Gauge()
                else:
                    child = Histogram(fam.bounds or DEFAULT_TIME_BUCKETS)
                fam.children[key] = child
            return child

    def counter(self, name: str, help_text: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get("counter", name, help_text, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get("gauge", name, help_text, labels)

    def histogram(self, name: str, help_text: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get("histogram", name, help_text, labels, bounds)

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able dict of every family and child.

        Shape (the ``horovod_tpu.metrics.v1`` per-rank payload)::

            {name: {"type": ..., "help": ...,
                    "values": [{"labels": {...}, "value": v}            # counter/gauge
                               | {"labels": {...}, "sum": s, "count": c,
                                  "buckets": {"0.001": n, ..., "+Inf": m}}]}}
        """
        with self._lock:
            families = {n: (f, dict(f.children))
                        for n, f in self._families.items()}
        out: Dict[str, dict] = {}
        for name in sorted(families):
            fam, children = families[name]
            values: List[dict] = []
            for key in sorted(children):
                child = children[key]
                entry: dict = {"labels": dict(key)}
                if fam.kind == "histogram":
                    entry["sum"] = child.sum
                    entry["count"] = child.count
                    entry["buckets"] = child.buckets()
                else:
                    entry["value"] = child.value
                values.append(entry)
            out[name] = {"type": fam.kind, "help": fam.help,
                         "values": values}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, fam in snap.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for entry in fam["values"]:
                labels = entry["labels"]
                if fam["type"] == "histogram":
                    # Cumulate the per-bucket counts for the wire format.
                    cum = 0
                    buckets = entry["buckets"]
                    for bound in sorted((b for b in buckets if b != "+Inf"),
                                        key=float):
                        cum += buckets[bound]
                        lines.append(_sample(
                            name + "_bucket",
                            dict(labels, le=_format_bound(bound)), cum))
                    cum += buckets["+Inf"]
                    lines.append(_sample(name + "_bucket",
                                         dict(labels, le="+Inf"), cum))
                    lines.append(_sample(name + "_sum", labels,
                                         entry["sum"]))
                    lines.append(_sample(name + "_count", labels,
                                         entry["count"]))
                else:
                    lines.append(_sample(name, labels, entry["value"]))
        return "\n".join(lines) + ("\n" if lines else "")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_bound(bound: str) -> str:
    # repr(float) round-trips exactly; Prometheus just wants a float token.
    f = float(bound)
    return repr(int(f)) + ".0" if f == int(f) else repr(f)


def _format_value(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _sample(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                         for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"
