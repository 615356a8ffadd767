"""Telemetry: the metrics registry, its exporters, spans and the eager
timeline.

Counterpart of ``horovod_tpu/telemetry/__init__.py`` (``:63-348``), with
the reference's series names, labels, help texts and bucket bounds, so
the reference launcher's merge (``aggregate``, ``trace_merge``,
``critical_path``) reads the port's documents unchanged.  The control
plane, the fusion and ZeRO wires, the codecs, checkpoints, the
resilience ladder and the RPC client record here; three paths export:

* ``HOROVOD_METRICS_PORT=9090``: Prometheus text on a stdlib HTTP server
  (port = base + local rank);
* ``HOROVOD_METRICS_FILE=/path/m.json``: a JSON document per rank at
  exit; under ``hvdrun --metrics-file`` the launcher also collects every
  rank's document over RPC (``HOROVOD_METRICS_RPC``) and merges them;
* ``hvd.metrics_snapshot()``: the in-process API.

``HOROVOD_EAGER_TIMELINE=/path/t.json`` starts the per-rank eager
timeline (:mod:`.eager_timeline`), ``HOROVOD_TRACE`` the span recorder
(:mod:`.spans`); each has its own no-op guard.

The no-op contract
------------------
With every telemetry variable unset, an instrumented site costs one
function call and one boolean test, and reads no clock::

    if telemetry.enabled():
        telemetry.counter("hvd_eager_ops_total", op="allreduce").inc()

:func:`counter`, :func:`gauge` and :func:`histogram` return the shared
:data:`NOOP` when off, so even an unguarded call allocates and mutates
nothing.  ``HOROVOD_METRICS=1`` turns collection on without an export
path (for ``hvd.metrics_snapshot()``).  Every site records host-side
only: nothing here waits on the device.
"""

from __future__ import annotations

import atexit
import os
import time
from typing import Dict, Optional

from horovod_tpu_torch.telemetry.registry import (  # noqa: F401  (re-export)
    DEFAULT_BANDWIDTH_BUCKETS,
    DEFAULT_BYTE_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

clock = time.monotonic   # one clock for every duration metric + timeline

_ENV_VARS = ("HOROVOD_METRICS", "HOROVOD_METRICS_PORT",
             "HOROVOD_METRICS_FILE", "HOROVOD_METRICS_RPC")
# Span tracing (HOROVOD_TRACE / _DIR / _RPC) is configured alongside but
# independently of metrics, like the eager timeline: telemetry.spans()
# returns None when every trace variable is unset.


class _Noop:
    """Shared do-nothing metric: accepts every mutator of Counter, Gauge
    and Histogram.  Identity-comparable (``is telemetry.NOOP``) so tests
    can assert the disabled path was taken."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


NOOP = _Noop()

_registry = MetricsRegistry()
_enabled = False
_timeline = None          # EagerTimelineWriter or None
_spans = None             # spans.SpanRecorder or None
_span_flush_hooks = []    # callables draining foreign span buffers
_metrics_flush_hooks = []  # callables mirroring foreign counters in
_http_server = None
_configured = False


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip() not in ("", "0", "false")


def _configure_from_env() -> None:
    """Resolve enablement and export paths from the environment.  Runs
    once at first import (i.e. before any instrumented op can fire);
    :func:`reset_for_tests` re-runs it after monkeypatching."""
    global _enabled, _timeline, _http_server, _configured, _spans
    _configured = True
    # HOROVOD_METRICS is a boolean toggle ("0"/"false" disable); the
    # export-path variables enable whenever non-empty — including
    # HOROVOD_METRICS_PORT=0, which binds an ephemeral scrape port.
    _enabled = _env_truthy("HOROVOD_METRICS") or any(
        os.environ.get(v, "").strip()
        for v in _ENV_VARS if v != "HOROVOD_METRICS")

    port = os.environ.get("HOROVOD_METRICS_PORT", "").strip()
    if port and _http_server is None:
        from horovod_tpu_torch.telemetry import exporter
        _http_server = exporter.start_http_server(
            exporter.resolve_metrics_port(int(port)),
            _registry.render_prometheus, _registry.snapshot)

    tl_path = os.environ.get("HOROVOD_EAGER_TIMELINE", "").strip()
    if tl_path and _timeline is None:
        from horovod_tpu_torch.telemetry.eager_timeline import (
            EagerTimelineWriter, per_rank_path)
        _timeline = EagerTimelineWriter(
            per_rank_path(tl_path),
            rank=int(os.environ.get("HOROVOD_RANK", "0") or 0))

    if _spans is None:
        # importlib, not ``from ... import spans``: the :func:`spans`
        # accessor below shadows the submodule as a package attribute,
        # so an attribute-based import would grab the function.
        import importlib
        _spans = importlib.import_module(
            "horovod_tpu_torch.telemetry.spans").configured_recorder()


def _at_exit() -> None:
    """Flush every export path.  File/RPC targets are re-read from the
    environment HERE (not at configure time) so the launcher's per-rank
    overrides and late ``os.environ`` edits are honored."""
    global _timeline, _spans
    if _timeline is not None:
        _timeline.close()
        _timeline = None
    if _spans is not None:
        # Other planes flush into the recorder first: this handler may
        # run before basics.shutdown() (atexit order), and spans handed
        # over after the export would vanish.
        for hook in list(_span_flush_hooks):
            try:
                hook()
            except Exception:
                pass
        # Span export runs BEFORE the metrics push so the recorder's
        # hvd_trace_* totals land in this rank's metrics snapshot.
        # (importlib: the spans() accessor shadows the submodule.)
        import importlib
        spans_mod = importlib.import_module(
            "horovod_tpu_torch.telemetry.spans")
        try:
            spans_mod.export_at_exit(_spans)
        except Exception:
            pass  # exit path: tracing must never mask the job's rc
        _spans = None
    if not _enabled:
        return
    # Other planes (the runtime's gauges) publish into the registry now:
    # this handler may run before basics.shutdown() (atexit order), and
    # a short job's last values would miss the snapshot below.
    for hook in list(_metrics_flush_hooks):
        try:
            hook()
        except Exception:
            pass
    from horovod_tpu_torch.telemetry import exporter
    endpoint = os.environ.get("HOROVOD_METRICS_RPC", "").strip()
    if endpoint:
        # Satellite of the trace plane that works even with tracing off:
        # measure this rank's monotonic-clock offset against the
        # launcher over the same collector the metrics push targets, so
        # the merged summary can attribute cross-host skew.
        skew = exporter.measure_launcher_offset(endpoint)
        if skew is not None:
            gauge("hvd_clock_skew_seconds",
                  "Monotonic-clock offset vs the launcher (launcher "
                  "minus rank, RTT-halving estimate)").set(skew[0])
        exporter.push_to_launcher(endpoint, _registry.snapshot)
    path = os.environ.get("HOROVOD_METRICS_FILE", "").strip()
    if path:
        try:
            from horovod_tpu_torch.telemetry.eager_timeline import per_rank_path
            exporter.write_json(per_rank_path(path), _registry.snapshot)
        except OSError:
            pass  # exit path: an unwritable target must not mask the rc


atexit.register(_at_exit)
_configure_from_env()


# ---------------------------------------------------------------------------
# Hot-path API
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """The one branch every instrumentation site tests first."""
    return _enabled


def active() -> bool:
    """True when any consumer is on (metrics, the eager timeline or
    spans): the one test a site makes before it reads the clock."""
    return _enabled or _timeline is not None or _spans is not None


def timeline():
    """The eager timeline writer, or None when HOROVOD_EAGER_TIMELINE is
    unset (the timeline's own no-op guard, independent of metrics).
    Named ``timeline`` — not ``eager_timeline`` — because that attribute
    is the submodule holding the writer class."""
    return _timeline


def spans():
    """The distributed span recorder, or None when tracing is off (the
    tracing plane's own no-op guard, independent of metrics — see
    ``spans.py``)."""
    return _spans


def register_span_flush_hook(fn) -> None:
    """Register a callable that moves spans buffered elsewhere into the
    recorder; hooks run right before the at-exit span export."""
    if fn not in _span_flush_hooks:
        _span_flush_hooks.append(fn)


def unregister_span_flush_hook(fn) -> None:
    try:
        _span_flush_hooks.remove(fn)
    except ValueError:
        pass


def register_metrics_flush_hook(fn) -> None:
    """Register a callable that publishes another plane's state (the
    runtime's gauges) into the registry; hooks run at exit right before
    the metrics push and dump."""
    if fn not in _metrics_flush_hooks:
        _metrics_flush_hooks.append(fn)


def unregister_metrics_flush_hook(fn) -> None:
    try:
        _metrics_flush_hooks.remove(fn)
    except ValueError:
        pass


def counter(name: str, help_text: str = "", **labels: str):
    if not _enabled:
        return NOOP
    return _registry.counter(name, help_text, labels or None)


def gauge(name: str, help_text: str = "", **labels: str):
    if not _enabled:
        return NOOP
    return _registry.gauge(name, help_text, labels or None)


def histogram(name: str, help_text: str = "", bounds=None, **labels: str):
    if not _enabled:
        return NOOP
    return _registry.histogram(name, help_text, labels or None,
                               bounds=bounds)


def observe_op(op: str, seconds: float, nbytes: int = 0) -> None:
    """One-call recorder for a completed eager collective: count,
    latency histogram, byte counter, effective-bandwidth histogram."""
    if not _enabled:
        return
    counter("hvd_eager_ops_total",
            "Completed eager-plane collective operations", op=op).inc()
    histogram("hvd_eager_op_seconds",
              "Eager collective latency, submit to completion (seconds)",
              bounds=DEFAULT_TIME_BUCKETS, op=op).observe(seconds)
    if nbytes:
        counter("hvd_eager_bytes_total",
                "Payload bytes submitted to eager collectives",
                op=op).inc(nbytes)
        histogram("hvd_eager_bandwidth_bytes_per_second",
                  "Effective eager collective bandwidth (payload bytes / "
                  "op latency)", bounds=DEFAULT_BANDWIDTH_BUCKETS,
                  op=op).observe(nbytes / max(seconds, 1e-9))


# ---------------------------------------------------------------------------
# Snapshot / lifecycle API
# ---------------------------------------------------------------------------

def registry() -> MetricsRegistry:
    return _registry


def metrics_snapshot() -> Dict[str, dict]:
    """The current registry contents (``hvd.metrics_snapshot()``).
    Empty when telemetry never ran — enable collection with any metrics
    env var or :func:`configure`."""
    return _registry.snapshot()


def render_prometheus() -> str:
    return _registry.render_prometheus()


def configure(enabled_flag: Optional[bool] = None) -> None:
    """Turn collection on or off without environment variables."""
    global _enabled
    if enabled_flag is not None:
        _enabled = bool(enabled_flag)


def flush() -> None:
    """Write every configured export target now (normally runs at
    interpreter exit; explicit for long-running programs and tests)."""
    _at_exit()


def reset_for_tests() -> None:
    """Clear the registry and re-resolve the environment.  Test-only:
    tears down the timeline writer (without terminator) and forgets a
    previously started HTTP server reference (daemon thread; freed at
    process exit)."""
    global _timeline, _http_server, _enabled, _spans
    if _timeline is not None:
        _timeline.close()
        _timeline = None
    if _spans is not None:
        _spans.close()
        _spans = None
    if _http_server is not None:
        _http_server.shutdown()
        _http_server = None
    _registry.clear()
    _configure_from_env()
