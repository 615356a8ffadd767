"""Export paths of the metrics registry.

Counterpart of ``horovod_tpu/telemetry/exporter.py``, stdlib only:

* :func:`start_http_server`: Prometheus text on ``/metrics`` and the
  JSON document on ``/metrics.json``, at ``HOROVOD_METRICS_PORT`` plus
  ``HOROVOD_LOCAL_RANK``;
* :func:`write_json`: the ``HOROVOD_METRICS_FILE`` dump at exit, one
  ``horovod_tpu.metrics.v1`` document per rank (the reference's schema:
  the reference launcher merges it unchanged);
* :func:`push_to_launcher`: the same document to ``hvdrun``'s metrics
  collector over the authenticated RPC plane (the port's client,
  ``horovod_tpu_torch/runner/rpc.py``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable


def snapshot_document(snapshot_fn: Callable[[], dict]) -> dict:
    """The per-rank JSON payload: snapshot plus attribution envelope."""
    return {
        "schema": "horovod_tpu.metrics.v1",
        "rank": int(os.environ.get("HOROVOD_RANK", "0") or 0),
        "size": int(os.environ.get("HOROVOD_SIZE", "1") or 1),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "restart_attempt": int(
            os.environ.get("HOROVOD_RESTART_ATTEMPT", "0") or 0),
        "metrics": snapshot_fn(),
    }


def write_json(path: str, snapshot_fn: Callable[[], dict]) -> str:
    """Atomically write the per-rank document (write + rename so a
    crash mid-dump never leaves a half-written file for the launcher's
    merge pass to choke on)."""
    doc = snapshot_document(snapshot_fn)
    tmp = f"{path}.tmp.{os.getpid()}"
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def push_to_launcher(endpoint: str, snapshot_fn: Callable[[], dict],
                     timeout: float = 5.0) -> bool:
    """Report this rank's metrics to the launcher's collector
    (``HOROVOD_METRICS_RPC=host:port``), authenticated with the job
    secret.  Failures are swallowed — this runs on the interpreter-exit
    path, where the launcher may already be tearing the job down; the
    launcher falls back to the rank's JSON file."""
    from horovod_tpu_torch.runner import rpc
    try:
        host, port = endpoint.rsplit(":", 1)
        key = rpc.job_key_bytes(os.environ.get("HOROVOD_SECRET_KEY"))
        resp = rpc.rpc_call(
            host, int(port),
            {"kind": "metrics_report",
             "report": snapshot_document(snapshot_fn)},
            key, timeout=timeout, retries=1)
        return bool(resp)
    except Exception:  # noqa: BLE001 — best-effort exit-path reporting
        return False


def measure_launcher_offset(endpoint: str):
    """This rank's monotonic-clock offset against the launcher's
    collector (``host:port``): ``(offset_seconds, rtt_seconds)`` from
    the RTT-halving handshake in ``runner/rpc.py``, or None when the
    collector is unreachable or predates the ``time_sync`` kind.  Runs
    on the exit path, so every failure is swallowed."""
    try:
        from horovod_tpu_torch.runner import rpc
        host, port = endpoint.rsplit(":", 1)
        key = rpc.job_key_bytes(os.environ.get("HOROVOD_SECRET_KEY"))
        return rpc.measure_clock_offset(host, int(port), key)
    except Exception:  # noqa: BLE001 — best-effort exit-path handshake
        return None


class _MetricsHandler(BaseHTTPRequestHandler):
    # Class attributes injected by start_http_server via type().
    render_prometheus: Callable[[], str]
    snapshot_fn: Callable[[], dict]

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path in ("/", "/metrics"):
            body = self.render_prometheus().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path == "/metrics.json":
            body = (json.dumps(snapshot_document(self.snapshot_fn),
                               indent=1, sort_keys=True) + "\n").encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        del fmt, args


def start_http_server(port: int, render_prometheus: Callable[[], str],
                      snapshot_fn: Callable[[], dict],
                      bind: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Serve the registry on ``bind:port`` from a daemon thread; returns
    the server (``server.server_address[1]`` is the bound port — pass
    ``port=0`` for an ephemeral one in tests).

    With several ranks per host the caller offsets ``port`` by
    ``HOROVOD_LOCAL_RANK`` (see ``telemetry/__init__.py``); a bind
    failure raises so a misconfigured job fails loudly rather than
    silently serving no metrics.
    """
    handler = type("Handler", (_MetricsHandler,), {
        "render_prometheus": staticmethod(render_prometheus),
        "snapshot_fn": staticmethod(snapshot_fn),
    })
    try:
        server = ThreadingHTTPServer((bind, port), handler)
    except OSError as e:
        job = os.environ.get("HOROVOD_FLEET_JOB", "")
        local_rank = os.environ.get("HOROVOD_LOCAL_RANK", "0")
        raise OSError(
            f"metrics exporter cannot bind {bind}:{port} "
            f"(local rank {local_rank}"
            + (f", fleet job {job!r}" if job else "")
            + f"): {e}. Two jobs sharing a host must use distinct "
            f"HOROVOD_METRICS_PORT bases — under hvdfleet set "
            f"--metrics-port-base/--port-stride so per-job ranges "
            f"(base + job_index*stride + local_rank) cannot overlap."
        ) from e
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="hvd-metrics-http", daemon=True)
    thread.start()
    return server


def resolve_metrics_port(base_port: int) -> int:
    """Per-rank scrape port: base + local rank (documented in
    docs/metrics.md so operators can enumerate scrape targets)."""
    local_rank = int(os.environ.get("HOROVOD_LOCAL_RANK", "0") or 0)
    return base_port + local_rank
