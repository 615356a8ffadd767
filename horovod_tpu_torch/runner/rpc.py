"""The client half of the launcher's authenticated RPC plane.

Counterpart of ``horovod_tpu/runner/rpc.py``: ``AuthError``,
``_send_msg``, ``_recv_exact`` and ``_recv_msg`` (``:30-60``),
``connect_with_retry`` and ``rpc_call`` (``:116-200``) and
``job_key_bytes`` (``:474``).  A message is an ``!Q`` payload length, the
HMAC-SHA256 digest of the payload under the job's key
(``HOROVOD_SECRET_KEY``), then the pickled payload: byte for byte what
the reference launcher's ``RpcServer`` reads, so the port's heartbeat
sender talks to ``hvdrun``'s health plane.  A reply's digest is checked
before anything in it is unpickled.  No server lives here: the launcher
is the server.  ``measure_clock_offset`` (``:212``) is the client half
of the launcher's time-sync handshake.  The reference's client-side
series (``hvd_rpc_calls_total``, ``_connect_retries_total``,
``_connect_failures_total``) and the ``rpc`` span are recorded here.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import pickle
import random
import socket
import struct
import time
from typing import Any, Callable, Optional

from horovod_tpu_torch import telemetry


class AuthError(RuntimeError):
    pass


def _send_msg(sock: socket.socket, payload: bytes, key: bytes) -> None:
    digest = hmac.new(key, payload, hashlib.sha256).digest()
    sock.sendall(struct.pack("!Q", len(payload)) + digest + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket, key: bytes,
              max_len: int = 64 << 20) -> bytes:
    (length,) = struct.unpack("!Q", _recv_exact(sock, 8))
    if length > max_len:
        raise AuthError(f"message length {length} exceeds sanity cap")
    digest = _recv_exact(sock, 32)
    payload = _recv_exact(sock, length)
    want = hmac.new(key, payload, hashlib.sha256).digest()
    if not hmac.compare_digest(digest, want):
        raise AuthError("message digest mismatch — wrong or missing "
                        "HOROVOD_SECRET_KEY")
    return payload


# The reference's default cap on one dial's time over all its retries.
CONNECT_DEADLINE_S = 60.0


def connect_with_retry(addr: str, port: int, timeout: float = 30.0,
                       retries: int = 4, base_delay: float = 0.2,
                       max_delay: float = 3.0,
                       sleep: Callable[[float], None] = time.sleep,
                       rng: Callable[[], float] = random.random,
                       deadline: float = CONNECT_DEADLINE_S,
                       clock: Callable[[], float] = time.monotonic
                       ) -> socket.socket:
    """``socket.create_connection`` with jittered exponential backoff.

    Only the dial is retried, never a request that may have been
    delivered.  The backoff is ``min(max_delay, base_delay * 2**attempt)``
    times a uniform [0.5, 1.5) jitter; ``deadline`` caps the time over
    every attempt.  ``sleep``, ``rng`` and ``clock`` are injection points
    for tests."""
    started = clock()
    last_err: Optional[OSError] = None
    attempts = 0
    for attempt in range(retries + 1):
        budget = deadline - (clock() - started)
        if budget <= 0:
            last_err = last_err or OSError("connect deadline exhausted")
            break
        attempts += 1
        try:
            return socket.create_connection((addr, port),
                                            timeout=min(timeout, budget))
        except OSError as e:
            last_err = e
            if attempt >= retries:
                break
            delay = (min(max_delay, base_delay * (2.0 ** attempt))
                     * (0.5 + rng()))
            if clock() - started + delay >= deadline:
                break
            telemetry.counter(
                "hvd_rpc_connect_retries_total",
                "RPC dial attempts that failed and were retried with "
                "backoff").inc()
            sleep(delay)
    telemetry.counter(
        "hvd_rpc_connect_failures_total",
        "RPC dials that exhausted every retry").inc()
    raise ConnectionError(
        f"could not connect to {addr}:{port} after {attempts} attempts "
        f"within {deadline:.1f}s: {last_err}")


def rpc_call(addr: str, port: int, request: Any, key: bytes,
             timeout: float = 30.0, retries: int = 4) -> Any:
    """One authenticated request/response round trip (``retries=0``: a
    single dial).  The time-sync probe records no span: it runs during
    the span export itself."""
    kind = (str(request.get("kind")) if isinstance(request, dict)
            else "raw")
    telemetry.counter("hvd_rpc_calls_total",
                      "Authenticated RPC round trips issued",
                      kind=kind).inc()
    sp = telemetry.spans() if kind != "time_sync" else None
    t0 = time.monotonic() if sp is not None else 0.0
    with connect_with_retry(addr, port, timeout=timeout,
                            retries=retries) as sock:
        _send_msg(sock, pickle.dumps(request), key)
        reply = pickle.loads(_recv_msg(sock, key))
    if sp is not None:
        sp.event(f"rpc/{kind}", "rpc", t0, time.monotonic())
    return reply


def measure_clock_offset(addr: str, port: int, key: bytes,
                         samples: int = 5,
                         timeout: float = 5.0) -> Optional[tuple]:
    """This process's monotonic-clock offset against the server at
    ``addr:port`` (Cristian's algorithm): ``(server - local, rtt)`` from
    the probe with the least round trip, or None when the server is
    unreachable or does not answer the ``time_sync`` kind."""
    best: Optional[tuple] = None
    for _ in range(max(samples, 1)):
        t0 = time.monotonic()
        try:
            reply = rpc_call(addr, port, {"kind": "time_sync"}, key,
                             timeout=timeout, retries=0)
        except Exception:
            continue
        t1 = time.monotonic()
        if not isinstance(reply, dict) or "server_time" not in reply:
            return None
        rtt = t1 - t0
        offset = float(reply["server_time"]) - (t0 + t1) / 2.0
        if best is None or rtt < best[1]:
            best = (offset, rtt)
    return best


def job_key_bytes(env_value: Optional[str]) -> bytes:
    """``HOROVOD_SECRET_KEY`` as raw bytes (urlsafe base64, else the raw
    string's bytes)."""
    if not env_value:
        return b""
    try:
        return base64.urlsafe_b64decode(env_value.encode())
    except Exception:  # noqa: BLE001
        return env_value.encode()
