"""The launcher's authenticated RPC plane, both halves.

Counterpart of ``horovod_tpu/runner/rpc.py``: ``AuthError``,
``_send_msg``, ``_recv_exact`` and ``_recv_msg`` (``:30-60``),
``RpcServer`` (``:63-113``), ``connect_with_retry`` and ``rpc_call``
(``:116-200``), ``time_sync_reply`` (``:201``), the coordination plane's
``control_call``, ``probe_reachable`` and ``local_addresses``
(``:243-338``), ``KeepaliveMonitor`` (``:340``) and ``job_key_bytes``
(``:474``).  A message is an ``!Q``
payload length, the HMAC-SHA256 digest of the payload under the job's
key (``HOROVOD_SECRET_KEY``), then the pickled payload: byte for byte
what the reference launcher's ``RpcServer`` reads, so the port's
heartbeat sender talks to ``hvdrun``'s health plane.  A digest is
checked before anything in the message is unpickled.  The port's
``RpcServer`` serves the serving plane's replicas
(:mod:`horovod_tpu_torch.serving.replica`) and the port's launcher
(:mod:`horovod_tpu_torch.runner.run`), whose health plane tells dead
ranks from hung ones with ``KeepaliveMonitor``.  ``measure_clock_offset``
(``:212``) is the client half of the launcher's time-sync handshake.
The reference's client-side series (``hvd_rpc_calls_total``,
``_connect_retries_total``, ``_connect_failures_total``) and the ``rpc``
span are recorded here.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import pickle
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable, Optional

from horovod_tpu_torch import config, faults, telemetry


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


class RpcServer:
    """A threaded TCP server dispatching authenticated pickled requests.

    ``handler(request) -> response`` runs under one lock by default;
    ``serialize=False`` drops the lock for handlers that lock finer
    themselves and must answer probes while a slow request runs (the
    serving replica).  A request whose digest, framing or pickle is bad
    is dropped without a reply; a connection carries one request and
    its response."""

    def __init__(self, key: bytes, handler: Callable[[Any], Any],
                 bind: str = "0.0.0.0", serialize: bool = True):
        self._key = key
        self._handler = handler
        self._lock = threading.Lock() if serialize else None
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = pickle.loads(_recv_msg(self.request, outer._key))
                except (AuthError, ConnectionError, pickle.PickleError,
                        struct.error):
                    return
                if outer._lock is not None:
                    with outer._lock:
                        resp = outer._handler(req)
                else:
                    resp = outer._handler(req)
                _send_msg(self.request, pickle.dumps(resp), outer._key)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((bind, 0), _Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


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
    the span export itself.  The call passes the ``rpc`` fault site
    first (detail: the request's kind)."""
    faults.inject("rpc", str(request.get("kind"))
                  if isinstance(request, dict) else None)
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


def time_sync_reply() -> dict:
    """The server half of the time-sync handshake: the launcher's
    collectors answer ``{"kind": "time_sync"}`` with their monotonic
    clock, read as close to the reply as possible."""
    return {"ok": True, "server_time": time.monotonic()}


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


def control_call(addr: str, port: int, request: dict, key: bytes,
                 *, epoch: int = 0, seq: int = 0,
                 retries: Optional[int] = None,
                 deadline: Optional[float] = None,
                 timeout: float = 5.0,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] = random.random,
                 clock: Callable[[], float] = time.monotonic) -> Any:
    """A coordination-plane round trip: :func:`rpc_call` hardened.

    The request is stamped with ``(epoch, seq)`` so that the receiver can
    drop stale epochs and de-duplicate retransmits
    (:class:`~horovod_tpu_torch.coordination.DedupFilter`), which makes
    retrying the whole round trip safe here, where :func:`rpc_call` may
    retry only the dial.  Retransmits back off under a
    :class:`~horovod_tpu_torch.coordination.RetryPolicy` of
    ``HOROVOD_COORD_MSG_RETRIES`` retries within a total budget of
    ``HOROVOD_COORD_MSG_DEADLINE`` seconds, each counted in
    ``hvd_coord_msg_retries_total{kind}``.  Each send polls the
    ``control`` fault site (:func:`horovod_tpu_torch.faults.control_chaos`):
    ``msg_drop`` and ``partition`` fail the send, ``msg_dup`` sends it
    twice and ``msg_delay`` stalls it."""
    from horovod_tpu_torch.coordination import RetryPolicy
    if retries is None:
        retries = config.env_int("HOROVOD_COORD_MSG_RETRIES")
    if deadline is None:
        deadline = config.env_float("HOROVOD_COORD_MSG_DEADLINE")
    policy = RetryPolicy(retries=retries, deadline=deadline)
    request = dict(request, epoch=int(epoch), seq=int(seq))
    kind = str(request.get("kind"))
    started = clock()
    attempt = 0
    last_err: Optional[Exception] = None
    while not policy.give_up(attempt, clock() - started):
        send_copies = 1
        try:
            for fault_kind, arg in faults.control_chaos():
                if fault_kind == "msg_drop":
                    raise ConnectionError("chaos: control message dropped")
                if fault_kind == "msg_dup":
                    send_copies = 2
                elif fault_kind == "msg_delay":
                    sleep(float(arg) / 1000.0 if arg is not None else 0.1)
                elif fault_kind == "partition":
                    raise ConnectionError("chaos: control partition")
            resp = None
            for _ in range(send_copies):
                with connect_with_retry(addr, port, timeout=timeout,
                                        retries=0, deadline=timeout,
                                        clock=clock) as sock:
                    _send_msg(sock, pickle.dumps(request), key)
                    resp = pickle.loads(_recv_msg(sock, key))
            return resp
        except (OSError, AuthError, pickle.PickleError) as e:
            last_err = e
            attempt += 1
            telemetry.counter(
                "hvd_coord_msg_retries_total",
                "Control-plane messages retransmitted after a failed "
                "round trip", kind=kind).inc()
            sleep(policy.backoff(attempt - 1, rng))
    raise ConnectionError(
        f"control message kind={kind} epoch={epoch} seq={seq} to "
        f"{addr}:{port} failed after {attempt} attempts: {last_err}")


def probe_reachable(host: str, port: int, timeout: float = 3.0) -> bool:
    """True when a TCP connection to ``host:port`` opens within
    ``timeout`` (the reachability probe, without a shell)."""
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


def local_addresses() -> list:
    """This host's routable IPv4 addresses, sorted (``127.0.0.1`` when it
    has none): those its hostname resolves to, and the one a datagram
    socket would leave by (connected, never sent on), loopback left out.
    A task reports them and the driver intersects."""
    addrs = set()
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       family=socket.AF_INET):
            addrs.add(info[4][0])
    except socket.gaierror:
        pass
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        addrs.add(s.getsockname()[0])
        s.close()
    except OSError:
        pass
    addrs.discard("127.0.0.1")
    return sorted(addrs) or ["127.0.0.1"]


class KeepaliveMonitor:
    """Driver-side liveness bookkeeping: tasks ping periodically; a task
    silent past ``timeout`` is reported dead (the failure-detection half
    of the reference's task services).

    Pings may carry a training step (:meth:`progress` — the heartbeat
    health plane), which lets the monitor distinguish two very different
    failures: a *dead* task (socket gone, pings stopped —
    :meth:`dead_tasks`) and a *hung* one (pings keep arriving but the
    step has not advanced past ``hang_deadline`` seconds —
    :meth:`hung_tasks`).  The distinction matters because a hung worker
    holds every peer hostage inside a collective: waiting for the
    collective's own timeout wastes minutes the health plane can save.

    ``clock`` is a monotonic-seconds callable, injectable so tests step
    time instead of sleeping.  Call :meth:`forget` when a task finishes
    cleanly — a completed task stops pinging and must not be mistaken
    for a dead one."""

    def __init__(self, timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 hang_deadline: float = 0.0):
        self._clock = clock
        self._timeout = timeout
        self._hang_deadline = hang_deadline
        self._last: dict = {}
        self._steps: dict = {}          # task_id -> (step, last_advance_ts)
        self._reported_dead: set = set()
        self._reported_hung: set = set()
        self._lock = threading.Lock()

    def ping(self, task_id) -> None:
        with self._lock:
            self._last[task_id] = self._clock()
            # A task that pings again was a network blip, not a loss.
            self._reported_dead.discard(task_id)

    def progress(self, task_id, step: int) -> None:
        """A heartbeat carrying the task's training step.  Counts as a
        ping; the hang clock restarts only when the step ADVANCES."""
        with self._lock:
            now = self._clock()
            self._last[task_id] = now
            self._reported_dead.discard(task_id)
            prev = self._steps.get(task_id)
            if prev is None or step > prev[0]:
                self._steps[task_id] = (int(step), now)
                self._reported_hung.discard(task_id)

    def forget(self, task_id) -> None:
        """Stop tracking a task (it reported its result or was removed
        from the job); silence from it is no longer a failure."""
        with self._lock:
            self._last.pop(task_id, None)
            self._steps.pop(task_id, None)
            self._reported_dead.discard(task_id)
            self._reported_hung.discard(task_id)

    def forget_all(self) -> None:
        """Atomically stop tracking every task.

        Tearing a per-job monitor down mid-episode (fleet preemption, a
        new elastic attempt) must not race a concurrent watchdog sweep
        into reporting half-forgotten ranks: a sweep observes either the
        full pre-teardown set or nothing.  Looping :meth:`forget` over
        :meth:`tracked` cannot give that guarantee — an RPC handler can
        insert between the snapshot and the per-id pops, and a sweep can
        run mid-loop against a partially cleared map."""
        with self._lock:
            self._last.clear()
            self._steps.clear()
            self._reported_dead.clear()
            self._reported_hung.clear()

    def dead_tasks(self) -> list:
        now = self._clock()
        with self._lock:
            dead = [t for t, ts in self._last.items()
                    if now - ts > self._timeout]
            fresh = [t for t in dead if t not in self._reported_dead]
            self._reported_dead.update(fresh)
        if fresh:
            # Counted once per silence episode, not per poll.
            telemetry.counter(
                "hvd_rpc_keepalive_losses_total",
                "Tasks whose keepalive pings went silent past the "
                "timeout").inc(len(fresh))
        return dead

    def hung_tasks(self) -> list:
        """Tasks whose heartbeats still arrive but whose step has been
        stalled longer than ``hang_deadline`` (0 disables).  Reported
        once per stall episode — a step advance re-arms the detector.
        Disjoint from :meth:`dead_tasks`: a silent task is dead, not
        hung."""
        if not self._hang_deadline:
            return []
        now = self._clock()
        with self._lock:
            hung = [
                t for t, (step, advance_ts) in self._steps.items()
                if now - advance_ts > self._hang_deadline
                and now - self._last.get(t, 0.0) <= self._timeout
            ]
            fresh = [t for t in hung if t not in self._reported_hung]
            self._reported_hung.update(fresh)
        if fresh:
            telemetry.counter(
                "hvd_heartbeat_hangs_total",
                "Tasks whose heartbeats stayed alive while the training "
                "step stalled past the hang deadline").inc(len(fresh))
        return fresh

    def tracked(self) -> list:
        """Every task id with any recorded state (ping or step)."""
        with self._lock:
            return sorted(set(self._last) | set(self._steps))

    def step_lags(self) -> dict:
        """Per-task straggler lag: ``max(step) - step`` over every task
        that has reported a step.  Empty until the first progress ping."""
        with self._lock:
            if not self._steps:
                return {}
            top = max(step for step, _ in self._steps.values())
            return {t: top - step for t, (step, _) in self._steps.items()}


def find_free_port(bind: str = "") -> int:
    """A TCP port free on ``bind`` (every interface by default) when
    asked: the kernel's pick for port 0 (reference ``rpc.py:468``)."""
    with socket.socket() as s:
        s.bind((bind, 0))
        return s.getsockname()[1]


def job_key_bytes(env_value: Optional[str]) -> bytes:
    """``HOROVOD_SECRET_KEY`` as raw bytes (urlsafe base64, else the raw
    string's bytes)."""
    if not env_value:
        return b""
    try:
        return base64.urlsafe_b64decode(env_value.encode())
    except Exception:  # noqa: BLE001
        return env_value.encode()
