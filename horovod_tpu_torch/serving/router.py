"""Request router: multi-tenant continuous batching over replicas.

Counterpart of ``horovod_tpu/serving/router.py``.  Per-tenant FIFO queues
sit in front of a pool of replicas, scheduled with token-level
continuous batching (Orca, OSDI '22): a sequence joins a replica's
running batch at any decode-step boundary and leaves the moment it
completes.  One :meth:`Router.step` is one token step across every
replica; :meth:`Router.serve` loops it on a thread, and tests drive it
synchronously with an injected clock.

Admission, per tenant, at submit time: ``quota`` (queued plus in-flight
requests, ``HOROVOD_SERVING_QUOTA`` by default; reason ``quota``) and,
with ``slo_ms`` set, the estimated queue wait (the queue ahead over the
healthy decode slots, times the measured per-step EWMA; reason ``slo``).
With no healthy replica the reason is ``capacity``.

A replica whose decode fails mid-step is marked unhealthy and every
sequence it ran goes back to the front of its tenant's queue with its
token state: decode is deterministic in (token, position, weights), so
the retried step gives the same token on another replica.
:meth:`Router.stats` is the queue-pressure document an autoscaler reads
(schema ``horovod_tpu.serving.stats.v1``, the reference's name, which
the reference's fleet controller parses), and :meth:`Router.write_stats`
publishes it atomically.  Every scheduler pass polls
:func:`horovod_tpu_torch.faults.storm_requests` and floods the queues
under the ``storm`` tenant when a ``request_storm`` rule fires.

Weights cross the RPC wire as host arrays, never as CUDA tensors (a
pickled CUDA tensor needs a CUDA context on the receiving side); each
replica moves what it receives to its own device.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from horovod_tpu_torch import config, faults, telemetry
from horovod_tpu_torch.serving.model import host_weights

OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

#: Implicit tenant chaos request_storm traffic is booked under.
STORM_TENANT = "storm"


@dataclass
class TenantConfig:
    """Per-tenant admission policy.  ``quota``/``slo_ms`` left ``None``
    resolve to the ``HOROVOD_SERVING_QUOTA`` / ``HOROVOD_SERVING_SLO_MS``
    defaults at router construction."""
    name: str
    quota: Optional[int] = None
    slo_ms: Optional[float] = None


class RequestHandle:
    """What :meth:`Router.submit` returns: terminal state is exactly one
    of completed (``tokens`` full), ``rejected`` (reason string, never
    admitted) or ``dropped`` (admitted, then lost with no healthy
    replica left)."""

    def __init__(self, request_id: str, tenant: str):
        self.request_id = request_id
        self.tenant = tenant
        self.tokens: List[int] = []
        self.rejected: Optional[str] = None
        self.dropped = False
        self.done = threading.Event()

    @property
    def completed(self) -> bool:
        return self.done.is_set() and not self.dropped and \
            self.rejected is None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class _Seq:
    """One admitted request's decode state (migrates between replicas on
    crash retry — the state IS the idempotency token)."""

    __slots__ = ("handle", "last_token", "pos", "max_new_tokens",
                 "submitted_at", "first_token_at")

    def __init__(self, handle: RequestHandle, prompt_token: int,
                 max_new_tokens: int, submitted_at: float):
        self.handle = handle
        self.last_token = int(prompt_token)
        self.pos = 0
        self.max_new_tokens = int(max_new_tokens)
        self.submitted_at = submitted_at
        self.first_token_at: Optional[float] = None


class ReplicaHandle:
    """Router-side view of one replica."""

    healthy: bool = True

    def decode(self, seqs: Sequence[tuple]) -> dict:
        raise NotImplementedError

    def update_weights(self, weights, generation: int) -> None:
        raise NotImplementedError


class LocalReplicaHandle(ReplicaHandle):
    """In-process replica (unit tests, benchmarks, single-rank jobs)."""

    def __init__(self, worker):
        self.worker = worker
        self.healthy = True

    def decode(self, seqs):
        return self.worker.decode(list(seqs))

    def update_weights(self, weights, generation):
        self.worker.stage_update(weights, generation)


class RpcReplicaHandle(ReplicaHandle):
    """Replica across the authenticated RPC plane.  ``retries=0`` on
    decode: a dead replica must surface as a failure at once so that the
    router fails the batch over instead of waiting in dial backoff."""

    def __init__(self, addr: str, port: int, key: bytes,
                 timeout: float = 30.0):
        from horovod_tpu_torch.runner import rpc
        self._rpc = rpc
        self.addr, self.port, self.key = addr, int(port), key
        self.timeout = timeout
        self.healthy = True

    def _call(self, request: dict, retries: int = 0):
        resp = self._rpc.rpc_call(self.addr, self.port, request, self.key,
                                  timeout=self.timeout, retries=retries)
        if not (isinstance(resp, dict) and resp.get("ok")):
            raise RuntimeError(f"replica {self.addr}:{self.port} "
                               f"error: {resp!r}")
        return resp

    def decode(self, seqs):
        return self._call({"kind": "decode", "seqs": list(seqs)})

    def update_weights(self, weights, generation):
        self._call({"kind": "update_weights",
                    "weights": host_weights(weights),
                    "generation": int(generation)}, retries=2)

    def ping(self) -> dict:
        return self._call({"kind": "ping"}, retries=4)


def stats_path_from_env() -> Optional[str]:
    """The autoscaler handshake path (``HOROVOD_SERVING_STATS``), or
    None when none is set."""
    return config.env_str("HOROVOD_SERVING_STATS")


class Router:
    """See the module docstring.  ``clock`` is injectable so the unit
    suite drives whole episodes without sleeping."""

    def __init__(self, replicas: Sequence[ReplicaHandle],
                 tenants: Sequence[TenantConfig], *,
                 max_batch: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        self.max_batch = int(max_batch if max_batch is not None
                             else config.env_int("HOROVOD_SERVING_MAX_BATCH"))
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got "
                             f"{self.max_batch})")
        self._clock = clock
        self._lock = threading.RLock()
        self._tenants: Dict[str, TenantConfig] = OrderedDict()
        default_quota = config.env_int("HOROVOD_SERVING_QUOTA")
        default_slo = config.env_float("HOROVOD_SERVING_SLO_MS")
        for t in tenants:
            if t.name in self._tenants:
                raise ValueError(f"duplicate tenant {t.name!r}")
            self._tenants[t.name] = TenantConfig(
                t.name,
                quota=default_quota if t.quota is None else int(t.quota),
                slo_ms=default_slo if t.slo_ms is None
                else float(t.slo_ms))
        self._queues: Dict[str, deque] = {name: deque()
                                          for name in self._tenants}
        self._rr: List[str] = list(self._tenants)   # round-robin order
        self._assigned: List[Dict[str, _Seq]] = [
            {} for _ in self.replicas]
        self._latencies: deque = deque(maxlen=512)  # seconds, completed
        self._step_ewma = 0.0        # seconds per decode step
        self.generation = 0          # last generation pushed
        self.completed = 0
        self.dropped = 0
        self._storm_seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- admission ---------------------------------------------------------

    def _ensure_storm_tenant(self) -> None:
        if STORM_TENANT not in self._tenants:
            self._tenants[STORM_TENANT] = TenantConfig(
                STORM_TENANT, quota=1 << 30, slo_ms=0.0)
            self._queues[STORM_TENANT] = deque()
            self._rr.append(STORM_TENANT)

    def _tenant_load(self, tenant: str) -> int:
        return len(self._queues[tenant]) + sum(
            1 for batch in self._assigned for s in batch.values()
            if s.handle.tenant == tenant)

    def _healthy(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas) if r.healthy]

    def _estimated_wait_ms(self) -> float:
        slots = len(self._healthy()) * self.max_batch
        if slots <= 0 or self._step_ewma <= 0.0:
            return 0.0
        depth = sum(len(q) for q in self._queues.values())
        return (depth / slots) * self._step_ewma * 1000.0

    def submit(self, tenant: str, prompt_token: int,
               max_new_tokens: int = 8,
               request_id: Optional[str] = None) -> RequestHandle:
        """Admit (or reject) one request; never blocks on capacity."""
        with self._lock:
            if tenant not in self._tenants:
                raise KeyError(f"unknown tenant {tenant!r}")
            rid = request_id or uuid.uuid4().hex
            handle = RequestHandle(rid, tenant)
            telemetry.counter(
                "hvd_serving_requests_total",
                "Requests submitted to the router", tenant=tenant).inc()
            cfg = self._tenants[tenant]
            if not self._healthy():
                return self._reject(handle, "capacity")
            if self._tenant_load(tenant) >= cfg.quota:
                return self._reject(handle, "quota")
            if cfg.slo_ms and self._estimated_wait_ms() > cfg.slo_ms:
                return self._reject(handle, "slo")
            self._queues[tenant].append(
                _Seq(handle, prompt_token, max_new_tokens, self._clock()))
            return handle

    def _reject(self, handle: RequestHandle, reason: str) -> RequestHandle:
        handle.rejected = reason
        handle.done.set()
        telemetry.counter(
            "hvd_serving_rejects_total",
            "Requests rejected at admission",
            tenant=handle.tenant, reason=reason).inc()
        return handle

    # -- scheduling --------------------------------------------------------

    def _fill(self) -> None:
        """Continuous batching join: top every healthy replica's batch
        up to ``max_batch`` from the tenant queues, round-robin across
        tenants so no tenant monopolizes the step."""
        for idx in self._healthy():
            batch = self._assigned[idx]
            while len(batch) < self.max_batch:
                seq = self._next_queued()
                if seq is None:
                    return
                batch[seq.handle.request_id] = seq

    def _next_queued(self) -> Optional[_Seq]:
        for _ in range(len(self._rr)):
            name = self._rr.pop(0)
            self._rr.append(name)
            q = self._queues[name]
            if q:
                return q.popleft()
        return None

    def step(self) -> int:
        """One token-level step across every replica; returns the number
        of tokens produced.  Sequences join before the step and leave
        the moment they complete — the continuous-batching boundary."""
        with self._lock:
            storm = faults.storm_requests()
            if storm:
                self._ensure_storm_tenant()
                telemetry.counter(
                    "hvd_serving_storm_requests_total",
                    "Synthetic requests injected by chaos "
                    "request_storm").inc(storm)
                for i in range(storm):
                    self._storm_seq += 1
                    self.submit(STORM_TENANT, prompt_token=i,
                                max_new_tokens=4,
                                request_id=f"storm-{self._storm_seq}")
            self._fill()
            produced = 0
            for idx in self._healthy():
                batch = self._assigned[idx]
                if not batch:
                    continue
                seqs = [(rid, batch[rid].last_token, batch[rid].pos)
                        for rid in sorted(batch)]
                t0 = self._clock()
                # Request-scoped trace span: the router->replica leg of a
                # decode step, on the real monotonic clock (the injectable
                # self._clock may be synthetic in tests).
                sp = telemetry.spans()
                t0m = time.monotonic() if sp is not None else 0.0
                try:
                    resp = self.replicas[idx].decode(seqs)
                except Exception as e:                # noqa: BLE001
                    self._failover(idx, e)
                    continue
                if sp is not None:
                    sp.event(f"serving/route.replica{idx}", "route",
                             t0m, time.monotonic())
                dt = max(0.0, self._clock() - t0)
                self._step_ewma = dt if self._step_ewma == 0.0 else \
                    0.8 * self._step_ewma + 0.2 * dt
                telemetry.histogram(
                    "hvd_serving_batch_occupancy",
                    "Sequences per executed decode step",
                    bounds=OCCUPANCY_BUCKETS).observe(float(len(seqs)))
                produced += self._advance(idx, resp["tokens"])
            self._update_gauges()
            return produced

    def _advance(self, idx: int, tokens: Dict[str, int]) -> int:
        batch = self._assigned[idx]
        now = self._clock()
        n = 0
        for rid, tok in tokens.items():
            seq = batch.get(rid)
            if seq is None:
                continue
            seq.last_token = int(tok)
            seq.pos += 1
            seq.handle.tokens.append(int(tok))
            n += 1
            tenant = seq.handle.tenant
            telemetry.counter(
                "hvd_serving_tokens_total",
                "Tokens generated", tenant=tenant).inc()
            if seq.first_token_at is None:
                seq.first_token_at = now
                telemetry.histogram(
                    "hvd_serving_ttft_seconds",
                    "Submit-to-first-token latency",
                    bounds=LATENCY_BUCKETS, tenant=tenant).observe(
                    max(0.0, now - seq.submitted_at))
            if len(seq.handle.tokens) >= seq.max_new_tokens:
                del batch[rid]
                self.completed += 1
                latency = max(0.0, now - seq.submitted_at)
                self._latencies.append(latency)
                telemetry.counter(
                    "hvd_serving_completed_total",
                    "Requests completed", tenant=tenant).inc()
                telemetry.histogram(
                    "hvd_serving_latency_seconds",
                    "Submit-to-completion latency",
                    bounds=LATENCY_BUCKETS, tenant=tenant).observe(latency)
                sp = telemetry.spans()
                if sp is not None:
                    # End-to-end request span, unique by request id.  The
                    # end sits on the monotonic clock; the start is backed
                    # off by the measured latency (exact whenever
                    # self._clock IS time.monotonic, the production case).
                    now_m = time.monotonic()
                    sp.event(f"request/{rid}", "route", now_m - latency,
                             now_m)
                seq.handle.done.set()
        return n

    def _failover(self, idx: int, error: Exception) -> None:
        """A replica's decode failed mid-step: mark it unhealthy and
        re-queue its whole running batch, token state intact, at the
        front of each tenant queue.  Deterministic decode makes the
        retried step idempotent by request id."""
        self.replicas[idx].healthy = False
        batch = self._assigned[idx]
        retried = list(batch.values())
        batch.clear()
        if retried:
            telemetry.counter(
                "hvd_serving_retries_total",
                "In-flight requests re-queued after a replica "
                "failure").inc(len(retried))
        if not self._healthy():
            for seq in retried:
                self._drop(seq)
            for q in self._queues.values():
                while q:
                    self._drop(q.popleft())
            return
        for seq in reversed(retried):
            self._queues[seq.handle.tenant].appendleft(seq)

    def _drop(self, seq: _Seq) -> None:
        self.dropped += 1
        seq.handle.dropped = True
        telemetry.counter(
            "hvd_serving_dropped_total",
            "Admitted requests lost with no healthy replica left",
            tenant=seq.handle.tenant).inc()
        seq.handle.done.set()

    def _update_gauges(self) -> None:
        if not telemetry.enabled():
            return
        for name, q in self._queues.items():
            telemetry.gauge(
                "hvd_serving_queue_depth",
                "Requests queued per tenant", tenant=name).set(
                float(len(q)))
        telemetry.gauge(
            "hvd_serving_inflight",
            "Sequences currently assigned to replica batches").set(
            float(sum(len(b) for b in self._assigned)))
        telemetry.gauge(
            "hvd_serving_replicas_healthy",
            "Replicas the router considers healthy").set(
            float(len(self._healthy())))

    # -- hot updates -------------------------------------------------------

    def push_weights(self, weights, generation: int) -> int:
        """Stage a weight generation on every healthy replica (applied
        at each replica's next step boundary — zero requests dropped).
        Returns the number of replicas that accepted the update.  A
        tensor is copied to the host once, before the first replica."""
        if isinstance(weights, torch.Tensor):
            weights = host_weights(weights)
        pushed = 0
        with self._lock:
            targets = self._healthy()
        for idx in targets:
            try:
                self.replicas[idx].update_weights(weights,
                                                  int(generation))
                pushed += 1
            except Exception as e:                    # noqa: BLE001
                with self._lock:
                    self._failover(idx, e)
        self.generation = int(generation)
        return pushed

    # -- draining / serving ------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values()) + \
                sum(len(b) for b in self._assigned)

    def drain(self, max_steps: int = 100000) -> None:
        """Step until nothing is queued or in flight (tests/benchmarks)."""
        for _ in range(max_steps):
            if not self.pending():
                return
            self.step()
        raise RuntimeError(f"router did not drain in {max_steps} steps")

    def serve(self, stats_path: Optional[str] = None,
              idle_sleep: float = 0.005) -> None:
        """Run the scheduler on a background thread until
        :meth:`close`; with ``stats_path`` (or
        ``HOROVOD_SERVING_STATS``), publish :meth:`stats` every
        ``HOROVOD_SERVING_STATS_INTERVAL`` seconds for the autoscaler."""
        path = stats_path or stats_path_from_env()
        interval = config.env_float("HOROVOD_SERVING_STATS_INTERVAL")
        self._stop.clear()

        def loop():
            last_stats = 0.0
            while not self._stop.is_set():
                if not self.step():
                    time.sleep(idle_sleep)
                if path and time.monotonic() - last_stats >= interval:
                    last_stats = time.monotonic()
                    self.write_stats(path)
            if path:
                self.write_stats(path)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="hvd-serving-router")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- autoscaler handshake ----------------------------------------------

    def p99_ms(self) -> float:
        with self._lock:
            lat = sorted(self._latencies)
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1000.0

    def stats(self) -> dict:
        """The queue-pressure summary an autoscaler scales on (schema
        ``horovod_tpu.serving.stats.v1``, kept from the reference)."""
        with self._lock:
            depth = sum(len(q) for q in self._queues.values())
            inflight = sum(len(b) for b in self._assigned)
            slos = [t.slo_ms for t in self._tenants.values() if t.slo_ms]
        return {
            "schema": "horovod_tpu.serving.stats.v1",
            "queue_depth": depth,
            "inflight": inflight,
            "healthy_replicas": len(self._healthy()),
            "p99_ms": round(self.p99_ms(), 3),
            "slo_ms": min(slos) if slos else 0.0,
            "completed": self.completed,
            "dropped": self.dropped,
        }

    def write_stats(self, path: str) -> None:
        """Atomic publish (write-then-rename): the autoscaler polling
        mid-write must see the previous snapshot, never a torn one."""
        doc = self.stats()
        dirname = os.path.dirname(os.path.abspath(path))
        os.makedirs(dirname, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
