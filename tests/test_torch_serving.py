"""The port's serving plane (``horovod_tpu_torch/serving/``) held against
the reference's ``horovod_tpu/serving/`` on the CPU.

* The cases of ``tests/test_serving.py`` from the decode contract to the
  stats handshake, on the port: ToyModel, the replica worker and its
  authenticated RPC surface, the continuous-batching router (join and
  leave at step boundaries, round robin, admission, hot updates, crash
  failover, the chaos kinds, stats and the serve thread).  The fleet and
  autoscaler cases belong to the launcher and stay with the reference.
* Seeded ``(token, pos)`` batches through both packages' ToyModel, with
  integer and non-integer weights: equal tokens and checksums.
* One router episode through both packages (tenants, fixed request ids,
  one virtual clock, quota, SLO and capacity rejects, a storm, a replica
  that fails mid-step, a hot update mid-stream, drops): equal streams,
  rejections, drops, ``stats()`` documents and serving series.
* ``run_serving_benchmark(device="cpu")``'s rows equal the reference's.
* The serving fault kinds parse as the reference's ``parse_spec`` does.
* A 2-rank port job over gloo playing ``tests/distributed/serving_np2.py``:
  two tenants over both replicas through ``RpcReplicaHandle``, rank 1
  serving while it sits in ``broadcast_weights``, zero drops, every
  stream flipping generation at its pause point, and the merged series
  that the CI's serving lane checks.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import horovod_tpu.serving as ref_serving
from horovod_tpu import faults as ref_faults
from horovod_tpu import telemetry as ref_telemetry
from horovod_tpu.runner import rpc as ref_rpc
from horovod_tpu.telemetry import aggregate as ref_aggregate
from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runner import rpc
from horovod_tpu_torch.serving import (LocalReplicaHandle, ReplicaCrashed,
                                       ReplicaWorker, Router,
                                       RpcReplicaHandle, TenantConfig,
                                       ToyModel, broadcast_weights,
                                       load_replica_model)
from horovod_tpu_torch.telemetry import aggregate
from torch_support import run_port_job, world1  # noqa: F401

KEY = b"0123456789abcdef0123456789abcdef"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in (faults.ENV_VAR, "HOROVOD_RANK", "HOROVOD_RESTART_ATTEMPT"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()


@pytest.fixture()
def metrics():
    for t in (telemetry, ref_telemetry):
        t.registry().clear()
        t.configure(enabled_flag=True)
    yield telemetry
    for t in (telemetry, ref_telemetry):
        t.configure(enabled_flag=False)
        t.registry().clear()


def toy(weights=None, generation=0):
    return ToyModel(weights, generation, device="cpu")


def expected_stream(prompt, n, weights=None, start_pos=0):
    """The reference's decode: what a ToyModel stream must produce."""
    m = ref_serving.ToyModel(weights)
    tok, out = prompt, []
    for pos in range(start_pos, start_pos + n):
        tok = m.decode_step([(tok, pos)])[0]
        out.append(tok)
    return out


def make_router(n_replicas=1, tenants=("a",), **kw):
    workers = [ReplicaWorker(toy(), replica_id=f"r{i}")
               for i in range(n_replicas)]
    router = Router([LocalReplicaHandle(w) for w in workers],
                    [TenantConfig(t, quota=64, slo_ms=0.0)
                     for t in tenants], **kw)
    return router, workers


# -- model -------------------------------------------------------------------

WEIGHTS = {
    "default": None,
    "integer": np.arange(8, dtype=np.float32) + 100.0,
    "seeded normal": np.random.default_rng(1).standard_normal(4096)
    .astype(np.float32) * 37.25,
    "large": np.random.default_rng(2).uniform(-3e6, 5e6, 1000)
    .astype(np.float32),
    "negative": -np.linspace(0.1, 900.7, 77, dtype=np.float32),
}


@pytest.mark.parametrize("label", sorted(WEIGHTS))
def test_toy_model_streams_match_the_reference(label):
    w = WEIGHTS[label]
    rng = np.random.default_rng(0)
    mine, ref = toy(w), ref_serving.ToyModel(w)
    assert mine.get_weights().dtype == torch.float32
    assert mine._checksum() == ref._checksum()
    for _ in range(4):
        n = int(rng.integers(1, 9))
        batch = list(zip(rng.integers(0, 10 ** 6, n).tolist(),
                         rng.integers(0, 4096, n).tolist()))
        got = mine.decode_step(batch)
        assert got == ref.decode_step(batch)
        assert all(type(t) is int for t in got)
    # The checksum is taken from the host copy however the weights come.
    if w is not None:
        mine.set_weights(torch.as_tensor(w), 3)
        assert mine._checksum() == ref._checksum() and mine.generation == 3
    assert mine.decode_step([]) == []


def test_toy_model_deterministic_and_generation_sensitive():
    a, b = toy(), toy()
    batch = [(3, 0), (7, 4)]
    assert a.decode_step(batch) == b.decode_step(batch)
    before = a.decode_step(batch)
    a.set_weights(np.arange(8, dtype=np.float32) + 100.0, generation=1)
    assert a.generation == 1
    assert a.decode_step(batch) != before


def test_toy_model_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ToyModel()


# -- replica worker ----------------------------------------------------------

def test_worker_applies_staged_update_at_step_boundary():
    w = ReplicaWorker(toy())
    r1 = w.decode([("x", 3, 0)])
    assert r1["generation"] == 0
    w.stage_update(np.ones(8, np.float32) * 50, generation=7)
    assert w.model.generation == 0  # staged, not yet applied
    r2 = w.decode([("x", 3, 0)])
    assert r2["generation"] == 7
    assert r2["tokens"]["x"] != r1["tokens"]["x"]
    assert r2["tokens"]["x"] == ref_serving.ToyModel(
        np.ones(8, np.float32) * 50).decode_step([(3, 0)])[0]


def test_worker_rpc_roundtrip_and_concurrent_probe():
    w = ReplicaWorker(toy(), replica_id="rpc0", step_time=0.5)
    server = w.attach(KEY)
    try:
        h = RpcReplicaHandle("127.0.0.1", server.port, KEY)
        assert h.ping()["replica"] == "rpc0"
        slow = {}
        t = threading.Thread(target=lambda: slow.update(
            h.decode([("q", 5, 0)])))
        t.start()
        time.sleep(0.1)
        t0 = time.monotonic()
        assert h.ping()["generation"] == 0      # answers mid-decode
        assert time.monotonic() - t0 < 0.4
        t.join()
        assert slow["tokens"]["q"] == expected_stream(5, 1)[0]
        w.step_time = 0.0
        h.update_weights(torch.zeros(8), 3)     # a tensor crosses as an array
        assert h.decode([("q", 5, 1)])["generation"] == 3
        stats = h._call({"kind": "stats"})
        assert (stats["decode_steps"], stats["dead"]) == (2, False)
        assert h._rpc.rpc_call("127.0.0.1", server.port, {"kind": "nope"},
                               KEY)["ok"] is False
    finally:
        server.shutdown()


def test_worker_rpc_rejects_wrong_key():
    w = ReplicaWorker(toy())
    server = w.attach(KEY)
    try:
        bad = RpcReplicaHandle("127.0.0.1", server.port, b"x" * 32,
                               timeout=2.0)
        with pytest.raises((ConnectionError, OSError)):
            bad.ping()
    finally:
        server.shutdown()


def test_rpc_server_speaks_the_references_wire():
    """The reference's client reaches the port's server and the port's
    client the reference's, one request a connection."""
    seen = []
    mine = rpc.RpcServer(KEY, lambda r: seen.append(r) or {"echo": r},
                         bind="127.0.0.1")
    theirs = ref_rpc.RpcServer(KEY, lambda r: {"echo": r}, bind="127.0.0.1")
    try:
        assert ref_rpc.rpc_call("127.0.0.1", mine.port, [1, "a"], KEY,
                                retries=0) == {"echo": [1, "a"]}
        assert rpc.rpc_call("127.0.0.1", theirs.port, {"kind": "x"}, KEY,
                            retries=0) == {"echo": {"kind": "x"}}
        with pytest.raises((ConnectionError, OSError)):
            rpc.rpc_call("127.0.0.1", mine.port, "bad", b"y" * 32,
                         timeout=2.0, retries=0)
        assert seen == [[1, "a"]]               # the bad one never ran
    finally:
        mine.shutdown()
        theirs.shutdown()


# -- router: continuous batching ---------------------------------------------

def test_single_stream_exact_tokens():
    router, _ = make_router()
    h = router.submit("a", prompt_token=3, max_new_tokens=5)
    router.drain()
    assert h.completed and h.tokens == expected_stream(3, 5)


def test_batch_occupancy_and_short_leaves_early():
    router, _ = make_router(max_batch=4)
    short = router.submit("a", 1, max_new_tokens=2)
    long = router.submit("a", 2, max_new_tokens=6)
    steps = 0
    while router.pending():
        router.step()
        steps += 1
    assert steps == 6
    assert short.completed and long.completed
    assert short.tokens == expected_stream(1, 2)
    assert long.tokens == expected_stream(2, 6)


def test_sequence_joins_running_batch_at_boundary():
    router, _ = make_router(max_batch=4)
    long = router.submit("a", 2, max_new_tokens=6)
    router.step()
    router.step()
    late = router.submit("a", 9, max_new_tokens=2)
    steps = 2
    while router.pending():
        router.step()
        steps += 1
    assert steps == 6
    assert late.completed and late.tokens == expected_stream(9, 2)
    assert long.tokens == expected_stream(2, 6)


def test_round_robin_across_tenants():
    router, _ = make_router(tenants=("a", "b"), max_batch=1)
    ha1 = router.submit("a", 1, max_new_tokens=1)
    ha2 = router.submit("a", 2, max_new_tokens=1)
    hb1 = router.submit("b", 3, max_new_tokens=1)
    order = []
    for _ in range(3):
        router.step()
        for name, h in (("a1", ha1), ("a2", ha2), ("b1", hb1)):
            if h.completed and name not in order:
                order.append(name)
    assert order == ["a1", "b1", "a2"]


def test_occupancy_histogram_exceeds_one(metrics):
    router, _ = make_router(max_batch=8)
    for i in range(4):
        router.submit("a", i, max_new_tokens=3)
    router.drain()
    fam = telemetry.metrics_snapshot()["hvd_serving_batch_occupancy"]
    (entry,) = fam["values"]
    assert entry["sum"] / entry["count"] > 1.0


# -- router: admission -------------------------------------------------------

def test_unknown_tenant_raises():
    router, _ = make_router()
    with pytest.raises(KeyError):
        router.submit("nope", 1)


def test_quota_reject(metrics):
    router, _ = make_router()
    router._tenants["a"].quota = 2
    assert router.submit("a", 1).rejected is None
    assert router.submit("a", 2).rejected is None
    h = router.submit("a", 3)
    assert h.rejected == "quota" and not h.completed
    assert aggregate.counter_total(
        telemetry.metrics_snapshot(), "hvd_serving_rejects_total",
        {"tenant": "a", "reason": "quota"}) == 1


def test_slo_reject_uses_estimated_wait(metrics):
    router, _ = make_router(max_batch=1)
    router._tenants["a"].slo_ms = 10.0
    router._step_ewma = 1.0
    assert router.submit("a", 1).rejected is None
    h = router.submit("a", 2)
    assert h.rejected == "slo"
    assert aggregate.counter_total(
        telemetry.metrics_snapshot(), "hvd_serving_rejects_total",
        {"tenant": "a", "reason": "slo"}) == 1


def test_capacity_reject_when_no_healthy_replica():
    router, _ = make_router()
    router.replicas[0].healthy = False
    assert router.submit("a", 1).rejected == "capacity"


def test_defaults_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVING_MAX_BATCH", "3")
    monkeypatch.setenv("HOROVOD_SERVING_QUOTA", "5")
    monkeypatch.setenv("HOROVOD_SERVING_SLO_MS", "12.5")
    router = Router([LocalReplicaHandle(ReplicaWorker(toy()))],
                    [TenantConfig("a")])
    assert router.max_batch == 3
    assert (router._tenants["a"].quota, router._tenants["a"].slo_ms) == (
        5, 12.5)
    with pytest.raises(ValueError, match="max_batch"):
        Router([LocalReplicaHandle(ReplicaWorker(toy()))],
               [TenantConfig("a")], max_batch=0)


# -- router: hot weight updates ----------------------------------------------

def test_hot_update_mid_stream_changes_tokens_zero_drops():
    router, workers = make_router()
    new_w = np.ones(8, np.float32) * 123
    h = router.submit("a", 3, max_new_tokens=8)
    for _ in range(3):
        router.step()
    assert router.push_weights(torch.as_tensor(new_w), generation=1) == 1
    router.drain()
    assert h.completed and not h.dropped
    assert workers[0].model.generation == 1
    head = expected_stream(3, 3)
    tail = expected_stream(head[-1], 5, weights=new_w, start_pos=3)
    assert h.tokens == head + tail
    assert h.tokens != expected_stream(3, 8)


def test_push_weights_reaches_all_replicas():
    router, workers = make_router(n_replicas=3)
    assert router.push_weights(np.zeros(8, np.float32), 4) == 3
    for w in workers:
        w.decode([("warm", 1, 0)])
        assert w.model.generation == 4
    assert router.generation == 4


def test_broadcast_weights_at_size_one(world1):  # noqa: F811
    w = np.arange(8, dtype=np.float32) * 1.5
    got, gen = broadcast_weights(w, 6)
    assert gen == 6 and isinstance(got, torch.Tensor)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), w)


def test_load_replica_model_takes_the_checkpoints_step(world1,  # noqa: F811
                                                       tmp_path):
    from horovod_tpu_torch import checkpoint

    m = load_replica_model(str(tmp_path / "none"), device="cpu")
    assert m.generation == 0 and m._checksum() == toy()._checksum()
    w = np.arange(8, dtype=np.float32) + 41.0
    assert checkpoint.save(str(tmp_path), {"w": w}, step=5)
    m = load_replica_model(str(tmp_path), device="cpu")
    assert m.generation == 5
    assert np.array_equal(m.get_weights().numpy(), w)
    assert m.decode_step([(2, 3)]) == ref_serving.ToyModel(w).decode_step(
        [(2, 3)])


# -- router: crash failover --------------------------------------------------

class FlakyHandle(LocalReplicaHandle):
    """Delegates to a real worker but fails its Nth decode call."""

    def __init__(self, worker, fail_on=1):
        super().__init__(worker)
        self.calls = 0
        self.fail_on = fail_on

    def decode(self, seqs):
        self.calls += 1
        if self.calls == self.fail_on:
            raise ConnectionError("replica went away mid-step")
        return super().decode(seqs)


def test_crash_retry_is_idempotent_by_request_id(metrics):
    control, _ = make_router(n_replicas=2, max_batch=4)
    expect = {i: control.submit("a", i, max_new_tokens=5) for i in range(4)}
    control.drain()

    flaky = FlakyHandle(ReplicaWorker(toy(), replica_id="flaky"), fail_on=3)
    good = LocalReplicaHandle(ReplicaWorker(toy(), replica_id="ok"))
    router = Router([flaky, good],
                    [TenantConfig("a", quota=64, slo_ms=0.0)], max_batch=4)
    handles = {i: router.submit("a", i, max_new_tokens=5) for i in range(4)}
    router.drain()
    assert not flaky.healthy
    assert router.dropped == 0
    for i in range(4):
        assert handles[i].completed
        assert handles[i].tokens == expect[i].tokens
    snap = telemetry.metrics_snapshot()
    assert aggregate.counter_total(snap, "hvd_serving_retries_total") > 0
    assert aggregate.counter_total(snap, "hvd_serving_dropped_total") == 0


def test_all_replicas_dead_drops_and_rejects(metrics):
    flaky = FlakyHandle(ReplicaWorker(toy()), fail_on=1)
    router = Router([flaky], [TenantConfig("a", quota=64, slo_ms=0.0)])
    h = router.submit("a", 1, max_new_tokens=3)
    router.step()
    assert h.dropped and not h.completed
    assert router.dropped == 1
    assert router.submit("a", 2).rejected == "capacity"
    assert aggregate.counter_total(
        telemetry.metrics_snapshot(), "hvd_serving_dropped_total",
        {"tenant": "a"}) == 1


# -- chaos kinds -------------------------------------------------------------

SPECS = ["site=serving,kind=replica_crash",
         "site=serving,kind=replica_crash:3",
         "site=serving,kind=replica_crash:2,count=5,after=4,rank=1",
         "site=serving,kind=request_storm",
         "site=serving,kind=request_storm:40",
         "kind=request_storm:7,count=3;site=serving,kind=replica_crash,"
         "attempt=1"]
BAD_SPECS = ["kind=replica_crash:0", "kind=request_storm:0",
             "kind=replica_crash:x", "kind=request_storm:-2"]


def test_parse_spec_serving_kinds_match_the_reference():
    fields = ("rank", "site", "after", "kind", "arg", "count", "attempt")
    for spec in SPECS:
        got = [[getattr(r, f) for f in fields] for r in
               faults.parse_spec(spec)]
        want = [[getattr(r, f) for f in fields] for r in
                ref_faults.parse_spec(spec)]
        assert got == want, spec
    for spec in BAD_SPECS:
        with pytest.raises(ValueError) as ref_err:
            ref_faults.parse_spec(spec)
        with pytest.raises(ValueError) as err:
            faults.parse_spec(spec)
        assert str(err.value) == str(ref_err.value)
    (r,) = faults.parse_spec("site=serving,kind=replica_crash")
    assert r.kind == "replica_crash" and r.count == 1
    (r,) = faults.parse_spec("site=serving,kind=request_storm:40")
    assert r.kind == "request_storm" and r.arg == 40 and r.count == 1


def test_hooks_arm_like_the_references(monkeypatch):
    for spec in ("site=serving,kind=replica_crash,after=2",
                 "site=serving,kind=replica_crash:2,after=1",
                 "kind=request_storm:3,count=2,after=1",
                 "site=heartbeat,kind=request_storm"):
        monkeypatch.setenv(faults.ENV_VAR, spec)
        faults.reset()
        ref_faults.reset()
        assert [faults.crash_replica() for _ in range(5)] == [
            ref_faults.crash_replica() for _ in range(5)], spec
        assert [faults.storm_requests() for _ in range(5)] == [
            ref_faults.storm_requests() for _ in range(5)], spec
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    assert not faults.crash_replica() and faults.storm_requests() == 0


def test_replica_crash_kills_worker_mid_request(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "site=serving,kind=replica_crash")
    faults.reset()
    w = ReplicaWorker(toy())
    with pytest.raises(ReplicaCrashed):
        w.decode([("x", 1, 0)])
    with pytest.raises(ReplicaCrashed):
        w.decode([("x", 1, 1)])


def test_rpc_replica_crash_fails_over_with_equal_streams(monkeypatch):
    """A crash over the RPC plane: the worker shuts its listener down,
    the request in flight gets no answer, the router retries the batch
    on the other replica and the streams equal a clean run's."""
    clean, _ = make_router(n_replicas=2, max_batch=4)
    want = [clean.submit("a", i, max_new_tokens=4).tokens for i in range(6)]
    clean.drain()
    workers = [ReplicaWorker(toy(), replica_id=f"r{i}") for i in range(2)]
    servers = [w.attach(KEY) for w in workers]
    try:
        handles = [RpcReplicaHandle("127.0.0.1", s.port, KEY, timeout=5.0)
                   for s in servers]
        router = Router(handles, [TenantConfig("a", quota=64, slo_ms=0.0)],
                        max_batch=4)
        monkeypatch.setenv(faults.ENV_VAR,
                           "site=serving,kind=replica_crash,after=2")
        faults.reset()
        got = [router.submit("a", i, max_new_tokens=4) for i in range(6)]
        router.drain()
        assert [h.tokens for h in got] == want
        assert router.dropped == 0 and router.completed == 6
        assert sum(not h.healthy for h in handles) == 1
        assert sum(w._dead for w in workers) == 1
    finally:
        for s in servers:
            s.shutdown()


def test_request_storm_floods_router(monkeypatch, metrics):
    monkeypatch.setenv(faults.ENV_VAR,
                       "site=serving,kind=request_storm:12")
    faults.reset()
    router, _ = make_router(max_batch=4)
    router.step()
    snap = telemetry.metrics_snapshot()
    assert aggregate.counter_total(
        snap, "hvd_serving_storm_requests_total") == 12
    assert aggregate.counter_total(
        snap, "hvd_serving_requests_total", {"tenant": "storm"}) == 12
    router.drain()
    assert router.completed == 12


# -- router: stats handshake -------------------------------------------------

def test_stats_and_atomic_write(tmp_path):
    router, _ = make_router(tenants=("a", "b"))
    router._tenants["b"].slo_ms = 250.0
    for i in range(3):
        router.submit("a", i, max_new_tokens=2)
    doc = router.stats()
    assert doc["schema"] == "horovod_tpu.serving.stats.v1"
    assert doc["queue_depth"] == 3 and doc["healthy_replicas"] == 1
    assert doc["slo_ms"] == 250.0
    path = tmp_path / "stats.json"
    router.write_stats(str(path))
    assert json.loads(path.read_text())["queue_depth"] == 3
    assert [p for p in os.listdir(tmp_path)
            if p.startswith("stats.json.tmp")] == []


def test_serve_thread_publishes_stats(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVING_STATS_INTERVAL", "0.01")
    monkeypatch.setenv("HOROVOD_SERVING_STATS", str(tmp_path / "env.json"))
    path = tmp_path / "s.json"
    router, _ = make_router()
    router.serve(stats_path=str(path))
    try:
        h = router.submit("a", 1, max_new_tokens=3)
        assert h.wait(timeout=5.0) and h.completed
        deadline = time.monotonic() + 5.0
        while not path.exists():
            assert time.monotonic() < deadline, "no stats publish"
            time.sleep(0.005)
    finally:
        router.close()
    assert json.loads(path.read_text())["completed"] >= 1
    assert not (tmp_path / "env.json").exists()


# -- one episode through both packages ---------------------------------------

PORT = types.SimpleNamespace(
    serving=types.SimpleNamespace(
        ToyModel=lambda w=None: ToyModel(w, device="cpu"),
        ReplicaWorker=ReplicaWorker, LocalReplicaHandle=LocalReplicaHandle,
        Router=Router, TenantConfig=TenantConfig),
    faults=faults, telemetry=telemetry)
REF = types.SimpleNamespace(serving=ref_serving, faults=ref_faults,
                            telemetry=ref_telemetry)


def _episode(pkg, monkeypatch):
    """Tenants a (quota 5) and b (SLO 6 ms) over a replica that fails on
    its 4th step and a steady one, 4 ms of virtual time a decode; a storm
    of 5 after two passes; a hot update after the 4th step; then a router
    over one replica that dies at its 2nd step (drops, capacity)."""
    s = pkg.serving
    clock = [0.0]

    class Timed(s.LocalReplicaHandle):
        def __init__(self, worker, fail_on=None):
            super().__init__(worker)
            self.calls, self.fail_on = 0, fail_on

        def decode(self, seqs):
            self.calls += 1
            clock[0] += 0.004
            if self.calls == self.fail_on:
                raise ConnectionError("replica went away mid-step")
            return super().decode(seqs)

    monkeypatch.setenv(faults.ENV_VAR,
                       "site=serving,kind=request_storm:5,after=2")
    pkg.faults.reset()
    pkg.telemetry.registry().clear()
    pkg.telemetry.configure(enabled_flag=True)
    try:
        flaky = Timed(s.ReplicaWorker(s.ToyModel(), replica_id="flaky"), 4)
        steady = Timed(s.ReplicaWorker(s.ToyModel(), replica_id="steady"))
        router = s.Router([flaky, steady],
                          [s.TenantConfig("a", quota=5, slo_ms=0.0),
                           s.TenantConfig("b", quota=64, slo_ms=6.0)],
                          max_batch=3, clock=lambda: clock[0])
        handles = {}
        for step in range(14):
            for i in range(3):
                rid = f"a{step}.{i}"
                handles[rid] = router.submit("a", 7 * step + i,
                                             max_new_tokens=2 + (i + step)
                                             % 4, request_id=rid)
            rid = f"b{step}"
            handles[rid] = router.submit("b", 1000 + step, max_new_tokens=5,
                                         request_id=rid)
            router.step()
            clock[0] += 0.001
            if step == 3:
                router.push_weights(np.arange(8, dtype=np.float32) * 2.5, 1)
        stats_mid = router.stats()
        router.drain()
        lone = Timed(s.ReplicaWorker(s.ToyModel(), replica_id="lone"), 2)
        dying = s.Router([lone], [s.TenantConfig("a", quota=64, slo_ms=0.0)],
                         max_batch=2, clock=lambda: clock[0])
        for i in range(3):
            handles[f"d{i}"] = dying.submit("a", i, max_new_tokens=4,
                                            request_id=f"d{i}")
        dying.step()
        dying.step()
        handles["late"] = dying.submit("a", 9, request_id="late")
        snap = pkg.telemetry.metrics_snapshot()
    finally:
        pkg.telemetry.configure(enabled_flag=False)
        pkg.telemetry.registry().clear()
    snap.pop("hvd_serving_decode_seconds")      # wall time, not modelled
    return {
        "streams": {rid: h.tokens for rid, h in handles.items()},
        "rejected": {rid: h.rejected for rid, h in handles.items()
                     if h.rejected},
        "dropped": sorted(rid for rid, h in handles.items() if h.dropped),
        "stats": [stats_mid, router.stats(), dying.stats()],
        "healthy": [flaky.healthy, steady.healthy, lone.healthy],
        "series": snap,
    }


def test_a_router_episode_matches_the_reference(monkeypatch):
    mine, ref = _episode(PORT, monkeypatch), _episode(REF, monkeypatch)
    assert mine == ref
    # The episode exercised what it is there for.
    reasons = set(mine["rejected"].values())
    assert reasons == {"quota", "slo", "capacity"}, reasons
    assert mine["dropped"] == ["d0", "d1", "d2"]
    assert mine["healthy"] == [False, True, False]
    assert mine["stats"][1]["completed"] == 19
    series = mine["series"]
    assert aggregate.counter_total(
        series, "hvd_serving_requests_total", {"tenant": "storm"}) == 5
    assert aggregate.counter_total(series, "hvd_serving_retries_total") > 0
    assert aggregate.counter_total(
        series, "hvd_serving_weight_updates_total") == 1


def test_serving_lane_rows_equal_the_references():
    from horovod_tpu.benchmark import run_serving_benchmark as ref_lane
    from horovod_tpu_torch.benchmark import run_serving_benchmark

    mine = run_serving_benchmark(device="cpu")
    ref = ref_lane()
    assert mine["rows"] == ref["rows"]
    assert len(mine["rows"]) == 6
    assert {k: mine[k] for k in ("metric", "replicas", "num_requests",
                                 "tokens_per_request", "step_time_ms")} == {
        k: ref[k] for k in ("metric", "replicas", "num_requests",
                            "tokens_per_request", "step_time_ms")}


# -- the 2-rank episode of tests/distributed/serving_np2.py, on the port -----

SERVING_JOB = r'''
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import telemetry
from horovod_tpu_torch.runner import rpc
from horovod_tpu_torch.serving import (ReplicaWorker, Router,
                                       RpcReplicaHandle, TenantConfig,
                                       ToyModel, broadcast_weights)

out_dir = sys.argv[1]
GATE_DIR = os.environ["HOROVOD_SERVING_GATE_DIR"]
NEW_WEIGHTS = np.arange(8, dtype=np.float32) + 100.0
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
key = rpc.job_key_bytes(os.environ.get("HOROVOD_SECRET_KEY"))
worker = ReplicaWorker(ToyModel(device="cpu"), replica_id=f"r{rank}")
server = worker.attach(key)
os.makedirs(GATE_DIR, exist_ok=True)
with open(os.path.join(GATE_DIR, f"port.{rank}.tmp"), "w") as f:
    f.write(str(server.port))
os.replace(os.path.join(GATE_DIR, f"port.{rank}.tmp"),
           os.path.join(GATE_DIR, f"port.{rank}"))


def wait_for_file(name, timeout=60.0):
    path = os.path.join(GATE_DIR, name)
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {name}")
        time.sleep(0.02)
    return path


def touch(name):
    tmp = os.path.join(GATE_DIR, f"{name}.tmp")
    with open(tmp, "w") as f:
        f.write("ok\n")
    os.replace(tmp, os.path.join(GATE_DIR, name))


def expected_stream(prompt, n, weights=None, start_pos=0):
    m = ToyModel(weights, device="cpu")
    tok, out = prompt, []
    for pos in range(start_pos, start_pos + n):
        tok = m.decode_step([(tok, pos)])[0]
        out.append(tok)
    return out


result = {}
if rank != 0:
    # Serve on the RPC threads while the main thread sits in the
    # hot-update collective; stage what arrives, then keep serving.
    served_before = worker._decode_steps
    weights, gen = broadcast_weights(worker.model.get_weights(), 0)
    result["served_while_waiting"] = worker._decode_steps - served_before
    worker.stage_update(weights, gen)
    touch(f"staged.{rank}")
    wait_for_file("done")
    result["weights"] = weights.tolist()
    print(f"SERVING_REPLICA_OK rank={rank} staged_gen={gen}", flush=True)
else:
    handles = []
    for r in range(size):
        with open(wait_for_file(f"port.{r}")) as f:
            port = int(f.read().strip())
        handles.append(RpcReplicaHandle("127.0.0.1", port, key,
                                        timeout=30.0))
    router = Router(handles,
                    [TenantConfig("alice", quota=64, slo_ms=0.0),
                     TenantConfig("bob", quota=64, slo_ms=0.0)],
                    max_batch=4)
    phase1 = {}
    for i in range(4):
        phase1[("alice", i)] = router.submit("alice", i, max_new_tokens=5)
        phase1[("bob", i)] = router.submit("bob", 10 + i, max_new_tokens=3)
    router.drain()
    for (tenant, i), h in phase1.items():
        assert h.completed, (tenant, i, h.rejected, h.dropped)
        prompt = i if tenant == "alice" else 10 + i
        assert h.tokens == expected_stream(prompt, len(h.tokens)), (tenant, i)
    phase2 = {}
    for i in range(6):
        phase2[i] = router.submit("alice" if i % 2 else "bob", 20 + i,
                                  max_new_tokens=8)
    while any(len(h.tokens) < 2 for h in phase2.values()):
        router.step()
    pause = {i: list(h.tokens) for i, h in phase2.items()}
    weights, gen = broadcast_weights(NEW_WEIGHTS, 1)
    assert gen == 1 and np.array_equal(weights.numpy(), NEW_WEIGHTS)
    worker.stage_update(weights, gen)
    router.generation = gen
    for r in range(1, size):
        wait_for_file(f"staged.{r}")
    router.drain()
    assert router.dropped == 0, router.stats()
    for i, h in phase2.items():
        assert h.completed and not h.dropped, (i, h.rejected)
        head = pause[i]
        k = len(head)
        tail = expected_stream(head[-1], 8 - k, weights=NEW_WEIGHTS,
                               start_pos=k)
        assert h.tokens == head + tail, f"stream {i} did not flip at its pause"
        assert h.tokens != expected_stream(20 + i, 8), i
    probes = [h.decode([("probe", 1, 0)])["generation"] for h in handles]
    assert probes == [1] * size, probes
    result.update(phase1={f"{t}{i}": h.tokens for (t, i), h in phase1.items()},
                  phase2={str(i): h.tokens for i, h in phase2.items()},
                  pause={str(i): p for i, p in pause.items()},
                  stats=router.stats())
    touch("done")
    print(f"SERVING_OK rank=0 completed={router.completed} "
          f"dropped={router.dropped} tenants=alice,bob", flush=True)

server.shutdown()
with open(os.path.join(out_dir, f"metrics.{rank}.json"), "w") as f:
    json.dump(telemetry.metrics_snapshot(), f)
with open(os.path.join(out_dir, f"result.{rank}.json"), "w") as f:
    json.dump(result, f)
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), ok=np.ones(1))
hvd.shutdown()
'''


def test_two_rank_episode_over_gloo(tmp_path):
    out = tmp_path / "job"
    out.mkdir()
    env = {"HOROVOD_SERVING_GATE_DIR": str(tmp_path / "gate"),
           "HOROVOD_SECRET_KEY": "c2VydmluZy1nYXRlLWtleS0wMTIzNDU2Nzg5YWI=",
           "HOROVOD_METRICS": "1", "OMP_NUM_THREADS": "1"}
    for var in ("HOROVOD_FAULT_SPEC", "HOROVOD_METRICS_FILE",
                "HOROVOD_TRACE"):
        env[var] = ""
    _, logs = run_port_job(SERVING_JOB, str(out), np_=2, env=env,
                           timeout=150)
    text = "".join(logs)
    assert "SERVING_OK rank=0 completed=14 dropped=0 tenants=alice,bob" in \
        text, text[-3000:]
    assert "SERVING_REPLICA_OK rank=1 staged_gen=1" in text, text[-3000:]
    results = [json.loads((out / f"result.{r}.json").read_text())
               for r in (0, 1)]
    # Rank 1 served decodes while it sat in the broadcast.
    assert results[1]["served_while_waiting"] > 0
    assert results[1]["weights"] == (np.arange(8) + 100.0).tolist()
    stats = results[0]["stats"]
    assert (stats["completed"], stats["dropped"], stats["inflight"]) == (
        14, 0, 0)
    # The streams are the reference's ToyModel's, flipping at the pause.
    new_w = np.arange(8, dtype=np.float32) + 100.0
    for i, tokens in results[0]["phase2"].items():
        head = results[0]["pause"][i]
        k = len(head)
        assert tokens == head + expected_stream(head[-1], 8 - k,
                                                weights=new_w, start_pos=k)

    # What ci/run_tests.sh's serving lane asserts of the merged series.
    snaps = {str(r): json.loads((out / f"metrics.{r}.json").read_text())
             for r in (0, 1)}
    merged = aggregate.merge_snapshots(snaps)
    assert merged == ref_aggregate.merge_snapshots(snaps)
    for tenant in ("alice", "bob"):
        assert aggregate.counter_total(
            merged, "hvd_serving_completed_total", {"tenant": tenant}) == 7
    assert "hvd_serving_dropped_total" not in merged
    (occ,) = merged["hvd_serving_batch_occupancy"]["values"]
    assert occ["count"] and occ["sum"] / occ["count"] > 1
    assert aggregate.counter_total(
        merged, "hvd_serving_weight_updates_total") == 2
    for snap in snaps.values():
        (steps,) = snap["hvd_serving_decode_steps_total"]["values"]
        assert steps["value"] > 0
