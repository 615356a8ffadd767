"""The port's telemetry (``horovod_tpu_torch/telemetry``) held against the
reference's (``horovod_tpu/telemetry``), on the CPU.

* The registry: one recorded sequence renders to the same Prometheus text
  and snapshot in both packages; the bucket bounds and their ``le`` edges
  are the reference's.
* The no-op contract: with collection off, an op through the runtime
  records nothing, its entries carry no hook (so its wait reads no
  clock), and the fusion, codec and ZeRO paths leave the snapshot empty.
* The series of one op at size 1, the fusion walk's and the codec's,
  against the reference's recorders fed the same plan; the checkpoint
  and step-guard series.
* The exporters: the HTTP server and the ``horovod_tpu.metrics.v1``
  document; the eager timeline's SUBMIT/WAIT/FINISH rows.
* End to end: a 2-rank port job under the port's launcher with
  ``--metrics-file`` (the counterpart of
  ``tests/distributed/metrics_workload_np2.py``), merged by the port's
  ``aggregate``, beside the reference's own job under its launcher: the same series names, types, help texts, labels and bounds, and
  the same op counts, apart from the series each side has alone (listed
  below with the reason).
"""

import importlib
import json
import os
import subprocess
import sys
import urllib.request

import pytest
import torch

from horovod_tpu.telemetry import aggregate
from horovod_tpu.telemetry import exporter as ref_exporter
from horovod_tpu_torch import telemetry
from horovod_tpu_torch.ops import compression, fusion
from horovod_tpu_torch.parallel import zero
from horovod_tpu_torch.telemetry import exporter
from horovod_tpu_torch.telemetry.eager_timeline import (EagerTimelineWriter,
                                                        per_rank_path)
from torch_support import (PORT_LAUNCHER, REF_LAUNCHER, REPO,  # noqa: F401
                           free_port, world1)

ref_telemetry = importlib.import_module("horovod_tpu.telemetry")
# The packages' registry() accessors shadow the submodules.
registry = importlib.import_module("horovod_tpu_torch.telemetry.registry")
ref_registry = importlib.import_module("horovod_tpu.telemetry.registry")

# Series only the reference's job publishes: the native transports'
# (out of scope for the port) and the native chunk/shm/stripe knobs.
REF_ONLY = {"hvd_autotune_chunk_bytes", "hvd_autotune_shm_granule_bytes",
            "hvd_autotune_transport_stripes", "hvd_transport_bytes_total",
            "hvd_transport_ops_total", "hvd_transport_seconds_total"}
# Series only the port publishes: its fused eager responses as fusion
# walks of kind "eager", and gauges of state the reference exposes as
# native introspection symbols.
PORT_ONLY = {"hvd_coord_tree", "hvd_fusion_bucket_bytes",
             "hvd_fusion_buckets_total", "hvd_fusion_requests_total",
             "hvd_fusion_tensors_total", "hvd_membership_changed",
             "hvd_world_epoch"}


@pytest.fixture()
def metrics_on():
    telemetry.registry().clear()
    telemetry.configure(enabled_flag=True)
    yield telemetry
    telemetry.configure(enabled_flag=False)
    telemetry.registry().clear()


def _record(reg, counter, gauge, histogram):
    """One sequence of calls through a registry's API."""
    counter(reg, "ops_total", "Completed ops", {"op": "allreduce"}).inc(3)
    counter(reg, "ops_total", "Completed ops", {"op": "allgather"}).inc()
    gauge(reg, "depth", "Queue depth", None).set(2.5)
    gauge(reg, "depth", "Queue depth", None).dec(1)
    h = histogram(reg, "lat_seconds", "Latency\nseconds", {"op": 'a"b'},
                  ref_registry.DEFAULT_TIME_BUCKETS)
    for v in (0.0001, 0.00011, 0.05, 1.0, 59.9, 60.0, 61.0):
        h.observe(v)
    b = histogram(reg, "bw", "Bandwidth", None,
                  ref_registry.DEFAULT_BANDWIDTH_BUCKETS)
    for v in (1e6, 2.5e9, 1e12):
        b.observe(v)


@pytest.mark.parametrize("order", ["as_recorded", "reversed_labels"])
def test_the_same_sequence_renders_the_same_in_both_packages(order):
    regs = [registry.MetricsRegistry(), ref_registry.MetricsRegistry()]
    for reg in regs:
        labels = (lambda d: d) if order == "as_recorded" else (
            lambda d: dict(reversed(list(d.items()))) if d else d)
        _record(reg,
                lambda r, n, h, lb: r.counter(n, h, labels(lb)),
                lambda r, n, h, lb: r.gauge(n, h, labels(lb)),
                lambda r, n, h, lb, bounds: r.histogram(n, h, labels(lb),
                                                        bounds=bounds))
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].render_prometheus() == regs[1].render_prometheus()


def test_histogram_edges_are_the_references():
    assert registry.DEFAULT_TIME_BUCKETS == ref_registry.DEFAULT_TIME_BUCKETS
    assert registry.DEFAULT_BYTE_BUCKETS == ref_registry.DEFAULT_BYTE_BUCKETS
    assert (registry.DEFAULT_BANDWIDTH_BUCKETS
            == ref_registry.DEFAULT_BANDWIDTH_BUCKETS)
    for mod in (registry, ref_registry):
        h = mod.Histogram((1.0, 10.0))
        for v in (1.0, 1.0001, 10.0, 10.5):
            h.observe(v)
        assert h.buckets() == {"1.0": 1, "10.0": 2, "+Inf": 1}
    with pytest.raises(ValueError, match="ascending"):
        registry.Histogram((2.0, 1.0))


def test_the_disabled_path_records_nothing_and_reads_no_clock(
        world1, monkeypatch):
    telemetry.configure(enabled_flag=False)
    telemetry.registry().clear()
    assert not telemetry.active()
    assert telemetry.counter("c_total") is telemetry.NOOP
    assert telemetry.histogram("h") is telemetry.NOOP
    assert telemetry.spans() is None and telemetry.timeline() is None

    def no_clock():
        raise AssertionError("the disabled path read the clock")

    monkeypatch.setattr(telemetry, "clock", no_clock)
    rt = world1.basics.runtime()
    seen = []
    submit = rt.submit
    monkeypatch.setattr(rt, "submit", lambda entries, kind: (
        seen.extend(entries), submit(entries, kind))[1])
    out = world1.allreduce(torch.ones(8), average=False, name="off")
    assert out.tolist() == [1.0] * 8
    assert seen and all(e.telemetry is None for e in seen)
    fusion.fused_psum([torch.ones(3), torch.ones(2)], mean=False)
    codec = compression.resolve_codec("int8")
    params = [torch.ones(5), torch.ones(3)]
    from horovod_tpu_torch import optim
    zopt = zero.sharded_optimizer(optim.sgd(0.1), compression=codec)
    state = zopt.init(params)
    zopt.update([torch.ones(5), torch.ones(3)], state, params)
    assert telemetry.metrics_snapshot() == {}


def test_one_op_at_size_one_records_the_references_series(world1,
                                                          metrics_on):
    out = world1.allreduce(torch.ones(8), average=False, name="on")
    assert out.tolist() == [1.0] * 8
    snap = world1.metrics_snapshot()
    assert aggregate.counter_total(snap, "hvd_eager_ops_total",
                                   {"op": "allreduce"}) == 1
    assert aggregate.counter_total(snap, "hvd_eager_bytes_total",
                                   {"op": "allreduce"}) == 32
    lat = snap["hvd_eager_op_seconds"]["values"][0]
    assert lat["count"] == 1 and lat["sum"] > 0
    assert snap["hvd_native_wait_seconds"]["values"][0]["count"] == 1
    assert aggregate.counter_total(snap, "hvd_fusion_buckets_total",
                                   {"kind": "eager"}) == 1
    assert aggregate.counter_total(
        snap, "hvd_collective_bytes_total",
        {"plane": "eager", "kind": "allreduce"}) == 32
    # The reference's observe_op for the same op gives the same series.
    ref_telemetry.registry().clear()
    ref_telemetry.configure(enabled_flag=True)
    try:
        ref_telemetry.observe_op("allreduce", lat["sum"], 32)
        ref = ref_telemetry.metrics_snapshot()
    finally:
        ref_telemetry.configure(enabled_flag=False)
        ref_telemetry.registry().clear()
    for name in ref:
        assert snap[name] == ref[name], name


def test_fusion_and_codec_series_equal_the_references_recorders(
        world1, metrics_on):
    """The walk and the int8 codec on one plan, against the reference's
    ``_record_plan``/``_record_compression`` fed the reference's plan of
    the same leaves."""
    import jax.numpy as jnp
    from horovod_tpu.ops import compression as rcomp
    from horovod_tpu.ops import fusion as rfusion
    shapes = [(6,), (3, 2), (5,)]
    leaves = [torch.ones(s) for s in shapes]
    plan = fusion.make_reduce_scatter_plan(leaves, 1, threshold=32)
    codec = compression.resolve_codec("int8")
    shards, _ = compression.compressed_reduce_scatter(
        leaves, None, codec, plan=plan, state=codec.init_state(plan, None))
    compression.compressed_all_gather(shards, plan, None, codec,
                                      state=codec.init_state(plan, None))
    snap = world1.metrics_snapshot()
    rplan = rfusion.make_reduce_scatter_plan(
        [jnp.ones(s) for s in shapes], 1, threshold=32)
    ref_telemetry.registry().clear()
    ref_telemetry.configure(enabled_flag=True)
    try:
        rfusion._record_plan("reduce_scatter", rplan)
        nbytes = sum(rplan.padded_size(b) * rplan.bucket_dtype(b).itemsize
                     for b in range(len(rplan.buckets)))
        rs = aggregate.counter_total(snap, "hvd_collective_bytes_total",
                                     {"kind": "reduce_scatter"})
        ag = aggregate.counter_total(snap, "hvd_collective_bytes_total",
                                     {"kind": "all_gather"})
        rcomp._record_compression("int8", nbytes, int(rs), 0.0)
        rcomp._record_compression("int8", nbytes, int(ag), 0.0)
        ref = ref_telemetry.metrics_snapshot()
    finally:
        ref_telemetry.configure(enabled_flag=False)
        ref_telemetry.registry().clear()
    for name in ("hvd_fusion_requests_total", "hvd_fusion_buckets_total",
                 "hvd_fusion_tensors_total", "hvd_fusion_bucket_bytes",
                 "hvd_compression_bytes_in_total",
                 "hvd_compression_bytes_out_total", "hvd_compression_ratio"):
        assert snap[name] == ref[name], name
    secs = snap["hvd_compression_encode_seconds_total"]
    assert secs["help"] == ref["hvd_compression_encode_seconds_total"]["help"]
    assert secs["values"][0]["value"] > 0


def test_zero_checkpoint_and_guard_series(world1, metrics_on, tmp_path):
    from horovod_tpu_torch import checkpoint, optim, resilience
    params = [torch.zeros(6), torch.zeros(3)]
    zopt = zero.sharded_optimizer(optim.sgd(0.5))
    state = zopt.init(params)
    for _ in range(2):
        zopt.update([torch.ones(6), torch.ones(3)], state, params)
    checkpoint.save(str(tmp_path), {"w": params[0]}, step=1)
    checkpoint.restore(str(tmp_path), {"w": torch.zeros(6)})
    guard = resilience.StepGuard(policy="rollback", nan_burst=1,
                                 snapshot_interval=1, sentinel_interval=0)
    p, o = {"w": torch.ones(2)}, {"m": torch.zeros(2)}
    p, o, ev = guard.after_step(p, o, 0, 0.5)
    p, o, ev = guard.after_step(p, o, 1, float("nan"))
    assert ev.action == "rollback"
    snap = world1.metrics_snapshot()
    total = aggregate.counter_total
    assert total(snap, "hvd_zero_updates_total") == 2
    assert total(snap, "hvd_zero_buckets_total") == 2 * len(state.plan.buckets)
    assert snap["hvd_zero_shard_bytes"]["values"][0]["count"] == 2 * len(
        state.plan.buckets)
    assert total(snap, "hvd_checkpoint_saves_total") == 1
    assert total(snap, "hvd_checkpoint_restores_total",
                 {"found": "True"}) == 1
    assert total(snap, "hvd_guard_checks_total") == 2
    assert total(snap, "hvd_guard_nonfinite_steps_total") == 1
    assert total(snap, "hvd_rollback_snapshots_total") == 1
    assert total(snap, "hvd_rollback_restores_total") == 1
    # Help texts are the reference's, word for word.
    ref_src = open(os.path.join(REPO, "horovod_tpu", "resilience.py")).read()
    ref_src += open(os.path.join(REPO, "horovod_tpu", "checkpoint.py")).read()
    ref_src += open(os.path.join(REPO, "horovod_tpu", "parallel",
                                 "zero.py")).read()
    flat = " ".join(ref_src.replace('"\n', "").split())
    for name, fam in snap.items():
        if name.startswith(("hvd_guard", "hvd_rollback", "hvd_checkpoint",
                            "hvd_zero")):
            assert fam["help"].split()[0] in flat, name
            assert f'"{name}"' in ref_src, name


def test_http_server_and_json_document(metrics_on, tmp_path):
    telemetry.counter("served_total", "help").inc()
    server = exporter.start_http_server(
        0, telemetry.render_prometheus, telemetry.metrics_snapshot,
        bind="127.0.0.1")
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "served_total 1" in body
        js = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json", timeout=5).read())
    finally:
        server.shutdown()
    assert js["schema"] == "horovod_tpu.metrics.v1"
    path = str(tmp_path / "m.json")
    exporter.write_json(path, telemetry.metrics_snapshot)
    ref_path = str(tmp_path / "r.json")
    ref_exporter.write_json(ref_path, telemetry.metrics_snapshot)
    mine, ref = json.load(open(path)), json.load(open(ref_path))
    assert mine == ref


def test_the_eager_timeline_rows(world1, tmp_path, monkeypatch):
    path = str(tmp_path / "tl.json")
    monkeypatch.setenv("HOROVOD_EAGER_TIMELINE", path)
    telemetry.reset_for_tests()
    try:
        assert isinstance(telemetry.timeline(), EagerTimelineWriter)
        world1.allreduce(torch.ones(4), name="tl.x")
        world1.allgather(torch.ones(2), name="tl.y")
    finally:
        monkeypatch.delenv("HOROVOD_EAGER_TIMELINE")
        telemetry.reset_for_tests()
    events = json.loads(open(path).read())
    rows = {e["args"]["name"]: e["tid"] for e in events
            if e.get("name") == "thread_name"}
    names = [(e["tid"], e["name"]) for e in events if e["ph"] in "Xi"]
    for tensor, op in (("tl.x", "ALLREDUCE"), ("tl.y", "ALLGATHER")):
        tid = rows[tensor]
        got = [n for t, n in names if t == tid]
        assert got[0] == f"SUBMIT_{op}" and got[-1] == "FINISH", got
        assert set(got) <= {f"SUBMIT_{op}", f"WAIT_{op}", "FINISH"}
    assert events[-1]["name"] == "SHUTDOWN"
    assert per_rank_path("/x/t.json") == "/x/t.json"


PORT_METRICS = r'''
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import telemetry

hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
assert size == 2, size
assert telemetry.enabled()
for step in range(5):
    out = hvd.allreduce(torch.full((16,), float(rank + 1)), average=False,
                        name=f"metrics.step{step}")
    assert out.tolist() == [3.0] * 16, out
g = hvd.allgather(torch.full((4,), float(rank)), name="metrics.gather")
assert tuple(g.shape) == (8,)
print(f"METRICS_WORKLOAD_OK rank={rank}", flush=True)
'''


def _launch(args, script, summary, tmp_path, launcher):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1")
    for var in ("XLA_FLAGS", "HOROVOD_METRICS_FILE", "HOROVOD_EAGER_TIMELINE",
                "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        env.pop(var, None)
    return subprocess.Popen(
        [sys.executable, "-m", launcher, "-np", "2",
         "--metrics-file", summary, *args, sys.executable, script],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_a_two_rank_job_merges_as_the_references(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(PORT_METRICS)
    mine, ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    procs = [_launch([], str(script), mine, tmp_path, PORT_LAUNCHER),
             _launch([], os.path.join(REPO, "tests", "distributed",
                                      "metrics_workload_np2.py"), ref,
                     tmp_path, REF_LAUNCHER)]
    logs = [p.communicate(timeout=150)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert logs[0].count("METRICS_WORKLOAD_OK") == 2, logs[0][-3000:]
    docs = [json.load(open(mine)), json.load(open(ref))]
    for doc in docs:
        assert doc["schema"] == "horovod_tpu.metrics.summary.v1"
        assert set(doc["ranks"]) == {"0", "1"}
    got, want = docs[0]["merged"], docs[1]["merged"]
    assert set(want) - set(got) == REF_ONLY
    assert set(got) - set(want) == PORT_ONLY
    for name in set(got) & set(want):
        g, w = got[name], want[name]
        assert (g["type"], g["help"]) == (w["type"], w["help"]), name
        assert ([v["labels"] for v in g["values"]]
                == [v["labels"] for v in w["values"]]), name
        if g["type"] == "histogram":
            for gv, wv in zip(g["values"], w["values"]):
                assert list(gv["buckets"]) == list(wv["buckets"]), name
                assert gv["count"] == wv["count"], name
    for name in ("hvd_eager_ops_total", "hvd_eager_bytes_total",
                 "hvd_rpc_calls_total", "hvd_coord_epoch",
                 "hvd_schedule_check_enabled",
                 "hvd_autotune_fusion_threshold_bytes",
                 "hvd_autotune_cycle_time_ms"):
        assert got[name]["values"] == want[name]["values"], name
    # The port's eager plane counts exactly its five allreduces per rank
    # (the reference's native plane adds one internal flat allreduce of
    # its own per rank to the same series).
    assert aggregate.counter_total(got, "hvd_collective_bytes_total",
                                   {"plane": "eager"}) == 2 * 5 * 64
    assert aggregate.counter_total(got, "hvd_fusion_buckets_total",
                                   {"kind": "eager"}) == 2 * 5
