"""The port's telemetry tools (``horovod_tpu_torch/telemetry/aggregate.py``,
``trace_merge.py`` and ``critical_path.py``) held against the reference's
on the documents of a real 2-rank port job.

The job (gloo, no launcher) runs named all-reduces with rank 1 late on
some of them, an all-gather and a broadcast under ``HOROVOD_METRICS``,
``HOROVOD_TRACE_DIR`` and ``HOROVOD_EAGER_TIMELINE``, and dumps each
rank's metric snapshot.  On those files both packages' tools must give
the same merged metrics, percentiles and counter totals, the same rank
documents, Chrome events and merged timelines, and the same
critical-path analysis, report and gauges.
"""

import json
import os

import pytest

from horovod_tpu import telemetry as ref_telemetry
from horovod_tpu.telemetry import aggregate as ref_aggregate
from horovod_tpu.telemetry import critical_path as ref_critical_path
from horovod_tpu.telemetry import trace_merge as ref_trace_merge
from horovod_tpu_torch import telemetry
from horovod_tpu_torch.telemetry import aggregate, critical_path, trace_merge
from torch_support import run_port_job

JOB = r'''
import json, os, sys, time
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import telemetry

out_dir = sys.argv[1]
hvd.init(device="cpu")
rank = hvd.rank()
for step in range(6):
    if rank == 1 and step % 2:
        time.sleep(0.03)
    out = hvd.allreduce(torch.full((64,), float(rank + 1)), average=False,
                        name=f"tools.step{step}")
    assert out.tolist() == [3.0] * 64
g = hvd.allgather(torch.full((4,), float(rank)), name="tools.gather")
b = hvd.broadcast(torch.arange(8.0) + rank, root_rank=0, name="tools.bcast")
assert b.tolist() == list(range(8))
with open(os.path.join(out_dir, f"metrics.{rank}.json"), "w") as f:
    json.dump(telemetry.metrics_snapshot(), f)
import numpy as np
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), ok=np.ones(1))
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("tools")
    trace_dir = out / "trace"
    env = {"HOROVOD_METRICS": "1", "HOROVOD_TRACE": "1",
           "HOROVOD_TRACE_DIR": str(trace_dir),
           "HOROVOD_EAGER_TIMELINE": str(out / "eager.json"),
           "OMP_NUM_THREADS": "1"}
    for var in ("HOROVOD_FAULT_SPEC", "HOROVOD_METRICS_FILE",
                "HOROVOD_TRACE_RPC", "HOROVOD_METRICS_RPC"):
        env[var] = ""
    run_port_job(JOB, str(out), np_=2, env=env, timeout=150)
    snaps = {str(r): json.loads((out / f"metrics.{r}.json").read_text())
             for r in (0, 1)}
    return out, trace_dir, snaps


def test_aggregate_matches_the_reference(job):
    _, _, snaps = job
    merged = aggregate.merge_snapshots(snaps)
    assert merged == ref_aggregate.merge_snapshots(snaps)
    assert aggregate.merge_snapshots({"0": snaps["0"], "x": None}) == \
        ref_aggregate.merge_snapshots({"0": snaps["0"], "x": None})
    hists = [(name, v) for name, fam in merged.items()
             if fam["type"] == "histogram" for v in fam["values"]]
    assert hists
    for _, v in hists:
        for qs in ((0.5, 0.95, 0.99), (0.1, 1.0)):
            assert aggregate.estimate_percentiles(v["buckets"], qs) == \
                ref_aggregate.estimate_percentiles(v["buckets"], qs)
    assert aggregate.estimate_percentiles({}) == {}
    for name, labels in (("hvd_eager_ops_total", None),
                         ("hvd_eager_ops_total", {"op": "allreduce"}),
                         ("hvd_eager_bytes_total", {"op": "broadcast"}),
                         ("hvd_nothing_total", None)):
        got = aggregate.counter_total(merged, name, labels)
        assert got == ref_aggregate.counter_total(merged, name, labels)
    assert aggregate.counter_total(merged, "hvd_eager_ops_total",
                                   {"op": "allreduce"}) == 12


def test_trace_merge_matches_the_reference(job, tmp_path):
    out, trace_dir, _ = job
    docs = trace_merge.load_rank_docs(str(trace_dir))
    assert set(docs) == {0, 1}
    assert docs == ref_trace_merge.load_rank_docs(str(trace_dir))
    for doc in docs.values():
        assert trace_merge.spans_doc_to_events(doc) == \
            ref_trace_merge.spans_doc_to_events(doc)
        shifted = dict(doc, clock_offset=0.25)
        assert trace_merge.spans_doc_to_events(shifted, tid_base={"x": 4}) \
            == ref_trace_merge.spans_doc_to_events(shifted,
                                                   tid_base={"x": 4})
    events = trace_merge.merge_span_docs(docs.values())
    assert events == ref_trace_merge.merge_span_docs(docs.values())
    assert {e["pid"] for e in events if e.get("ph") == "X"} == {0, 1}

    timelines = sorted(str(out / n) for n in os.listdir(out)
                       if n.startswith("eager.rank"))
    assert len(timelines) == 2
    offsets = {0: 0.0, 1: 0.125}
    merged = trace_merge.merge_chrome_traces(timelines, offsets)
    assert merged == ref_trace_merge.merge_chrome_traces(timelines, offsets)
    assert any(e.get("ph") == "X" for e in merged)

    # A writer that died mid-line leaves a file both read the same way.
    torn = tmp_path / "torn.json"
    text = open(timelines[0]).read()
    torn.write_text(text[: len(text) * 2 // 3])
    assert trace_merge.tolerant_load_events(str(torn)) == \
        ref_trace_merge.tolerant_load_events(str(torn))
    written = trace_merge.write_chrome(events, str(tmp_path / "m.json"))
    assert trace_merge.tolerant_load_events(written) == events
    assert json.load(open(written))["displayTimeUnit"] == "ms"


def test_critical_path_matches_the_reference(job):
    _, trace_dir, _ = job
    docs = trace_merge.load_rank_docs(str(trace_dir))
    result = critical_path.analyze(docs)
    assert result == ref_critical_path.analyze(docs)
    assert result["ranks"] == [0, 1] and result["steps"] >= 8
    for k in (1, 3):
        assert critical_path.format_report(result, top_k=k) == \
            ref_critical_path.format_report(result, top_k=k)
    snaps = []
    for tele, tool in ((telemetry, critical_path),
                       (ref_telemetry, ref_critical_path)):
        tele.registry().clear()
        tool.publish_gauges(result)      # off: records nothing
        assert tele.metrics_snapshot() == {}
        tele.configure(enabled_flag=True)
        try:
            tool.publish_gauges(result)
            snaps.append(tele.metrics_snapshot())
        finally:
            tele.configure(enabled_flag=False)
            tele.registry().clear()
    assert snaps[0] == snaps[1]
    assert "hvd_critical_path_steps" in snaps[0]
