"""The port's span recorder (``horovod_tpu_torch/telemetry/spans.py``)
held against the reference's, on the CPU.

* ``trace_id`` is the reference's bit for bit over a hypothesis sweep of
  names and occurrence numbers.
* Sampling, the buffer bound and the document match the reference's
  recorder fed the same calls.
* A 2-rank port job under the port's launcher with ``--trace DIR`` (the
  counterpart of
  ``tests/distributed/trace_workload_np2.py``): the launcher merges the
  ranks' documents into ``trace.json`` and ``critical_path.json``, the
  reference's ``trace_merge`` and ``critical_path`` read the port's rank
  files unchanged, and every collective step's ``trace_id`` appears on
  both ranks.  Without ``--trace`` the same job records and writes
  nothing.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from horovod_tpu.telemetry import critical_path, trace_merge
from torch_support import PORT_LAUNCHER, REPO, free_port

spans = importlib.import_module("horovod_tpu_torch.telemetry.spans")
ref_spans = importlib.import_module("horovod_tpu.telemetry.spans")


@settings(max_examples=300, deadline=None)
@given(st.text(max_size=40), st.integers(min_value=0, max_value=2**62))
def test_trace_id_is_the_references_bit_for_bit(name, seq):
    assert spans.trace_id(name, seq) == ref_spans.trace_id(name, seq)


@pytest.mark.parametrize("sample,capacity", [(1, 65536), (3, 65536),
                                             (1, 5), (2, 4)])
def test_sampling_buffer_and_document_match_the_reference(
        sample, capacity, monkeypatch):
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    docs = []
    for mod in (spans, ref_spans):
        rec = mod.SpanRecorder(rank=1, sample=sample, capacity=capacity)
        for i in range(6):
            for name in ("grad/a", "grad/b"):
                seq = rec.next_seq(name)
                rec.record(name, "submit", seq, 10.0 + i, 10.1 + i, 64)
                rec.record(name, "wait", seq, 10.1 + i, 10.5 + i, 64)
        rec.event("rpc/heartbeat", "rpc", 1.0, 1.5)
        rec.close()
        rec.record("grad/a", "wait", 99, 0.0, 1.0)
        docs.append(rec.document())
    assert docs[0] == docs[1]
    assert docs[0]["dropped"] == docs[1]["dropped"]


def test_configured_recorder_reads_the_same_environment(monkeypatch):
    for var in ("HOROVOD_TRACE", "HOROVOD_TRACE_DIR", "HOROVOD_TRACE_RPC"):
        monkeypatch.delenv(var, raising=False)
    assert spans.configured_recorder() is None
    monkeypatch.setenv("HOROVOD_TRACE", "1")
    monkeypatch.setenv("HOROVOD_TRACE_SAMPLE", "4")
    monkeypatch.setenv("HOROVOD_TRACE_BUFFER", "7")
    monkeypatch.setenv("HOROVOD_RANK", "3")
    mine, ref = spans.configured_recorder(), ref_spans.configured_recorder()
    assert (mine.rank, mine.sample, mine.capacity) == (
        ref.rank, ref.sample, ref.capacity) == (3, 4, 7)


TRACE_JOB = r'''
import os
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import telemetry

hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
assert size == 2, size
traced = os.environ.get("HOROVOD_TRACE", "").strip() not in ("", "0",
                                                              "false")
sp = telemetry.spans()
assert (sp is not None) == traced, (sp, traced)
for step in range(5):
    out = hvd.allreduce(torch.full((16,), float(rank + 1)), average=False,
                        name=f"trace.step{step}")
    assert out.tolist() == [3.0] * 16, out
g = hvd.allgather(torch.full((4,), float(rank)), name="trace.gather")
assert tuple(g.shape) == (8,)
n = len(sp) if sp is not None else 0
assert (n > 0) == traced, n
print(f"TRACE_WORKLOAD_OK rank={rank} traced={int(traced)} spans={n}",
      flush=True)
'''


def _run(tmp_path, args):
    script = tmp_path / "job.py"
    script.write_text(TRACE_JOB)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1")
    for var in ("XLA_FLAGS", "HOROVOD_TRACE", "HOROVOD_TRACE_DIR",
                "HOROVOD_TRACE_RPC", "HOROVOD_METRICS_FILE", "HOROVOD_RANK",
                "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        env.pop(var, None)
    return subprocess.Popen(
        [sys.executable, "-m", PORT_LAUNCHER, "-np", "2", *args,
         sys.executable, str(script)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_a_traced_job_merges_and_correlates_and_an_untraced_one_is_silent(
        tmp_path):
    traced_dir, quiet_dir = tmp_path / "traced", tmp_path / "quiet"
    traced_dir.mkdir()
    quiet_dir.mkdir()
    trace = traced_dir / "trace"
    procs = [_run(traced_dir, ["--trace", str(trace)]), _run(quiet_dir, [])]
    logs = [p.communicate(timeout=150)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert logs[0].count("traced=1") == 2, logs[0][-3000:]
    assert logs[1].count("traced=0 spans=0") == 2, logs[1][-3000:]
    assert sorted(os.listdir(quiet_dir)) == ["job.py"]

    # The launcher merged the port's documents.
    merged = trace_merge.tolerant_load_events(str(trace / "trace.json"))
    assert any(e.get("ph") == "X" for e in merged)
    report = json.load(open(trace / "critical_path.json"))
    assert report["steps"] >= 6, report.keys()

    # The reference's tools read the port's rank files unchanged.
    docs = trace_merge.load_rank_docs(str(trace))
    assert set(docs) == {0, 1}
    for doc in docs.values():
        assert doc["schema"] == ref_spans.SCHEMA
        assert doc["clock_offset"] is not None
        for s in doc["spans"]:
            assert s["trace_id"] == ref_spans.trace_id(s["name"], s["seq"])
    events = trace_merge.merge_span_docs(docs.values())
    assert {e["pid"] for e in events if e.get("ph") == "X"} == {0, 1}
    result = critical_path.analyze(docs)
    assert result["steps"] == report["steps"]

    # Cross-rank correlation: each collective step on both ranks.
    ids = [{s["trace_id"] for s in docs[r]["spans"]
            if s["name"].startswith("trace.")} for r in (0, 1)]
    assert ids[0] == ids[1] and len(ids[0]) == 6
    for r in (0, 1):
        phases = {(s["name"], s["phase"]) for s in docs[r]["spans"]}
        assert ("trace.step0", "submit") in phases
        assert ("trace.step0", "wait") in phases
