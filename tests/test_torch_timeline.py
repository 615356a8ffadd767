"""The port's timeline (``horovod_tpu_torch/native/timeline.py``) against
the reference's, on the CPU.

* ``tests/test_distributed.py:263-285``'s script (three allreduces and
  an allgather) runs with ``--timeline-filename --timeline-mark-cycles``,
  once through the port under the port's launcher and once through the
  reference under the reference's.  Both files parse as JSON and hold
  ``CYCLE_START``; per tensor the port's events carry the reference's
  ``NEGOTIATE_*`` and op names, and its activities are the reference's
  with ``TCP_<OP>`` read as ``GLOO_<OP>``.  Every tensor's events nest
  and move forward in time.
* At size 1, in this process: a grouped allreduce (one fused response)
  marks ``MEMCPY_IN_FUSION_BUFFER`` and then ``GLOO_ALLREDUCE`` on every
  name inside its ``ALLREDUCE``; a name with quotes and a newline is
  escaped; a timeline or a trial log that cannot be opened fails
  ``init`` and leaves no world behind.
"""

import collections
import json
import os

import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as thvd
from torch_support import PORT_LAUNCHER, REF_LAUNCHER, run_job

REF = r'''
import sys

import numpy as np

import horovod_tpu as hvd

hvd.init()
for i in range(3):
    hvd.allreduce(np.ones(4, np.float32), op=hvd.Sum, name=f"t{i}")
hvd.allgather(np.ones((2, 2), np.float32), name="ag")
np.savez(f"{sys.argv[1]}/rank{hvd.rank()}.npz")
hvd.shutdown()
'''

PORT = r'''
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd

hvd.init(device="cpu")
for i in range(3):
    hvd.allreduce(torch.ones(4), op=hvd.Sum, name=f"t{i}")
hvd.allgather(torch.ones(2, 2), name="ag")
np.savez(f"{sys.argv[1]}/rank{hvd.rank()}.npz")
hvd.shutdown()
'''

TENSORS = ("t0", "t1", "t2", "ag")


def _timeline(script, tmp_path, key):
    out = tmp_path / key
    out.mkdir()
    path = out / "timeline.json"
    run_job(script, str(out), np_=2,
            args=["--timeline-filename", str(path), "--timeline-mark-cycles"],
            launcher=PORT_LAUNCHER if script is PORT else REF_LAUNCHER)
    text = path.read_text()
    assert text.startswith("[\n") and text.endswith("]\n")
    return json.loads(text)


def _by_tensor(events):
    """Per tensor: its events in file order, and its name sets."""
    rows = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    per = collections.defaultdict(list)
    for e in events:
        if e["ph"] in "BE" and e["tid"] in rows:
            per[rows[e["tid"]]].append(e)
    return per


def _names(per, tensor):
    negotiate = {e["name"] for e in per[tensor]
                 if e["name"].startswith("NEGOTIATE_")}
    ops = {e["name"] for e in per[tensor] if e["name"] in (
        "ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL", "REDUCESCATTER")}
    acts = {e["name"] for e in per[tensor] if e["ph"] == "B"} - negotiate - ops
    return negotiate, ops, acts


def _nested(events):
    """B/E pairs balance and every E comes no earlier than its B."""
    stack = []
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["ph"] == "B":
            stack.append(e)
        else:
            assert stack, events
            assert e["ts"] >= stack.pop()["ts"]
    assert not stack, events


@pytest.fixture(scope="module")
def timelines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("timelines")
    return _timeline(REF, tmp, "ref"), _timeline(PORT, tmp, "port")


@pytest.mark.parametrize("tensor", TENSORS)
def test_the_port_records_the_references_events(timelines, tensor):
    ref, port = timelines
    ref_per, port_per = _by_tensor(ref), _by_tensor(port)
    r_neg, r_ops, r_acts = _names(ref_per, tensor)
    p_neg, p_ops, p_acts = _names(port_per, tensor)
    assert p_neg == r_neg and r_neg == {"NEGOTIATE_" + (
        "ALLGATHER" if tensor == "ag" else "ALLREDUCE")}
    assert p_ops == r_ops and len(r_ops) == 1
    assert p_acts == {a.replace("TCP_", "GLOO_") for a in r_acts}
    assert p_acts == {"GLOO_" + next(iter(r_ops))}
    _nested(port_per[tensor])


def test_both_files_mark_cycles(timelines):
    for events in timelines:
        assert any(e["name"] == "CYCLE_START" and e["ph"] == "i"
                   for e in events)
        assert events[-1]["name"] == "SHUTDOWN"


@pytest.fixture()
def timeline_world(monkeypatch, tmp_path):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR",
                "HOROVOD_AUTOTUNE", "HOROVOD_AUTOTUNE_LOG"):
        monkeypatch.delenv(var, raising=False)
    thvd.shutdown()
    yield monkeypatch, tmp_path
    thvd.shutdown()


def test_a_fused_response_marks_its_copy_and_its_wire(timeline_world):
    monkeypatch, tmp_path = timeline_world
    path = tmp_path / "timeline.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    thvd.init(device="cpu")
    odd = 'we"ird\nname'
    outs = thvd.grouped_allreduce([torch.ones(3), torch.ones(5)], name="gr")
    assert [o.tolist() for o in outs] == [[1.0] * 3, [1.0] * 5]
    thvd.allreduce(torch.ones(2), name=odd)
    thvd.shutdown()
    per = _by_tensor(json.loads(path.read_text()))
    fused = [t for t in per if t.startswith("gr")]
    assert len(fused) == 2
    for t in fused:
        seq = [e["name"] for e in per[t] if e["ph"] == "B"]
        assert seq == ["NEGOTIATE_ALLREDUCE", "ALLREDUCE",
                       "MEMCPY_IN_FUSION_BUFFER", "GLOO_ALLREDUCE"], seq
        _nested(per[t])
    assert [e["name"] for e in per[odd] if e["ph"] == "B"] == [
        "NEGOTIATE_ALLREDUCE", "ALLREDUCE", "GLOO_ALLREDUCE"]


@pytest.mark.parametrize("var", ["HOROVOD_TIMELINE", "HOROVOD_AUTOTUNE_LOG"])
def test_an_instrument_that_cannot_start_fails_init(timeline_world, var):
    monkeypatch, tmp_path = timeline_world
    monkeypatch.setenv(var, str(tmp_path / "missing" / "file"))
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    with pytest.raises(OSError):
        thvd.init(device="cpu")
    assert not thvd.is_initialized() and not dist.is_initialized()
    assert not os.path.exists(tmp_path / "missing")
