"""The schedule verifier (``HOROVOD_SCHEDULE_CHECK``) of the port's
coordinator, on the CPU.

* The ``field`` and ``order`` scenarios of
  ``tests/distributed/schedule_check_np2.py``, as 2-rank port jobs under
  the port's launcher: after a matching collective, a same-named
  broadcast with a rank-dependent root fails on both ranks with the
  reference's words ("mismatched field: root rank", "call #1", both
  ranks named), and two different names fail after the quiet window
  ("no peer submitted", each rank's unmatched name); neither through
  the stall path, each within 30 s.  ``HOROVOD_COORD_TREE=1`` is set too:
  the verifier keeps flat coordination.
* A valid schedule (names submitted in different orders by the two
  ranks, async) does not abort, and its digests agree at shutdown.
* A join suspends the quiescence detector: rank 1 joins with a record
  of its own unmatched while rank 0 waits on another past the window.
* The controller alone: records, poison and abort as the reference
  forms them, fed by two virtual ranks.
"""

import os
import subprocess
import sys

import pytest

from horovod_tpu_torch.native.controller import (Controller, sched_describe,
                                                 sched_mismatch)
from horovod_tpu_torch.native.message import (OpType, Request, RequestList,
                                              SCHED_DIGEST_INIT, sched_fold)
from horovod_tpu_torch.native.response_cache import ResponseCache
from horovod_tpu_torch.native.stall_inspector import StallInspector
from torch_support import PORT_LAUNCHER, REPO, free_port

PRELUDE = r'''
import os
os.environ["HOROVOD_SCHEDULE_CHECK"] = "1"
os.environ["HOROVOD_SCHEDULE_CHECK_QUIET_SECONDS"] = "0.5"
os.environ["HOROVOD_STALL_CHECK_TIME_SECONDS"] = "300"
os.environ["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = "600"
import sys
import time
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd

scenario = sys.argv[1]
hvd.init(device="cpu")
rank = hvd.rank()
assert not hvd.basics.runtime().coord_tree_enabled()
x = torch.ones(4)
'''

DIVERGE = PRELUDE + r'''
out = hvd.allreduce(x, average=False, name="sched.ok")
assert out.tolist() == [2.0] * 4
t0 = time.monotonic()
try:
    if scenario == "field":
        hvd.broadcast(x, root_rank=rank, name="sched.diverge")
    else:
        hvd.allreduce(x, average=False, name=f"sched.diverge.{rank}")
except RuntimeError as e:
    elapsed = time.monotonic() - t0
    msg = str(e)
    assert "HOROVOD_SCHEDULE_CHECK" in msg, f"unexpected error: {e}"
    assert "rank 0" in msg and "rank 1" in msg, msg
    assert "call #1" in msg, msg
    if scenario == "field":
        assert "mismatched field: root rank" in msg, msg
    else:
        assert "no peer submitted" in msg, msg
        assert "sched.diverge.0" in msg and "sched.diverge.1" in msg, msg
    assert "Stalled" not in msg, msg
    assert elapsed < 30, elapsed
    print(f"SCHED_OK {scenario} rank={rank} {elapsed:.2f}s", flush=True)
    print(f"MSG {msg}", flush=True)
else:
    raise SystemExit("expected a schedule-divergence abort")
'''

VALID = PRELUDE + r'''
names = [f"v.{i}" for i in range(6)]
order = names if rank == 0 else names[::-1]
handles = {n: hvd.allreduce_async(x * (rank + 1), average=False, name=n)
           for n in order}
for n in names:
    assert hvd.synchronize(handles[n]).tolist() == [3.0] * 4
hvd.barrier(name="v.barrier")
time.sleep(1.0)       # longer than the quiet window, nothing pending
out = hvd.allreduce(x, average=False, name="v.after")
assert out.tolist() == [2.0] * 4
rt = hvd.basics.runtime()
print(f"VALID_OK rank={rank} submissions={rt.sched_submissions}",
      flush=True)
hvd.shutdown()
'''

JOINED = PRELUDE + r'''
if rank == 1:
    h = hvd.allreduce_async(x, average=False, name="j.b")
    last = hvd.join()
    assert hvd.synchronize(h).tolist() == [2.0] * 4
else:
    out = hvd.allreduce(x * 5, average=False, name="j.a")
    assert out.tolist() == [5.0] * 4, out     # rank 1 joined: zeros
    time.sleep(2.0)    # both ranks hold an unmatched record, no new ones
    out = hvd.allreduce(x, average=False, name="j.b")
    assert out.tolist() == [2.0] * 4
    last = hvd.join()
assert last == 0, last
out = hvd.allreduce(x, average=False, name="j.after")
assert out.tolist() == [2.0] * 4
print(f"JOIN_OK rank={rank}", flush=True)
hvd.shutdown()
'''


def _start(tmp_path, tag, script, *args):
    path = tmp_path / f"{tag}.py"
    path.write_text(script)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1", HOROVOD_COORD_TREE="1",
               HOROVOD_TOPOLOGY="a:1,b:1")
    for var in ("XLA_FLAGS", "HOROVOD_RANK", "HOROVOD_SIZE",
                "HOROVOD_COORDINATOR_ADDR", "HOROVOD_METRICS_FILE"):
        env.pop(var, None)
    return subprocess.Popen(
        [sys.executable, "-m", PORT_LAUNCHER, "-np", "2",
         sys.executable, str(path), *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sched")
    procs = {"field": _start(tmp, "field", DIVERGE, "field"),
             "order": _start(tmp, "order", DIVERGE, "order"),
             "valid": _start(tmp, "valid", VALID, "valid"),
             "join": _start(tmp, "join", JOINED, "join")}
    out = {}
    for tag, p in procs.items():
        out[tag] = (p.communicate(timeout=120)[0], p.returncode)
    return out


@pytest.mark.parametrize("scenario", ["field", "order"])
def test_a_divergence_aborts_with_the_references_words(jobs, scenario):
    log, rc = jobs[scenario]
    assert rc == 0, log[-4000:]
    for r in (0, 1):
        assert f"SCHED_OK {scenario} rank={r}" in log, log[-4000:]
    if scenario == "field":
        assert ("at call #1: rank 0 submitted broadcast('sched.diverge', "
                "float32, shape=[4], root=0) but rank 1 (call #1) submitted "
                "broadcast('sched.diverge', float32, shape=[4], root=1) -- "
                "mismatched field: root rank.") in log, log[-4000:]
    else:
        assert ("every rank is blocked on a collective no peer submitted "
                "(job quiet for 0.5s): ") in log, log[-4000:]
        for r, other in ((0, 1), (1, 0)):
            assert (f"rank {r} submitted allreduce('sched.diverge.{r}', "
                    f"float32, shape=[4]) at call #1, never matched by "
                    f"rank(s) {other}") in log, log[-4000:]


def test_a_valid_schedule_does_not_abort(jobs):
    log, rc = jobs["valid"]
    assert rc == 0, log[-4000:]
    for r in (0, 1):
        assert f"VALID_OK rank={r} submissions=8" in log, log[-4000:]
    assert "schedule digests differ" not in log
    assert "HOROVOD_SCHEDULE_CHECK:" not in log


def test_a_join_suspends_the_detector(jobs):
    log, rc = jobs["join"]
    assert rc == 0, log[-4000:]
    for r in (0, 1):
        assert f"JOIN_OK rank={r}" in log, log[-4000:]
    assert "HOROVOD_SCHEDULE_CHECK:" not in log


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _req(rank, name, op=OpType.ALLREDUCE, arg=1, shape=(4,), set_id=0):
    return Request(rank=rank, op_type=op, name=name, dtype="float32",
                   arg=arg, shape=shape, set_id=set_id)


def _lists(*per_rank):
    return [RequestList(requests=list(rs), sched=list(rs)) for rs in per_rank]


def test_the_controller_poisons_a_field_mismatch_and_aborts_a_quiet_job():
    clock = Clock()
    c = Controller(2, ResponseCache(0), StallInspector(0, 0),
                   schedule_check=True, sched_quiet_s=2.0, clock=clock)
    out = c.cycle(_lists([_req(0, "ok")], [_req(1, "ok")]))
    assert [r.error for r in out.responses] == [False]
    b0 = _req(0, "b", OpType.BROADCAST, arg=0)
    b1 = _req(1, "b", OpType.BROADCAST, arg=1)
    out = c.cycle(_lists([b0], [b1]))
    (resp,) = out.responses
    assert resp.error and not resp.cacheable
    assert resp.error_message == (
        "Mismatched broadcast root ranks for tensor b. "
        "HOROVOD_SCHEDULE_CHECK: collective schedule divergence at call #1: "
        f"rank 0 submitted {sched_describe(b0)} but rank 1 (call #1) "
        f"submitted {sched_describe(b1)} -- mismatched field: root rank. "
        "Every rank must submit each named collective with matching ops, "
        "dtypes and arguments; run `python -m tools.hvdlint` to locate the "
        "rank-divergent call site.")
    assert not out.abort_message
    out = c.cycle(_lists([_req(0, "x.0")], [_req(1, "x.1")]))
    assert out.responses == [] and not out.abort_message
    clock.t += 1.9
    assert not c.cycle(_lists([], [])).abort_message
    clock.t += 0.2
    out = c.cycle(_lists([], []))
    assert out.abort_message.startswith(
        "HOROVOD_SCHEDULE_CHECK: collective schedule divergence: every rank "
        "is blocked on a collective no peer submitted (job quiet for 2s): "
        "rank 0 submitted allreduce('x.0', float32, shape=[4]) at call #2, "
        "never matched by rank(s) 1; rank 1 submitted allreduce('x.1', "
        "float32, shape=[4]) at call #2, never matched by rank(s) 0. ")
    assert sched_mismatch(_req(0, "a", shape=(4,)),
                          _req(1, "a", shape=(5,))) == "shape"
    assert sched_mismatch(_req(0, "a", OpType.ALLGATHER, shape=(4, 2)),
                          _req(1, "a", OpType.ALLGATHER,
                               shape=(7, 2))) == ""


def test_the_digest_is_order_insensitive():
    reqs = [_req(0, f"n{i}", shape=(i + 1,)) for i in range(5)]
    a = b = SCHED_DIGEST_INIT
    for r in reqs:
        a = sched_fold(a, r)
    for r in reversed(reqs):
        b = sched_fold(b, r)
    assert a == b != SCHED_DIGEST_INIT
    assert sched_fold(SCHED_DIGEST_INIT, reqs[0]) != sched_fold(
        SCHED_DIGEST_INIT, _req(0, "n0", shape=(2,)))
