"""Tree coordination (``HOROVOD_COORD_TREE``), the coordination epoch and
the coordinator failover of the port, on the CPU.

* The scenario of ``tests/test_chaos.py:392-440`` in the port: an np=4
  job under the reference's launcher across two hosts
  (``-H 127.0.1.1:2,localhost:2``; 127.0.1.1 routes to loopback but is
  not local, so its ranks ride ``ci/fake_ssh.sh``) with
  ``HOROVOD_COORD_TREE=1``: ``coord_tree_enabled()`` on every rank, the
  response cache hit through the tree, and every result bitwise equal to
  the same job's in flat mode; the shutdown goes through the tree too.
* The fallbacks: flat under a one-host topology (a 2-rank job) and, in
  ``tests/test_torch_schedule_check.py``, under the schedule check; the
  plan and its words on their own.
* The epoch: a rank announcing a stale ``HOROVOD_COORD_EPOCH`` does not
  join; rank 0 logs the reference's words, and the world forms without
  it when the rank comes back under the current epoch.
* The failover end to end, the counterpart of
  ``tests/distributed/coord_failover_np4.py`` and
  ``tests/test_chaos.py:350-390``: both ranks of the coordinator's host
  die after committing step 4; the launcher elects the other host
  (epoch 1) and the 2 survivors warm-restore from its spills; the merged
  summary counts one election.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from horovod_tpu.telemetry import aggregate
from horovod_tpu_torch.native import coord_tree
from torch_support import REPO, caplog, free_port  # noqa: F401

JOB_TIMEOUT = 120

TREE = r'''
import os
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd

out_dir, mode = sys.argv[1], sys.argv[2]
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
assert size == 4, size
rt = hvd.basics.runtime()
assert rt.coord_tree_enabled() == (mode == "tree"), (rank, mode)
res = {}
for step in range(3):
    res[f"sum{step}"] = hvd.allreduce(
        torch.arange(8.0) * (rank + 1) + step, average=False,
        name="tree.sum").numpy()
    res[f"mean{step}"] = hvd.allreduce(
        torch.full((5,), 0.25 * rank + step), name="tree.mean").numpy()
    res[f"gather{step}"] = hvd.allgather(
        torch.full((rank + 1, 2), float(rank + step)),
        name="tree.gather").numpy()
    grouped = hvd.grouped_allreduce(
        [torch.full((3,), float(rank)), torch.full((2, 2), 1.0 + rank)],
        average=False, name="tree.grouped")
    res[f"grouped{step}"] = np.concatenate([g.reshape(-1).numpy()
                                            for g in grouped])
res["bcast"] = hvd.broadcast(torch.full((4,), float(rank)), root_rank=2,
                             name="tree.bcast").numpy()
res["a2a"] = hvd.alltoall(torch.arange(8.0) + 10 * rank,
                          name="tree.a2a").numpy()
res["rs"] = hvd.reducescatter(torch.arange(8.0) * (rank + 1),
                              name="tree.rs").numpy()
hvd.barrier(name="tree.barrier")
hits = rt.cache_hits
np.savez(os.path.join(out_dir, f"{mode}_rank{rank}.npz"), **res)
hvd.shutdown()
print(f"TREE_OK rank={rank} mode={mode} hits={hits}", flush=True)
'''


def _launch(tmp_path, script, np_, hosts, flags=(), env=None, args=()):
    path = tmp_path / f"job_{abs(hash(script)) % 10**8}.py"
    path.write_text(script)
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                HOROVOD_SSH_CMD="ci/fake_ssh.sh", OMP_NUM_THREADS="1",
                HOROVOD_TERMINATE_GRACE_SECONDS="3")
    for var in ("XLA_FLAGS", "HOROVOD_RANK", "HOROVOD_SIZE",
                "HOROVOD_COORDINATOR_ADDR", "HOROVOD_SPILL_DIR",
                "HOROVOD_FAULT_SPEC", "HOROVOD_ON_RANK_FAILURE",
                "HOROVOD_COORD_TREE", "HOROVOD_METRICS_FILE",
                "MASTER_ADDR", "MASTER_PORT"):
        full.pop(var, None)
    full.update(env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu.runner", "-np", str(np_),
         "-H", hosts, *flags, "--jax-distributed", sys.executable,
         str(path), str(tmp_path), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=full, cwd=REPO)


def _wait(p):
    out, err = p.communicate(timeout=JOB_TIMEOUT)
    return p.returncode, out, err


def test_the_tree_on_two_hosts_equals_flat_bit_for_bit(tmp_path):
    procs = {mode: _launch(tmp_path, TREE, 4, "127.0.1.1:2,localhost:2",
                           env={"HOROVOD_COORD_TREE": "1"} if mode == "tree"
                           else None, args=(mode,))
             for mode in ("tree", "flat")}
    for mode, p in procs.items():
        rc, out, err = _wait(p)
        assert rc == 0, (out + err)[-6000:]
        for r in range(4):
            assert f"TREE_OK rank={r} mode={mode}" in out, (out + err)[-4000:]
        assert "did not agree to shut down" not in err
        if mode == "tree":
            hits = [int(line.rsplit("hits=", 1)[1]) for line in
                    out.splitlines() if "TREE_OK" in line]
            assert min(hits) > 0, hits
    for r in range(4):
        tree = dict(np.load(tmp_path / f"tree_rank{r}.npz"))
        flat = dict(np.load(tmp_path / f"flat_rank{r}.npz"))
        assert tree.keys() == flat.keys()
        for k in tree:
            np.testing.assert_array_equal(tree[k], flat[k], err_msg=k)
    want = (np.arange(8.0) * 10 + 4 * 2).astype(np.float32)
    np.testing.assert_array_equal(
        np.load(tmp_path / "tree_rank0.npz")["sum2"], want)


ONE_HOST = r'''
import sys
import torch
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
assert not hvd.basics.runtime().coord_tree_enabled()
out = hvd.allreduce(torch.ones(3), average=False, name="one.host")
assert out.tolist() == [2.0] * 3
print(f"FLAT_OK rank={hvd.rank()}", flush=True)
'''


def test_one_host_falls_back_to_flat(tmp_path):
    p = _launch(tmp_path, ONE_HOST, 2, "localhost:2",
                env={"HOROVOD_COORD_TREE": "1"})
    rc, out, err = _wait(p)
    assert rc == 0, (out + err)[-4000:]
    assert "FLAT_OK rank=0" in out and "FLAT_OK rank=1" in out
    assert ('HOROVOD_COORD_TREE=1 but HOROVOD_TOPOLOGY ("localhost:2") does '
            'not map this 2-rank job onto >= 2 hosts; using flat '
            'coordination') in out + err, (out + err)[-3000:]


@pytest.mark.parametrize("topology,schedule_check,size,want", [
    ("h1:2,h2:2", False, 4, ((0, 2), [1])),
    ("h1:3,h2:1,h3:2", False, 6, ((0, 3, 4), [1, 2])),
    ("h1:2,h2:2", True, 4, None),
    ("h1:4", False, 4, None),
    ("h1:2,h2:1", False, 4, None),
    ("h1:2,h2:0", False, 4, None),
    ("", False, 4, None),
])
def test_the_plan_and_its_fallbacks(topology, schedule_check, size, want,
                                    monkeypatch, caplog):
    monkeypatch.setenv("HOROVOD_COORD_TREE", "1")
    monkeypatch.setenv("HOROVOD_TOPOLOGY", topology)
    with caplog.at_level(logging.WARNING,
                         logger="horovod_tpu_torch.controller"):
        plan = coord_tree.plan_from_env(0, size, schedule_check)
    if want is None:
        assert plan is None
        assert "using flat coordination" in caplog.text
        if schedule_check:
            assert ("HOROVOD_COORD_TREE=1 is incompatible with "
                    "HOROVOD_SCHEDULE_CHECK=1" in caplog.text)
        return
    from horovod_tpu.coordination import TreePlan
    ref = TreePlan.from_topology_string(topology)
    assert tuple(plan.leaders) == tuple(ref.leaders) == want[0]
    assert plan.members_of(0) == ref.members_of(0) == want[1]
    for r in range(size):
        assert plan.leader_of(r) == ref.leader_of(r)
    monkeypatch.setenv("HOROVOD_COORD_TREE", "0")
    assert coord_tree.plan_from_env(0, size, False) is None


EPOCH = r'''
import sys
import torch
import horovod_tpu_torch as hvd
try:
    hvd.init(device="cpu")
except RuntimeError as e:
    print(f"REFUSED {e}", flush=True)
    sys.exit(3)
out = hvd.allreduce(torch.ones(2), average=False, name="epoch.sum")
assert out.tolist() == [2.0, 2.0], out
print(f"EPOCH_OK rank={hvd.rank()}", flush=True)
hvd.shutdown()
'''


def test_a_stale_epoch_rank_does_not_join(tmp_path):
    path = tmp_path / "epoch.py"
    path.write_text(EPOCH)
    base = dict(os.environ, PYTHONPATH=REPO, HOROVOD_SIZE="2",
                HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{free_port()}")

    def start(rank, epoch):
        return subprocess.Popen(
            [sys.executable, str(path)], cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=dict(base, HOROVOD_RANK=str(rank),
                     HOROVOD_COORD_EPOCH=str(epoch)))

    rank0 = start(0, 1)
    try:
        stale = start(1, 0)
        out = stale.communicate(timeout=60)[0]
        assert stale.returncode == 3, out
        assert ("REFUSED controller: dropped rank 1 announcing stale "
                "coordination epoch 0 (current epoch 1)") in out, out
        fresh = start(1, 1)
        out1 = fresh.communicate(timeout=60)[0]
        out0 = rank0.communicate(timeout=60)[0]
    finally:
        rank0.kill()
    assert fresh.returncode == 0 and rank0.returncode == 0, out0 + out1
    assert "EPOCH_OK rank=0" in out0 and "EPOCH_OK rank=1" in out1
    assert ("controller: dropped rank 1 announcing stale coordination epoch "
            "0 (current epoch 1)") in out0, out0


FAILOVER = r'''
import os
import signal
import sys
import time
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import resilience, telemetry

hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
attempt = os.environ.get("HOROVOD_RESTART_ATTEMPT", "0")
TOTAL, CRASH_AT = 8, 5
coord = hvd.coordinator()
if attempt == "0":
    assert size == 4, size
    assert (coord.rank, coord.epoch, coord.elections) == (0, 0, 0), coord
else:
    assert size == 2, size
    assert (coord.rank, coord.epoch, coord.elections) == (0, 1, 1), coord
params, opt_state = {"w": torch.zeros(4)}, {"m": torch.zeros(4)}
guard = resilience.StepGuard(policy="rollback", nan_burst=1,
                             snapshot_interval=1, sentinel_interval=0)
params, opt_state, committed, source, extra = resilience.warm_restore(
    params, opt_state)
if attempt == "0":
    assert (source, committed) == ("fresh", -1), (source, committed)
else:
    assert (source, committed) == ("spill", CRASH_AT - 1), (source,
                                                            committed)
    prev, lr_scale, accum = hvd.elastic_transition(policy="lr_scale")
    assert (prev, lr_scale, accum) == (4, 0.5, 1), (prev, lr_scale, accum)
for step in range(committed + 1, TOTAL):
    g = torch.full((4,), float(step))
    params = {"w": params["w"] + hvd.allreduce(g, name=f"coord.{step}")}
    params, opt_state, ev = guard.after_step(params, opt_state, step, 0.1)
    assert ev.action == "ok", (rank, step, ev)
    if attempt == "0" and rank < 2 and step + 1 == CRASH_AT:
        time.sleep(0.5)
        os.kill(os.getpid(), signal.SIGKILL)
want = float(sum(range(TOTAL)))
assert params["w"].tolist() == [want] * 4, params
if attempt == "1":
    assert telemetry.enabled()
    fam = hvd.metrics_snapshot()["hvd_coord_epoch"]
    assert [v["value"] for v in fam["values"]] == [1.0], fam
print(f"COORD_OK attempt={attempt} rank={rank} size={size} "
      f"epoch={coord.epoch} source={source} committed={committed}",
      flush=True)
hvd.shutdown()
'''


def test_the_coordinator_host_dies_and_the_other_host_is_elected(tmp_path):
    metrics = tmp_path / "metrics.json"
    p = _launch(tmp_path, FAILOVER, 4, "127.0.1.1:2,localhost:2",
                ["--elastic-restarts", "1", "--min-np", "2",
                 "--metrics-file", str(metrics)])
    rc, out, err = _wait(p)
    log = out + err
    assert rc == 0, log[-6000:]
    assert "blacklisting host 127.0.1.1" in err, log[-4000:]
    assert ("coordinator lease expired (host 127.0.1.1 gone); elected "
            "host localhost as coordinator epoch=1") in err, log[-4000:]
    assert "smaller world: 2/4" in err, log[-4000:]
    assert ("COORD_OK attempt=1 rank=0 size=2 epoch=1 source=spill "
            "committed=4") in out, log[-4000:]
    assert "COORD_OK attempt=0" not in out
    doc = json.loads(metrics.read_text())
    assert doc["schema"] == "horovod_tpu.metrics.summary.v1"
    assert aggregate.counter_total(
        doc["merged"], "hvd_coord_elections_total") >= 1
    assert aggregate.counter_total(
        doc["launcher"]["metrics"], "hvd_coord_elections_total") == 1
    epochs = doc["merged"]["hvd_coord_epoch"]["values"][0]
    assert epochs["min"] == epochs["max"] == 1.0, epochs
