"""Warm restart and fail-in-place of the port under the JAX package's
launcher (``python -m horovod_tpu.runner``), on the CPU.

* ``MembershipChangedError``: under ``HOROVOD_ON_RANK_FAILURE=shrink`` a
  runtime whose world changed fails every pending and later entry with
  it (a ``RuntimeError`` subclass); under ``restart`` nothing changes.
* (i) The port's counterpart of ``tests/distributed/warm_restart_np2.py``
  launched as ``ci/run_tests.sh:362-372`` launches it, plus
  ``--jax-distributed`` (a fresh ``HOROVOD_COORDINATOR_ADDR`` every
  attempt): two gloo ranks with a ZeRO-1 SGD state, rank 1 SIGKILLs
  itself after committing step 4, the launcher relaunches at np=1, and
  ``warm_restore`` recovers ``source=spill committed=4`` with the spilled
  cursor, ``elastic_transition`` gives ``(2, 0.5, 1)``, the ZeRO-1 state
  re-sharded from 2 ranks to 1, and the final state is the
  uninterrupted run's.
* (ii) The counterpart of ``failinplace_np3.py``, launched as
  ``ci/run_tests.sh:382-392`` launches it (``--on-rank-failure
  shrink``): rank 2 SIGKILLs itself in the loop, the survivors catch
  ``MembershipChangedError`` and call ``reform_world``; each keeps its
  PID, ``world_epoch()`` becomes 1, the committed step comes back from
  the spills, and the final state is the uninterrupted run's.

Each job has its own subprocess timeout, so a hang fails the test; each
rank runs one intra-op thread.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.native import runtime as runtime_mod
from horovod_tpu_torch.native.runtime import MembershipChangedError
from torch_support import REPO, caplog, run_port_job  # noqa: F401

JOB_TIMEOUT = 90


@pytest.fixture
def shrink_world(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR",
                "HOROVOD_LOCAL_RANK", "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(var, raising=False)

    def start(policy):
        thvd.shutdown()
        if policy is None:
            monkeypatch.delenv("HOROVOD_ON_RANK_FAILURE", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_ON_RANK_FAILURE", policy)
        thvd.init(device="cpu")
        return thvd.basics.runtime()

    yield start
    thvd.shutdown()


@pytest.mark.parametrize("policy", ["shrink", "shrink-then-restart"])
def test_a_changed_world_fails_every_entry_with_membership_changed(
        shrink_world, policy):
    rt = shrink_world(policy)
    assert rt.shrink and not rt.membership_changed
    assert torch.equal(thvd.allreduce(torch.ones(2), name="before"),
                       torch.ones(2))
    err = rt._peer_left(ConnectionResetError("peer gone"))
    assert isinstance(err, MembershipChangedError)
    assert isinstance(err, RuntimeError) and rt.membership_changed
    with pytest.raises(MembershipChangedError, match="a peer left"):
        thvd.allreduce(torch.ones(2), name="after")


def test_restart_policy_keeps_plain_errors(shrink_world):
    rt = shrink_world(None)
    assert not rt.shrink
    rt.queue.close(RuntimeError("horovod_tpu_torch runtime stopped: x"))
    with pytest.raises(RuntimeError) as e:
        thvd.allreduce(torch.ones(2), name="after")
    assert not isinstance(e.value, MembershipChangedError)


def test_a_failed_wait_becomes_membership_changed(shrink_world):
    from horovod_tpu_torch.native.message import OpType
    from horovod_tpu_torch.native.tensor_queue import TensorEntry

    rt = shrink_world("shrink")

    class Broken:
        def wait(self):
            raise RuntimeError("Connection closed by peer")

    sent = TensorEntry(OpType.ALLREDUCE, "x", torch.ones(1))
    rt.submit([sent], "allreduce")
    sent.result()
    assert sent.on_error == rt._membership_error  # submit wires each entry
    entry = TensorEntry(OpType.ALLREDUCE, "y", torch.ones(1))
    entry.on_error = sent.on_error
    entry.launch([Broken()], lambda: None)
    with pytest.raises(MembershipChangedError):
        entry.result()
    assert rt.membership_changed


def test_a_failed_wait_that_is_no_peer_loss_keeps_its_error(shrink_world):
    from horovod_tpu_torch.native.message import OpType
    from horovod_tpu_torch.native.tensor_queue import TensorEntry

    rt = shrink_world("shrink")

    class Broken:
        def wait(self):
            raise RuntimeError("CUDA error: an illegal memory access")

    entry = TensorEntry(OpType.ALLREDUCE, "y", torch.ones(1))
    entry.on_error = rt._membership_error
    entry.launch([Broken()], lambda: None)
    with pytest.raises(RuntimeError, match="illegal memory") as e:
        entry.result()
    assert not isinstance(e.value, MembershipChangedError)
    assert not rt.membership_changed


@pytest.mark.parametrize("where", ["exchange", "launch"])
@pytest.mark.parametrize("exc, changed", [
    (ValueError("a controller bug"), False),
    (ConnectionResetError("Connection reset by peer"), True),
    (RuntimeError("[gloo] Timed out waiting 60000ms for recv"), True)])
def test_only_a_peer_loss_becomes_membership_changed(shrink_world, caplog,
                                                     where, exc, changed):
    """Under shrink a failure that is no peer loss, in the control-plane
    thread or in a data-group collective, keeps a plain RuntimeError and
    its logged traceback; a peer loss latches the membership change."""
    rt = shrink_world("shrink")

    def broken(*_):
        raise exc

    if where == "exchange":
        rt.controller.cycle = broken
    else:
        rt._launch = broken
    with caplog.at_level(logging.WARNING, logger=runtime_mod.log.name):
        with pytest.raises(RuntimeError) as e:
            thvd.allreduce(torch.ones(2), name="x")
    assert isinstance(e.value, MembershipChangedError) == changed
    assert rt.membership_changed == changed
    if not changed:
        assert "a controller bug" in str(e.value)
        assert any(r.exc_info and r.exc_info[1] is exc
                   for r in caplog.records)
    if where == "launch":       # the runtime goes on only without a change
        del rt._launch
        if changed:
            with pytest.raises(MembershipChangedError):
                thvd.allreduce(torch.ones(2), name="after")
        else:
            assert torch.equal(thvd.allreduce(torch.ones(2), name="after"),
                               torch.ones(2))


def _launch(tmp_path, script: str, np_: int, hosts: str, flags, env=None,
            args=()):
    path = tmp_path / "job.py"
    path.write_text(script)
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                HOROVOD_SSH_CMD="ci/fake_ssh.sh",
                HOROVOD_TERMINATE_GRACE_SECONDS="3")
    for var in ("XLA_FLAGS", "HOROVOD_RANK", "HOROVOD_SIZE",
                "HOROVOD_COORDINATOR_ADDR", "HOROVOD_SPILL_DIR",
                "HOROVOD_FAULT_SPEC", "HOROVOD_ON_RANK_FAILURE",
                "MASTER_ADDR", "MASTER_PORT"):
        full.pop(var, None)
    full.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu.runner", "-np", str(np_),
         "-H", hosts, *flags, "--jax-distributed", sys.executable,
         str(path), str(tmp_path), *args],
        capture_output=True, text=True, timeout=JOB_TIMEOUT, env=full,
        cwd=REPO)


WARM = r'''
import os
import signal
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint, optim, resilience
from horovod_tpu_torch.parallel import zero

out_dir = sys.argv[1]
ckpt = os.path.join(out_dir, "ckpt")
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
attempt = os.environ.get("HOROVOD_RESTART_ATTEMPT", "0")
TOTAL, DISK_STEP, CRASH_AT = 8, 2, 5

params = [torch.zeros(6), torch.zeros(3)]
zopt = zero.sharded_optimizer(optim.sgd(0.5, 0.5))
state = zopt.init(params)
assert state.plan.axis_size == size
guard = resilience.StepGuard(policy="rollback", nan_burst=1,
                             snapshot_interval=1, sentinel_interval=0)
params, state, committed, source, extra = resilience.warm_restore(
    params, state, ckpt_dir=ckpt)
if attempt == "0":
    assert (source, committed) == ("fresh", -1), (source, committed)
else:
    assert size == 1, size
    assert (source, committed) == ("spill", CRASH_AT - 1), (source,
                                                            committed)
    assert committed > DISK_STEP - 1
    assert extra == {"cursor": CRASH_AT - 1}, extra
    prev, lr_scale, accum = hvd.elastic_transition(policy="lr_scale")
    assert (prev, lr_scale, accum) == (2, 0.5, 1), (prev, lr_scale, accum)
    shard = hvd.elastic_shard(16, committed, size, rank)
    assert sorted(shard.tolist()) == list(range(16)), shard

for step in range(committed + 1, TOTAL):
    grads = [hvd.allreduce(torch.full(p.shape, 0.25 * (step + 1)),
                           name=f"warm.{step}.{i}")
             for i, p in enumerate(params)]
    updates, state = zopt.update(grads, state, params)
    for p, u in zip(params, updates):
        p.add_(u)
    guard.spill_extra["cursor"] = step
    params, state, ev = guard.after_step(params, state, step, 0.1)
    assert ev.action == "ok", (rank, step, ev)
    if step + 1 == DISK_STEP:
        checkpoint.save(ckpt, {"params": params, "opt_state": state,
                               "step": step}, step=step)
    if attempt == "0" and rank == 1 and step + 1 == CRASH_AT:
        os.kill(os.getpid(), signal.SIGKILL)

full = zero.gather_full_state(state)
np.savez(os.path.join(out_dir, f"warm_rank{rank}_attempt{attempt}.npz"),
         p0=params[0].numpy(), p1=params[1].numpy(),
         t0=full.trace[0].numpy(), t1=full.trace[1].numpy())
print(f"WARM_OK attempt={attempt} rank={rank} size={size} "
      f"source={source} committed={committed}", flush=True)
hvd.shutdown()
'''


def _uninterrupted(total=8):
    """The job's arithmetic with no fault: ``optim.sgd(0.5, 0.5)`` on the
    all-reduced (equal) gradients, in f32 (every value on a 2^-k grid)."""
    ps = [np.zeros(6, np.float32), np.zeros(3, np.float32)]
    ts = [np.zeros(6, np.float32), np.zeros(3, np.float32)]
    for step in range(total):
        for i in range(2):
            g = np.float32(0.25 * (step + 1))
            ts[i] = g + ts[i] * np.float32(0.5)
            ps[i] = ps[i] + ts[i] * np.float32(-0.5)
    return ps, ts


def test_warm_restart_under_the_launcher(tmp_path):
    res = _launch(tmp_path, WARM, 2, "localhost:1,127.0.1.1:1",
                  ["--elastic-restarts", "2", "--min-np", "1"])
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    assert ("WARM_OK attempt=1 rank=0 size=1 source=spill committed=4"
            in res.stdout), log[-6000:]
    got = dict(np.load(tmp_path / "warm_rank0_attempt1.npz"))
    ps, ts = _uninterrupted()
    for key, want in (("p0", ps[0]), ("p1", ps[1]), ("t0", ts[0]),
                      ("t1", ts[1])):
        np.testing.assert_array_equal(got[key], want)


FIP = r'''
import os
import signal
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import horovod_tpu_torch as hvd
from horovod_tpu_torch import resilience
from horovod_tpu_torch.native.runtime import MembershipChangedError

out_dir = sys.argv[1]
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
PID = os.getpid()
TOTAL, KILL_AFTER, W0 = 12, 5, 8.0
assert size == 3, size
assert hvd.world_epoch() == 0, hvd.world_epoch()

params = {"w": torch.full((4,), W0)}
opt = {"m": torch.zeros(4)}
guard = resilience.StepGuard(policy="rollback", nan_burst=1,
                             snapshot_interval=1, sentinel_interval=0)
params, opt, committed, source, extra = resilience.warm_restore(params, opt)
assert (source, committed) == ("fresh", -1), (source, committed)
step, reformed = 0, False
while step < TOTAL:
    try:
        # Every rank holds the same w, so the mean is w and the
        # trajectory is the same at 3 ranks and at 2.
        g = hvd.allreduce(params["w"], name=f"fip.{step}")
        params["w"].sub_(0.25 * g)
        opt["m"].add_(1.0)
        params, opt, ev = guard.after_step(
            params, opt, step, float((params["w"] ** 2).sum()))
        assert ev.action == "ok", (rank, step, ev)
        if rank == 2 and step == KILL_AFTER:
            os.kill(os.getpid(), signal.SIGKILL)
        step += 1
    except MembershipChangedError as e:
        assert not reformed, f"second membership change: {e}"
        reformed = True
        params, opt, committed, source, extra = resilience.reform_world(
            params, opt)
        rank, size = hvd.rank(), hvd.size()
        assert os.getpid() == PID
        assert size == 2 and hvd.world_epoch() == 1, (size,
                                                      hvd.world_epoch())
        assert source == "spill" and committed >= KILL_AFTER, (source,
                                                               committed)
        prev, lr_scale, accum = hvd.elastic_transition(policy="lr_scale")
        assert prev == 3 and abs(lr_scale - 2.0 / 3.0) < 1e-6, (prev,
                                                                lr_scale)
        step = committed + 1

np.savez(os.path.join(out_dir, f"fip_rank{rank}.npz"),
         w=params["w"].numpy(), m=opt["m"].numpy(), pid=PID,
         epoch=hvd.world_epoch(), committed=committed,
         reformed=reformed)
print(f"FIP_OK rank={rank} size={size} epoch={hvd.world_epoch()} "
      f"source={source} committed={committed} pid={PID}", flush=True)
hvd.shutdown()
'''


def test_fail_in_place_under_the_launcher(tmp_path):
    # The launcher learns of rank 2's death from its exit, not from the
    # heartbeat.  The deadline only has to outlast a survivor's exit after
    # FIP_OK: once the interpreter finalizes no thread of it runs, and on a
    # loaded host that took more than the default 5 intervals (1 s).
    res = _launch(tmp_path, FIP, 3, "localhost:2,127.0.1.1:1",
                  ["--heartbeat-interval", "0.2", "--min-np", "2",
                   "--on-rank-failure", "shrink"],
                  env={"HOROVOD_HEARTBEAT_DEADLINE": "10"})
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    assert ("reforming the world in-process as epoch 1 with 2 rank(s)"
            in res.stderr), log[-6000:]
    assert ("absorbed by in-process reformation (2 survivor(s) continue)"
            in res.stderr), log[-6000:]
    pids = set()
    for r in range(2):
        got = dict(np.load(tmp_path / f"fip_rank{r}.npz"))
        assert bool(got["reformed"]) and int(got["epoch"]) == 1
        assert int(got["committed"]) >= 5
        np.testing.assert_array_equal(
            got["w"], np.full(4, 8.0 * 0.75 ** 12, np.float32))
        np.testing.assert_array_equal(got["m"], np.full(4, 12.0,
                                                        np.float32))
        assert f"pid={int(got['pid'])}" in res.stdout
        pids.add(int(got["pid"]))
    assert len(pids) == 2
    assert res.stdout.count("FIP_OK") == 2


# -- what made the reform job above fail under load -----------------------------

SLOW_SHUTDOWN = r'''
import os
import sys
import time

import torch

torch.set_num_threads(1)

import horovod_tpu_torch as hvd

hvd.init(device="cpu")
rank = hvd.rank()
hvd.allreduce(torch.ones(1), name="start")
time.sleep(1.0)          # a few heartbeats: the launcher tracks the rank
if rank == 1:
    time.sleep(6.0)
t0 = time.monotonic()
hvd.shutdown()
print(f"SHUT_OK rank={rank} seconds={time.monotonic() - t0:.1f}",
      flush=True)
os._exit(0)              # no interpreter teardown: only shutdown is timed
'''


def test_a_rank_waiting_for_its_peers_to_shut_down_is_not_dead(tmp_path):
    """Rank 0 waits about 6 s in ``shutdown`` for rank 1 to agree.  The
    heartbeat beats on meanwhile, so the launcher (a 2 s deadline at a
    0.2 s interval) does not kill it as dead at the end of a run that
    succeeded, as it killed the survivors of the reform job above in a
    loaded run."""
    res = _launch(tmp_path, SLOW_SHUTDOWN, 2, "localhost:2",
                  ["--heartbeat-interval", "0.2"],
                  env={"HOROVOD_HEARTBEAT_DEADLINE": "2"})
    log = res.stdout + res.stderr
    assert res.returncode == 0, log[-6000:]
    assert "sent no heartbeat" not in res.stderr, log[-6000:]
    assert res.stdout.count("SHUT_OK") == 2, log[-6000:]
    waited = float(res.stdout.split("SHUT_OK rank=0 seconds=")[1].split()[0])
    assert waited > 2.0, log[-6000:]


BEHIND = r'''
import os
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
thvd.init(device="cpu")
r = thvd.rank()
rt = thvd.basics.runtime()
thvd.allreduce(torch.ones(1), name="start")
if r == 0:
    answer = rt._answer

    def failing(lists):
        # The coordinator meets a dead peer while gathering "boom".
        if any(q.name == "boom" for rl in lists for q in rl.requests):
            raise ConnectionError("Connection reset by peer")
        return answer(lists)

    rt._answer = failing
t0 = time.monotonic()
try:
    thvd.allreduce(torch.ones(2), name="boom")
    msg = "no error"
except RuntimeError as e:
    msg = str(e)
np.savez(f"{out_dir}/rank{r}.npz", msg=np.array(msg),
         seconds=np.array(time.monotonic() - t0))
thvd.shutdown()
'''


def test_a_survivor_behind_the_coordinator_learns_of_the_failure_at_once(
        tmp_path):
    """Rank 1 sent its list and waits for the coordinator's answer when
    rank 0's exchange fails.  Rank 0 closes its control connections as its
    runtime stops, so rank 1's wait fails within seconds, not after the
    control group's 60 s timeout (the 60 s that a survivor of the reform
    job above spent in a loaded run)."""
    (r0, r1), _ = run_port_job(BEHIND, str(tmp_path), timeout=45)
    assert "Connection reset by peer" in str(r0["msg"]), r0["msg"]
    assert str(r1["msg"]).startswith("horovod_tpu_torch runtime stopped"), (
        r1["msg"])
    assert float(r1["seconds"]) < 15, r1["seconds"]
