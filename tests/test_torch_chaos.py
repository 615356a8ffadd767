"""The chaos gates of ``tests/test_chaos.py`` that the port's launcher now
carries, under ``python -m horovod_tpu_torch.runner`` on the CPU.

Each runs a real job of port ranks with ``HOROVOD_FAULT_SPEC`` arming a
fault and checks that the recovery machinery did its job: a crash is
absorbed by an elastic restart that resumes from the checkpoint (``:36``),
a hang trips the eager-op deadline (``:114``), a typo in the spec fails
the ranks loudly (``:529``), a dropped error-feedback residual is
tolerated (``:656``) and a ``preempt_storm`` of the fleet controller
ends in a resume (``:627``).  Where the reference's gate checks the final
state, the state here is held to the same run without the fault, bit
for bit.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from horovod_tpu_torch import faults

from test_torch_fleet import WORKER, _fleet, start_solo
from torch_support import REPO, free_port, world1  # noqa: F401


def _hvdrun(args, tmp_path, env=None, timeout=240):
    """``python -m horovod_tpu_torch.runner ARGS``: its result."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("HOROVOD_", "MASTER_"))}
    full.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                HOROVOD_TERMINATE_GRACE_SECONDS="3")
    full.update(env or {})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", *args]
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=full, cwd=REPO)


TRAIN = r'''
import os
import sys

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint

torch.set_num_threads(1)
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
attempt = os.environ.get("HOROVOD_RESTART_ATTEMPT", "0")
CKPT, OUT = sys.argv[1], sys.argv[2]
TOTAL = 5
state = {"w": torch.zeros(4), "step": torch.zeros((), dtype=torch.int64)}
state = checkpoint.restore(CKPT, state)
start = int(state["step"])
if attempt == "1":
    # Rank 1 died at step 3's allreduce: steps 0-2 were checkpointed,
    # and the relaunch resumes there on the world that survived.
    assert start == 3, f"expected a resume from step 3, got {start}"
    assert size == 1, f"expected a surviving world of 1, got {size}"
for step in range(start, TOTAL):
    # The same value on every rank: the mean does not depend on the
    # world size.
    g = torch.full((4,), float(step)) / 3
    state["w"] = state["w"] + hvd.allreduce(g, name=f"chaos.{step}")
    state["step"] = torch.tensor(step + 1)
    checkpoint.save(CKPT, state, step + 1)
if rank == 0:
    torch.save(state["w"], OUT)
    print(f"CHAOS_OK attempt={attempt} size={size} "
          f"final={state['w'][0].item()}", flush=True)
hvd.shutdown()
'''


def test_a_crash_is_absorbed_by_an_elastic_restart_that_resumes(tmp_path):
    """``kind=crash`` SIGKILLs rank 1 at its fourth allreduce on attempt
    0; the launcher blacklists rank 1's host (127.0.1.1, reached over
    ``ci/fake_ssh.sh``), relaunches the one rank left (``--min-np 1``),
    which resumes from step 3 and ends where the run without the fault
    ends."""
    script = tmp_path / "train.py"
    script.write_text(TRAIN)
    got, want = tmp_path / "got.pt", tmp_path / "want.pt"
    res = _hvdrun(
        ["-np", "2", "-H", "localhost:1,127.0.1.1:1",
         "--elastic-restarts", "2", "--min-np", "1",
         sys.executable, str(script), str(tmp_path / "ckpt"), str(got)],
        tmp_path,
        env={"HOROVOD_SSH_CMD": os.path.join(REPO, "ci", "fake_ssh.sh"),
             "HOROVOD_FAULT_SPEC":
                 "rank=1,site=allreduce,after=3,kind=crash,attempt=0"})
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-5000:]
    assert "CHAOS_OK attempt=1 size=1" in res.stdout, out[-5000:]
    assert "horovod_tpu_torch.faults: firing kind=crash" in out, out
    assert "blacklisting host 127.0.1.1" in res.stderr, out
    assert "smaller world: 1/2" in res.stderr, out
    assert "elastic restart 1/2" in res.stderr, out
    # The run without the fault comes after, not beside it: a job left
    # running with its pipes unread, and two launchers rendezvousing at
    # once, are what a loaded host does not forgive.  Its port comes from
    # this worker's window (the faulted job's attempts take the
    # launcher's fresh ports, which the gate checks).
    clean = _hvdrun(["-np", "2", "--rendezvous-port", str(free_port()),
                     sys.executable, str(script), str(tmp_path / "ckpt2"),
                     str(want)], tmp_path)
    assert clean.returncode == 0, (clean.stdout + clean.stderr)[-3000:]
    assert torch.equal(torch.load(got), torch.load(want))


HANG = r'''
import os

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.native.runtime import EagerStallError

hvd.init(device="cpu")
try:
    hvd.allreduce(torch.ones(4), name="stuck.t")
    print("NO_STALL", flush=True)
    os._exit(0)
except EagerStallError as e:
    print(f"STALL_CAUGHT {e}", flush=True)
    os._exit(3)
'''


def test_a_hang_trips_the_eager_op_deadline(tmp_path):
    """``kind=hang`` wedges rank 1 before it submits; rank 0's deadline
    (``HOROVOD_EAGER_OP_TIMEOUT``) turns the hang into an
    ``EagerStallError`` naming the tensor and the missing rank, and the
    job fails instead of hanging."""
    script = tmp_path / "hang.py"
    script.write_text(HANG)
    res = _hvdrun(["-np", "2", sys.executable, str(script)], tmp_path,
                  env={"HOROVOD_FAULT_SPEC":
                       "rank=1,site=allreduce,kind=hang",
                       "HOROVOD_EAGER_OP_TIMEOUT": "3"}, timeout=120)
    out = res.stdout + res.stderr
    assert res.returncode != 0, out
    assert "firing kind=hang" in out, out
    assert "STALL_CAUGHT" in res.stdout and "stuck.t" in res.stdout, out
    assert "suspected missing ranks: [1]" in res.stdout, out
    assert "NO_STALL" not in res.stdout, out


TYPO = r'''
import torch
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
hvd.allreduce(torch.ones(4), name="t")
print("RAN_CLEAN", flush=True)
'''


def test_a_typo_in_the_spec_fails_loudly(tmp_path):
    script = tmp_path / "typo.py"
    script.write_text(TYPO)
    res = _hvdrun(["-np", "2", sys.executable, str(script)], tmp_path,
                  env={"HOROVOD_FAULT_SPEC":
                       "rank=1,site=allreduce,kind=krash"}, timeout=120)
    err = res.stdout + res.stderr
    assert res.returncode != 0, err
    assert "FaultSpecError" in err and "unknown fault kind 'krash'" in err
    assert "RAN_CLEAN" not in res.stdout, err


def _compressed_losses(world, steps=8):
    torch.manual_seed(0)
    model = torch.nn.Linear(12, 3)
    gen = torch.Generator().manual_seed(100)
    x, y = torch.randn(16, 12, generator=gen), torch.randn(16, 3,
                                                            generator=gen)
    step = world.make_training_step(
        lambda m, b: ((torch.tanh(m(b[0])) - b[1]) ** 2).mean(), model,
        torch.optim.Adam(model.parameters(), lr=5e-2), compression="int8")
    step.init()
    return [float(step((x, y))) for _ in range(steps)]


def test_a_dropped_residual_is_tolerated(world1, monkeypatch):
    """``residual_drop`` at site ``compression`` zeroes the rank's
    error-feedback residuals before step 3 of an int8 step under the
    ``skip`` guard: every loss stays finite, the run still improves, and
    the rule fired once (its default count)."""
    monkeypatch.setenv("HOROVOD_STEP_GUARD", "skip")
    monkeypatch.setenv(faults.ENV_VAR,
                       "rank=*,site=compression,kind=residual_drop,after=3")
    faults.reset()
    try:
        losses = _compressed_losses(world1)
        (rule,) = faults.load()
        assert rule._fired == 1
    finally:
        faults.reset()
    assert all(np.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses
    monkeypatch.delenv(faults.ENV_VAR)
    clean = _compressed_losses(world1)
    # Up to the drop the runs agree bit for bit.
    assert losses[:3] == clean[:3]


def test_a_preempt_storm_ends_in_a_resume(tmp_path):
    """A single ``preempt_storm`` of the controller (site ``fleet``, the
    21st tick with the job running) hits the only job; it saves, is requeued and resumes from
    its save, ending where the job never preempted ends.  The ranks
    inherit the spec and must not fire it."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    ckpt, ref = tmp_path / "ckpt", tmp_path / "ref"
    solo = start_solo(script, 2, ref, 24, "solo", tmp_path)
    res = _fleet(
        ["-H", "localhost:2", "--tick-interval", "0.1",
         "--job", f"solo 1 2 env:FLEET_CKPT={ckpt} env:FLEET_STEPS=24 "
                  f"env:FLEET_STEP_SECONDS=0.1 -- {sys.executable} "
                  f"{script}"], tmp_path,
        env={"HOROVOD_FAULT_SPEC":
             "site=fleet,after=20,kind=preempt_storm:1"})
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-5000:]
    assert "firing kind=preempt_storm" in res.stderr, out
    assert "preempting job solo" in res.stderr, out
    assert "chaos preempt_storm" in res.stderr, out
    assert "job solo preempted (rc 75)" in res.stderr, out
    assert "FLEET_RESUME job=solo" in res.stdout, out
    assert "FLEET_OK job=solo rank=0 size=2 steps=24" in res.stdout, out
    assert "blacklisting host" not in res.stderr, out
    _, err = solo.communicate(timeout=120)
    assert solo.returncode == 0, err[-3000:]
    for r in (0, 1):
        assert torch.equal(torch.load(ckpt / f"final.solo.{r}.pt"),
                           torch.load(ref / f"final.solo.{r}.pt"))
