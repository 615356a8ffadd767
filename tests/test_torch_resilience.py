"""The port's resilience ladder against the JAX package's, on the CPU.

* ``StepGuard``: the reference's and the port's guard run over one
  scripted sequence of finite and NaN losses under every policy,
  ``nan_burst`` 1 and 2, ``snapshot_interval`` 1 and 2; the events are
  equal step for step, the state each returns is equal bit for bit (a
  rollback restores the snapshot exactly), and ``abort`` raises at the
  same step.  ``rollback`` and ``abort`` no longer act as ``skip``.
* ``LastKnownGood``, ``tree_digest`` (equal to the reference's digest of
  the same bytes) and ``_divergent_ranks``, as
  ``tests/test_resilience.py:157-295``.
* The value faults (``nan``, ``corrupt[:N]``) as
  ``tests/test_resilience.py:310-391``, through a real eager allreduce,
  and the ``attempt`` key firing only on its restart attempt; the kinds
  the port does not inject are refused, not ignored (the plane kinds are
  ``tests/test_torch_warm_restart.py``'s).
* One 2-rank gloo job: a NaN on one rank is a bad step on both (skip,
  then a rollback on both), and the sentinel names a diverged rank and
  heals it under ``rollback``, or raises ``DivergenceError`` under
  ``skip``.
* Preemption: the flag, the signal handler, ``maybe_save_and_exit``; a
  subprocess exits with rc 75 leaving a checkpoint, and a second one
  resumes from it to the uninterrupted run's final state.
"""

import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import resilience as jres
from horovod_tpu_torch import checkpoint, faults, resilience as tres
from torch_support import (REPO, jax_world, run_port_job,  # noqa: F401
                           world1)

LOSSES = [0.5, float("nan"), 0.4, float("nan"), float("nan"), 0.3,
          float("nan"), float("nan"), float("nan"), 0.2, 0.1]


def _state_at(t):
    w = np.arange(4, dtype=np.float32) + t
    m = np.full(3, 0.5 * t, np.float32)
    return w, m


def _run(policy, burst, interval, jax_side):
    """Events and returned states over :data:`LOSSES`."""
    mod = jres if jax_side else tres
    guard = mod.StepGuard(policy=policy, nan_burst=burst,
                          snapshot_interval=interval)
    events, states = [], []
    for t, loss in enumerate(LOSSES):
        w, m = _state_at(t)
        if jax_side:
            params, opt = {"w": jnp.asarray(w)}, {"m": jnp.asarray(m)}
        else:
            params, opt = {"w": torch.from_numpy(w)}, {"m": torch.from_numpy(
                m)}
        try:
            p, o, ev = guard.after_step(params, opt, t, loss)
        except mod.GuardAbort as e:
            events.append(("abort", t, str(e)))
            break
        events.append((ev.action, ev.step))
        states.append((np.asarray(p["w"]), np.asarray(o["m"])))
    return events, states


@pytest.mark.parametrize("interval", [1, 2])
@pytest.mark.parametrize("burst", [1, 2])
@pytest.mark.parametrize("policy", ["off", "skip", "rollback", "abort"])
def test_step_guard_matches_the_reference(jax_world, policy, burst,
                                          interval):
    want_ev, want_st = _run(policy, burst, interval, jax_side=True)
    got_ev, got_st = _run(policy, burst, interval, jax_side=False)
    assert got_ev == want_ev
    for (gw, gm), (ww, wm) in zip(got_st, want_st):
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gm, wm)
    if policy in ("rollback", "abort"):
        assert got_ev != _run("skip", burst, interval, jax_side=False)[0]


def test_rollback_writes_the_snapshot_into_the_live_tensors(world1):
    guard = tres.StepGuard(policy="rollback", snapshot_interval=1)
    w = torch.arange(4.0)
    m = [torch.zeros(3, dtype=torch.bfloat16)]
    guard.after_step({"w": w}, m, 0, torch.tensor(0.5))
    snap_w, snap_m = w.clone(), m[0].clone()
    w.add_(3.0)
    m[0].fill_(float("nan"))
    p, o, ev = guard.after_step({"w": w}, m, 1, torch.tensor(float("nan")))
    assert ev == tres.GuardEvent("rollback", 0)
    assert p["w"] is w and o[0] is m[0]
    assert torch.equal(w, snap_w) and torch.equal(m[0], snap_m)


# -- last-known-good (reference tests/test_resilience.py:157-200) ------------

def test_lkg_stage_commit_restore_bit_identical():
    lkg = tres.LastKnownGood()
    assert not lkg.available and lkg.step is None
    params = {"w": torch.from_numpy(np.random.RandomState(2).randn(8, 3)
                                    .astype(np.float32))}
    opt = {"m": torch.zeros(8, 3, dtype=torch.bfloat16),
           "count": torch.tensor(7, dtype=torch.int32), "n": 3}
    assert lkg.stage(params, opt, step=5)
    lkg.commit()
    assert lkg.available and lkg.step == 5
    r_params, r_opt, r_step = lkg.restore()
    assert r_step == 5
    assert torch.equal(r_params["w"], params["w"])
    assert torch.equal(r_opt["m"], opt["m"]) and r_opt["m"].dtype == \
        torch.bfloat16
    assert int(r_opt["count"]) == 7 and r_opt["n"] == 3
    assert r_params["w"] is not params["w"]


def test_lkg_rejects_poisoned_snapshot():
    lkg = tres.LastKnownGood()
    good = {"w": torch.ones(4)}
    bad = {"w": torch.tensor([1.0, float("nan"), 0.0, 0.0])}
    assert lkg.stage(good, {}, step=1)
    lkg.commit()
    assert not lkg.stage(bad, {}, step=2)
    lkg.commit()
    assert lkg.step == 1
    assert torch.equal(lkg.restore()[0]["w"], good["w"])


def test_lkg_reuses_its_two_host_buffers():
    lkg = tres.LastKnownGood()
    seen = set()
    for step in range(5):
        assert lkg.stage({"w": torch.full((6,), float(step))}, {}, step)
        seen.add(lkg._staged[2].flat.data_ptr())
        lkg.commit()
        assert float(lkg.restore()[0]["w"][0]) == step
    assert len(seen) == 2


def test_lkg_restore_without_snapshot_raises():
    with pytest.raises(RuntimeError, match="no last-known-good"):
        tres.LastKnownGood().restore()


def test_step_guard_env_construction(monkeypatch):
    monkeypatch.setenv("HOROVOD_STEP_GUARD", "rollback")
    monkeypatch.setenv("HOROVOD_SENTINEL_INTERVAL", "50")
    monkeypatch.setenv("HOROVOD_GUARD_NAN_BURST", "3")
    monkeypatch.setenv("HOROVOD_LKG_INTERVAL", "4")
    guard = tres.StepGuard()
    assert (guard.policy, guard.sentinel_interval, guard.nan_burst,
            guard.snapshot_interval) == ("rollback", 50, 3, 4)
    monkeypatch.setenv("HOROVOD_LKG_INTERVAL", "0")
    with pytest.raises(ValueError, match="must be >= 1"):
        tres.StepGuard()


# -- digests -----------------------------------------------------------------

@pytest.mark.parametrize("digests", [
    [[1.0, 2.0], [1.0, 2.0], [9.0, 2.0], [1.0, 2.0]],
    [[5.0], [5.0], [1.0], [1.0]],
    [[3.0], [3.0], [3.0]],
    [[7.0, 1.0], [8.0, 1.0]],
])
def test_divergent_ranks_as_the_reference(digests):
    d = np.array(digests)
    assert tres._divergent_ranks(d) == jres._divergent_ranks(d)


def test_tree_digest_equals_the_references():
    t = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "b": np.float64(1.5), "c": [np.int32(3), np.ones(2, np.int64)]}
    assert tres.tree_digest(t) == jres.tree_digest(t)
    as_torch = {"a": torch.from_numpy(t["a"]), "b": t["b"],
                "c": [t["c"][0], torch.from_numpy(t["c"][1])]}
    assert tres.tree_digest(as_torch) == jres.tree_digest(t)
    t2 = {**t, "a": t["a"].copy()}
    t2["a"][1, 2] = np.nextafter(t2["a"][1, 2], np.float32(np.inf))
    assert tres.tree_digest(t2) != tres.tree_digest(t)
    assert 0 <= tres.tree_digest(t) < 2 ** 32


# -- value faults (reference tests/test_resilience.py:310-391) ---------------

@pytest.fixture
def spec(monkeypatch):
    def set_spec(value):
        monkeypatch.setenv(faults.ENV_VAR, value)
        faults.reset()
    yield set_spec
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.reset()


def test_parse_corrupt_kind_arg():
    (r,) = faults.parse_spec("site=allreduce,kind=corrupt:3")
    assert r.kind == "corrupt" and r.arg == 3
    (r,) = faults.parse_spec("site=allreduce,kind=corrupt")
    assert r.arg is None
    with pytest.raises(faults.FaultSpecError, match=">= 1 byte"):
        faults.parse_spec("site=allreduce,kind=corrupt:0")
    with pytest.raises(faults.FaultSpecError, match="takes no argument"):
        faults.parse_spec("site=allreduce,kind=nan:1")


@pytest.mark.parametrize("kind,site,match", [
    ("frame_corrupt", "transport", "native transports"),
    ("stripe_kill:2", "transport", "native transports"),
    ("shm_stall:5", "transport", "native transports"),
    ("link_reset", "*", "native transports"),
    ("rank_kill", "transport", "native transports"),
    ("bogus", "allreduce", "unknown fault kind .*valid kinds: crash, exit"),
])
def test_other_kinds_are_refused_not_ignored(kind, site, match):
    # The reference's transport kinds act inside its native transports,
    # which the port does not have; every other kind is ported.
    with pytest.raises(faults.FaultSpecError, match=match):
        faults.parse_spec(f"site={site},kind={kind}")
    with pytest.raises(faults.FaultSpecError, match="unknown fault site"):
        faults.parse_spec("site=nowhere,kind=nan")


def test_attempt_key_is_refused(spec, monkeypatch):
    # attempt=N refuses to fire on any launcher restart attempt but the
    # N-th (HOROVOD_RESTART_ATTEMPT), and fires there, as the
    # reference's rule does.
    from horovod_tpu import faults as jfaults
    (want,) = jfaults.parse_spec("site=allreduce,kind=nan,attempt=1")
    (got,) = faults.parse_spec("site=allreduce,kind=nan,attempt=1")
    assert got.attempt == want.attempt == 1
    spec("site=allreduce,kind=nan,attempt=1")
    x = torch.ones(3)
    for attempt, fires in (("0", False), ("2", False), ("1", True)):
        monkeypatch.setenv("HOROVOD_RESTART_ATTEMPT", attempt)
        out = faults.corrupt_output("allreduce", x, rank=0)
        assert bool(torch.isnan(out).all()) is fires
        assert want._matches("allreduce", 0) is fires


def test_corrupt_output_nan(spec, capsys):
    spec("site=allreduce,kind=nan,count=1")
    src = torch.ones(4)
    out = faults.corrupt_output("allreduce", src, "grads.0")
    assert torch.isnan(out).all() and (src == 1.0).all()
    assert "firing kind=nan" in capsys.readouterr().err
    assert (faults.corrupt_output("allreduce", src, "grads.0") == 1).all()


def test_corrupt_output_nan_int_dtype_passthrough(spec, capsys):
    spec("site=allgather,kind=nan")
    src = torch.arange(4, dtype=torch.int32)
    assert torch.equal(faults.corrupt_output("allgather", src), src)
    assert "output unchanged" in capsys.readouterr().err


def test_corrupt_output_bit_flips_as_the_reference(spec, monkeypatch):
    spec("site=allreduce,kind=corrupt:2,count=1")
    src = torch.zeros(8)
    out = faults.corrupt_output("allreduce", src)
    assert (src == 0).all()
    from horovod_tpu import faults as jfaults
    jfaults.reset()
    want = jfaults.corrupt_output("allreduce", np.zeros(8, np.float32))
    jfaults.reset()
    np.testing.assert_array_equal(out.numpy().view(np.uint8),
                                  want.view(np.uint8))
    assert (out.numpy().view(np.uint8) != 0).sum() == 2
    assert torch.equal(faults.corrupt_output("allreduce", src), src)


def test_corrupt_output_respects_site_and_rank(spec, monkeypatch):
    spec("rank=1,site=allreduce,kind=nan")
    src = torch.ones(2)
    assert (faults.corrupt_output("allreduce", src, rank=0) == 1).all()
    assert (faults.corrupt_output("broadcast", src, rank=1) == 1).all()
    assert torch.isnan(faults.corrupt_output("allreduce", src, rank=1)).all()


def test_eager_allreduce_routes_through_corrupt_output(world1, spec):
    spec("site=allreduce,kind=nan,count=1")
    assert torch.isnan(world1.allreduce(torch.ones(4),
                                        name="poisoned.t")).all()
    assert (world1.allreduce(torch.ones(4), name="clean.t") == 1).all()


# -- 2 ranks ------------------------------------------------------------------

JOB = r'''
import os
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import resilience

out_dir = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
res = {}

# A NaN on rank 1 only: a bad step on both ranks.
guard = resilience.StepGuard(policy="rollback", nan_burst=2)
w = torch.zeros(3)
events = []
for t, bad_on_1 in enumerate([False, True, True, False]):
    w.fill_(float(t))
    loss = float("nan") if (bad_on_1 and r == 1) else 1.0
    p, _, ev = guard.after_step({"w": w}, [], t, loss)
    events.append(f"{ev.action}:{ev.step}:{float(p['w'][0])}")
res["events"] = np.array(events)

# The sentinel: rank %(bad)d diverges.
state = {"w": torch.arange(4.0), "b": torch.ones(2, dtype=torch.bfloat16)}
if r == %(bad)d:
    state["w"][2] += %(delta)r
for policy in ("skip", "rollback"):
    guard = resilience.StepGuard(policy=policy, sentinel_interval=1)
    try:
        p, o, ev = guard.after_step(state, [], 1, 0.5)
        res[f"{policy}/event"] = np.array(f"{ev.action}:{ev.step}")
        res[f"{policy}/w"] = p["w"].numpy()
        res[f"{policy}/same_object"] = np.array(p["w"] is state["w"])
    except resilience.DivergenceError as e:
        res[f"{policy}/event"] = np.array(f"raised:{list(e.ranks)}")
np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _diverged():
    """A perturbation whose digest row sorts above the healthy one, so at
    2 ranks the tie goes to the healthy row and the perturbed rank 1 is
    the one named (the reference's rule)."""
    good = {"w": torch.arange(4.0), "b": torch.ones(2, dtype=torch.bfloat16)}
    for delta in np.linspace(0.5, 8.0, 16):
        bad = {"w": good["w"].clone(), "b": good["b"]}
        bad["w"][2] += float(delta)
        if tres.tree_digest(bad) > tres.tree_digest(good):
            return 1, float(delta)
    raise AssertionError("no perturbation sorts above the healthy digest")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    bad, delta = _diverged()
    ranks, _ = run_port_job(JOB % dict(bad=bad, delta=delta),
                            str(tmp_path_factory.mktemp("resilience")),
                            env={"OMP_NUM_THREADS": "1"})
    return bad, ranks


def test_a_nan_on_one_rank_is_a_bad_step_on_both(job):
    _, ranks = job
    for r in ranks:
        assert list(r["events"]) == ["ok:0:0.0", "skip:1:1.0",
                                     "rollback:0:0.0", "ok:3:3.0"]


def test_the_sentinel_names_the_diverged_rank_and_heals_it(job):
    bad, ranks = job
    for r in ranks:
        assert str(r["skip/event"]) == f"raised:[{bad}]"
        assert str(r["rollback/event"]) == "heal:1"
        np.testing.assert_array_equal(r["rollback/w"], np.arange(4.0))
        assert bool(r["rollback/same_object"])


# -- preemption ---------------------------------------------------------------

@pytest.fixture
def clean_preemption():
    tres._reset_for_tests()
    yield
    tres._reset_for_tests()


def test_preemption_rc_is_the_references(clean_preemption):
    assert tres.PREEMPTION_RC == jres.PREEMPTION_RC == 75


def test_preemption_request_flag(clean_preemption):
    assert not tres.preemption_requested()
    tres.request_preemption()
    assert tres.preemption_requested()
    tres._reset_for_tests()
    assert not tres.preemption_requested()


def test_install_preemption_handler_defers_signal(clean_preemption):
    old = signal.getsignal(signal.SIGUSR1)
    try:
        tres.install_preemption_handler(signal.SIGUSR1)
        assert not tres.preemption_requested()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert tres.preemption_requested()
    finally:
        signal.signal(signal.SIGUSR1, old)


def test_maybe_save_and_exit_noop_without_request(clean_preemption,
                                                  tmp_path):
    assert tres.maybe_save_and_exit(str(tmp_path / "ckpt"),
                                    {"w": torch.zeros(2)}, step=0) is False
    assert not (tmp_path / "ckpt").exists()


def test_maybe_save_and_exit_saves_then_exits_75(clean_preemption, world1,
                                                 tmp_path):
    ckpt = tmp_path / "ckpt"
    tres.request_preemption()
    with pytest.raises(SystemExit) as exc:
        tres.maybe_save_and_exit(str(ckpt), {"w": torch.full((4,), 3.0)},
                                 step=7)
    assert exc.value.code == tres.PREEMPTION_RC
    assert checkpoint.latest_step(str(ckpt)) == 7


PREEMPT = r'''
import sys

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint, resilience

ckpt, mode = sys.argv[1], sys.argv[2]
hvd.init(device="cpu")
torch.manual_seed(0)
w = torch.randn(8)
state = {"w": w, "step": 0}
if mode == "resume":
    state = checkpoint.restore(ckpt, state)
    w = state["w"]
for step in range(state["step"], 6):
    w.mul_(0.9).add_(0.1 * step)
    state["step"] = step + 1
    if mode == "preempt" and step == 2:
        resilience.request_preemption()
    resilience.maybe_save_and_exit(ckpt, state, step + 1)
print("final", ",".join(f"{v:.9e}" for v in w.tolist()), flush=True)
hvd.shutdown()
'''


def test_a_preempted_run_exits_75_and_a_second_resumes(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(PREEMPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        env.pop(var, None)

    def run(mode):
        return subprocess.run([sys.executable, str(script),
                               str(tmp_path / "ckpt"), mode],
                              capture_output=True, text=True, env=env,
                              timeout=120)

    first = run("preempt")
    assert first.returncode == 75, first.stdout + first.stderr
    assert checkpoint.latest_step(str(tmp_path / "ckpt")) == 3
    second = run("resume")
    assert second.returncode == 0, second.stdout + second.stderr
    whole = run("plain")
    assert whole.returncode == 0, whole.stdout + whole.stderr
    final = [ln for ln in second.stdout.splitlines() if ln.startswith(
        "final")]
    assert final and final == [ln for ln in whole.stdout.splitlines()
                               if ln.startswith("final")]
