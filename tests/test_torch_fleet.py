"""The port's fleet controller against the reference's
(``horovod_tpu/runner/fleet.py``).

Both ``FleetController``s run the same episode side by side: one fake
clock each, advanced together, and the stub job runners of
``tests/test_fleet.py`` (jobs "run" until the episode finishes them or
the controller preempts or stops them).  Before each tick the harness
waits for every job thread that is bound to end, so that each tick reaps
the same jobs in both packages.  After every step the job states, sizes,
attempts, preemptions, hosts, ``_used``, the blacklist and the launches
must be equal; at the end so must the summaries.  The episodes are those
of ``tests/test_fleet.py`` and the fleet half of ``tests/test_serving.py``
(admission order, no backfill, starvation preemption, requeue without
blame, blame, grow, serving autoscale up and down, ``preempt_storm``,
``host_flap``, ``rank_kill`` at site ``fleet``).

Then the port's own part: two jobs on one host of cards hold disjoint
cards (``CUDA_VISIBLE_DEVICES``), and one process episode of ``python -m
horovod_tpu_torch.runner fleet`` with two CPU jobs of port ranks.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from horovod_tpu import faults as jfaults
from horovod_tpu.runner import fleet as jfleet
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu_torch import faults
from horovod_tpu_torch.runner import fleet, hosts

from test_fleet import FakeClock, HoldPreemptRunner, StubRunner, wait_for
from torch_support import REPO


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


class Side:
    """One package's controller, clock and stub runner."""

    def __init__(self, mod, hmod, tmp, pool, specs, hold, kw):
        self.clock = FakeClock()
        self.runner = HoldPreemptRunner() if hold else StubRunner()
        self.hold = hold
        kw = dict(kw)
        if "metrics_file" in kw:
            kw["metrics_file"] = str(tmp / "summary.json")
        self.ctl = mod.FleetController(
            hmod.parse_hosts(pool), [mod.parse_job_spec(s) for s in specs],
            fleet_dir=str(tmp / "fleet"), clock=self.clock,
            sleep=lambda s: None, job_runner=self.runner, **kw)

    def job(self, name):
        return next(j for j in self.ctl.jobs if j.name == name)

    def quiesce(self):
        """Wait until every launched job thread has registered, and every
        thread bound to end has ended."""
        launched = sum(j.attempt for j in self.ctl.jobs)
        wait_for(lambda: len(self.runner.launches) == launched,
                 msg="launches")
        for j in self.ctl.jobs:
            t = j.thread
            if t is None:
                continue
            rec = self.runner.active[j.name]
            c = j.control
            ends = (c.stop_requested.is_set() or rec["finish"].is_set()
                    or (c.preempt_requested.is_set()
                        and (not self.hold or rec["allow"].is_set())))
            if ends:
                wait_for(lambda: not t.is_alive(), msg=f"{j.name} ends")

    def state(self):
        ctl = self.ctl
        return {
            "jobs": [(j.name, j.state, j.np, j.prev_np, j.attempt,
                      j.preemptions, j.rc, j.preempted, j.resizing,
                      j.restarts_left, j.target_np,
                      [(i.rank, i.hostname, i.local_rank) for i in j.infos],
                      list(j.chaos_kills))
                     for j in ctl.jobs],
            "used": sorted(ctl._used.items()),
            "blacklisted": [h.hostname for h in ctl.pool
                            if ctl.blacklist.is_blacklisted(h.hostname)],
            "flapped": sorted(ctl._flapped),
            "launches": list(self.runner.launches),
            "alive": ctl.alive(),
        }


def _stats(side, name, depth=0.0, p99=0.0, slo=0.0):
    j = side.job(name)
    os.makedirs(os.path.dirname(j.stats_path), exist_ok=True)
    with open(j.stats_path, "w") as f:
        json.dump({"queue_depth": depth, "p99_ms": p99, "slo_ms": slo}, f)


def play(tmp_path, pool, specs, steps, *, hold=False, spec=None,
         monkeypatch=None, drain=True, **kw):
    """Run ``steps`` on both packages and compare after each; the port's
    side is returned (and both fleets stopped, unless ``drain`` is
    False)."""
    if spec:
        monkeypatch.setenv(faults.ENV_VAR, spec)
        faults.reset()
        jfaults.reset()
    sides = [Side(fleet, hosts, tmp_path / "port", pool, specs, hold, kw),
             Side(jfleet, jhosts, tmp_path / "ref", pool, specs, hold, kw)]
    for i, step in enumerate(steps):
        op, *args = step if isinstance(step, tuple) else (step,)
        for s in sides:
            s.quiesce()
            if op == "tick":
                s.ctl.tick()
            elif op == "advance":
                s.clock.advance(args[0])
            elif op == "finish":
                name, rc, report = args[0], args[1], (args[2:] or [{}])[0]
                s.runner.finish(name, rc, **report)
            elif op == "allow":
                s.runner.allow_preempt(args[0])
            elif op == "stats":
                _stats(s, *args)
            elif op == "stop":
                s.ctl.stop()
            elif op == "run":
                s.rc = s.ctl.run()
        for s in sides:
            s.quiesce()
        got, want = sides[0].state(), sides[1].state()
        assert got == want, f"step {i} {step}"
    port, ref = sides
    if kw.get("metrics_file"):
        a = json.load(open(tmp_path / "port" / "summary.json"))
        b = json.load(open(tmp_path / "ref" / "summary.json"))
        assert a["schema"] == b["schema"] == "horovod_tpu.fleet.summary.v1"
        assert a["pool"] == b["pool"] and a["blacklist"] == b["blacklist"]
        for name in b["jobs"]:
            pa, pb = a["jobs"][name], b["jobs"][name]
            pa.pop("merged"), pb.pop("merged")
            assert pa == pb, name
    for s in sides:
        if drain or s is ref:
            _drain(s.ctl)
    return port


def _drain(ctl):
    if ctl.alive():
        ctl.stop()
        wait_for(lambda: not ctl.tick(), msg="drain")


T = "tick"


EPISODES = {
    "gang_admission_waits_for_min_np": dict(
        pool="localhost:3", specs=["a 2 2:3 -- x", "b 1 2 -- y"],
        steps=[T, T, ("finish", "a", 0), T, T]),
    "no_backfill_past_starved_head": dict(
        pool="localhost:2",
        specs=["big 2 2 -- x", "small 1 1 -- y", "first 0 1 -- z"],
        steps=[T, ("finish", "big", 0), T, T]),
    "unsatisfiable_min_np_fails_not_crashes": dict(
        pool="localhost:2", specs=["huge 1 5 -- x", "ok 0 2 -- y"],
        steps=[T, ("finish", "ok", 0), T]),
    "starvation_preempts_lowest_priority": dict(
        pool="localhost:3", kw=dict(starvation_deadline=5.0),
        specs=["low 1 2:3 -- x", "mid 2 1 after=1.0 -- m",
               "high 3 2 after=1.0 -- h"],
        steps=[T, ("advance", 2.0), T, ("advance", 5.0), T, T, T,
               ("finish", "high", 0), T, T, ("finish", "mid", 0), T,
               ("finish", "low", 0), T]),
    "equal_priority_never_preempts": dict(
        pool="localhost:2", kw=dict(starvation_deadline=1.0),
        specs=["a 1 2 -- x", "b 1 2 after=0.5 -- y"],
        steps=[T, ("advance", 10.0), T, ("finish", "a", 0), T,
               ("finish", "b", 0), T]),
    "starvation_counts_inflight_saves_toward_deficit": dict(
        pool="localhost:4", hold=True, kw=dict(starvation_deadline=2.0),
        specs=["lo1 1 2 -- x", "lo2 1 2 -- y", "hi 3 2 after=1.0 -- h"],
        steps=[T, ("advance", 4.0), T, T, T, T, ("allow", "lo1"),
               ("allow", "lo2"), T, "stop", T, T]),
    "failure_blames_host_via_shared_blacklist": dict(
        pool="hostA:2,hostB:2", specs=["a 1 2:4 restarts=1 -- x"],
        steps=[T, ("finish", "a", 1, {"failed": [(2, "hostB", 1)]}), T,
               ("finish", "a", 1), T]),
    "blame_keeps_floor_for_smallest_live_job": dict(
        pool="hostA:2", specs=["a 1 2 restarts=1 -- x"],
        steps=[T, ("finish", "a", 1, {"failed": [(0, "hostA", 1)]}), T, T,
               ("finish", "a", 0), T]),
    "spare_capacity_grows_running_job": dict(
        pool="localhost:3", kw=dict(grow_after=5.0),
        specs=["big 2 2 -- x", "grower 1 1:3 -- y"],
        steps=[T, ("finish", "big", 0), T, T, ("advance", 6.0), T, T, T,
               ("finish", "grower", 0), T]),
    "grow_waits_for_inflight_resize": dict(
        pool="localhost:4", hold=True, kw=dict(grow_after=1.0),
        specs=["c1 9 1 -- x", "c2 8 1 -- y", "a 2 1:9 -- a", "b 1 1:9 -- b"],
        steps=[T, ("finish", "c1", 0), T, ("advance", 1.5),
               ("finish", "c2", 0), T, T, T, ("allow", "a"), T, T,
               "stop", T, T]),
    "chaos_preempt_storm_hits_lowest_priority": dict(
        pool="localhost:3", spec="site=fleet,kind=preempt_storm:1",
        specs=["hi 2 1 -- x", "lo 1 1 -- y"],
        steps=[T, T, T, T, ("finish", "hi", 0), ("finish", "lo", 0), T]),
    "chaos_host_flap_bounces_last_host": dict(
        pool="hostA:1,hostB:1", spec="site=fleet,kind=host_flap",
        specs=["a 1 2 restarts=0 -- x"],
        steps=[T, T, T, T, ("finish", "a", 0), T]),
    "host_flap_spares_genuinely_blamed_host": dict(
        pool="hostA:2,hostB:2", spec="site=fleet,kind=host_flap:1",
        specs=["a 1 2 restarts=3 -- x"],
        steps=[T, ("finish", "a", 1, {"failed": [(1, "hostB", 1)]}), T, T,
               T, ("finish", "a", 0), T]),
    "chaos_rank_kill_at_fleet_site": dict(
        pool="localhost:3", spec="site=fleet,after=1,kind=rank_kill",
        specs=["hi 2 1 -- x", "lo 1 1:2 -- y"],
        steps=[T, T, T, ("finish", "hi", 0), ("finish", "lo", 0), T]),
    "per_job_isolation": dict(
        pool="localhost:4",
        kw=dict(metrics_port_base=18000, port_stride=64,
                metrics_file="summary"),
        specs=["one 1 2 -- x", "two 1 2 -- y"],
        steps=[T, ("finish", "one", 0), ("finish", "two", 0), T, "run"]),
    "stop_tears_down_all_jobs": dict(
        pool="localhost:2", specs=["a 1 1 -- x", "b 1 1 -- y"],
        steps=[T, "stop", "run"]),
    "stop_with_queued_jobs_terminates": dict(
        pool="localhost:1", specs=["run 2 1 -- x", "wait 1 1 -- y"],
        steps=[T, "stop", T, "run"]),
    # tests/test_serving.py's fleet half.
    "serving_admits_at_min_np": dict(
        pool="localhost:3", specs=["serve 2 1:3 type=serving -- sleep inf"],
        steps=[T, "stop", T]),
    "autoscaler_grows_on_queue_depth": dict(
        pool="localhost:3", specs=["serve 2 1:3 type=serving -- sleep inf"],
        steps=[T, ("stats", "serve", 20.0), T, T, T, "stop", T]),
    "autoscaler_grows_on_p99_over_slo": dict(
        pool="localhost:2", specs=["s 2 1:2 type=serving -- x"],
        steps=[T, ("stats", "s", 0.0, 900.0, 250.0), T, T, T, "stop", T]),
    "autoscaler_preempts_training_then_returns_capacity": dict(
        pool="localhost:3",
        kw=dict(serving_scale_down_idle=5.0, grow_after=1e9),
        specs=["serve 2 1:3 type=serving -- sleep inf",
               "train 1 2:2 -- sleep inf"],
        steps=[T, ("stats", "serve", 20.0), T, T, T, T,
               ("stats", "serve", 0.0), T, ("advance", 6.0), T, T, T,
               "stop", T]),
    "autoscaler_ignores_stale_pressure_without_stats": dict(
        pool="localhost:3", specs=["serve 2 1:3 type=serving -- sleep inf"],
        steps=[T, T, "stop", T]),
    "maybe_grow_leaves_serving_jobs_alone": dict(
        pool="localhost:3", kw=dict(grow_after=0.0),
        specs=["serve 2 1:3 type=serving -- sleep inf"],
        steps=[T, ("advance", 100.0), T, "stop", T]),
    "summary_records_job_type": dict(
        pool="localhost:3", kw=dict(metrics_file="summary"),
        specs=["serve 2 1:3 type=serving -- sleep inf", "train 1 1 -- x"],
        steps=[T, ("finish", "serve", 0), ("finish", "train", 0), "run"]),
}


@pytest.mark.parametrize("name", sorted(EPISODES))
def test_the_controllers_decide_alike_tick_by_tick(name, tmp_path,
                                                   monkeypatch):
    ep = EPISODES[name]
    play(tmp_path, ep["pool"], ep["specs"], ep["steps"],
         hold=ep.get("hold", False), spec=ep.get("spec"),
         monkeypatch=monkeypatch, **ep.get("kw", {}))


def test_the_episodes_reach_their_states(tmp_path, monkeypatch):
    """The harness drives what the reference's tests assert (a few of
    their end states, read on the port's side)."""
    ep = EPISODES["starvation_preempts_lowest_priority"]
    port = play(tmp_path / "a", ep["pool"], ep["specs"], ep["steps"][:6],
                drain=False, **ep["kw"])
    lo = port.job("low")
    assert lo.state == fleet.QUEUED and lo.preempted and lo.prev_np == 3
    assert ("high", 2) in port.runner.launches
    assert ("mid", 1) in port.runner.launches
    assert port.ctl.blacklist.filter(port.ctl.pool) == port.ctl.pool
    _drain(port.ctl)
    ep = EPISODES["chaos_host_flap_bounces_last_host"]
    port = play(tmp_path / "b", ep["pool"], ep["specs"], ep["steps"][:3],
                spec=ep["spec"], monkeypatch=monkeypatch, drain=False)
    assert port.runner.launches == [("a", 2), ("a", 2)]
    assert {i.hostname for i in port.job("a").infos} == {"hostA", "hostB"}
    _drain(port.ctl)
    ep = EPISODES["chaos_rank_kill_at_fleet_site"]
    port = play(tmp_path / "c", ep["pool"], ep["specs"], ep["steps"][:3],
                spec=ep["spec"], monkeypatch=monkeypatch, drain=False)
    assert port.job("lo").chaos_kills == [
        (1, "chaos rank_kill (fleet fault injection)")]
    _drain(port.ctl)


def test_the_resume_env_carries_prev_size_attempt_and_the_rendezvous(
        tmp_path):
    port = play(tmp_path, "localhost:3", ["low 1 1:3 -- x",
                                          "hi 2 2 after=1.0 -- h"],
                [T, ("advance", 3.0), T, T, T], starvation_deadline=1.0)
    # (play stopped the fleet; the runner kept every admission's env.)
    env0, env1 = (port.runner.envs["low"][0][0],
                  port.runner.envs["low"][1][0])
    assert env0["HOROVOD_RESTART_ATTEMPT"] == "0"
    assert "HOROVOD_ELASTIC_PREV_SIZE" not in env0
    assert env1["HOROVOD_RESTART_ATTEMPT"] == "1"
    assert env1["HOROVOD_ELASTIC_PREV_SIZE"] == "3"
    assert env1["HOROVOD_SIZE"] == "1"
    assert env1["HOROVOD_SPILL_DIR"] == env0["HOROVOD_SPILL_DIR"]
    assert env1["HOROVOD_SECRET_KEY"] == env0["HOROVOD_SECRET_KEY"]
    # The port's ranks meet at HOROVOD_COORDINATOR_ADDR, fresh each
    # admission, and read the host map from HOROVOD_TOPOLOGY.
    for env in (env0, env1):
        assert env["HOROVOD_COORDINATOR_ADDR"] == \
            f"127.0.0.1:{env['HOROVOD_RENDEZVOUS_PORT']}"
    assert env0["HOROVOD_COORDINATOR_ADDR"] != env1["HOROVOD_COORDINATOR_ADDR"]
    assert env0["HOROVOD_TOPOLOGY"] == "localhost:3"
    assert env1["HOROVOD_TOPOLOGY"] == "localhost:1"


def _cards(side, name, attempt=-1):
    return [(e["HOROVOD_HOSTNAME"], e["HOROVOD_LOCAL_RANK"],
             e["CUDA_VISIBLE_DEVICES"])
            for e in side.runner.envs[name][attempt]]


def test_two_jobs_on_one_host_of_cards_hold_disjoint_cards(tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    port = play(tmp_path, "localhost:4",
                ["one 2 2 -- x", "two 1 2 -- y", "three 0 1:2 -- z"],
                [T, ("finish", "one", 0), T, T], drain=False)
    assert port.ctl._cards["localhost"] == {0, 1, 2, 3}
    _drain(port.ctl)
    # one and two shared the host: cards 0,1 and 2,3.  When one ended,
    # three took the cards it left.
    assert _cards(port, "one") == [("localhost", "0", "0,1"),
                                   ("localhost", "1", "0,1")]
    assert _cards(port, "two") == [("localhost", "0", "2,3"),
                                   ("localhost", "1", "2,3")]
    assert _cards(port, "three") == [("localhost", "0", "0,1"),
                                     ("localhost", "1", "0,1")]
    assert port.ctl._cards["localhost"] == set()   # all released


def test_cards_count_per_host_and_within_the_controllers_own(
        tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    port = play(tmp_path, "localhost:2,hostB:2",
                ["a 2 3 -- x", "b 1 1 -- y"], [T])
    assert _cards(port, "a") == [("localhost", "0", "4,5"),
                                 ("localhost", "1", "4,5"),
                                 ("hostB", "0", "0")]
    assert _cards(port, "b") == [("hostB", "0", "1")]


WORKER = r'''
import signal

# A preemption may land while torch still imports: note it now, act on
# it at the first step boundary.
_early = []
signal.signal(signal.SIGTERM, lambda sig, frame: _early.append(sig))

import os
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint, resilience

torch.set_num_threads(1)
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
resilience.install_preemption_handler()
if _early:
    resilience.request_preemption()
CKPT = os.environ["FLEET_CKPT"]
os.makedirs(CKPT, exist_ok=True)
TOTAL = int(os.environ["FLEET_STEPS"])
JOB = os.environ["HOROVOD_FLEET_JOB"]
torch.manual_seed(0)
model = torch.nn.Linear(4, 2)
state = {"w": model.weight.detach().clone(), "step": torch.zeros((), dtype=torch.int64)}
state = checkpoint.restore(CKPT, state)
start = int(state["step"])
if start:
    print(f"FLEET_RESUME job={JOB} rank={rank} size={size} start={start} "
          f"prev={os.environ.get('HOROVOD_ELASTIC_PREV_SIZE', '')}",
          flush=True)
x = torch.arange(8.0).reshape(2, 4) / 8
for step in range(start, TOTAL):
    # The same gradient on every rank: the mean, and so the state, does
    # not depend on the world size.
    w = state["w"].requires_grad_(True)
    loss = ((x @ w.t()) ** 2).sum() * (step + 1)
    g, = torch.autograd.grad(loss, w)
    g = hvd.allreduce(g, name=f"g.{step}")
    state["w"] = (w - 0.01 * g).detach()
    state["step"] = torch.tensor(step + 1)
    resilience.report_progress(step)
    time.sleep(float(os.environ.get("FLEET_STEP_SECONDS", "0")))
    # Every rank saves at the same step: the preemption's SIGTERM may
    # reach the ranks on either side of a step boundary.
    asked = torch.tensor([float(resilience.preemption_requested())])
    if float(hvd.allreduce(asked, op=hvd.Max, name=f"p.{step}")):
        resilience.request_preemption()
    resilience.maybe_save_and_exit(CKPT, state, step + 1)
torch.save(state["w"], os.path.join(CKPT, f"final.{JOB}.{rank}.pt"))
print(f"FLEET_OK job={JOB} rank={rank} size={size} steps={TOTAL}",
      flush=True)
hvd.shutdown()
'''


def start_solo(script, np_, ckpt, steps, job, cwd):
    """The same job never preempted, under the port's launcher, started
    now (``communicate()`` waits for it)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", FLEET_CKPT=str(ckpt),
               FLEET_STEPS=str(steps), HOROVOD_FLEET_JOB=job)
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(np_),
         sys.executable, str(script)], cwd=str(cwd), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _fleet(args, tmp_path, timeout=240, env=None):
    full = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                HOROVOD_TERMINATE_GRACE_SECONDS="15")
    for var in (faults.ENV_VAR, "HOROVOD_METRICS_FILE", "MASTER_ADDR",
                "MASTER_PORT", "HOROVOD_RANK", "HOROVOD_SIZE"):
        full.pop(var, None)
    full.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "fleet", *args],
        capture_output=True, text=True, timeout=timeout, env=full,
        cwd=str(tmp_path))


def test_a_fleet_of_port_jobs_preempts_and_resumes(tmp_path):
    """``-H localhost:2``: ``low`` (1:2) takes both slots; ``high`` (one
    slot) arrives, starves past the deadline and preempts ``low``, which
    saves (rc 75, no host blamed), resumes at np 1 from its save and ends
    at the state of a run that was never interrupted."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    ckpt, ref = tmp_path / "ckpt", tmp_path / "ref"
    metrics = tmp_path / "fleet.json"
    cmd = f"{sys.executable} {script}"
    t0 = time.monotonic()
    solo = start_solo(script, 1, ref, 30, "low", tmp_path)
    res = _fleet(
        ["-H", "localhost:2", "--starvation-deadline", "1",
         "--tick-interval", "0.1", "--metrics-file", str(metrics),
         "--job", f"low 0 1:2 env:FLEET_CKPT={ckpt} env:FLEET_STEPS=30 "
                  f"env:FLEET_STEP_SECONDS=0.2 -- {cmd}",
         "--job", f"high 10 1 after=4 env:FLEET_CKPT={tmp_path / 'hi'} "
                  f"env:FLEET_STEPS=2 -- {cmd}"], tmp_path)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-6000:]
    assert "admit job low np=2" in res.stderr, out
    assert "preempting job low" in res.stderr and "starved" in res.stderr
    assert "job low preempted (rc 75)" in res.stderr, out
    assert "admit job high np=1" in res.stderr, out
    assert "admit job low np=1" in res.stderr, out
    assert "prev_np=2 (resume)" in res.stderr, out
    assert "blacklisting host" not in res.stderr, out
    assert "FLEET_RESUME job=low rank=0 size=1" in res.stdout, out
    assert "prev=2" in res.stdout and "FLEET_OK job=high" in res.stdout
    assert "FLEET_OK job=low rank=0 size=1 steps=30" in res.stdout, out
    doc = json.loads(metrics.read_text())
    assert doc["schema"] == "horovod_tpu.fleet.summary.v1"
    assert doc["jobs"]["low"]["state"] == doc["jobs"]["high"]["state"] \
        == "done"
    assert doc["jobs"]["low"]["preemptions"] == 1
    from horovod_tpu_torch.telemetry import aggregate
    snap = doc["controller"]["metrics"]
    assert aggregate.counter_total(snap, "hvd_fleet_preemptions_total") == 1
    assert aggregate.counter_total(snap, "hvd_fleet_admissions_total") == 3
    _, err = solo.communicate(timeout=120)
    assert solo.returncode == 0, err[-3000:]
    import torch
    got = torch.load(ckpt / "final.low.0.pt")
    want = torch.load(ref / "final.low.0.pt")
    assert torch.equal(got, want)
    assert time.monotonic() - t0 < 200
