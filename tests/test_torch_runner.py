"""The port's launcher (``python -m horovod_tpu_torch.runner``) held
against the reference's (``python -m horovod_tpu.runner``), on the CPU.

* The pure functions take the same inputs in both packages and give the
  same outputs, one parametrised case each: host and hostfile parsing,
  allocation (uneven slots, after a demotion), the topology string,
  promotion, free slots, the blacklist's cool-down on an injected clock,
  the config file's precedence and its unknown key, the flags' env, one
  rank's env, the terminate grace's parsing, the host probe and its
  cache, ``_demote_failed_hosts`` and ``_plan_reformation``; without
  PyYAML, ``--config-file`` names the missing module.
* A ``-np 4`` job over two hosts (``-H localhost:2,127.0.1.1:2`` and the
  same as a hostfile; 127.0.1.1 is not local, so its ranks ride
  ``ci/fake_ssh.sh``) under each launcher prints every rank's
  ``HOROVOD_*`` environment: equal rank for rank, apart from
  :data:`DIFFERENT` (ports, the secret, the shm namespace of the native
  transports and the port's rendezvous, the reference's JAX key).
* SIGINT to the launcher once its ranks run: rc 130.
* ``--elastic-restarts 1``: a failed attempt is relaunched with a fresh
  rendezvous, and the port's world forms again.
* With a ``jax`` on ``PYTHONPATH`` that raises ``ImportError``, a ``-np
  2`` port job and ``--check-build`` run: neither the launcher nor its
  ranks need JAX.
* The heartbeat of a port rank against the port launcher's health plane:
  delivery, preemption and the reform spec.
"""

import dataclasses
import io
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from horovod_tpu.runner import config_parser as ref_config_parser
from horovod_tpu.runner import hosts as ref_hosts
from horovod_tpu.runner import launch as ref_launch
from horovod_tpu.runner import network as ref_network
from horovod_tpu.runner import run as ref_run
from horovod_tpu_torch import resilience as tres
from horovod_tpu_torch.runner import config_parser, hosts, launch, network
from horovod_tpu_torch.runner import run
from torch_support import PORT_LAUNCHER, REF_LAUNCHER, REPO

PORT = {"hosts": hosts, "config_parser": config_parser, "launch": launch,
        "network": network, "run": run}
REF = {"hosts": ref_hosts, "config_parser": ref_config_parser,
       "launch": ref_launch, "network": ref_network, "run": ref_run}

JOB_TIMEOUT = 120


def _plain(x):
    """Dataclasses of either package as tuples, recursively."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _plain(v) for v in dataclasses.astuple(x))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


# -- the pure functions, case by case ------------------------------------------

def _parse_hosts(m, tmp_path, monkeypatch):
    return [m["hosts"].parse_hosts(s) for s in
            ("h1:2,h2:2", "a, b:3 ,c:1,", "solo", "x:0,y:4")]


def _parse_hostfile(m, tmp_path, monkeypatch):
    path = tmp_path / "hostfile"
    path.write_text("# the pool\nnode-a slots=4\n\nnode-b   slots=2 # two\n"
                    "node-c\nnode-d max_slots=9 slots=3\n")
    return m["hosts"].parse_hostfile(str(path))


def _allocate_uneven(m, tmp_path, monkeypatch):
    h = m["hosts"]
    pool = [h.HostSlots("a", 3), h.HostSlots("b", 1), h.HostSlots("c", 2)]
    return [h.allocate(pool, n) for n in (1, 3, 4, 5, 6)]


def _allocate_after_a_demotion(m, tmp_path, monkeypatch):
    h = m["hosts"]
    pool = [h.HostSlots("a", 2), h.HostSlots("b", 2), h.HostSlots("c", 1)]
    bl = h.HostBlacklist()
    bl.demote("a", "rank 0 exited with code 1")
    usable = bl.filter(pool)
    infos = h.allocate(usable, 3)
    return [usable, infos, h.topology_string(infos), bl.summary(),
            h.topology_string(h.allocate(h.promote_host(pool, "c"), 5))]


def _promote_and_free(m, tmp_path, monkeypatch):
    h = m["hosts"]
    pool = [h.HostSlots("a", 2), h.HostSlots("b", 3), h.HostSlots("c", 1)]
    return [h.promote_host(pool, "b"), h.promote_host(pool, "zz"),
            h.free_slots(pool, {"a": 2, "b": 1}), h.free_slots(pool, {})]


def _blacklist_cooldown(m, tmp_path, monkeypatch):
    h = m["hosts"]
    now = [100.0]
    bl = h.HostBlacklist(cooldown=10.0, clock=lambda: now[0])
    seen = []
    bl.demote("a", "crash")
    bl.demote("b")
    for t in (100.0, 105.0, 110.0, 110.5, 111.0):
        now[0] = t
        seen.append((t, bl.is_blacklisted("a"), bl.summary()))
    bl.demote("a", "again")
    bl.forgive("a")
    seen.append(bl.is_blacklisted("a"))
    forever = h.HostBlacklist(clock=lambda: now[0])
    forever.demote("x")
    now[0] = 1e9
    seen.append(forever.is_blacklisted("x"))
    return seen


def _config_file(m, tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    path.write_text("fusion-threshold-mb: 32\ncycle-time-ms: 5\n"
                    "autotune: true\nmin-np: 2\nlog-level: info\n")
    parser = m["run"].build_parser()
    args = parser.parse_args(["--config-file", str(path),
                              "--cycle-time-ms", "2", "-np", "4", "x"])
    m["config_parser"].apply_config_file(args, parser)
    out = [args.fusion_threshold_mb, args.cycle_time_ms, args.autotune,
           args.min_np, args.log_level,
           m["config_parser"].env_from_args(args)]
    bad = tmp_path / "bad.yaml"
    bad.write_text("fusion-threshold-mb: 1\nno-such-key: 3\n")
    args = parser.parse_args(["--config-file", str(bad), "x"])
    with pytest.raises(ValueError) as e:
        m["config_parser"].apply_config_file(args, parser)
    return out + [str(e.value)]


def _env_from_flags(m, tmp_path, monkeypatch):
    args = m["run"].build_parser().parse_args(
        ["-np", "2", "--fusion-threshold-mb", "1.5", "--cache-capacity",
         "0", "--timeline-filename", "/t.json", "--timeline-mark-cycles",
         "--stall-check-time-seconds", "9", "--autotune",
         "--autotune-log-file", "/a.csv", "--log-hide-timestamp",
         "--network-interface", "eth0", "cmd"])
    return m["config_parser"].env_from_args(args)


def _runtime_env(m, tmp_path, monkeypatch):
    for k in list(os.environ):
        if k.startswith("HOROVOD_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("HOROVOD_HOSTNAME", "leaked")
    h = m["hosts"]
    infos = h.allocate([h.HostSlots("a", 2), h.HostSlots("b", 1)], 3)
    out = []
    for multi in (False, True):
        for info in infos:
            env = m["config_parser"].runtime_env(
                info, "a", 1234, {"HOROVOD_CYCLE_TIME": "2"},
                multi_host=multi)
            out.append({k: v for k, v in env.items()
                        if k.startswith("HOROVOD_")})
    monkeypatch.delenv("HOROVOD_HOSTNAME")
    monkeypatch.setenv("HOROVOD_NETWORK_INTERFACE", "eth1")
    env = m["config_parser"].runtime_env(infos[2], "a", 1, {})
    out.append("HOROVOD_HOSTNAME" in env)
    return out


def _terminate_grace(m, tmp_path, monkeypatch):
    out = []
    for v in (None, "", "2.5", "0", "soon"):
        if v is None:
            monkeypatch.delenv("HOROVOD_TERMINATE_GRACE_SECONDS",
                               raising=False)
        else:
            monkeypatch.setenv("HOROVOD_TERMINATE_GRACE_SECONDS", v)
        err = io.StringIO()
        monkeypatch.setattr(sys, "stderr", err)
        out.append((m["launch"]._terminate_grace_seconds(), err.getvalue()))
        monkeypatch.undo()
    return out


def _probe_and_cache(m, tmp_path, monkeypatch):
    net = m["network"]
    probes = []

    def builder(host):
        probes.append(host)
        return ["false"] if host.startswith("dead") else ["true"]

    cache = tmp_path / f"cache-{len(os.listdir(tmp_path))}.json"
    out = [net.probe_hosts(["ok1", "dead1"], ssh_builder=builder)]
    with pytest.raises(RuntimeError) as e:
        net.check_hosts_reachable(["ok1", "dead1", "dead2"],
                                  ssh_builder=builder,
                                  cache_path=str(cache))
    out.append(str(e.value))
    net.check_hosts_reachable(["ok1", "ok2"], ssh_builder=builder,
                              cache_path=str(cache))
    before = len(probes)
    net.check_hosts_reachable(["ok2", "ok1"], ssh_builder=builder,
                              cache_path=str(cache))
    out.append((len(probes) - before, sorted(json.loads(cache.read_text()))))
    return out


def _demote_failed(m, tmp_path, monkeypatch):
    h = m["hosts"]
    pool = [h.HostSlots("a", 2), h.HostSlots("b", 2), h.HostSlots("c", 1)]
    out = []
    for failed, min_np in (([(0, "a", 1)], 3),
                           ([(0, "a", 1), (2, "b", -9)], 3),
                           ([(2, "b", 75), (4, "c", 1)], 1),
                           ([(4, "c", 1)], 5)):
        bl = h.HostBlacklist()
        err = io.StringIO()
        monkeypatch.setattr(sys, "stderr", err)
        m["run"]._demote_failed_hosts(bl, pool, failed, min_np)
        monkeypatch.undo()
        out.append((bl.summary(), err.getvalue()))
    return out


def _plan_reform(m, tmp_path, monkeypatch):
    h = m["hosts"]
    infos = h.allocate([h.HostSlots("a", 3), h.HostSlots("b", 2)], 5)
    out = []
    for dead in ((1,), (0, 4), (3, 4), (0, 1, 2)):
        survivors = [i for i in reversed(infos) if i.rank not in dead]
        out.append(m["run"]._plan_reformation(survivors, "10.0.0.1",
                                              4242, len(dead)))
    return out


CASES = {
    "parse_hosts": _parse_hosts,
    "parse_hostfile": _parse_hostfile,
    "allocate_uneven": _allocate_uneven,
    "allocate_after_demotion": _allocate_after_a_demotion,
    "promote_and_free_slots": _promote_and_free,
    "blacklist_cooldown": _blacklist_cooldown,
    "config_file_precedence_and_unknown_key": _config_file,
    "env_from_flags": _env_from_flags,
    "runtime_env": _runtime_env,
    "terminate_grace": _terminate_grace,
    "probe_and_cache": _probe_and_cache,
    "demote_failed_hosts": _demote_failed,
    "plan_reformation": _plan_reform,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_pure_functions_are_the_references(case, tmp_path, monkeypatch):
    fn = CASES[case]
    want = _plain(fn(REF, tmp_path, monkeypatch))
    got = _plain(fn(PORT, tmp_path, monkeypatch))
    assert got == want


def test_a_config_file_without_pyyaml_names_the_module(tmp_path,
                                                      monkeypatch):
    """PyYAML may be absent on the GPU host: only ``--config-file`` needs
    it, and then the error says which module is missing."""
    path = tmp_path / "cfg.yaml"
    path.write_text("cycle-time-ms: 5\n")
    parser = run.build_parser()
    args = parser.parse_args(["--config-file", str(path), "x"])
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml fails
    with pytest.raises(RuntimeError, match="PyYAML"):
        config_parser.apply_config_file(args, parser)
    config_parser.apply_config_file(parser.parse_args(["x"]), parser)


def test_the_parsers_take_the_references_flags():
    """Every flag of the reference's parser but the two JAX ones, with
    its default, in the port's."""
    def flags(parser):
        return {opt: (a.dest, a.default) for a in parser._actions
                for opt in a.option_strings}

    want, got = flags(ref_run.build_parser()), flags(run.build_parser())
    jax_only = {"--jax-distributed", "--jax-coordinator-port"}
    assert set(want) - set(got) == jax_only
    assert set(got) == set(want) - jax_only
    for opt in got:
        if opt not in ("-v", "--version"):
            assert got[opt] == want[opt], opt


# -- whole jobs -----------------------------------------------------------------

ENV_JOB = ("import json, os; print('ENV ' + json.dumps({k: v for k, v in "
           "os.environ.items() if k.startswith('HOROVOD_')}, "
           "sort_keys=True), flush=True)")

# Keys whose values may differ between the two launchers' ranks: the
# rendezvous port and the RPC endpoints' ports (their hosts are held
# equal), the job's secret, the native transports' shm namespace (the
# reference's alone), and the port's rendezvous address, which the
# reference sets only under --jax-distributed (the JAX coordinator).
PORT_KEYS = ("HOROVOD_RENDEZVOUS_PORT", "HOROVOD_HEALTH_RPC",
             "HOROVOD_METRICS_RPC", "HOROVOD_TRACE_RPC")
DIFFERENT = PORT_KEYS + ("HOROVOD_SECRET_KEY", "HOROVOD_SHM_DIR",
                         "HOROVOD_COORDINATOR_ADDR")


def _clean_env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               HOME=str(tmp_path), HOROVOD_SSH_CMD="ci/fake_ssh.sh",
               HOROVOD_TERMINATE_GRACE_SECONDS="3")
    env.update(extra)
    return env


def _rank_envs(stdout):
    envs = {}
    for line in stdout.splitlines():
        m = re.match(r"\[(\d+)\]<stdout>:ENV (.*)$", line)
        if m:
            envs[int(m.group(1))] = json.loads(m.group(2))
    return envs


@pytest.mark.parametrize("how", ["hosts", "hostfile"])
def test_every_rank_gets_the_references_environment(how, tmp_path):
    if how == "hosts":
        where = ["-H", "localhost:2,127.0.1.1:2"]
    else:
        hostfile = tmp_path / "hostfile"
        hostfile.write_text("localhost slots=2\n127.0.1.1 slots=2\n")
        where = ["--hostfile", str(hostfile)]
    flags = ["-np", "4", *where, "--fusion-threshold-mb", "8",
             "--cycle-time-ms", "2", "--autotune", "--log-level", "info",
             "--stall-check-time-seconds", "30", "--heartbeat-interval", "5",
             "--metrics-file", str(tmp_path / "m.json"),
             "--trace", str(tmp_path / "trace")]
    envs = {}
    for launcher in (REF_LAUNCHER, PORT_LAUNCHER):
        p = subprocess.run(
            [sys.executable, "-m", launcher, *flags, sys.executable, "-c",
             ENV_JOB], cwd=REPO, env=_clean_env(tmp_path),
            capture_output=True, text=True, timeout=JOB_TIMEOUT)
        assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
        envs[launcher] = _rank_envs(p.stdout)
        assert sorted(envs[launcher]) == [0, 1, 2, 3], p.stdout[-3000:]
    for r in range(4):
        want, got = envs[REF_LAUNCHER][r], envs[PORT_LAUNCHER][r]
        assert ({k: v for k, v in got.items() if k not in DIFFERENT}
                == {k: v for k, v in want.items() if k not in DIFFERENT}), r
        assert set(want) - set(got) == {"HOROVOD_SHM_DIR"}
        assert set(got) - set(want) == {"HOROVOD_COORDINATOR_ADDR"}
        for k in PORT_KEYS:
            assert (got[k].rpartition(":")[0]
                    == want[k].rpartition(":")[0]), k
        assert got["HOROVOD_COORDINATOR_ADDR"] == (
            f"{got['HOROVOD_RENDEZVOUS_ADDR']}:"
            f"{got['HOROVOD_RENDEZVOUS_PORT']}")
        assert got["HOROVOD_RANK"] == str(r)
        assert got["HOROVOD_HOSTNAME"] == ("localhost" if r < 2
                                           else "127.0.1.1")
        assert got["HOROVOD_TOPOLOGY"] == "localhost:2,127.0.1.1:2"


SLEEPER = r'''
import os, time
print(f"READY rank={os.environ['HOROVOD_RANK']}", flush=True)
time.sleep(60)
'''


def test_sigint_stops_the_job_with_rc_130(tmp_path):
    """The signal goes to the launcher only once both ranks printed that
    they run (no race with their start)."""
    script = tmp_path / "sleeper.py"
    script.write_text(SLEEPER)
    p = subprocess.Popen(
        [sys.executable, "-m", PORT_LAUNCHER, "-np", "2", sys.executable,
         str(script)], cwd=REPO, env=_clean_env(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = set()
        deadline = time.monotonic() + JOB_TIMEOUT
        while len(ready) < 2 and time.monotonic() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            m = re.search(r"READY rank=(\d)", line)
            if m:
                ready.add(m.group(1))
        assert ready == {"0", "1"}, ready
        t0 = time.monotonic()
        p.send_signal(signal.SIGINT)
        rc = p.wait(timeout=30)
    finally:
        p.kill()
    assert rc == 130
    assert time.monotonic() - t0 < 15


RESTART = r'''
import os, sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
attempt = os.environ["HOROVOD_RESTART_ATTEMPT"]
hvd.init(device="cpu")
rank = hvd.rank()
got = hvd.allreduce(torch.ones(2), op=hvd.Sum, name="restart")
print(f"RESTART attempt={attempt} rank={rank} sum={got.tolist()} "
      f"addr={os.environ['HOROVOD_COORDINATOR_ADDR']}", flush=True)
hvd.shutdown()
if attempt == "0" and rank == 1:
    sys.exit(3)
'''


def test_a_rank_a_signal_killed_is_blamed_before_its_collateral(
        monkeypatch):
    """Both ranks are found dead at one poll: rank 1 SIGKILLed itself,
    then rank 0 exited with an error, as a rank whose peer died does.
    Rank 1 stays a failure of its own (the teardown that rank 0, seen
    first, starts does not excuse a rank already dead), and the report
    names it first, so the host blame walks it first.  Under load the
    launcher's poll can find both dead at once; it then blamed rank 0's
    host alone (tests/test_torch_chaos.py's crash gate)."""
    monkeypatch.setattr(launch, "_POLL_SECONDS", 5.0)
    script = ("import os, signal, time\n"
              "rank = int(os.environ['HOROVOD_RANK'])\n"
              "time.sleep(0.6 - 0.4 * rank)\n"
              "os.kill(os.getpid(), signal.SIGKILL) if rank else "
              "os._exit(1)\n")
    infos = [hosts.RankInfo(r, 2, r, 2, 0, 1, "localhost") for r in (0, 1)]
    envs = [dict(os.environ, HOROVOD_RANK=str(r)) for r in (0, 1)]
    report = {}
    rc = launch.launch_job(infos, [sys.executable, "-c", script], envs,
                           report=report, install_signal_handlers=False)
    assert rc == 1
    assert report["failed"] == [(1, "localhost", -signal.SIGKILL),
                                (0, "localhost", 1)]


def test_an_elastic_restart_relaunches_at_a_fresh_rendezvous(tmp_path):
    script = tmp_path / "restart.py"
    script.write_text(RESTART)
    p = subprocess.run(
        [sys.executable, "-m", PORT_LAUNCHER, "-np", "2",
         "--elastic-restarts", "1", sys.executable, str(script)],
        cwd=REPO, env=_clean_env(tmp_path), capture_output=True, text=True,
        timeout=JOB_TIMEOUT)
    log = p.stdout + p.stderr
    assert p.returncode == 0, log[-4000:]
    assert "job failed (rc=3); elastic restart 1/1" in p.stderr, log[-4000:]
    rows = re.findall(r"RESTART attempt=(\d) rank=(\d) sum=\[2\.0, 2\.0\] "
                      r"addr=(\S+)", p.stdout)
    assert sorted((a, r) for a, r, _ in rows) == [
        ("0", "0"), ("0", "1"), ("1", "0"), ("1", "1")], log[-4000:]
    addrs = {a: {addr for a2, _, addr in rows if a2 == a} for a in "01"}
    assert len(addrs["0"]) == len(addrs["1"]) == 1
    assert addrs["0"] != addrs["1"]


NO_JAX = r'''
import sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
got = hvd.allreduce(torch.full((3,), hvd.rank() + 1.0), op=hvd.Sum)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "horovod_tpu")]
print(f"NOJAX rank={hvd.rank()} sum={got.tolist()} bad={bad}", flush=True)
hvd.shutdown()
'''


def test_the_launcher_and_its_ranks_need_no_jax(tmp_path):
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        "raise ImportError('jax is not installed on this host')\n")
    env = _clean_env(tmp_path,
                     PYTHONPATH=f"{tmp_path / 'stub'}{os.pathsep}{REPO}")
    probe = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                           capture_output=True, text=True, timeout=60)
    assert probe.returncode != 0 and "not installed" in probe.stderr
    script = tmp_path / "nojax.py"
    script.write_text(NO_JAX)
    job = subprocess.run(
        [sys.executable, "-m", PORT_LAUNCHER, "-np", "2", sys.executable,
         str(script)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=JOB_TIMEOUT)
    assert job.returncode == 0, (job.stdout + job.stderr)[-4000:]
    for r in (0, 1):
        assert f"NOJAX rank={r} sum=[3.0, 3.0, 3.0] bad=[]" in job.stdout
    build = subprocess.run(
        [sys.executable, "-m", PORT_LAUNCHER, "--check-build"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=60)
    assert build.returncode == 0, build.stderr[-3000:]
    for line in ("Available backends:", "NCCL", "[X] Gloo",
                 "Kernels (sm_90a, built at first use):", "fused_stem",
                 "flash_attention", "[X] PyTorch"):
        assert line in build.stdout, build.stdout


# -- the heartbeat against the port launcher's health plane --------------------

def _wait(cond, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_a_port_rank_heartbeats_to_the_port_launchers_health_plane(
        monkeypatch):
    hp = run._HealthPlane("s3cret", 0.05, 5.0, 0.0)
    try:
        monkeypatch.setenv("HOROVOD_HEALTH_RPC", f"127.0.0.1:{hp.port}")
        monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", "0.05")
        monkeypatch.setenv("HOROVOD_SECRET_KEY", "s3cret")
        tres.report_progress(7)
        assert tres.start_heartbeat(rank=1) is not None
        assert _wait(lambda: 1 in hp.monitor.step_lags())
        hp.request_preempt()
        assert _wait(tres.preemption_requested)
        infos = hosts.allocate([hosts.HostSlots("localhost", 3)], 3)
        specs, alias = run._plan_reformation(infos[:2], "127.0.0.1", 4242,
                                             1)
        hp.request_reform(specs, alias, 1)
        assert tres._take_reform_spec(5.0) == specs[1]
    finally:
        tres.stop_heartbeat()
        hp.shutdown()
        tres._preempt_event.clear()
