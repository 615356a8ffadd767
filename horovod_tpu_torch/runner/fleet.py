"""``python -m horovod_tpu_torch.runner fleet``: the priority
gang-scheduling fleet controller (``hvdfleet``).

Counterpart of ``horovod_tpu/runner/fleet.py``.  One controller owns a
pool of hosts and runs many jobs of the port over it, each through the
port's own launcher machinery (:func:`~horovod_tpu_torch.runner.launch.
launch_job` under a :class:`~horovod_tpu_torch.runner.launch.JobControl`):

* **Gang admission** in strict priority order: a job starts only when
  ``min_np`` slots are free and takes up to ``max_np``; nothing behind a
  queued job backfills past it.
* **Preemption**: when the head of the queue has starved past
  ``--starvation-deadline``, the lowest-priority running jobs are
  preempted through SIGTERM, the coordinated save of
  :mod:`horovod_tpu_torch.resilience` and its exit code 75; a victim is
  requeued without host blame and resumes from its save.
* **Elastic resize**: spare capacity grows a running job toward
  ``max_np`` (a controlled preemption and re-admission with
  ``HOROVOD_ELASTIC_PREV_SIZE``); capacity loss shrinks it.
* **Serving autoscaling**: ``type=serving`` jobs are resized from the
  queue depth and p99 latency their router publishes to
  ``HOROVOD_SERVING_STATS``.
* **Shared blame**: one :class:`~horovod_tpu_torch.runner.hosts.
  HostBlacklist` spans every job.
* **Isolation**: each job has its own secret, rendezvous (the address
  where its gloo/NCCL world meets, ``HOROVOD_COORDINATOR_ADDR``), spill
  directory, metrics files and exporter port base, and its own cards:
  the controller tracks which card indices each job holds on each host
  and hands every rank ``CUDA_VISIBLE_DEVICES`` listing its job's cards
  there, so that ``cuda:<local_rank>`` indexes within them and two jobs
  on one host of cards never share one.  The scheduling decisions are
  the reference's; the cards follow the slots.

Scheduling is a deterministic tick loop (``tick()``) with an injectable
clock and job runner, so tests drive episodes without processes.  Chaos
enters through :func:`horovod_tpu_torch.faults.fleet_chaos` (site
``fleet``: ``preempt_storm``, ``host_flap``, ``rank_kill``).
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import socket
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.coordination import PREEMPTION_RC
from horovod_tpu_torch.runner import config_parser, hosts, launch

# Job lifecycle.  PREEMPTING covers both scheduler preemptions and
# controlled resizes — the job was asked to save and exit; its slots
# free at reap time.
QUEUED = "queued"
RUNNING = "running"
PREEMPTING = "preempting"
DONE = "done"
FAILED = "failed"
STOPPED = "stopped"

_LIVE_STATES = (QUEUED, RUNNING, PREEMPTING)


@dataclass
class JobSpec:
    """One job line: ``name priority min_np[:max_np] [key=val ...] --
    command ...``."""
    name: str
    priority: int
    min_np: int
    max_np: int
    command: List[str]
    after: float = 0.0        # submit delay (seconds from fleet start)
    restarts: int = 2         # failure-restart budget (preemptions free)
    type: str = "batch"       # "batch" | "serving" (autoscaled replicas)
    env: Dict[str, str] = field(default_factory=dict)


def parse_job_spec(line: str) -> JobSpec:
    """Parse one job line.

    Grammar: ``name priority min_np[:max_np] [after=S] [restarts=N]
    [env:KEY=VAL ...] -- command args...``.  The ``--`` separator is
    mandatory so job metadata can grow without ever being confused for
    the command.
    """
    tokens = shlex.split(line)
    if "--" not in tokens:
        raise ValueError(
            f"job spec {line!r} has no ' -- ' separating metadata from "
            f"the command")
    sep = tokens.index("--")
    meta, command = tokens[:sep], tokens[sep + 1:]
    if len(meta) < 3:
        raise ValueError(
            f"job spec {line!r} needs at least 'name priority "
            f"min_np[:max_np]' before ' -- '")
    if not command:
        raise ValueError(f"job spec {line!r} has an empty command")
    name = meta[0]
    if not name or any(c in name for c in "/\\ \t"):
        raise ValueError(f"bad job name {name!r} (used for directories "
                         f"and metric labels)")
    try:
        priority = int(meta[1])
    except ValueError:
        raise ValueError(f"job {name}: priority {meta[1]!r} is not an int")
    np_spec = meta[2]
    lo, _, hi = np_spec.partition(":")
    try:
        min_np = int(lo)
        max_np = int(hi) if hi else min_np
    except ValueError:
        raise ValueError(
            f"job {name}: np spec {np_spec!r} is not min_np[:max_np]")
    if min_np < 1 or max_np < min_np:
        raise ValueError(
            f"job {name}: need 1 <= min_np <= max_np (got {np_spec!r})")
    spec = JobSpec(name=name, priority=priority, min_np=min_np,
                   max_np=max_np, command=command)
    for extra in meta[3:]:
        key, eq, value = extra.partition("=")
        if not eq:
            raise ValueError(
                f"job {name}: metadata {extra!r} is not key=value")
        if key == "after":
            spec.after = float(value)
        elif key == "restarts":
            spec.restarts = int(value)
        elif key == "type":
            if value not in ("batch", "serving"):
                raise ValueError(
                    f"job {name}: unknown job type {value!r} (valid: "
                    f"batch, serving)")
            spec.type = value
        elif key.startswith("env:") and len(key) > 4:
            spec.env[key[4:]] = value
        else:
            raise ValueError(
                f"job {name}: unknown metadata key {key!r} (valid: "
                f"after=, restarts=, type=, env:KEY=)")
    return spec


class _Job:
    """Controller-side state for one spec across its whole lifetime
    (admissions, preemptions, resizes, restarts)."""

    def __init__(self, spec: JobSpec, index: int, fleet_dir: str):
        self.spec = spec
        self.index = index          # submission order; also port offset
        self.state = QUEUED
        self.dir = os.path.join(fleet_dir, "jobs", spec.name)
        self.spill_dir = os.path.join(self.dir, "spill")
        self.metrics_base = os.path.join(self.dir, "metrics.json")
        self.stats_path = os.path.join(self.dir, "serving_stats.json")
        self.secret = config_parser.job_secret()
        self.queued_at = 0.0        # set on (re)queue by the controller
        self.eligible_at = 0.0
        self.started_at = 0.0
        self.preempt_at = 0.0
        self.attempt = 0            # launch counter (HOROVOD_RESTART_ATTEMPT)
        self.restarts_left = spec.restarts
        self.np = 0                 # current world size (0 = not running)
        self.prev_np: Optional[int] = None   # last world size, for PREV_SIZE
        self.preempted = False      # queued-for-resume (vs never-started)
        self.resizing = False       # current PREEMPTING is a resize, not
                                    # a scheduler/chaos preemption
        self.target_np = None       # autoscaler-chosen size for the next
                                    # admission (serving resizes only)
        self.calm_since = 0.0       # start of the current low-pressure
                                    # window (serving scale-down timer)
        self.preemptions = 0
        self.rc: Optional[int] = None
        self.infos: List[hosts.RankInfo] = []
        self.cards: Dict[str, List[int]] = {}   # host -> card indices held
        self.control: Optional[launch.JobControl] = None
        self.health = None          # per-job _HealthPlane, if enabled
        self.chaos_kills: List = [] # pending (rank, reason) kill orders
                                    # from fleet-site rank_kill chaos,
                                    # drained by the job's watchdog
        self.thread: Optional[threading.Thread] = None
        self.result = None          # (rc, report) set by the job thread
        self.starve_logged = False

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def priority(self) -> int:
        return self.spec.priority


class FleetController:
    """The scheduler.  ``tick()`` is one deterministic pass (reap →
    chaos → starvation/preemption → admission → grow → gauges);
    ``run()`` loops it.  ``clock``/``sleep``/``job_runner`` are
    injectable so tests drive whole episodes synchronously.

    ``job_runner(job, infos, env_per_rank, control, report, watchdog)
    -> rc`` replaces process spawning in unit tests; the default runs
    :func:`horovod_tpu_torch.runner.launch.launch_job` in a worker thread
    with ``install_signal_handlers=False`` and a
    :class:`~horovod_tpu_torch.runner.launch.JobControl`.
    """

    def __init__(self, pool: List[hosts.HostSlots], specs: List[JobSpec],
                 *, starvation_deadline: float = 30.0,
                 tick_interval: float = 0.25,
                 grow_after: float = 15.0,
                 serving_scale_up_depth: float = 8.0,
                 serving_scale_down_idle: float = 10.0,
                 blacklist: Optional[hosts.HostBlacklist] = None,
                 blacklist_cooldown: Optional[float] = None,
                 fleet_dir: Optional[str] = None,
                 metrics_file: Optional[str] = None,
                 metrics_port_base: int = 0,
                 port_stride: int = 64,
                 output_dir: Optional[str] = None,
                 heartbeat_interval: float = 0.0,
                 hang_deadline: float = 0.0,
                 start_timeout: Optional[float] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 job_runner=None,
                 verbose: bool = False):
        if not pool:
            raise ValueError("fleet needs a non-empty host pool")
        if not specs:
            raise ValueError("fleet needs at least one job spec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate job names in {names}")
        self.pool = list(pool)
        self.starvation_deadline = float(starvation_deadline)
        self.tick_interval = float(tick_interval)
        self.grow_after = float(grow_after)
        self.serving_scale_up_depth = float(serving_scale_up_depth)
        self.serving_scale_down_idle = float(serving_scale_down_idle)
        self.blacklist = blacklist or hosts.HostBlacklist(
            cooldown=blacklist_cooldown)
        self._permanent_blacklist = (blacklist is None and
                                     blacklist_cooldown is None)
        self.fleet_dir = fleet_dir or tempfile.mkdtemp(prefix="hvd-fleet-")
        self.metrics_file = metrics_file
        self.metrics_port_base = int(metrics_port_base or 0)
        self.port_stride = int(port_stride)
        self.output_dir = output_dir
        self.heartbeat_interval = float(heartbeat_interval or 0.0)
        self.hang_deadline = float(hang_deadline or 0.0)
        self.start_timeout = start_timeout
        self.extra_env = dict(extra_env or {})
        self._clock = clock
        self._sleep = sleep
        self._job_runner = job_runner or self._run_job_process
        self.verbose = verbose
        self._stopping = False
        self._used: Dict[str, int] = {}
        self._cards: Dict[str, set] = {}   # host -> card indices held
        self._flapped: set = set()  # hosts chaos host_flap will restore
        self.jobs = [_Job(s, i, self.fleet_dir)
                     for i, s in enumerate(specs)]
        self._t0 = self._clock()
        total = sum(h.slots for h in self.pool)
        for job in self.jobs:
            job.queued_at = self._t0
            job.eligible_at = self._t0 + job.spec.after
            if job.spec.min_np > total:
                job.state = FAILED
                job.rc = 1
                self._log(f"job {job.name} can never fit: min_np "
                          f"{job.spec.min_np} > pool capacity {total}")

    # -- plumbing ----------------------------------------------------------

    def _log(self, msg: str) -> None:
        print(f"hvdfleet: {msg}", file=sys.stderr, flush=True)

    def _usable_pool(self) -> List[hosts.HostSlots]:
        return self.blacklist.filter(self.pool)

    def _free_hosts(self) -> List[hosts.HostSlots]:
        return hosts.free_slots(self._usable_pool(), self._used)

    def _queued(self) -> List[_Job]:
        """Eligible queued jobs in admission order: priority first, then
        longest-waiting, then submission order."""
        now = self._clock()
        out = [j for j in self.jobs
               if j.state == QUEUED and now >= j.eligible_at]
        out.sort(key=lambda j: (-j.priority, j.queued_at, j.index))
        return out

    def _running(self) -> List[_Job]:
        return [j for j in self.jobs if j.state == RUNNING]

    def alive(self) -> bool:
        return any(j.state in _LIVE_STATES for j in self.jobs)

    # -- scheduling pass ---------------------------------------------------

    def tick(self) -> bool:
        """One scheduling pass; returns True while any job is live."""
        self._reap()
        if not self._stopping:
            self._apply_chaos()
            self._autoscale_serving()
            self._check_starvation()
            self._admit()
            self._maybe_grow()
            self._fail_unsatisfiable()
        self._update_gauges()
        return self.alive()

    # -- reaping -----------------------------------------------------------

    def _release(self, job: _Job) -> None:
        for info in job.infos:
            left = self._used.get(info.hostname, 0) - 1
            if left > 0:
                self._used[info.hostname] = left
            else:
                self._used.pop(info.hostname, None)
        for host, cards in job.cards.items():
            self._cards[host].difference_update(cards)
        job.infos = []
        job.cards = {}

    def _take_cards(self, infos: List[hosts.RankInfo]
                    ) -> Dict[str, List[int]]:
        """The lowest free card indices on each host of ``infos``, one a
        rank: a host's slots are its cards, so there are always enough."""
        cards: Dict[str, List[int]] = {}
        for host, n in _host_counts(infos).items():
            held = self._cards.setdefault(host, set())
            mine, i = [], 0
            while len(mine) < n:
                if i not in held:
                    mine.append(i)
                i += 1
            held.update(mine)
            cards[host] = mine
        return cards

    def _requeue(self, job: _Job, *, preempted: bool) -> None:
        job.prev_np = job.np
        job.np = 0
        job.state = QUEUED
        job.queued_at = self._clock()
        job.eligible_at = job.queued_at
        job.preempted = preempted
        job.starve_logged = False

    def _reap(self) -> None:
        for job in self.jobs:
            if job.state not in (RUNNING, PREEMPTING):
                continue
            if job.thread is not None and job.thread.is_alive():
                # A preempted job whose ranks ignore SIGTERM would pin
                # its slots forever; past twice the terminate grace the
                # controller escalates to the operator-stop teardown
                # (SIGTERM-as-launcher + SIGKILL hammer).
                if job.state == PREEMPTING and job.preempt_at and \
                        self._clock() - job.preempt_at > \
                        2.0 * launch._terminate_grace_seconds():
                    self._log(f"job {job.name} ignored preemption for "
                              f"too long; hard-stopping it")
                    job.preempt_at = 0.0  # escalate once
                    job.control.stop()
                continue
            if job.thread is not None:
                job.thread.join()
                job.thread = None
            rc, report = job.result if job.result else (1, {})
            job.result = None
            was_resize = job.resizing
            job.resizing = False
            job.preempt_at = 0.0
            self._release(job)
            if job.health is not None:
                job.health.shutdown()
                job.health.monitor.forget_all()
                job.health = None
            failed = report.get("failed") or []
            if failed:
                self._blame(failed)
            preempt_req = (job.control is not None and
                           job.control.preempt_requested.is_set())
            job.rc = rc
            if rc == 0:
                job.state = DONE
                self._log(f"job {job.name} finished ok")
            elif self._stopping:
                job.state = STOPPED
                self._log(f"job {job.name} stopped (fleet shutdown)")
            elif rc == PREEMPTION_RC or preempt_req:
                self._requeue(job, preempted=True)
                if was_resize:
                    self._log(f"job {job.name} paused for resize "
                              f"(rc {rc}) — re-queued")
                else:
                    self._log(f"job {job.name} preempted (rc {rc}) — "
                              f"re-queued for resume, host not blamed")
            elif report.get("signalled"):
                job.state = STOPPED
                self._log(f"job {job.name} stopped by operator (rc {rc})")
            else:
                telemetry.counter(
                    "hvd_fleet_job_restarts_total",
                    "Per-job failure restarts consumed under the fleet "
                    "controller", job=job.name).inc()
                if job.restarts_left > 0:
                    job.restarts_left -= 1
                    self._requeue(job, preempted=False)
                    self._log(f"job {job.name} failed (rc {rc}); "
                              f"re-queued ({job.restarts_left} restarts "
                              f"left)")
                else:
                    job.state = FAILED
                    self._log(f"job {job.name} failed (rc {rc}); restart "
                              f"budget exhausted")

    def _blame(self, failed) -> None:
        """Shared soft demotion: blame crashed ranks' hosts for EVERY
        job, but keep enough capacity for the smallest live job."""
        floor = min((j.spec.min_np for j in self.jobs
                     if j.state in _LIVE_STATES), default=1)
        for rank, hostname, code in failed:
            if code == PREEMPTION_RC or \
                    self.blacklist.is_blacklisted(hostname):
                continue
            remaining = sum(
                h.slots for h in self.pool
                if h.hostname != hostname and
                not self.blacklist.is_blacklisted(h.hostname))
            if remaining >= floor:
                self.blacklist.demote(
                    hostname, f"rank {rank} exited with code {code}")
                self._log(f"blacklisting host {hostname} (rank {rank} "
                          f"exited with code {code}) for ALL jobs")
            else:
                self._log(f"NOT blacklisting {hostname} despite rank "
                          f"{rank} rc {code}: remaining capacity "
                          f"{remaining} < smallest live min_np {floor}")

    # -- chaos -------------------------------------------------------------

    def _apply_chaos(self) -> None:
        if not self._running() and not self._flapped:
            # Don't burn injection budget on an empty fleet: a storm
            # with no victims (e.g. the tick before first admission)
            # would silently consume its count and the gate it was
            # meant to exercise would never fire.  A pending host_flap
            # is the exception — its forgive half must still fire even
            # while every job sits queued waiting for that host.
            return
        for kind in faults.fleet_chaos():
            if kind == "preempt_storm":
                victims = self._running()
                if not victims:
                    continue
                victim = min(victims,
                             key=lambda j: (j.priority, -j.started_at))
                self._preempt(victim, "chaos preempt_storm")
            elif kind == "rank_kill":
                # Fleet-site rank death: SIGKILL one rank of the lowest-
                # priority running job through its watchdog — the same
                # kill path a heartbeat death takes, so the job's
                # configured rank-failure policy (restart budget or
                # fail-in-place shrink) handles the aftermath.
                victims = self._running()
                if not victims:
                    continue
                victim = min(victims,
                             key=lambda j: (j.priority, -j.started_at))
                rank = max((i.rank for i in victim.infos), default=None)
                if rank is None:
                    continue
                victim.chaos_kills.append(
                    (rank, "chaos rank_kill (fleet fault injection)"))
                self._log(f"chaos rank_kill: killing rank {rank} of "
                          f"job {victim.name}")
            elif kind == "host_flap":
                host = self.pool[-1].hostname
                if host in self._flapped:
                    self.blacklist.forgive(host)
                    self._flapped.discard(host)
                    self._log(f"chaos host_flap: host {host} back in "
                              f"the pool")
                elif self.blacklist.is_blacklisted(host):
                    # Demoted for genuine rank failures, not by a prior
                    # flap — forgiving it here would resurrect a
                    # legitimately bad host mid-episode.
                    self._log(f"chaos host_flap: host {host} is "
                              f"blacklisted for real failures; leaving "
                              f"it demoted")
                else:
                    self.blacklist.demote(host, "chaos host_flap")
                    self._flapped.add(host)
                    self._log(f"chaos host_flap: host {host} demoted")
                    for job in self._running():
                        if any(i.hostname == host for i in job.infos):
                            self._preempt(
                                job, f"chaos host_flap on {host}")

    # -- preemption --------------------------------------------------------

    def _preempt(self, job: _Job, reason: str, *,
                 resize: bool = False) -> None:
        if job.state != RUNNING:
            return
        job.state = PREEMPTING
        job.resizing = resize
        job.preempt_at = self._clock()
        if not resize:
            job.preemptions += 1
            telemetry.counter(
                "hvd_fleet_preemptions_total",
                "Jobs preempted by the fleet controller (SIGTERM -> "
                "coordinated save -> rc 75 -> requeue)").inc()
            telemetry.counter(
                "hvd_fleet_job_preemptions_total",
                "Preemptions of this job by the fleet controller",
                job=job.name).inc()
        self._log(f"preempting job {job.name} (priority {job.priority}, "
                  f"np={job.np}): {reason}")
        job.control.preempt()
        if job.health is not None:
            # SIGTERM only reaches local process groups (for a remote
            # rank, its ssh client) — the health plane carries the
            # preemption to every heartbeating rank end-to-end.
            job.health.request_preempt()

    # -- serving autoscaler ------------------------------------------------

    def _read_serving_stats(self, job: _Job) -> Optional[dict]:
        """The job's router stats snapshot (written atomically by
        :meth:`horovod_tpu_torch.serving.router.Router.write_stats` to the
        ``HOROVOD_SERVING_STATS`` path this controller injected), or
        None before the first publish.  Staleness across attempts is a
        non-issue: :meth:`_start_job` deletes the file on every
        (re)admission."""
        try:
            with open(job.stats_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _autoscale_serving(self) -> None:
        """Elastic replica autoscaling for ``type=serving`` jobs, driven
        by the router's queue-depth / p99-latency telemetry:

        * **pressure** (queue depth >= ``serving_scale_up_depth``, or
          p99 over the job's SLO) grows the job toward ``max_np`` via
          the resize path; with no free slots it preempts the lowest
          strictly-lower-priority running job first — latency-sensitive
          serving takes capacity from batch training during a spike;
        * **calm** for ``serving_scale_down_idle`` continuous seconds
          shrinks back toward ``min_np``, returning the capacity.

        One resize in flight fleet-wide (the `_maybe_grow` invariant);
        the grown-toward slots are reserved against lower-priority
        admission by :meth:`_reserved_slots` while the resize is in
        flight."""
        for job in self._running():
            if job.spec.type != "serving":
                continue
            stats = self._read_serving_stats(job)
            if stats is None:
                continue
            depth = float(stats.get("queue_depth", 0) or 0)
            p99 = float(stats.get("p99_ms", 0) or 0)
            slo = float(stats.get("slo_ms", 0) or 0)
            telemetry.gauge(
                "hvd_fleet_serving_queue_depth",
                "Router queue depth last reported by this serving job",
                job=job.name).set(depth)
            telemetry.gauge(
                "hvd_fleet_serving_p99_ms",
                "Router p99 request latency (ms) last reported by this "
                "serving job", job=job.name).set(p99)
            pressure = depth >= self.serving_scale_up_depth or \
                (slo > 0.0 and p99 > slo)
            now = self._clock()
            resize_busy = any(j.state == PREEMPTING for j in self.jobs)
            if pressure:
                job.calm_since = 0.0
                if job.np >= job.spec.max_np or resize_busy:
                    continue
                free = sum(h.slots for h in self._free_hosts())
                if free > 0:
                    target = min(job.spec.max_np, job.np + free)
                    job.target_np = target
                    telemetry.counter(
                        "hvd_fleet_serving_scale_events_total",
                        "Serving autoscaler resize decisions",
                        job=job.name, direction="grow").inc()
                    self._preempt(
                        job,
                        f"serving scale-up {job.np}->{target} (queue "
                        f"depth {depth:g}, p99 {p99:g}ms)", resize=True)
                else:
                    victims = [j for j in self._running()
                               if j.priority < job.priority]
                    if not victims:
                        continue
                    victim = min(victims,
                                 key=lambda j: (j.priority,
                                                -j.started_at))
                    self._log(f"serving job {job.name} under pressure "
                              f"(queue depth {depth:g}, p99 {p99:g}ms) "
                              f"with no free slots")
                    self._preempt(
                        victim,
                        f"serving job {job.name} needs capacity (queue "
                        f"depth {depth:g})")
            else:
                if job.calm_since == 0.0:
                    job.calm_since = now
                    continue
                if now - job.calm_since < self.serving_scale_down_idle:
                    continue
                if job.np <= job.spec.min_np or resize_busy:
                    continue
                job.target_np = job.spec.min_np
                job.calm_since = 0.0
                telemetry.counter(
                    "hvd_fleet_serving_scale_events_total",
                    "Serving autoscaler resize decisions",
                    job=job.name, direction="shrink").inc()
                self._preempt(
                    job,
                    f"serving scale-down {job.np}->{job.spec.min_np} "
                    f"(calm {self.serving_scale_down_idle:g}s)",
                    resize=True)

    def _check_starvation(self) -> None:
        queue = self._queued()
        if not queue:
            return
        head = queue[0]
        free = sum(h.slots for h in self._free_hosts())
        if free >= head.spec.min_np:
            return  # admission will take it this tick
        now = self._clock()
        waited = now - max(head.queued_at, head.eligible_at)
        if waited <= self.starvation_deadline:
            return
        # Slots held by jobs already saving for preemption free at reap
        # time; counting them as pending frees keeps the deficit from
        # being recomputed from scratch every tick while a victim spends
        # several ticks in its coordinated save — which would preempt
        # extra victims beyond what the head job needs.
        pending = sum(j.np for j in self.jobs if j.state == PREEMPTING)
        deficit = head.spec.min_np - free - pending
        if deficit <= 0:
            return
        victims = [j for j in self._running()
                   if j.priority < head.priority]
        if not victims:
            if not head.starve_logged:
                head.starve_logged = True
                self._log(f"job {head.name} starved {waited:.1f}s but no "
                          f"lower-priority job is running to preempt")
            return
        # Lowest priority first; among equals the most recently started
        # (least sunk work) goes first.
        victims.sort(key=lambda j: (j.priority, -j.started_at))
        freed = 0
        for victim in victims:
            if freed >= deficit:
                break
            self._preempt(
                victim,
                f"job {head.name} (priority {head.priority}) starved "
                f"{waited:.1f}s past the {self.starvation_deadline:g}s "
                f"deadline")
            freed += victim.np

    # -- admission ---------------------------------------------------------

    def _reserved_slots(self, job: _Job) -> int:
        """Slots a grow-resize in flight will need on re-admission, held
        back from equal-or-lower-priority queued jobs so the grown job
        doesn't bounce back at its old size."""
        return sum(
            max(0, j.target_np - j.np) for j in self.jobs
            if j is not job and j.target_np is not None
            and j.state == PREEMPTING and j.priority >= job.priority)

    def _admit_np(self, job: _Job, cap: int) -> int:
        """World size to admit ``job`` at given ``cap`` free slots.
        Batch jobs stretch to ``max_np`` (elastic; `_maybe_grow` resizes
        them up later).  Serving jobs start at ``min_np`` — the
        autoscaler owns their size — unless a resize set ``target_np``
        or a prior attempt already ran wider."""
        if job.spec.type == "serving":
            want = job.target_np or job.prev_np or job.spec.min_np
            want = min(want, job.spec.max_np)
        else:
            want = job.spec.max_np
        return min(want, cap)

    def _admit(self) -> None:
        for job in self._queued():
            free_list = self._free_hosts()
            cap = sum(h.slots for h in free_list)
            cap -= self._reserved_slots(job)
            if cap < job.spec.min_np:
                # Strict priority: nothing behind this job may backfill
                # past it, or small low-priority jobs would starve it
                # forever — the exact inversion the fleet exists to stop.
                break
            self._start_job(job, self._admit_np(job, cap), free_list)

    def _start_job(self, job: _Job, np_: int,
                   free_list: List[hosts.HostSlots]) -> None:
        now = self._clock()
        infos = hosts.allocate(free_list, np_)
        for info in infos:
            self._used[info.hostname] = self._used.get(info.hostname, 0) + 1
        job.cards = self._take_cards(infos)
        wait = max(0.0, now - max(job.queued_at, job.eligible_at))
        telemetry.histogram(
            "hvd_fleet_queue_wait_seconds",
            "Seconds a job waited in the fleet queue before admission",
            bounds=(0.5, 1, 2, 5, 10, 30, 60, 120, 300, 600),
            job=job.name).observe(wait)
        telemetry.counter(
            "hvd_fleet_admissions_total",
            "Job admissions (first launches, resumes and resizes)").inc()
        if job.prev_np and job.prev_np != np_:
            telemetry.counter(
                "hvd_fleet_resizes_total",
                "Job world-size changes across fleet re-admissions",
                job=job.name,
                direction="grow" if np_ > job.prev_np else "shrink").inc()
        job.state = RUNNING
        job.np = np_
        job.infos = infos
        job.started_at = now
        if job.spec.type == "serving":
            # Fresh telemetry epoch: a stale stats file from the
            # pre-resize attempt would re-trigger (or mask) pressure.
            job.target_np = None
            job.calm_since = 0.0
            try:
                os.remove(job.stats_path)
            except OSError:
                pass
        remote_preempt = None
        if self.heartbeat_interval:
            # Resolved at call time: job.health is created in
            # _build_env, after the control.  Lets JobControl.preempt
            # spare remote ranks' ssh clients and deliver the preemption
            # over heartbeat responses instead.
            def remote_preempt(j=job):
                if j.health is not None:
                    j.health.request_preempt()
        job.control = launch.JobControl(remote_preempt=remote_preempt)
        host_summary = ",".join(
            f"{h}:{n}" for h, n in _host_counts(infos).items())
        self._log(f"admit job {job.name} np={np_} priority="
                  f"{job.priority} attempt={job.attempt} "
                  f"wait={wait:.1f}s hosts={host_summary}"
                  + (f" prev_np={job.prev_np}"
                     if job.prev_np and job.prev_np != np_ else "")
                  + (" (resume)" if job.preempted else ""))
        env_per_rank = self._build_env(job, infos)
        job.attempt += 1
        watchdog = self._make_watchdog(job)
        thread = threading.Thread(
            target=self._job_thread,
            args=(job, infos, env_per_rank, job.control, watchdog),
            name=f"hvdfleet-{job.name}", daemon=True)
        job.thread = thread
        thread.start()

    def _build_env(self, job: _Job,
                   infos: List[hosts.RankInfo]) -> List[Dict[str, str]]:
        os.makedirs(job.spill_dir, exist_ok=True)
        hostnames = {i.hostname for i in infos}
        all_local = all(launch.is_local(h) for h in hostnames)
        addr = "127.0.0.1" if all_local else infos[0].hostname
        port = launch.find_free_port()
        extra = dict(self.extra_env)
        # The job's ranks meet here: rank 0 serves the store, as under
        # the port's launcher (a fresh address every admission).
        extra["HOROVOD_COORDINATOR_ADDR"] = f"{addr}:{port}"
        extra["HOROVOD_TOPOLOGY"] = hosts.topology_string(infos)
        extra["HOROVOD_SECRET_KEY"] = job.secret
        extra["HOROVOD_SPILL_DIR"] = job.spill_dir
        extra["HOROVOD_FLEET_JOB"] = job.name
        extra["HOROVOD_RESTART_ATTEMPT"] = str(job.attempt)
        if job.spec.type == "serving":
            # Stats handshake: the job's router publishes queue depth /
            # p99 here (serving.router.Router.serve), the autoscaler
            # reads it each tick (_autoscale_serving).
            extra["HOROVOD_SERVING_STATS"] = job.stats_path
        if job.prev_np and job.prev_np != job.np:
            extra["HOROVOD_ELASTIC_PREV_SIZE"] = str(job.prev_np)
        else:
            extra.pop("HOROVOD_ELASTIC_PREV_SIZE", None)
        if self.metrics_port_base:
            # Per-job exporter base; ranks add their local_rank on top
            # (telemetry/exporter.py resolve_metrics_port), so the
            # stride must exceed the largest per-host slot count.
            extra["HOROVOD_METRICS_PORT"] = str(
                self.metrics_port_base + job.index * self.port_stride)
        if self.heartbeat_interval:
            from horovod_tpu_torch.runner.run import _HealthPlane
            job.health = _HealthPlane(
                job.secret, self.heartbeat_interval,
                5.0 * self.heartbeat_interval, self.hang_deadline)
            extra["HOROVOD_HEALTH_RPC"] = f"{addr}:{job.health.port}"
            extra["HOROVOD_HEARTBEAT_INTERVAL"] = str(
                self.heartbeat_interval)
            job.health.begin_attempt([i.rank for i in infos])
        extra.update(job.spec.env)
        env_per_rank = []
        for info in infos:
            env = config_parser.runtime_env(
                info, addr, port, extra, multi_host=len(hostnames) > 1)
            env["CUDA_VISIBLE_DEVICES"] = _visible_cards(
                job.cards[info.hostname], info.hostname)
            if self.metrics_file:
                from horovod_tpu_torch.runner.run import _per_rank_metrics_path
                env["HOROVOD_METRICS_FILE"] = _per_rank_metrics_path(
                    job.metrics_base, info.rank)
            env_per_rank.append(env)
        return env_per_rank

    def _make_watchdog(self, job: _Job):
        health = job.health
        control = job.control

        def watchdog() -> list:
            # Once this job is being preempted its ranks are busy with
            # the coordinated save — killing a "hung" rank now would
            # sabotage the very save the preemption asked for.
            if control.preempt_requested.is_set() or \
                    control.stop_requested.is_set():
                return []
            out: list = []
            if job.chaos_kills:
                # Swap-then-drain: the controller tick appends, this
                # (job-thread) side consumes — no partial reads.
                pending, job.chaos_kills = job.chaos_kills, []
                out.extend(pending)
            if health is not None:
                out.extend(health.watchdog())
            return out

        return watchdog

    def _job_thread(self, job, infos, env_per_rank, control,
                    watchdog) -> None:
        report: dict = {}
        try:
            rc = self._job_runner(job, infos, env_per_rank, control,
                                  report, watchdog)
        except Exception as e:                        # noqa: BLE001
            self._log(f"job {job.name} launch error: {e}")
            rc = 1
        job.result = (rc, report)

    def _run_job_process(self, job, infos, env_per_rank, control,
                         report, watchdog) -> int:
        out_dir = (os.path.join(self.output_dir, job.name)
                   if self.output_dir else None)
        return launch.launch_job(
            infos, job.spec.command, env_per_rank,
            output_dir=out_dir,
            prefix_output=True,
            start_timeout=self.start_timeout,
            report=report,
            watchdog=watchdog,
            install_signal_handlers=False,
            control=control,
            label=job.name)

    # -- elastic grow ------------------------------------------------------

    def _maybe_grow(self) -> None:
        if self._queued():
            return  # queued work has first claim on free slots
        if any(j.state == PREEMPTING for j in self.jobs):
            # A job mid-resize (or mid-preemption) is neither queued nor
            # running, so the queue looks empty and the slot it was
            # grown toward still looks free — growing another candidate
            # now would double-book that slot and force a needless
            # preemption once both re-admit.  One resize in flight at a
            # time, across ticks as well as within one.
            return
        free = sum(h.slots for h in self._free_hosts())
        if free <= 0:
            return
        now = self._clock()
        candidates = [
            j for j in self._running()
            if j.spec.type != "serving" and  # autoscaler owns serving size
            j.np < j.spec.max_np and
            now - j.started_at >= self.grow_after
        ]
        if not candidates:
            return
        # Highest priority grows first; one resize per tick keeps the
        # pool observable between moves.
        job = max(candidates, key=lambda j: (j.priority, -j.index))
        target = min(job.spec.max_np, job.np + free)
        self._log(f"growing job {job.name} {job.np}->{target} "
                  f"({free} free slot(s), nothing queued)")
        self._preempt(job, f"grow to np={target}", resize=True)

    def _fail_unsatisfiable(self) -> None:
        """A queued job whose min_np exceeds what the pool can EVER
        offer again must fail, not hang the fleet: with nothing running
        and a permanent blacklist there is no future event that frees
        capacity."""
        if not self._permanent_blacklist:
            return  # cooldown expiry can still restore capacity
        if self._flapped:
            return  # chaos host_flap will forgive these hosts itself
        if any(j.state in (RUNNING, PREEMPTING) for j in self.jobs):
            return
        usable = sum(h.slots for h in self._usable_pool())
        for job in list(self._queued()):
            if job.spec.min_np > usable:
                job.state = FAILED
                job.rc = 1
                self._log(f"job {job.name} unsatisfiable: min_np "
                          f"{job.spec.min_np} > usable capacity {usable} "
                          f"(blacklist is permanent, nothing running)")

    # -- telemetry / lifecycle ---------------------------------------------

    def _update_gauges(self) -> None:
        states = [j.state for j in self.jobs]
        telemetry.gauge(
            "hvd_fleet_jobs_running",
            "Jobs currently running (or saving for preemption) under "
            "the fleet controller").set(
            float(states.count(RUNNING) + states.count(PREEMPTING)))
        telemetry.gauge(
            "hvd_fleet_jobs_queued",
            "Jobs waiting for a full gang of min_np slots").set(
            float(states.count(QUEUED)))
        telemetry.gauge(
            "hvd_fleet_jobs_preempted",
            "Preempted jobs currently queued for resume").set(
            float(sum(1 for j in self.jobs
                      if j.state == QUEUED and j.preempted)))
        telemetry.gauge(
            "hvd_fleet_slots_total",
            "Slots in the fleet pool (before blacklist)").set(
            float(sum(h.slots for h in self.pool)))
        telemetry.gauge(
            "hvd_fleet_slots_free",
            "Unassigned, non-blacklisted slots").set(
            float(sum(h.slots for h in self._free_hosts())))

    def stop(self) -> None:
        """Operator stop: tear every job down with rc-130 semantics and
        let run() drain."""
        self._stopping = True
        for job in self.jobs:
            if job.state in (RUNNING, PREEMPTING) and \
                    job.control is not None:
                job.control.stop()
            elif job.state == QUEUED:
                # A queued job has no process to tear down, but it still
                # counts as live — with scheduling disabled under
                # _stopping nothing would ever move it to a terminal
                # state and run() would drain forever (e.g. an
                # oversubscribed fleet, or a preempted job waiting to
                # resume).
                job.state = STOPPED
                job.rc = 130
        self._log("stop requested; tearing down running jobs")

    def run(self) -> int:
        """Tick until every job reached a terminal state; returns 0 when
        all jobs finished, 130 on operator stop, 1 otherwise."""
        while self.tick():
            self._sleep(self.tick_interval)
        if self.metrics_file:
            try:
                self._write_summary()
            except Exception as e:                    # noqa: BLE001
                self._log(f"failed to write fleet summary to "
                          f"{self.metrics_file}: {e}")
        states = {j.name: j.state for j in self.jobs}
        self._log(f"all jobs terminal: {states}")
        if self._stopping:
            return 130
        return 0 if all(s == DONE for s in states.values()) else 1

    def _write_summary(self) -> None:
        """The merged fleet summary (schema ``horovod_tpu.fleet.summary.v1``,
        the reference's): the controller's metrics and each job's per-rank
        at-exit reports, merged by :mod:`horovod_tpu_torch.telemetry.
        aggregate`."""
        from horovod_tpu_torch.runner.run import _per_rank_metrics_path
        from horovod_tpu_torch.telemetry import aggregate
        jobs_doc = {}
        for job in self.jobs:
            ranks = {}
            # A job may have run at several world sizes; collect every
            # per-rank file that exists up to max_np.
            for rank in range(job.spec.max_np):
                path = _per_rank_metrics_path(job.metrics_base, rank)
                try:
                    with open(path) as f:
                        ranks[str(rank)] = json.load(f)
                except (OSError, ValueError):
                    pass
            snapshots = {k: r.get("metrics") or {}
                         for k, r in ranks.items()}
            jobs_doc[job.name] = {
                "state": job.state,
                "type": job.spec.type,
                "priority": job.priority,
                "min_np": job.spec.min_np,
                "max_np": job.spec.max_np,
                "final_np": job.np or job.prev_np,
                "attempts": job.attempt,
                "preemptions": job.preemptions,
                "restarts_left": job.restarts_left,
                "exit_code": job.rc,
                "ranks_reported": sorted(ranks, key=int),
                "merged": aggregate.merge_snapshots(snapshots),
            }
        doc = {
            "schema": "horovod_tpu.fleet.summary.v1",
            "pool": [{"hostname": h.hostname, "slots": h.slots}
                     for h in self.pool],
            "blacklist": self.blacklist.summary(),
            "controller": {
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "metrics": telemetry.metrics_snapshot(),
            },
            "jobs": jobs_doc,
        }
        path = self.metrics_file
        dirname = os.path.dirname(os.path.abspath(path))
        os.makedirs(dirname, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        self._log(f"fleet summary written to {path}")


def _host_counts(infos: List[hosts.RankInfo]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for info in infos:
        out[info.hostname] = out.get(info.hostname, 0) + 1
    return out


def _visible_cards(cards: List[int], hostname: str) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a rank whose job holds ``cards`` on
    ``hostname``.  On this host, indices count within the controller's
    own ``CUDA_VISIBLE_DEVICES`` where it has one."""
    mine = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    if launch.is_local(hostname) and mine.strip():
        listed = [c.strip() for c in mine.split(",") if c.strip()]
        return ",".join(listed[i] if i < len(listed) else str(i)
                        for i in cards)
    return ",".join(str(i) for i in cards)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdfleet",
        description="Priority gang-scheduling fleet controller: run many "
                    "jobs over one host pool with preemption and elastic "
                    "capacity sharing.")
    p.add_argument("-H", "--hosts", default=None,
                   help="comma-separated host:slots pool (hvdrun syntax)")
    p.add_argument("--hostfile", default=None,
                   help="file with one 'host slots=N' per line")
    p.add_argument("--job", action="append", default=[], metavar="SPEC",
                   help="job spec: 'name priority min_np[:max_np] "
                        "[after=S] [restarts=N] [type=T] [env:K=V ...] "
                        "-- cmd...' (repeatable)")
    p.add_argument("--jobs-file", default=None,
                   help="file with one job spec per line (# comments ok)")
    p.add_argument("--starvation-deadline", type=float, default=30.0,
                   help="seconds the head queued job may starve before "
                        "the controller preempts lower-priority jobs "
                        "(default 30)")
    p.add_argument("--tick-interval", type=float, default=0.25,
                   help="scheduler pass interval in seconds")
    p.add_argument("--grow-after", type=float, default=15.0,
                   help="seconds a job must run undisturbed before spare "
                        "capacity may grow it toward max_np (default 15)")
    p.add_argument("--serving-scale-up-depth", type=float, default=8.0,
                   help="router queue depth at which a type=serving job "
                        "scales up (default 8)")
    p.add_argument("--serving-scale-down-idle", type=float, default=10.0,
                   help="seconds a type=serving job must stay calm before "
                        "it shrinks back to min_np (default 10)")
    p.add_argument("--blacklist-cooldown", type=float, default=None,
                   help="seconds until a demoted host re-enters the "
                        "shared pool (default: demoted for good)")
    p.add_argument("--metrics-file", default=None,
                   help="write a merged fleet summary here and collect "
                        "per-rank metrics under the fleet dir")
    p.add_argument("--metrics-port-base", type=int, default=0,
                   help="base port for per-job Prometheus exporters; "
                        "job i serves at base + i*stride + local_rank")
    p.add_argument("--port-stride", type=int, default=64,
                   help="port distance between jobs' exporter ranges "
                        "(must exceed the largest per-host slot count)")
    p.add_argument("--fleet-dir", default=None,
                   help="scratch root for per-job spill/metrics dirs "
                        "(default: a fresh temp dir)")
    p.add_argument("--output-filename", default=None,
                   help="per-rank stdout/stderr under "
                        "<dir>/<job>/rank.<r>/ (hvdrun semantics)")
    p.add_argument("--start-timeout", type=float, default=None,
                   help="per-launch rank spawn timeout in seconds")
    p.add_argument("--heartbeat-interval", type=float, default=None,
                   help="enable the per-job heartbeat health plane at "
                        "this interval (seconds)")
    p.add_argument("--hang-deadline", type=float, default=None,
                   help="declare a rank hung after its step stalls this "
                        "long with heartbeats alive (needs "
                        "--heartbeat-interval)")
    p.add_argument("--verbose", action="store_true")
    return p


def _load_specs(args) -> List[JobSpec]:
    lines = list(args.job)
    if args.jobs_file:
        with open(args.jobs_file) as f:
            for raw in f:
                line = raw.strip()
                if line and not line.startswith("#"):
                    lines.append(line)
    if not lines:
        raise ValueError("no jobs: pass --job and/or --jobs-file")
    return [parse_job_spec(line) for line in lines]


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.hostfile:
        pool = hosts.parse_hostfile(args.hostfile)
    elif args.hosts:
        pool = hosts.parse_hosts(args.hosts)
    else:
        print("hvdfleet: need -H/--hosts or --hostfile", file=sys.stderr)
        return 2
    try:
        specs = _load_specs(args)
    except ValueError as e:
        print(f"hvdfleet: {e}", file=sys.stderr)
        return 2
    if args.metrics_file:
        # The controller writes the merged summary itself; an inherited
        # HOROVOD_METRICS_FILE would make ITS at-exit dump clobber it.
        os.environ.pop("HOROVOD_METRICS_FILE", None)
        telemetry.configure(enabled_flag=True)
    controller = FleetController(
        pool, specs,
        starvation_deadline=args.starvation_deadline,
        tick_interval=args.tick_interval,
        grow_after=args.grow_after,
        serving_scale_up_depth=args.serving_scale_up_depth,
        serving_scale_down_idle=args.serving_scale_down_idle,
        blacklist_cooldown=args.blacklist_cooldown,
        fleet_dir=args.fleet_dir,
        metrics_file=args.metrics_file,
        metrics_port_base=args.metrics_port_base,
        port_stride=args.port_stride,
        output_dir=args.output_filename,
        heartbeat_interval=args.heartbeat_interval or 0.0,
        hang_deadline=args.hang_deadline or 0.0,
        start_timeout=args.start_timeout,
        verbose=args.verbose,
    )

    def handle_signal(signum, frame):
        del frame
        controller._log(f"caught signal {signum}")
        controller.stop()

    old_int = signal.signal(signal.SIGINT, handle_signal)
    old_term = signal.signal(signal.SIGTERM, handle_signal)
    try:
        return controller.run()
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)


if __name__ == "__main__":
    sys.exit(main())
