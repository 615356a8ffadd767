"""Process spawn and supervision for the port's launcher.

Counterpart of ``horovod_tpu/runner/launch.py`` (the reference Horovod's
``run/gloo_run.py:165-262`` and ``run/common/util/safe_shell_exec.py``):
``RankProcess``, ``JobControl`` and ``launch_job``.  Each local rank runs
in a process group of its own, its output prefixed ``[rank]<stdout>:`` or
written to ``<dir>/rank.N/stdout|stderr``; a remote rank rides ssh
(``HOROVOD_SSH_CMD``) with its environment inlined on the command line,
except the job's secret, which travels over ssh's stdin.  The ssh line
forwards ``HOROVOD_*``, ``PYTHONPATH`` and ``PATH`` as the reference does,
and ``NCCL_*``, ``CUDA_*`` and ``TORCH_*`` where the reference forwards
``XLA_*`` and ``JAX_*``.  A rank that exits non-zero tears the job down:
SIGTERM to every other rank, SIGKILL after
``HOROVOD_TERMINATE_GRACE_SECONDS`` (10 s by default).  The launcher's
own SIGINT/SIGTERM makes the job's rc 130; a rank's preemption rc (75)
is no host's fault.  Each rank's spawn passes the ``spawn`` fault site
in the launcher (``faults.inject``, detail: the host, on behalf of the
rank being started).
"""

from __future__ import annotations

import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch import config, faults, telemetry
from horovod_tpu_torch.coordination import PREEMPTION_RC
from horovod_tpu_torch.runner.hosts import RankInfo

# What the ssh line forwards of a rank's environment (the secret apart).
FORWARDED_PREFIXES = ("HOROVOD_", "PYTHONPATH", "PATH", "NCCL_", "CUDA_",
                      "TORCH_")

# Seconds between SIGTERM fan-out and the SIGKILL hammer.  Tunable: ranks
# flushing checkpoints or closing remote filesystems may need more than
# the default 10 s; chaos tests want far less.
DEFAULT_TERMINATE_GRACE_SECONDS = 10.0


def _terminate_grace_seconds() -> float:
    v = config.env_str("HOROVOD_TERMINATE_GRACE_SECONDS", "")
    try:
        return float(v) if v else DEFAULT_TERMINATE_GRACE_SECONDS
    except ValueError:
        sys.stderr.write(
            f"hvdrun: ignoring non-numeric HOROVOD_TERMINATE_GRACE_"
            f"SECONDS={v!r}; using {DEFAULT_TERMINATE_GRACE_SECONDS}\n")
        return DEFAULT_TERMINATE_GRACE_SECONDS


def find_free_port() -> int:
    s = socket.socket()
    s.bind(("0.0.0.0", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def is_local(hostname: str) -> bool:
    return hostname in ("localhost", "127.0.0.1", socket.gethostname())


class RankProcess:
    def __init__(self, info: RankInfo, command: List[str],
                 env: Dict[str, str], output_dir: Optional[str],
                 prefix_output: bool, label: Optional[str] = None):
        self.info = info
        self.command = command
        self.env = env
        self.output_dir = output_dir
        self.prefix_output = prefix_output
        self.label = label
        self.proc: Optional[subprocess.Popen] = None
        self._pump: Optional[threading.Thread] = None
        self.terminated_by_launcher = False

    def start(self) -> None:
        faults.inject("spawn", self.info.hostname, rank=self.info.rank)
        self._stdin_secret = None   # set only on the ssh path
        if is_local(self.info.hostname):
            cmd = self.command
            env = self.env
        else:
            # Remote spawn over ssh with env inlined (reference
            # gloo_run.py:211-254 builds the same kind of command line) —
            # EXCEPT the job secret: anything on the command line is
            # world-readable via ps on both ends, which would defeat the
            # auth handshake exactly in the multi-host case it exists
            # for.  The secret travels over ssh stdin instead.
            exports = " ".join(
                f"{k}={shlex.quote(v)}" for k, v in sorted(self.env.items())
                if k != "HOROVOD_SECRET_KEY" and
                k.startswith(FORWARDED_PREFIXES))
            self._stdin_secret = self.env.get("HOROVOD_SECRET_KEY")
            read_key = ("IFS= read -r HOROVOD_SECRET_KEY; "
                        "export HOROVOD_SECRET_KEY; "
                        if self._stdin_secret else "")
            remote = read_key + \
                f"cd {shlex.quote(os.getcwd())} && env {exports} " + \
                " ".join(shlex.quote(c) for c in self.command)
            # HOROVOD_SSH_CMD: override for tests and exotic transports
            # (reference horovodrun has no override; its ssh path is
            # untested for the same reason ours would otherwise be).
            ssh = config.env_str("HOROVOD_SSH_CMD", "ssh")
            cmd = [ssh, "-o", "StrictHostKeyChecking=no",
                   self.info.hostname, remote]
            env = dict(os.environ)

        stdin_target = subprocess.PIPE if self._stdin_secret else None
        stdout_target = subprocess.PIPE
        if self.output_dir:
            rank_dir = os.path.join(self.output_dir,
                                    f"rank.{self.info.rank}")
            os.makedirs(rank_dir, exist_ok=True)
            self._stdout_f = open(os.path.join(rank_dir, "stdout"), "wb")
            self._stderr_f = open(os.path.join(rank_dir, "stderr"), "wb")
            self.proc = subprocess.Popen(
                cmd, env=env, stdin=stdin_target, stdout=self._stdout_f,
                stderr=self._stderr_f, start_new_session=True)
            self._feed_secret()
            return
        self.proc = subprocess.Popen(
            cmd, env=env, stdin=stdin_target, stdout=stdout_target,
            stderr=subprocess.STDOUT, start_new_session=True)
        self._feed_secret()
        self._pump = threading.Thread(target=self._pump_output, daemon=True)
        self._pump.start()

    def _feed_secret(self) -> None:
        if self._stdin_secret and self.proc.stdin is not None:
            try:
                self.proc.stdin.write(self._stdin_secret.encode() + b"\n")
                self.proc.stdin.flush()
            except (BrokenPipeError, OSError):
                pass  # rank died at spawn; the supervisor will notice
            finally:
                self.proc.stdin.close()

    def _pump_output(self) -> None:
        tag = (f"{self.label}:{self.info.rank}" if self.label
               else f"{self.info.rank}")
        prefix = f"[{tag}]<stdout>:" if self.prefix_output else ""
        for line in iter(self.proc.stdout.readline, b""):
            sys.stdout.write(prefix + line.decode(errors="replace"))
            sys.stdout.flush()

    def terminate(self) -> None:
        # A rank that has already exited keeps its exit as its own: a
        # peer's teardown must not excuse a rank that died first.
        if self.proc is None or self.proc.poll() is not None:
            return
        # Mark BEFORE signalling: a -SIGTERM exit after this point is
        # collateral teardown, not a failure of this rank.
        self.terminated_by_launcher = True
        try:
            os.killpg(self.proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass

    def kill(self) -> None:
        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


class JobControl:
    """Steering handle for a job supervised OFF the main thread.

    A fleet controller (the reference's ``runner/fleet.py``) runs each job's
    :func:`launch_job` in a worker thread, where ``signal.signal`` would
    raise — so instead of POSIX signals the controller talks to the
    supervisor through this object.  Two verbs:

    * :meth:`preempt` — deliver SIGTERM to every rank's process group
      WITHOUT marking the processes launcher-terminated.  Ranks that
      installed :func:`horovod_tpu_torch.resilience.install_preemption_handler`
      save and exit rc 75; ranks that did not die of the signal.  Either
      way the exits are attributed to *preemption* (no host blame, no
      blacklist) because this flag is set.
    * :meth:`stop` — operator-stop semantics, identical to the launcher's
      own SIGINT/SIGTERM handler: tear everything down, report rc 130,
      blame nothing.

    Signal delivery is inherently LOCAL: for a remote rank the spawned
    process is its ssh client, so ``killpg`` would tear the transport
    down under the remote process mid-save instead of preempting it —
    the rank may linger on its host holding its cards and ports while
    the controller reuses its slots.  When ``remote_preempt`` is given
    (the fleet wires it to the per-job heartbeat health plane's
    ``request_preempt``), :meth:`preempt` leaves remote ranks' ssh
    clients alive and invokes the hook instead: the preemption rides the
    authenticated RPC plane end-to-end, the remote rank saves and exits
    rc 75, and ssh propagates that exit status back to the supervisor.
    Without the hook (no ``--heartbeat-interval``), remote ranks only
    get their transport torn down — coordinated-save preemption is then
    guaranteed for local ranks only.

    Both verbs are safe to call before the ranks have spawned (the
    request is latched and applied at attach time) and are idempotent.
    """

    def __init__(self, remote_preempt: Optional[Callable[[], None]]
                 = None) -> None:
        self._lock = threading.Lock()
        self._procs: Optional[List[RankProcess]] = None
        self.remote_preempt = remote_preempt
        self.preempt_requested = threading.Event()
        self.stop_requested = threading.Event()

    def _attach(self, procs: List[RankProcess]) -> None:
        with self._lock:
            self._procs = procs
        # A verb that arrived before the ranks existed applies now.
        if self.stop_requested.is_set():
            self.stop()
        elif self.preempt_requested.is_set():
            self.preempt()

    def preempt(self) -> None:
        self.preempt_requested.set()
        with self._lock:
            procs = list(self._procs or ())
        any_remote = False
        for p in procs:
            # NOT p.terminate(): that would mark the exit as launcher
            # teardown and hide the rc-75 / -SIGTERM preemption outcome.
            if p.proc is None or p.proc.poll() is not None:
                continue
            if self.remote_preempt is not None and \
                    not is_local(p.info.hostname):
                # SIGTERM here would only hit the local ssh client —
                # the health plane delivers the preemption to the rank
                # itself; ssh relays its rc-75 exit back.
                any_remote = True
                continue
            try:
                os.killpg(p.proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        if any_remote:
            self.remote_preempt()

    def stop(self) -> None:
        self.stop_requested.set()
        with self._lock:
            procs = list(self._procs or ())
        for p in procs:
            p.terminate()


# Seconds between the supervision loop's polls of the ranks.
_POLL_SECONDS = 0.05


def _killed_by_signal(rc: int) -> bool:
    """Whether an exit code is a death by signal: negative from
    ``Popen``, 128 + N through a shell or ssh."""
    return rc < 0 or 128 < rc < 160


def launch_job(rank_infos: List[RankInfo], command: List[str],
               env_per_rank: List[Dict[str, str]],
               output_dir: Optional[str] = None,
               prefix_output: bool = True,
               start_timeout: Optional[float] = None,
               report: Optional[dict] = None,
               watchdog: Optional[Callable[[], list]] = None,
               install_signal_handlers: bool = True,
               control: Optional[JobControl] = None,
               label: Optional[str] = None,
               reform: Optional[Callable[
                   [RankInfo, int, List[RankInfo]], bool]] = None) -> int:
    """Run all ranks; on any non-zero exit terminate the rest (reference
    gloo_run.py:256-262).  Returns the job exit code.

    ``report``, when given, is filled in place for the elastic caller:
    ``report["failed"]`` = list of ``(rank, hostname, exit_code)`` for
    every rank that exited non-zero on its own (operator-stop SIGTERMs
    excluded — those are not host failures), ``report["signalled"]`` =
    True when the launcher's own SIGINT/SIGTERM handler fired.

    ``reform``, when given, is the fail-in-place hook
    (HOROVOD_ON_RANK_FAILURE=shrink|shrink-then-restart): called with
    ``(dead_info, exit_code, survivor_infos)`` when a rank dies on its
    own (crash / watchdog SIGKILL; never preemption or operator stop).
    Returning True means the death was absorbed — the survivors reform
    the collective world in-process, supervision continues over them,
    and the dead rank is reported under ``report["reformed"]`` instead
    of ``report["failed"]`` (a non-restart event: no teardown fan-out,
    no host blame).  Returning False falls through to the normal
    terminate-everyone path.

    ``watchdog``, when given, is polled in the supervision loop and
    returns ``(rank, reason)`` pairs for ranks the health plane declared
    dead (heartbeats gone) or hung (heartbeats alive, step stalled).
    Those ranks are SIGKILLed — deliberately via :meth:`RankProcess.kill`
    and not ``terminate()``, so the exit is attributed to the rank like
    any crash and flows through the normal blame / soft-demotion /
    elastic-restart machinery instead of being excused as launcher
    teardown.

    ``install_signal_handlers=False`` + ``control`` is the fleet path:
    the supervisor runs off the main thread (``signal.signal`` would
    raise there), so operator stop and preemption arrive through the
    :class:`JobControl` instead of SIGINT/SIGTERM.  ``label`` prefixes
    rank output as ``[label:rank]`` so interleaved jobs stay readable."""
    procs = [RankProcess(info, command, env, output_dir, prefix_output,
                         label=label)
             for info, env in zip(rank_infos, env_per_rank)]

    stop = threading.Event()
    signalled = threading.Event()   # the OPERATOR stopped the job

    def handle_signal(signum, frame):
        del frame
        signalled.set()
        stop.set()
        for p in procs:
            p.terminate()

    old_int = old_term = None
    if install_signal_handlers:
        old_int = signal.signal(signal.SIGINT, handle_signal)
        old_term = signal.signal(signal.SIGTERM, handle_signal)
    if control is not None:
        control._attach(procs)
    try:
        # start_timeout bounds LAUNCHING only (spawning every rank — ssh may
        # block on remote hosts), never a healthy running job; rendezvous
        # hangs are bounded by the runtime's own connect timeouts.
        launch_deadline = (time.monotonic() + start_timeout
                           if start_timeout else None)
        for p in procs:
            if launch_deadline and time.monotonic() > launch_deadline:
                sys.stderr.write("hvdrun: start timeout exceeded while "
                                 "launching ranks\n")
                for q in procs:
                    q.terminate()
                return 1
            p.start()
        exit_code = 0
        running = set(range(len(procs)))
        by_rank = {p.info.rank: p for p in procs}
        reformed = []            # (rank, hostname, exit_code) absorbed
        reformed_ranks = set()   # global ranks excluded from blame below
        while running and not stop.is_set():
            if control is not None and control.stop_requested.is_set():
                signalled.set()
                stop.set()
                for p in procs:
                    p.terminate()
                break
            if watchdog is not None:
                for bad_rank, reason in watchdog():
                    victim = by_rank.get(bad_rank)
                    if victim is None or victim.proc.poll() is not None:
                        continue
                    sys.stderr.write(
                        f"hvdrun: health plane: rank {bad_rank} {reason}; "
                        f"killing it to trigger a restart\n")
                    telemetry.counter(
                        "hvd_watchdog_kills_total",
                        "Ranks SIGKILLed by the health-plane watchdog "
                        "(dead or hung)").inc()
                    victim.kill()
            for i in sorted(running):
                rc = procs[i].proc.poll()
                if rc is None:
                    continue
                running.discard(i)
                if rc != 0:
                    # Fail-in-place: offer the death to the reform hook
                    # before the teardown fan-out.  Only genuine solo
                    # deaths qualify — preemption, operator stop and
                    # launcher teardown keep their existing semantics.
                    if (reform is not None and rc != PREEMPTION_RC and
                            not procs[i].terminated_by_launcher and
                            not signalled.is_set() and
                            not (control is not None and
                                 control.preempt_requested.is_set())):
                        survivors = [procs[j].info for j in sorted(running)]
                        if survivors and reform(procs[i].info, rc,
                                                survivors):
                            dead = procs[i].info
                            sys.stderr.write(
                                f"hvdrun: rank {dead.rank} exited with "
                                f"code {rc}; absorbed by in-process "
                                f"reformation ({len(survivors)} "
                                f"survivor(s) continue).\n")
                            reformed.append((dead.rank, dead.hostname, rc))
                            reformed_ranks.add(dead.rank)
                            continue
                    exit_code = rc
                    if rc == PREEMPTION_RC:
                        sys.stderr.write(
                            f"hvdrun: rank {procs[i].info.rank} exited "
                            f"with preemption code {rc}; terminating "
                            f"remaining ranks for reschedule.\n")
                    else:
                        sys.stderr.write(
                            f"hvdrun: rank {procs[i].info.rank} exited "
                            f"with code {rc}; terminating remaining "
                            f"ranks.\n")
                    if control is not None and \
                            control.preempt_requested.is_set():
                        # Controller-requested preemption: every rank
                        # already has the request (SIGTERM locally, the
                        # health plane remotely), so re-signalling here
                        # would mark peers launcher-terminated (hiding
                        # their rc-75 outcome) and kill remote ranks'
                        # ssh clients mid-coordinated-save.  The grace /
                        # hard-kill phase below still bounds laggards.
                        pass
                    else:
                        for j in sorted(running):
                            procs[j].terminate()
                    stop.set()
                break
            time.sleep(_POLL_SECONDS)
        # Grace period (HOROVOD_TERMINATE_GRACE_SECONDS), then hard kill,
        # logging which ranks needed the hammer — a rank that regularly
        # outlives its grace is hiding a shutdown bug.
        grace = _terminate_grace_seconds()
        t0 = time.monotonic()
        while any(p.proc.poll() is None for p in procs):
            if time.monotonic() - t0 > grace:
                laggards = sorted(p.info.rank for p in procs
                                  if p.proc.poll() is None)
                sys.stderr.write(
                    f"hvdrun: rank(s) {laggards} still running "
                    f"{grace:g}s after SIGTERM; sending SIGKILL\n")
                telemetry.counter(
                    "hvd_hard_killed_ranks_total",
                    "Ranks that outlived the SIGTERM grace period and "
                    "took a SIGKILL").inc(len(laggards))
                for p in procs:
                    p.kill()
                break
            time.sleep(0.05)
        failed = []
        preempted = []
        preempt_req = (control is not None and
                       control.preempt_requested.is_set())
        for p in procs:
            p.proc.wait()
            rc = p.proc.returncode
            if p.info.rank in reformed_ranks:
                # Absorbed by in-process reformation: the survivors'
                # exits define the job outcome; the dead rank neither
                # sets the exit code nor blames its host.
                continue
            if rc not in (0, None) and exit_code == 0:
                exit_code = rc
            if rc not in (0, None) and not p.terminated_by_launcher:
                if rc == PREEMPTION_RC or (preempt_req and
                                           rc == -signal.SIGTERM):
                    # A preempted rank is not a failure and not its
                    # host's fault: no blame, no blacklist — the elastic
                    # caller reschedules immediately (runner/run.py).
                    # Under a controller-requested preemption a rank
                    # that never installed the preemption handler dies
                    # of the raw SIGTERM (-15); that is still the
                    # controller's doing, not the host's.
                    preempted.append((p.info.rank, p.info.hostname, rc))
                    continue
                # Genuine rank failure: it failed BEFORE the launcher
                # began tearing the job down.  Anything after terminate()
                # is collateral — including positive exit codes, since a
                # SIGTERMed rank racing its peer's death often dies of
                # "peer closed connection" instead of the signal, and
                # blaming ITS host would demote a healthy machine.
                failed.append((p.info.rank, p.info.hostname, rc))
        # Ranks found dead in one poll all failed on their own; a rank a
        # signal killed (a crash, an OOM kill) is a cause, while one that
        # exited with an error in the same window may be collateral (its
        # peer's death failed its collectives): causes come first, so the
        # host blame walks them first.
        failed.sort(key=lambda f: not _killed_by_signal(f[2]))
        if preempt_req and not failed and preempted and \
                exit_code in (0, -signal.SIGTERM, PREEMPTION_RC):
            # The whole gang went down under a requested preemption:
            # surface the canonical preemption code even if the first
            # observed exit was a handler-less rank's -SIGTERM, so the
            # caller's rc-75 requeue path fires uniformly.
            exit_code = PREEMPTION_RC
        if signalled.is_set():
            # Operator stop: ALWAYS 130, even though the SIGTERMed ranks
            # report -15 — callers (elastic restarts) distinguish "the
            # operator stopped the job" from "a rank crashed" by this
            # code, and success must never be reported either.
            exit_code = 130
            failed = []     # nothing to blame a host for
            preempted = []
        if failed:
            telemetry.counter(
                "hvd_rank_failures_total",
                "Ranks that exited non-zero before launcher teardown "
                "began").inc(len(failed))
        if preempted:
            telemetry.counter(
                "hvd_preempted_ranks_total",
                "Ranks that exited with the preemption code (saved and "
                "asked for a reschedule)").inc(len(preempted))
        if report is not None:
            report["failed"] = failed
            report["preempted"] = preempted
            report["signalled"] = signalled.is_set()
            report["reformed"] = reformed
        return exit_code
    finally:
        if install_signal_handlers:
            signal.signal(signal.SIGINT, old_int)
            signal.signal(signal.SIGTERM, old_term)
