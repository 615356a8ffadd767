"""Deterministic fault injection: the port's chaos harness.

Counterpart of ``horovod_tpu/faults.py``.  Faults are injected at named
sites so that each failure path of the port has a test.  The grammar of
``HOROVOD_FAULT_SPEC`` is the reference's: ``;``-separated rules of
``,``-separated ``key=value`` pairs::

    HOROVOD_FAULT_SPEC="rank=1,site=allreduce,after=3,kind=crash"
    HOROVOD_FAULT_SPEC="rank=*,site=rpc,kind=delay:0.5,count=2"

``rank`` (an int, or ``*`` for any context, the launcher included),
``site`` (a name of :data:`SITES`, or ``*``), ``after`` (matching
passages let through before the first firing), ``kind``, ``count`` (most
firings) and ``attempt`` (fire only while ``HOROVOD_RESTART_ATTEMPT``
equals it, so a test can fault attempt 0 and let attempt 1 run clean).

The process kinds fire at :func:`inject`, the entry hook of the eager
collectives (site = the op, detail = the tensor name), of ``barrier``,
of the runtime's submit and wait (``native_submit``/``native_wait``), of
``runner.rpc.rpc_call`` (``rpc``, detail = the request kind) and of the
launcher's per-rank spawn (``spawn``, fired in the launcher on behalf of
the target rank):

* ``crash``: SIGKILL of the process itself;
* ``exit:N``: ``os._exit(N)``;
* ``hang``: block for ever;
* ``delay:S``: sleep S seconds, then go on;
* ``error[:msg]``: raise :class:`FaultInjected`.

Every other kind fires only at its own hook, never at :func:`inject`:

* the value kinds at :func:`corrupt_output`, which every eager collective
  passes its result through: ``nan`` (a floating output comes back all
  NaN) and ``corrupt[:N]`` (N bytes flipped, default 1);
* the plane kinds: ``heartbeat_drop[:N]`` at :func:`drop_heartbeat`
  (site ``heartbeat``), ``spill_corrupt[:N]`` at :func:`mangle_spill`
  (site ``spill``) and ``residual_drop[:N]`` at :func:`drop_residual`
  (site ``compression``, polled once per step by the compressed training
  steps: the rank's error-feedback residuals are zeroed, default once);
* the fleet kinds at :func:`fleet_chaos`, polled once per tick by the
  fleet controller (site ``fleet``): ``preempt_storm[:N]`` and
  ``host_flap[:N]``, and ``rank_kill`` where its rule says ``site=fleet``;
* the serving kinds at :func:`crash_replica` and :func:`storm_requests`
  (site ``serving``): ``replica_crash[:N]`` and ``request_storm[:N]``;
* the control kinds at :func:`control_chaos`, polled once per send by
  ``runner.rpc.control_call`` (site ``control``): ``msg_drop[:N]``,
  ``msg_dup[:N]``, ``msg_delay[:MS]``, ``partition[:S]`` and
  ``coord_crash``.

The reference's transport kinds (``frame_corrupt``, ``stripe_kill``,
``shm_stall``, ``link_reset``, and ``rank_kill`` anywhere but at site
``fleet``) act inside its native C++ transports, which the port does not
have: NCCL and gloo carry the port's wire.  A spec that names one is
refused at parse time, never silently ignored.  With no spec set each
hook is one global load and an identity test.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import List, Optional

import torch

from horovod_tpu_torch import config

ENV_VAR = "HOROVOD_FAULT_SPEC"

# Kinds that end, stall or fail the process at inject().
PROCESS_KINDS = ("crash", "exit", "hang", "delay", "error")
# Kinds that change an op's output; they fire at corrupt_output().
VALUE_KINDS = ("nan", "corrupt")
# Kinds of the health and recovery planes, each at its own hook.
PLANE_KINDS = ("heartbeat_drop", "spill_corrupt", "residual_drop")
# Kinds of the fleet controller's tick; they fire at fleet_chaos().
FLEET_KINDS = ("preempt_storm", "host_flap")
# Kinds of the serving plane (site ``serving``).
SERVING_KINDS = ("replica_crash", "request_storm")
# Kinds of the coordination control plane (site ``control``).
CONTROL_KINDS = ("msg_drop", "msg_dup", "msg_delay", "partition",
                 "coord_crash")
# The reference's native transports' kinds: refused (``rank_kill`` is
# accepted at site ``fleet`` only).
TRANSPORT_KINDS = ("frame_corrupt", "stripe_kill", "shm_stall",
                   "link_reset", "rank_kill")
KINDS = (PROCESS_KINDS + VALUE_KINDS + PLANE_KINDS[:2] + FLEET_KINDS
         + PLANE_KINDS[2:] + SERVING_KINDS + CONTROL_KINDS + ("rank_kill",))

SITES = (
    "allreduce", "allgather", "broadcast", "alltoall", "reducescatter",
    "barrier", "native_submit", "native_wait", "rpc", "spawn",
    "heartbeat", "spill", "fleet", "compression", "serving", "control",
    "transport",
)

# Kinds that never fire at inject().
_NOT_AT_INJECT = (VALUE_KINDS + PLANE_KINDS + FLEET_KINDS + SERVING_KINDS
                  + CONTROL_KINDS + TRANSPORT_KINDS)


class FaultInjected(RuntimeError):
    """Raised by a ``kind=error`` fault: a synthetic failure to exercise
    error propagation."""


class FaultSpecError(ValueError):
    """The HOROVOD_FAULT_SPEC grammar was violated, or the spec names a
    kind the port does not inject.  Raised at parse time."""


class FaultRule:
    """One parsed rule and its firing state (thread-safe: eager ops fire
    from the callers' threads)."""

    __slots__ = ("rank", "site", "after", "kind", "arg", "count",
                 "attempt", "_hits", "_fired", "_lock")

    def __init__(self, rank, site, after, kind, arg, count, attempt=None):
        self.rank = rank          # int or None (= '*')
        self.site = site          # str or None (= '*')
        self.after = after
        self.kind = kind
        self.arg = arg            # the kind's argument, or None
        self.count = count        # int or None (= unlimited)
        self.attempt = attempt    # int or None (= any attempt)
        self._hits = 0
        self._fired = 0
        self._lock = threading.Lock()

    def __repr__(self):
        rk = "*" if self.rank is None else self.rank
        st = "*" if self.site is None else self.site
        kd = self.kind if self.arg is None else f"{self.kind}:{self.arg}"
        return (f"FaultRule(rank={rk}, site={st}, after={self.after}, "
                f"kind={kd})")

    def _matches(self, site: str, rank: Optional[int]) -> bool:
        if self.site is not None and self.site != site:
            return False
        if self.rank is not None and self.rank != rank:
            return False
        return (self.attempt is None or self.attempt
                == (config.env_int("HOROVOD_RESTART_ATTEMPT") or 0))

    def arm(self, site: str, rank: Optional[int]) -> bool:
        """Count a passage through a matching site; True when the fault
        fires on this passage."""
        if not self._matches(site, rank):
            return False
        with self._lock:
            self._hits += 1
            if self._hits <= self.after:
                return False
            if self.count is not None and self._fired >= self.count:
                return False
            self._fired += 1
            return True

    def _announce(self, site, detail, rank, note: str = "") -> None:
        where = f"site={site}" + (f" ({detail})" if detail else "")
        who = "launcher" if rank is None or rank < 0 else f"rank {rank}"
        sys.stderr.write(
            f"horovod_tpu_torch.faults: firing kind={self.kind} at {where} "
            f"[{who}, hit {self._hits}]{note}\n")
        sys.stderr.flush()

    def execute(self, site: str, detail: Optional[str],
                rank: Optional[int]) -> None:
        """Carry out a process kind."""
        self._announce(site, detail, rank)
        if self.kind == "crash":
            os.kill(os.getpid(), signal.SIGKILL)
            while True:  # pragma: no cover - the signal is on its way
                time.sleep(1.0)
        if self.kind == "exit":
            os._exit(int(self.arg))
        if self.kind == "hang":
            while True:
                time.sleep(3600.0)
        if self.kind == "delay":
            time.sleep(float(self.arg))
            return
        if self.kind == "error":
            where = f"site={site}" + (f" ({detail})" if detail else "")
            raise FaultInjected(self.arg or f"injected fault at {where}")
        raise AssertionError(f"unreachable kind {self.kind}")

    def poison(self, site: str, out: torch.Tensor, detail, rank):
        """The output with this rule's value fault applied, on a fresh
        copy (the caller's tensor may alias a buffer)."""
        if self.kind == "nan":
            if out.is_floating_point() or out.is_complex():
                self._announce(site, detail, rank)
                return torch.full_like(out, float("nan"))
            self._announce(site, detail, rank,
                           note=f" (dtype {out.dtype} has no NaN; output "
                                f"unchanged)")
            return out
        flat = out.detach().clone().contiguous()
        raw = flat.reshape(-1).view(torch.uint8)
        if raw.numel() == 0:
            self._announce(site, detail, rank,
                           note=" (empty tensor; output unchanged)")
            return out
        n = min(int(self.arg) if self.arg else 1, raw.numel())
        positions = torch.unique(torch.linspace(
            0, raw.numel() - 1, n, dtype=torch.float64).to(torch.int64))
        self._announce(site, detail, rank,
                       note=f" (flipping {positions.numel()} byte(s))")
        positions = positions.to(raw.device)
        raw[positions] = raw[positions] ^ 0xFF
        return flat


# A kind's ``:N``: (parse, smallest allowed value, the refusal's words).
_ARGS = {
    "corrupt": (int, 1, "must flip >= 1 byte"),
    "heartbeat_drop": (int, 1, "must drop >= 1 heartbeat"),
    "spill_corrupt": (int, 0, "must keep >= 0 bytes"),
    "residual_drop": (int, 1, "must drop >= 1 residual"),
    "preempt_storm": (int, 1, "must fire on >= 1 tick"),
    "host_flap": (int, 1, "must fire on >= 1 tick"),
    "replica_crash": (int, 1, "must crash >= 1 replica"),
    "request_storm": (int, 1, "must inject >= 1 request per firing"),
    "msg_drop": (int, 1, "must act on >= 1 message"),
    "msg_dup": (int, 1, "must act on >= 1 message"),
    "msg_delay": (float, 0, "must delay by >= 0 ms"),
    "partition": (float, None, "must last > 0 seconds"),
    "rank_kill": (int, 1, "must fire >= 1 time"),
    # Parsed as the reference does before their refusal.
    "frame_corrupt": (int, 1, "must fire >= 1 time"),
    "stripe_kill": (int, 1, "must fire >= 1 time"),
    "link_reset": (int, 1, "must fire >= 1 time"),
    "shm_stall": (float, None, "must stall > 0 milliseconds"),
}


def _kind_arg(kind: str, kind_arg: str):
    """The kind's argument, checked with the reference's words."""
    if kind == "delay":
        return float(kind_arg)
    if kind == "exit":
        return int(kind_arg)
    if kind == "error":
        return kind_arg or None
    if kind in _ARGS:
        parse, low, words = _ARGS[kind]
        arg = parse(kind_arg) if kind_arg else None
        if arg is not None and (arg <= 0 if low is None else arg < low):
            raise FaultSpecError(f"kind {kind}:{arg} {words}")
        return arg
    if kind_arg:
        raise FaultSpecError(f"kind {kind!r} takes no argument (got "
                             f"{kind + ':' + kind_arg!r})")
    return None


def _default_count(kind: str, arg, count):
    """The reference's count shorthands and one-episode defaults."""
    if count is not None:
        return count
    if kind == "heartbeat_drop":
        return arg
    if kind in ("residual_drop", "replica_crash", "msg_drop", "msg_dup",
                "rank_kill"):
        return arg if arg is not None else 1
    if kind in FLEET_KINDS:
        # Each firing acts on a whole job or host: default to one
        # preemption, or one out+in blacklist cycle.
        return arg if arg is not None else (
            1 if kind == "preempt_storm" else 2)
    if kind in ("request_storm", "partition", "coord_crash"):
        return 1
    return None


def _refuse_transport(kind: str, site: Optional[str]) -> None:
    if kind in TRANSPORT_KINDS and not (kind == "rank_kill"
                                        and site == "fleet"):
        raise FaultSpecError(
            f"fault kind {kind!r} acts on the reference's native "
            f"transports (frame_corrupt, stripe_kill, shm_stall, "
            f"link_reset, rank_kill at site transport), which "
            f"horovod_tpu_torch does not have: NCCL and gloo carry its "
            f"wire; rank_kill is injected at site=fleet only")


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse a whole HOROVOD_FAULT_SPEC into rules; raises
    :class:`FaultSpecError` on any grammar violation or a kind the port
    does not inject."""
    rules: List[FaultRule] = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        rank = site = kind = arg = count = attempt = None
        after = 0
        for pair in chunk.split(","):
            pair = pair.strip()
            if not pair:
                continue
            if "=" not in pair:
                raise FaultSpecError(
                    f"fault spec entry {pair!r} is not key=value "
                    f"(in rule {chunk!r})")
            key, _, value = pair.partition("=")
            key, value = key.strip(), value.strip()
            try:
                if key == "rank":
                    rank = None if value == "*" else int(value)
                elif key == "site":
                    site = None if value == "*" else value
                elif key == "after":
                    after = int(value)
                elif key == "count":
                    count = int(value)
                elif key == "attempt":
                    attempt = int(value)
                elif key == "kind":
                    kind, _, kind_arg = value.partition(":")
                    if kind not in KINDS + TRANSPORT_KINDS:
                        raise FaultSpecError(
                            f"unknown fault kind {kind!r}; valid kinds: "
                            f"{', '.join(KINDS)}")
                    arg = _kind_arg(kind, kind_arg)
                else:
                    raise FaultSpecError(
                        f"unknown fault spec key {key!r} (in rule "
                        f"{chunk!r}); valid keys: rank, site, after, "
                        f"kind, count, attempt")
            except (TypeError, ValueError) as e:
                if isinstance(e, FaultSpecError):
                    raise
                raise FaultSpecError(
                    f"bad value for {key!r} in fault rule {chunk!r}: {e}")
        if kind is None:
            raise FaultSpecError(
                f"fault rule {chunk!r} has no kind= (one of "
                f"{', '.join(KINDS)})")
        count = _default_count(kind, arg, count)
        if site is not None and site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r}; shipped sites: "
                f"{', '.join(SITES)} (or '*')")
        _refuse_transport(kind, site)
        rules.append(FaultRule(rank, site, after, kind, arg, count,
                               attempt))
    return rules


_UNSET = object()
_plan = _UNSET
_load_lock = threading.Lock()


def load() -> Optional[List[FaultRule]]:
    """Read HOROVOD_FAULT_SPEC once; the active rules or None."""
    global _plan
    with _load_lock:
        if _plan is _UNSET:
            spec = config.env_str(ENV_VAR)
            _plan = (parse_spec(spec) or None) if spec.strip() else None
        return _plan


def reset() -> None:
    """Forget the cached plan; the next hook reads the environment."""
    global _plan
    with _load_lock:
        _plan = _UNSET


def active() -> bool:
    return load() is not None


def _context_rank(rank: Optional[int]) -> Optional[int]:
    return rank if rank is not None else config.env_int("HOROVOD_RANK")


def _firing(site: str, kinds, rank: Optional[int]):
    """``(rule, context rank)`` for each rule of ``kinds`` that fires on
    this passage through ``site`` (none when no spec is set)."""
    plan = _plan
    if plan is _UNSET:
        plan = load()
    if plan is None:
        return []
    ctx_rank = _context_rank(rank)
    return [(rule, ctx_rank) for rule in plan
            if rule.kind in kinds and rule.arm(site, ctx_rank)]


def inject(site: str, detail: Optional[str] = None,
           rank: Optional[int] = None) -> None:
    """The entry hook every site funnels through: each armed process
    kind is carried out in turn.  ``detail`` names the operand (tensor
    name, request kind, hostname) for the firing line; ``rank``
    overrides the context rank (the launcher's ``spawn`` site acts on
    behalf of the target rank)."""
    plan = _plan
    if plan is _UNSET:
        plan = load()
    if plan is None:
        return
    ctx_rank = _context_rank(rank)
    for rule in plan:
        if rule.kind in _NOT_AT_INJECT:
            continue
        if rule.arm(site, ctx_rank):
            rule.execute(site, detail, ctx_rank)


def corrupt_output(site: str, out: torch.Tensor,
                   detail: Optional[str] = None,
                   rank: Optional[int] = None) -> torch.Tensor:
    """The output hook: each eager collective's result passes through
    here just before it is returned; a matching rule poisons a copy."""
    for rule, ctx_rank in _firing(site, VALUE_KINDS, rank):
        out = rule.poison(site, out, detail, ctx_rank)
    return out


def _fires(site: str, kind: str, rank: Optional[int], note: str) -> bool:
    """True when an armed rule of ``kind`` fires on this passage (each
    firing announced with ``note``)."""
    fired = _firing(site, (kind,), rank)
    for rule, ctx_rank in fired:
        rule._announce(site, None, ctx_rank, note=note)
    return bool(fired)


def drop_heartbeat(rank: Optional[int] = None) -> bool:
    """The heartbeat sender's hook: True when an armed ``heartbeat_drop``
    rule says this heartbeat must be skipped (the sender keeps its
    cadence, so the launcher sees exactly N missing intervals)."""
    return _fires("heartbeat", "heartbeat_drop", rank,
                  " (heartbeat suppressed)")


def drop_residual(rank: Optional[int] = None) -> bool:
    """The compressed training steps' hook, polled once per step: True
    when an armed ``residual_drop`` rule says this rank's error-feedback
    residuals must be zeroed before the step.  The step owns the zeroing
    (``parallel.data._drop_residuals``); this hook arms and logs."""
    return _fires("compression", "residual_drop", rank,
                  " (residual state zeroed)")


def fleet_chaos() -> List[str]:
    """The fleet controller's hook, polled once per tick: the fleet
    kinds (``preempt_storm``, ``host_flap``, and ``rank_kill`` with
    ``site=fleet``) whose rules fired on this tick, one entry a firing.
    The controller owns what they do: only it knows the jobs and the
    pool."""
    plan = _plan
    if plan is _UNSET:
        plan = load()
    if plan is None:
        return []
    fired: List[str] = []
    for rule in plan:
        if rule.kind not in FLEET_KINDS and rule.kind != "rank_kill":
            continue
        if rule.arm("fleet", _context_rank(None)):
            rule._announce("fleet", None, None)
            fired.append(rule.kind)
    return fired


def crash_replica(rank: Optional[int] = None) -> bool:
    """The serving replica's hook, polled once per decode step: True when
    an armed ``replica_crash`` rule says this replica must die now (the
    worker owns the death; this hook arms and logs)."""
    return _fires("serving", "replica_crash", rank, " (replica crashed)")


def storm_requests(rank: Optional[int] = None) -> int:
    """The router's hook, polled once per scheduler pass: how many
    synthetic requests armed ``request_storm`` rules inject on this pass
    (each rule's ``:N``, default 8; 0 = no storm)."""
    burst = 0
    for rule, ctx_rank in _firing("serving", ("request_storm",), rank):
        size = int(rule.arg) if rule.arg is not None else 8
        rule._announce("serving", None, ctx_rank,
                       note=f" (storm of {size} requests)")
        burst += size
    return burst


def control_chaos(rank: Optional[int] = None):
    """The control plane's hook, polled once per coordination-message
    send (site ``control``): ``(kind, arg)`` for every control rule that
    fired on this send.  ``msg_drop`` (the send is suppressed and the
    bounded retry earns it back), ``msg_dup`` (sent twice; the receiver's
    (epoch, seq) dedup drops the copy), ``msg_delay`` (arg: milliseconds
    to stall the send), ``partition`` (arg: seconds the wire counts as
    unreachable) and ``coord_crash`` (the caller kills the coordinator).
    The caller owns what they do: only it knows its wire."""
    fired = []
    for rule, ctx_rank in _firing("control", CONTROL_KINDS, rank):
        rule._announce("control", None, ctx_rank)
        fired.append((rule.kind, rule.arg))
    return fired


def mangle_spill(path: str, rank: Optional[int] = None) -> bool:
    """The spill writer's hook: truncates the spill just written at
    ``path`` when an armed ``spill_corrupt`` rule fires (to its ``:N``
    bytes, by default half the file).  True when the file was cut."""
    mangled = False
    for rule, ctx_rank in _firing("spill", ("spill_corrupt",), rank):
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        keep = int(rule.arg) if rule.arg is not None else size // 2
        keep = max(0, min(keep, size))
        with open(path, "r+b") as f:
            f.truncate(keep)
        rule._announce("spill", os.path.basename(path), ctx_rank,
                       note=f" (truncated {size} -> {keep} bytes)")
        mangled = True
    return mangled
