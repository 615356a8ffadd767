"""Deterministic faults for the port's eager collectives and its
recovery planes.

The port's own copy of the part of ``horovod_tpu/faults.py`` that its
resilience tests need: the ``HOROVOD_FAULT_SPEC`` grammar (``;``-separated
rules of ``,``-separated ``key=value`` pairs: ``rank``, ``site``,
``after``, ``kind``, ``count``, ``attempt``) and four kinds.  The value
kinds fire at :func:`corrupt_output`, the hook every eager collective of
:mod:`horovod_tpu_torch.ops.collective` passes its result through:

* ``nan``: the next matching collective's output comes back all NaN
  (floating outputs only; any other dtype passes through, with a note);
* ``corrupt[:N]``: N bytes of the output (default 1), at positions spread
  evenly over it, are flipped.

The plane kinds fire only at their own hooks:

* ``heartbeat_drop[:N]`` at :func:`drop_heartbeat` (site ``heartbeat``):
  the heartbeat sender skips the next N sends (default: every one),
  keeping its cadence; ``:N`` is shorthand for ``count=N``;
* ``spill_corrupt[:N]`` at :func:`mangle_spill` (site ``spill``): the
  warm-restart spill just written is truncated to N bytes (default half
  its size), the torn write that the reader must reject.

The serving kinds fire at the serving plane's hooks, both at site
``serving``, and default to one firing so that an episode settles:

* ``replica_crash[:N]`` at :func:`crash_replica`, polled once per decode
  step by :class:`~horovod_tpu_torch.serving.replica.ReplicaWorker`: the
  replica dies mid-request; ``:N`` is shorthand for ``count=N``;
* ``request_storm[:N]`` at :func:`storm_requests`, polled once per
  scheduler pass by :class:`~horovod_tpu_torch.serving.router.Router`:
  a burst of N synthetic requests (default 8); ``:N`` sizes each burst
  and ``count`` says how many bursts.

``attempt=N`` fires a rule only while ``HOROVOD_RESTART_ATTEMPT`` (the
launcher's restart count) equals N, so a test can fault attempt 0 and
let attempt 1 run clean.  The reference's other kinds (``crash``,
``hang``, ``delay``, the fleet, control and transport kinds)
act on processes and planes the port does not have; a spec that names
one is refused at parse time, never silently ignored.  With no spec set
each hook is one global load and an identity test.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import List, Optional

import torch

from horovod_tpu_torch import config

ENV_VAR = "HOROVOD_FAULT_SPEC"

VALUE_KINDS = ("nan", "corrupt")
# Kinds of the health and recovery planes: they fire at their own hooks
# (drop_heartbeat, mangle_spill), never at corrupt_output.
PLANE_KINDS = ("heartbeat_drop", "spill_corrupt")
# Kinds of the serving plane (site ``serving``): crash_replica() and
# storm_requests() poll them.
SERVING_KINDS = ("replica_crash", "request_storm")
KINDS = VALUE_KINDS + PLANE_KINDS + SERVING_KINDS

SITES = (
    "allreduce", "allgather", "broadcast", "alltoall", "reducescatter",
    "barrier", "native_submit", "native_wait", "rpc", "spawn",
    "heartbeat", "spill", "fleet", "compression", "serving", "control",
    "transport",
)


class FaultSpecError(ValueError):
    """The HOROVOD_FAULT_SPEC grammar was violated, or the spec names a
    kind the port does not inject.  Raised at parse time."""


class FaultRule:
    """One parsed rule and its firing state (thread-safe: the collectives
    return on the callers' threads)."""

    __slots__ = ("rank", "site", "after", "kind", "arg", "count",
                 "attempt", "_hits", "_fired", "_lock")

    def __init__(self, rank, site, after, kind, arg, count, attempt=None):
        self.rank = rank          # int or None (= '*')
        self.site = site          # str or None (= '*')
        self.after = after
        self.kind = kind
        self.arg = arg            # int (the kind's :N) or None
        self.count = count        # int or None (= unlimited)
        self.attempt = attempt    # int or None (= any attempt)
        self._hits = 0
        self._fired = 0
        self._lock = threading.Lock()

    def _matches(self, site: str, rank: Optional[int]) -> bool:
        if self.site is not None and self.site != site:
            return False
        if self.rank is not None and self.rank != rank:
            return False
        return (self.attempt is None or self.attempt
                == config.env_int("HOROVOD_RESTART_ATTEMPT"))

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


def _int_arg(kind: str, kind_arg: str):
    """The kind's ``:N``, checked with the reference's words."""
    if kind in ("corrupt", "heartbeat_drop", "spill_corrupt") + \
            SERVING_KINDS:
        arg = int(kind_arg) if kind_arg else None
        if arg is None:
            return None
        if kind == "corrupt" and arg < 1:
            raise FaultSpecError(f"kind corrupt:{arg} must flip >= 1 byte")
        if kind == "heartbeat_drop" and arg < 1:
            raise FaultSpecError(f"kind heartbeat_drop:{arg} must drop "
                                 f">= 1 heartbeat")
        if kind == "spill_corrupt" and arg < 0:
            raise FaultSpecError(f"kind spill_corrupt:{arg} must keep "
                                 f">= 0 bytes")
        if kind == "replica_crash" and arg < 1:
            raise FaultSpecError(f"kind replica_crash:{arg} must crash "
                                 f">= 1 replica")
        if kind == "request_storm" and arg < 1:
            raise FaultSpecError(f"kind request_storm:{arg} must inject "
                                 f">= 1 request per firing")
        return arg
    if kind_arg:
        raise FaultSpecError(f"kind {kind!r} takes no argument (got "
                             f"{kind + ':' + kind_arg!r})")
    return None


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
                    if kind not in KINDS:
                        raise FaultSpecError(
                            f"unknown fault kind {kind!r}; valid kinds: "
                            f"{', '.join(KINDS)}")
                    arg = _int_arg(kind, kind_arg)
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
        # heartbeat_drop:N is shorthand for count=N (N intervals).
        if kind == "heartbeat_drop" and count is None and arg is not None:
            count = arg
        # replica_crash:N is shorthand for count=N; request_storm:N sizes
        # each burst instead.  Both default to one firing.
        if kind == "replica_crash" and count is None:
            count = arg if arg is not None else 1
        if kind == "request_storm" and count is None:
            count = 1
        if site is not None and site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r}; shipped sites: "
                f"{', '.join(SITES)} (or '*')")
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


def corrupt_output(site: str, out: torch.Tensor,
                   detail: Optional[str] = None,
                   rank: Optional[int] = None) -> torch.Tensor:
    """The output hook: each eager collective's result passes through
    here just before it is returned; a matching rule poisons a copy."""
    for rule, ctx_rank in _firing(site, VALUE_KINDS, rank):
        out = rule.poison(site, out, detail, ctx_rank)
    return out


def drop_heartbeat(rank: Optional[int] = None) -> bool:
    """The heartbeat sender's hook: True when an armed ``heartbeat_drop``
    rule says this heartbeat must be skipped (the sender keeps its
    cadence, so the launcher sees exactly N missing intervals)."""
    fired = _firing("heartbeat", ("heartbeat_drop",), rank)
    for rule, ctx_rank in fired:
        rule._announce("heartbeat", None, ctx_rank,
                       note=" (heartbeat suppressed)")
    return bool(fired)


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


def crash_replica(rank: Optional[int] = None) -> bool:
    """The serving replica's hook, polled once per decode step: True when
    an armed ``replica_crash`` rule says this replica must die now (the
    worker owns the death; this hook arms and logs)."""
    fired = _firing("serving", ("replica_crash",), rank)
    for rule, ctx_rank in fired:
        rule._announce("serving", None, ctx_rank,
                       note=" (replica crashed)")
    return bool(fired)


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
