"""Deterministic value faults for the port's eager collectives.

The port's own copy of the part of ``horovod_tpu/faults.py`` that its
resilience tests need: the ``HOROVOD_FAULT_SPEC`` grammar (``;``-separated
rules of ``,``-separated ``key=value`` pairs: ``rank``, ``site``,
``after``, ``kind``, ``count``) and the two value kinds,

* ``nan``: the next matching collective's output comes back all NaN
  (floating outputs only; any other dtype passes through, with a note);
* ``corrupt[:N]``: N bytes of the output (default 1), at positions spread
  evenly over it, are flipped,

which fire at :func:`corrupt_output`, the hook every eager collective of
:mod:`horovod_tpu_torch.ops.collective` passes its result through.  The
reference's other kinds (``crash``, ``hang``, ``delay``, the plane,
fleet, serving, control and transport kinds) act on processes and
planes the port does not have; a spec that names one is refused at parse
time with the reference's words, never silently ignored.  With no spec
set the hook is one global load and an identity test.  The reference's
``attempt`` key matches a launcher's restart count; the port has no
restarting launcher, so a rule that names it is refused too.
"""

from __future__ import annotations

import sys
import threading
from typing import List, Optional

import torch

from horovod_tpu_torch import config

ENV_VAR = "HOROVOD_FAULT_SPEC"

VALUE_KINDS = ("nan", "corrupt")

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
                 "_hits", "_fired", "_lock")

    def __init__(self, rank, site, after, kind, arg, count):
        self.rank = rank          # int or None (= '*')
        self.site = site          # str or None (= '*')
        self.after = after
        self.kind = kind
        self.arg = arg            # corrupt: bytes to flip, or None
        self.count = count        # int or None (= unlimited)
        self._hits = 0
        self._fired = 0
        self._lock = threading.Lock()

    def _matches(self, site: str, rank: Optional[int]) -> bool:
        if self.site is not None and self.site != site:
            return False
        return self.rank is None or self.rank == rank

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
    if kind == "corrupt":
        arg = int(kind_arg) if kind_arg else None
        if arg is not None and arg < 1:
            raise FaultSpecError(f"kind corrupt:{arg} must flip >= 1 byte")
        return arg
    if kind_arg:
        raise FaultSpecError(f"kind {kind!r} takes no argument (got "
                             f"{kind + ':' + kind_arg!r})")
    return None


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse a whole HOROVOD_FAULT_SPEC into rules; raises
    :class:`FaultSpecError` on any grammar violation or a kind other than
    the value kinds."""
    rules: List[FaultRule] = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        rank = site = kind = arg = count = None
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
                    raise FaultSpecError(
                        f"fault spec key 'attempt' (in rule {chunk!r}) "
                        f"matches a launcher's restart attempt; the port "
                        f"has no restarting launcher")
                elif key == "kind":
                    kind, _, kind_arg = value.partition(":")
                    if kind not in VALUE_KINDS:
                        raise FaultSpecError(
                            f"unknown fault kind {kind!r}; valid kinds: "
                            f"{', '.join(VALUE_KINDS)}")
                    arg = _int_arg(kind, kind_arg)
                else:
                    raise FaultSpecError(
                        f"unknown fault spec key {key!r} (in rule "
                        f"{chunk!r}); valid keys: rank, site, after, "
                        f"kind, count")
            except (TypeError, ValueError) as e:
                if isinstance(e, FaultSpecError):
                    raise
                raise FaultSpecError(
                    f"bad value for {key!r} in fault rule {chunk!r}: {e}")
        if kind is None:
            raise FaultSpecError(
                f"fault rule {chunk!r} has no kind= (one of "
                f"{', '.join(VALUE_KINDS)})")
        if site is not None and site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r}; shipped sites: "
                f"{', '.join(SITES)} (or '*')")
        rules.append(FaultRule(rank, site, after, kind, arg, count))
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


def corrupt_output(site: str, out: torch.Tensor,
                   detail: Optional[str] = None,
                   rank: Optional[int] = None) -> torch.Tensor:
    """The output hook: each eager collective's result passes through
    here just before it is returned; a matching rule poisons a copy."""
    plan = _plan
    if plan is _UNSET:
        plan = load()
    if plan is None:
        return out
    ctx_rank = _context_rank(rank)
    for rule in plan:
        if rule.arm(site, ctx_rank):
            out = rule.poison(site, out, detail, ctx_rank)
    return out
