"""Self-healing training: the step guard, last-known-good rollback, the
divergence sentinel and the preemption protocol.

Counterpart of ``horovod_tpu/resilience.py``: ``guard_policy``
(``:130``), ``all_finite`` (``:159``), ``apply_step_guard`` (``:178``),
``tree_digest`` (``:254``), ``_divergent_ranks`` (``:266``),
``LastKnownGood`` (``:280``), ``GuardEvent`` and ``StepGuard``
(``:356-571``), ``_broadcast_state`` (``:573``), the warm-restart spill
and its recovery ladder (``:595-917``), the heartbeat sender
(``:920-1128``), ``reform_world`` (``:1131-1256``) and the preemption
functions (``:1259-1327``).

* **In-step guard** (:func:`apply_step_guard`, policy from
  ``HOROVOD_STEP_GUARD``: ``off | skip | rollback | abort``): under any
  policy but ``off`` a step whose loss or gradients are not finite on
  some rank keeps the old state on every rank and reports a NaN mean
  loss.  The JAX step selects per leaf between the new and the old state
  (a collective cannot sit in a ``lax.cond`` branch under SPMD); an
  eager step branches on the ranks' agreed verdict instead, so a bad
  step skips its update on every rank alike, for one host sync a step
  under a policy.
* **Host-side ladder** (:class:`StepGuard`, called after every step):
  the ranks agree on the step's verdict (a Min all-reduce), then ``skip``
  keeps the state, ``abort`` raises :class:`GuardAbort`, and ``rollback``
  restores the last-known-good snapshot after ``nan_burst`` bad steps in
  a row.  :class:`LastKnownGood` is a double-buffered host copy of the
  last validated ``(params, opt_state, step)``, staged every
  ``snapshot_interval`` steps and committed only once every rank found
  the step good.
* **Divergence sentinel** (every ``sentinel_interval`` steps, size > 1):
  a crc32 digest of params and optimizer state (this rank's shards under
  ZeRO-1), Min- and Max-all-reduced; on a mismatch an all-gather names
  the diverged ranks and ``rollback`` heals by broadcasting the state
  from the lowest good rank (a diverged rank's own snapshots are finite
  but wrong); any other policy raises :class:`DivergenceError`.
* **Warm-restart spill** (``HOROVOD_SPILL_DIR``, every
  ``HOROVOD_SPILL_INTERVAL``-th commit): the committed state goes to a
  host-local file, ``rank{r}.spill``: the reference's ``!8sIqIIQI``
  header (magic, version, step, world size, rank, payload length, crc32)
  and a torch payload, streamed from the snapshot's host buffer through
  the crc into a temp file that is fsynced and renamed over the old one.
  ZeRO-1 states are written in the full layout.
* **Recovery ladder** (:func:`warm_restore`): the newest committed spill
  on any rank (a Max election, then a Min election of the lowest rank
  holding it, a layout check every rank agrees on, then a broadcast leaf
  by leaf, ZeRO-1 re-sharded for this world), else the newest intact
  checkpoint, else the state passed in.
* **Health plane**: :class:`HeartbeatSender` pushes ``(rank, step)`` to
  the launcher's ``HOROVOD_HEALTH_RPC`` every interval; a reply may ask
  for a preemption or deliver a fail-in-place spec, which
  :func:`reform_world` adopts: the old world torn down, the survivors'
  world initialized, the state recovered through the ladder.
* **Preemption**: :func:`install_preemption_handler` turns SIGTERM into a
  flag; :func:`maybe_save_and_exit` saves a checkpoint at the next step
  boundary and exits with :data:`PREEMPTION_RC` (75), which the launcher
  reschedules without blacklisting.

State is a tree as :mod:`horovod_tpu_torch.tree` walks it, ZeRO-1 states
opened to their shards.  A rollback, a heal or a warm restore writes
into the tensors of the state passed in (a module's parameters and an
optimizer's buffers stay the objects they hold) and returns that state.
Not ported: the reference's ``hvd_guard_*``, ``hvd_rollback_*``,
``hvd_sentinel_*``, ``hvd_warm_restart_*``, ``hvd_heartbeat_*`` and
``hvd_failinplace_*`` series (the port has no telemetry registry yet).
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import signal
import struct
import sys
import threading
import time
import zlib
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import basics, config, faults, telemetry
from horovod_tpu_torch.parallel.sequence import axis_mean
from horovod_tpu_torch.tree import tree_leaves, tree_map

log = logging.getLogger(__name__)

# "Preempted, please reschedule": BSD EX_TEMPFAIL, far from the launcher's
# operator-stop codes (130/143) and from any 128+N signal code.
PREEMPTION_RC = 75

GUARD_POLICIES = ("off", "skip", "rollback", "abort")


class GuardAbort(RuntimeError):
    """Raised by :meth:`StepGuard.after_step` under policy ``abort``."""


class DivergenceError(RuntimeError):
    """Raised by the sentinel when replicas diverged and the policy does
    not heal (anything but ``rollback``); ``.ranks`` names them."""

    def __init__(self, message: str, ranks: Sequence[int]):
        super().__init__(message)
        self.ranks = tuple(ranks)


def guard_policy() -> str:
    """The policy from ``HOROVOD_STEP_GUARD`` (default ``off``), read when
    the training step is built."""
    value = (config.env_str("HOROVOD_STEP_GUARD") or "off").strip().lower()
    value = value or "off"
    if value not in GUARD_POLICIES:
        raise ValueError(f"HOROVOD_STEP_GUARD={value!r}: expected one of "
                         f"{', '.join(GUARD_POLICIES)}")
    return value


def _env_interval(var: str, minimum: int = 0) -> int:
    value = config.env_int(var)
    if value < minimum:
        raise ValueError(f"{var}={value} must be >= {minimum}")
    return value


# ---------------------------------------------------------------------------
# In-step guard
# ---------------------------------------------------------------------------

def all_finite(loss: torch.Tensor, grads: Sequence[torch.Tensor],
               group=None) -> torch.Tensor:
    """True iff ``loss`` and every floating gradient are finite on EVERY
    rank of ``group``: a local int32 flag, min-reduced across ranks."""
    flags = [torch.isfinite(t).all() for t in (loss, *grads)
             if t.is_floating_point()]
    local = torch.stack(flags).all() if flags else torch.tensor(True)
    flag = local.to(device=loss.device, dtype=torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return flag[0] == 1


def mean_across(t: torch.Tensor, group=None) -> torch.Tensor:
    """``pmean``: the mean of ``t`` over the ranks of ``group``."""
    return axis_mean(t.detach(), group)


def apply_step_guard(do_update: Callable[[], None], *, loss: torch.Tensor,
                     grads: Sequence[torch.Tensor],
                     restore: Optional[Callable[[], None]] = None,
                     group=None, policy: Optional[str] = None,
                     agree_group=None) -> torch.Tensor:
    """Run one optimizer update under the step guard; returns the mean loss
    over ``group``.

    ``do_update()`` applies the update in place.  ``restore()`` puts back
    whatever the forward pass already changed (the BatchNorm running
    statistics).  The ranks of ``agree_group`` (default: ``group``; the
    LM's step passes every mesh axis, as the reference's ``agree_axes``)
    agree on the verdict.  Under policy ``off`` this is ``do_update()``
    plus the loss mean, with no check at all.
    """
    policy = guard_policy() if policy is None else policy
    mean_loss = mean_across(loss, group)
    if policy == "off":
        do_update()
        return mean_loss
    if telemetry.enabled():  # once per guarded step (the port has no trace)
        telemetry.counter(
            "hvd_guard_traces_total",
            "training-step traces built with the step guard enabled",
            policy=policy).inc()
    agree = group if agree_group is None else agree_group
    if bool(all_finite(loss, grads, agree)):
        do_update()
        return mean_loss
    if restore is not None:
        restore()
    return torch.full_like(mean_loss, float("nan"))


# ---------------------------------------------------------------------------
# Digests
# ---------------------------------------------------------------------------

def _host_bytes(leaf) -> bytes:
    if torch.is_tensor(leaf):
        t = leaf.detach().contiguous().reshape(-1)
        return t.view(torch.uint8).cpu().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def tree_digest(tree) -> int:
    """crc32 chained over the host bytes of every leaf, in the tree's
    fixed order.  Below 2**32, so exact in float64 and through a float64
    all-reduce."""
    crc = 0
    for leaf in tree_leaves(tree):
        crc = zlib.crc32(_host_bytes(leaf), crc)
    return crc


def _divergent_ranks(digests) -> list:
    """The ranks whose digest row differs from the modal row; a tie goes
    to the smallest row, so every rank names the same ranks."""
    rows = [tuple(np.asarray(row).ravel().tolist()) for row in digests]
    counts: dict = {}
    for row in rows:
        counts[row] = counts.get(row, 0) + 1
    top = max(counts.values())
    modal = min(row for row, n in counts.items() if n == top)
    return [i for i, row in enumerate(rows) if row != modal]


# ---------------------------------------------------------------------------
# ZeRO-1 states opened to their tensors
# ---------------------------------------------------------------------------

class _Shards(NamedTuple):
    """A ZeRO-1 state opened up so the tree walker reaches its tensors:
    this rank's optimizer shards and its codec state."""
    inner: Any
    rs: Any
    ag: Any
    factors: Any


def _is_zero(x) -> bool:
    from horovod_tpu_torch.parallel import zero
    return zero.is_zero_state(x)


def _open_zero(tree):
    """``tree`` with every ZeRO-1 state replaced by its :class:`_Shards`."""
    def open_(x):
        if not _is_zero(x):
            return x
        w = x.wire
        return _Shards(x.inner, *((w.rs, w.ag, w.factors) if w is not None
                                  else (None, None, None)))
    return tree_map(open_, tree, is_leaf=_is_zero)


def _close_zero(opened, template):
    """Inverse of :func:`_open_zero`, the shells taken from ``template``."""
    def close(t, o):
        if not _is_zero(t):
            return o
        wire = (None if t.wire is None else dataclasses.replace(
            t.wire, rs=o.rs, ag=o.ag, factors=o.factors))
        return dataclasses.replace(t, inner=o.inner, wire=wire)
    return tree_map(close, template, opened, is_leaf=_is_zero)


def _has_zero(tree) -> bool:
    return any(_is_zero(leaf) for leaf in tree_leaves(tree))


def _write_into(live, new):
    """``new``'s values written into ``live``'s tensors (ZeRO-1 shards
    too); other leaves take ``new``'s value in ``live``'s type.  Returns
    ``live``'s structure."""
    from horovod_tpu_torch import checkpoint

    def put(dst, src):
        if not torch.is_tensor(src):
            return src
        if not torch.is_tensor(dst):
            return checkpoint._like(src, dst)
        with torch.no_grad():
            dst.copy_(src, non_blocking=True)
        return dst

    out = tree_map(put, _open_zero(live), _open_zero(new))
    for dev in {t.device for t in tree_leaves(out)
                if torch.is_tensor(t) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return _close_zero(out, live)


# ---------------------------------------------------------------------------
# Last-known-good
# ---------------------------------------------------------------------------

def _all_finite_leaves(leaves) -> bool:
    """Finiteness of every floating leaf, checked where it lives (one
    host sync a device); the bytes a stage copies are these."""
    by_device: dict = {}
    for leaf in leaves:
        if torch.is_tensor(leaf):
            if leaf.is_floating_point() or leaf.is_complex():
                by_device.setdefault(leaf.device, []).append(
                    torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
                return False
    return all(bool(torch.stack(flags).all()) for flags in
               by_device.values())


class _HostBuffer:
    """Host copies of a list of tensors, in one flat (pinned, when the
    tensors are on the card) allocation, reused from stage to stage."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.layout = [(t.shape, t.dtype) for t in tensors]
        sizes = [t.numel() * t.element_size() for t in tensors]
        self.offsets = [sum(-(-s // 64) * 64 for s in sizes[:i])
                        for i in range(len(sizes))]
        total = (self.offsets[-1] + sizes[-1]) if sizes else 0
        pin = any(t.is_cuda for t in tensors) and torch.cuda.is_available()
        self.flat = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
        self.views = [
            self.flat[o:o + s].view(dt).view(shape)
            for o, s, (shape, dt) in zip(self.offsets, sizes, self.layout)]

    def fits(self, tensors) -> bool:
        return self.layout == [(t.shape, t.dtype) for t in tensors]


class LastKnownGood:
    """Double-buffered host snapshot of the last validated training state.
    :meth:`stage` copies the state into the standby buffer (after finding
    it finite); :meth:`commit` swaps it in only once the global verdict is
    in, so a poisoned or torn snapshot never replaces a good one.  The two
    buffers are reused: a stage allocates nothing after the first two."""

    def __init__(self):
        self._committed = None  # (step, template, tensor buffer, others)
        self._staged = None
        self._spare: Optional[_HostBuffer] = None
        self.last_stage_seconds: Optional[float] = None

    @property
    def available(self) -> bool:
        return self._committed is not None

    @property
    def step(self) -> Optional[int]:
        return self._committed[0] if self._committed else None

    def stage(self, params, opt_state, step: int) -> bool:
        """Copy ``(params, opt_state)`` into the standby buffer.  Returns
        False, and stages nothing, when the state holds NaN/Inf (it is
        already poisoned)."""
        t0 = time.perf_counter()
        tree = (params, opt_state)
        leaves = tree_leaves(_open_zero(tree))
        if not _all_finite_leaves(leaves):
            self._staged = None
            if telemetry.enabled():
                telemetry.counter(
                    "hvd_rollback_snapshot_rejected_total",
                    "staged snapshots rejected for non-finite bytes").inc()
                self._record_stage(t0)
            return False
        tensors = [t for t in leaves if torch.is_tensor(t)]
        buf = self._spare
        self._spare = None
        if buf is None or not buf.fits(tensors):
            buf = _HostBuffer(tensors)
        for view, t in zip(buf.views, tensors):
            view.copy_(t.detach(), non_blocking=True)
        for dev in {t.device for t in tensors if t.is_cuda}:
            torch.cuda.synchronize(dev)
        others = [np.array(leaf, copy=True) for leaf in leaves
                  if not torch.is_tensor(leaf)]
        self._staged = (int(step), tree, buf, others)
        self.last_stage_seconds = time.perf_counter() - t0
        if telemetry.enabled():
            self._record_stage(t0)
        return True

    @staticmethod
    def _record_stage(t0: float) -> None:
        telemetry.histogram(
            "hvd_rollback_snapshot_seconds",
            "host pull + validation time per staged snapshot",
        ).observe(time.perf_counter() - t0)

    def commit(self) -> None:
        if self._staged is None:
            return
        old = self._committed
        self._committed, self._staged = self._staged, None
        if old is not None:
            self._spare = old[2]
        if telemetry.enabled():
            telemetry.counter(
                "hvd_rollback_snapshots_total",
                "last-known-good snapshots committed").inc()

    def discard_stage(self) -> None:
        if self._staged is not None:
            self._spare = self._staged[2]
        self._staged = None

    def host_state(self) -> Tuple[Any, Any]:
        """The committed snapshot as ``(params, opt_state)``: its tensors
        are views of the host buffer itself (no copy, valid until the
        next commit), its other leaves copies in the staged leaf's type."""
        if self._committed is None:
            raise RuntimeError("no last-known-good snapshot available")
        _, template, buf, others = self._committed
        tensors, rest = iter(buf.views), iter(others)

        def leaf_of(leaf):
            if torch.is_tensor(leaf):
                return next(tensors)
            value = next(rest)
            return type(leaf)(value) if np.isscalar(leaf) else value.copy()

        return _close_zero(tree_map(leaf_of, _open_zero(template)), template)

    def restore(self, into=None) -> Tuple[Any, Any, int]:
        """The committed snapshot as ``(params, opt_state, step)``: fresh
        tensors on the devices the state was staged from, or, with
        ``into=(params, opt_state)`` of the same structure, written into
        those tensors (and returned)."""
        state = self.host_state()
        step, template = self._committed[:2]
        if telemetry.enabled():
            telemetry.counter(
                "hvd_rollback_restores_total",
                "in-process restores from last-known-good").inc()
        if into is not None:
            params, opt_state = _write_into(tuple(into), state)
            return params, opt_state, step
        out = tree_map(lambda leaf, src: src.to(leaf.device, copy=True)
                       if torch.is_tensor(leaf) else src,
                       _open_zero(template), _open_zero(state))
        params, opt_state = _close_zero(out, template)
        return params, opt_state, step


# ---------------------------------------------------------------------------
# StepGuard
# ---------------------------------------------------------------------------

class GuardEvent(NamedTuple):
    """What :meth:`StepGuard.after_step` did: ``action`` is ``ok``,
    ``skip``, ``rollback`` or ``heal``; ``step`` the step the returned
    state belongs to (the last-known-good step after a rollback)."""
    action: str
    step: int


class StepGuard:
    """The host-side half of the guard, called on every rank after every
    step::

        guard = hvd.StepGuard()        # HOROVOD_STEP_GUARD and friends
        for step in range(n):
            loss = train_step(...)     # NaN loss marks a guarded bad step
            params, opt_state, ev = guard.after_step(
                params, opt_state, step, loss)

    The ranks agree on each step's verdict with a Min all-reduce, so
    every rank rolls back or none does.  ``snapshot_interval`` (default
    ``HOROVOD_LKG_INTERVAL``, 1) is how often a good step is staged under
    ``rollback``; ``nan_burst`` (``HOROVOD_GUARD_NAN_BURST``, 1) how many
    bad steps in a row fire a rollback; ``sentinel_interval``
    (``HOROVOD_SENTINEL_INTERVAL``, 0 = off) how often the replicas'
    digests are compared.  With a ``spill_dir`` (default
    ``HOROVOD_SPILL_DIR``) every ``spill_interval``-th commit
    (``HOROVOD_SPILL_INTERVAL``, 1) is also written to this rank's spill
    file, from the snapshot's host buffer, for :func:`warm_restore`;
    ``spill_extra`` (a dict of small host values: a data cursor, a seed)
    rides along.  A spill that fails degrades to a warning."""

    def __init__(self, policy: Optional[str] = None,
                 sentinel_interval: Optional[int] = None,
                 snapshot_interval: Optional[int] = None,
                 nan_burst: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 spill_interval: Optional[int] = None,
                 spill_extra: Optional[Dict[str, Any]] = None):
        self.policy = guard_policy() if policy is None else policy
        if self.policy not in GUARD_POLICIES:
            raise ValueError(f"policy {self.policy!r}: expected one of "
                             f"{', '.join(GUARD_POLICIES)}")
        self.sentinel_interval = (
            _env_interval("HOROVOD_SENTINEL_INTERVAL")
            if sentinel_interval is None else int(sentinel_interval))
        self.snapshot_interval = (
            _env_interval("HOROVOD_LKG_INTERVAL", minimum=1)
            if snapshot_interval is None else max(1, int(snapshot_interval)))
        self.nan_burst = (
            _env_interval("HOROVOD_GUARD_NAN_BURST", minimum=1)
            if nan_burst is None else max(1, int(nan_burst)))
        self.lkg = LastKnownGood()
        self._bad_streak = 0
        self._warned_no_lkg = False
        self._spill_dir = _spill_dir() if spill_dir is None else spill_dir
        self.spill_interval = (
            _env_interval("HOROVOD_SPILL_INTERVAL", minimum=1)
            if spill_interval is None else max(1, int(spill_interval)))
        self.spill_extra: Dict[str, Any] = dict(spill_extra or {})
        self._commits = 0

    @staticmethod
    def _global_ok(local_ok: bool) -> bool:
        """The step is good only if it is good on every rank."""
        if basics.size() <= 1:
            return local_ok
        from horovod_tpu_torch.ops import collective as _c
        flag = torch.tensor([1.0 if local_ok else 0.0], dtype=torch.float32)
        out = _c.allreduce(flag, op=_c.Min, name="hvd.resilience.guard.ok")
        return bool(out[0] >= 0.5)

    def _digests(self, params, opt_state) -> np.ndarray:
        from horovod_tpu_torch.parallel import zero
        opt = (zero.local_state_digest(opt_state)
               if zero.is_zero_state(opt_state) else tree_digest(opt_state))
        return np.array([float(tree_digest(params)), float(opt)],
                        np.float64)

    def _sentinel(self, params, opt_state, step: int):
        """Min/max digest agreement; on a mismatch, name the diverged
        ranks, then heal (``rollback``) or raise."""
        from horovod_tpu_torch.ops import collective as _c
        if telemetry.enabled():
            telemetry.counter(
                "hvd_sentinel_checks_total",
                "divergence sentinel digest comparisons").inc()
        digest = torch.from_numpy(self._digests(params, opt_state))
        lo = _c.allreduce(digest, op=_c.Min,
                          name="hvd.resilience.sentinel.min")
        hi = _c.allreduce(digest, op=_c.Max,
                          name="hvd.resilience.sentinel.max")
        if torch.equal(lo, hi):
            return params, opt_state, None
        gathered = _c.allgather(digest.reshape(1, -1),
                                name="hvd.resilience.sentinel.digests")
        bad = _divergent_ranks(gathered.numpy())
        if telemetry.enabled():
            telemetry.counter(
                "hvd_sentinel_divergence_total",
                "sentinel checks that found diverged replicas").inc()
        message = (f"divergence sentinel at step {step}: replica digests "
                   f"disagree; diverging rank(s): {bad}")
        if self.policy != "rollback":
            log.error("%s", message)
            raise DivergenceError(message, bad)
        source = min(r for r in range(basics.size()) if r not in bad)
        log.error("%s; healing by re-broadcasting state from rank %d",
                  message, source)
        params, opt_state = _broadcast_state(params, opt_state, source)
        if telemetry.enabled():
            telemetry.counter(
                "hvd_sentinel_heals_total",
                "in-process divergence heals (state re-broadcast)").inc()
        return params, opt_state, GuardEvent("heal", step)

    def after_step(self, params, opt_state, step: int, loss):
        """Validate one completed step; returns ``(params, opt_state,
        GuardEvent)``, the state possibly the restored last-known-good.
        Every rank calls it for every step."""
        report_progress(step)
        if self.policy == "off" and self.sentinel_interval == 0:
            return params, opt_state, GuardEvent("ok", step)
        if telemetry.enabled():
            telemetry.counter(
                "hvd_guard_checks_total",
                "host-side step-boundary guard evaluations").inc()
        local_ok = bool(np.isfinite(np.asarray(
            loss.detach().float().cpu() if torch.is_tensor(loss) else loss,
            np.float64)).all())
        staged = False
        if (local_ok and self.policy == "rollback"
                and step % self.snapshot_interval == 0):
            staged = self.lkg.stage(params, opt_state, step)
            local_ok = staged        # a rejected stage: the state is bad
        ok = self._global_ok(local_ok)
        if ok:
            if staged:
                self.lkg.commit()
                if self._spill_dir:
                    self._commits += 1
                    if self._commits % self.spill_interval == 0:
                        self._spill(opt_state, step)
            self._bad_streak = 0
            if (self.sentinel_interval > 0 and step > 0
                    and step % self.sentinel_interval == 0
                    and basics.size() > 1):
                params, opt_state, event = self._sentinel(
                    params, opt_state, step)
                if event is not None:
                    return params, opt_state, event
            return params, opt_state, GuardEvent("ok", step)

        # A bad step (on at least one rank: every rank agrees it was).
        self.lkg.discard_stage()
        self._bad_streak += 1
        if telemetry.enabled():
            telemetry.counter(
                "hvd_guard_nonfinite_steps_total",
                "steps rejected by the guard (non-finite loss/grads)").inc()
        if self.policy == "abort":
            raise GuardAbort(f"step guard: non-finite loss/grads at step "
                             f"{step} (policy abort)")
        if self.policy == "rollback" and self._bad_streak >= self.nan_burst:
            if self.lkg.available:
                params, opt_state, good = self.lkg.restore(
                    into=(params, opt_state))
                self._bad_streak = 0
                log.warning("step guard: non-finite step %d; rolled back "
                            "to last-known-good step %d", step, good)
                return params, opt_state, GuardEvent("rollback", good)
            if not self._warned_no_lkg:
                self._warned_no_lkg = True
                log.warning("step guard: rollback requested at step %d but "
                            "no last-known-good snapshot exists yet; "
                            "skipping instead", step)
        if telemetry.enabled():
            telemetry.counter(
                "hvd_guard_skipped_steps_total",
                "bad steps skipped (old state kept)").inc()
        log.warning("step guard: non-finite step %d skipped (streak %d)",
                    step, self._bad_streak)
        return params, opt_state, GuardEvent("skip", step)

    def _spill(self, opt_state, step: int) -> None:
        """Write the commit just made to this rank's spill file: the
        parameters (and a replicated optimizer state) from the snapshot's
        host buffer, a ZeRO-1 state gathered to the full layout.  A
        failure degrades to a warning: a broken scratch disk must not
        stop a healthy loop."""
        try:
            params, opt = self.lkg.host_state()
            write_spill(self._spill_dir, params,
                        opt_state if _has_zero(opt_state) else opt, step,
                        extra=self.spill_extra)
        except Exception as e:  # noqa: BLE001 (degrade, do not die)
            log.warning("warm-restart spill at step %d FAILED (%s: %s); "
                        "continuing without it", step, type(e).__name__, e)
            if telemetry.enabled():
                telemetry.counter(
                    "hvd_warm_restart_spill_failures_total",
                    "spill writes that raised (degraded, not fatal)").inc()


def _broadcast_state(params, opt_state, root_rank: int):
    """``(params, opt_state)`` from ``root_rank``, written into each
    rank's tensors (other leaves replaced): the divergence heal."""
    from horovod_tpu_torch.ops import collective as _c
    counter = iter(range(1 << 30))

    def heal(leaf):
        name = f"hvd.resilience.heal.{next(counter)}"
        if torch.is_tensor(leaf):
            _c.broadcast_(leaf.data, root_rank, name=name)
            return leaf
        arr = np.asarray(leaf)
        got = _c.broadcast(torch.from_numpy(np.array(arr)), root_rank,
                           name=name).numpy()
        return type(leaf)(got.item()) if np.isscalar(leaf) else got

    return tree_map(heal, (params, opt_state))


# ---------------------------------------------------------------------------
# Warm restart: host-local spill files and the recovery ladder
# ---------------------------------------------------------------------------

SPILL_MAGIC = b"HVDSPILL"
SPILL_VERSION = 1
# magic, version, step, world_size, rank, payload_len, payload_crc32
_SPILL_HEADER = struct.Struct("!8sIqIIQI")
_CHUNK = 64 << 20

# Bytes and seconds of this process's newest spill write and warm restore,
# by part (printed by the card's smoke test; read by nothing else).
last_spill: Dict[str, float] = {}
last_restore: Dict[str, float] = {}


def spill_dir() -> Optional[str]:
    """The job's host-local scratch dir (``HOROVOD_SPILL_DIR``, set by the
    launcher and stable across restarts), or None."""
    return (config.env_str("HOROVOD_SPILL_DIR") or "").strip() or None


_spill_dir = spill_dir   # StepGuard's parameter of the same name hides it


def _spill_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank{int(rank)}.spill")


def _dtype_name(dtype: torch.dtype) -> str:
    """A fixed name for each torch dtype (bf16 has no numpy dtype)."""
    return str(dtype).removeprefix("torch.")


def _host_tensor(leaf) -> torch.Tensor:
    """A leaf as a contiguous host tensor (no copy when it is one)."""
    from horovod_tpu_torch import checkpoint
    return checkpoint._as_tensor(leaf).to("cpu").contiguous()


class _CrcSink:
    """The file a payload streams into: each chunk is added to the crc
    and written as it comes, so no copy of the payload is held."""

    def __init__(self, f):
        self.f, self.crc, self.nbytes = f, 0, 0
        self.crc_s = self.write_s = 0.0

    def write(self, data) -> int:
        t0 = time.perf_counter()
        self.crc = zlib.crc32(data, self.crc)
        t1 = time.perf_counter()
        n = self.f.write(data)
        self.write_s += time.perf_counter() - t1
        self.crc_s += t1 - t0
        self.nbytes += n
        return n

    def flush(self) -> None:
        self.f.flush()


class _Window(io.RawIOBase):
    """A read-only view of a file from ``offset`` on, as a file."""

    def __init__(self, f, offset: int):
        self.f, self.offset = f, offset
        f.seek(offset)

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            pos += self.offset
        return self.f.seek(pos, whence) - self.offset

    def tell(self) -> int:
        return self.f.tell() - self.offset

    def readinto(self, b) -> int:
        return self.f.readinto(b)


def write_spill(directory: str, params, opt_state, step: int, *,
                extra: Optional[Dict[str, Any]] = None,
                rank: Optional[int] = None,
                world_size: Optional[int] = None) -> str:
    """Write a committed state to this rank's spill file in
    ``directory``; returns its path.

    The optimizer state goes in the portable layout (a ZeRO-1 state
    gathered to the full per-leaf state, collective over its group), so
    a world of another size can restore it.  The payload is a torch
    state, ``{"params": [...], "opt": [...], "layout": [...], "extra":
    {...}}``: each leaf as the uint8 bytes of a host tensor (views of
    the caller's host buffer stay views: ``torch.save`` writes a shared
    storage once), ``layout`` its shape and dtype name.  It streams into
    a temp file behind a placeholder header through a running crc32;
    the real header is written last, the file fsynced and renamed over
    the old spill, so a reader sees the old file or the whole new one."""
    from horovod_tpu_torch import checkpoint
    rank = basics.rank() if rank is None else int(rank)
    world_size = basics.size() if world_size is None else int(world_size)
    t0 = time.perf_counter()
    portable = checkpoint._gather_zero(opt_state)
    groups = [[_host_tensor(leaf) for leaf in tree_leaves(t)]
              for t in (params, portable)]
    layout = [[list(t.shape), _dtype_name(t.dtype)] for g in groups
              for t in g]
    payload = {"params": [t.reshape(-1).view(torch.uint8)
                          for t in groups[0]],
               "opt": [t.reshape(-1).view(torch.uint8) for t in groups[1]],
               "layout": layout, "extra": dict(extra or {})}
    t1 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    path = _spill_path(directory, rank)
    tmp = path + ".tmp"
    from torch import serialization
    crc_opts = getattr(serialization, "get_crc32_options", None)
    with open(tmp, "wb") as f:
        f.write(b"\0" * _SPILL_HEADER.size)
        sink = _CrcSink(f)
        # The zip records' own crc32 would be a second pass over the
        # payload, which the header's crc covers already.
        was = crc_opts() if crc_opts else None
        if crc_opts:
            serialization.set_crc32_options(False)
        try:
            torch.save(payload, sink)
        finally:
            if crc_opts:
                serialization.set_crc32_options(was)
        t2 = time.perf_counter()
        f.seek(0)
        f.write(_SPILL_HEADER.pack(SPILL_MAGIC, SPILL_VERSION, int(step),
                                   world_size, rank, sink.nbytes,
                                   sink.crc))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    t3 = time.perf_counter()
    faults.mangle_spill(path, rank)
    if telemetry.enabled():
        telemetry.counter(
            "hvd_warm_restart_spills_total",
            "warm-restart spill files written").inc()
        telemetry.histogram(
            "hvd_warm_restart_spill_seconds",
            "host serialization + fsync time per spill").observe(t3 - t0)
    last_spill.clear()
    last_spill.update(
        bytes=sink.nbytes + _SPILL_HEADER.size, host_copy_s=t1 - t0,
        serialize_s=t2 - t1 - sink.crc_s - sink.write_s, crc_s=sink.crc_s,
        write_s=sink.write_s, fsync_s=t3 - t2, total_s=t3 - t0)
    log.debug("spilled step %d (%d bytes) to %s", step, sink.nbytes, path)
    return path


def read_spill(path: str) -> Optional[Dict[str, Any]]:
    """One spill file, validated: ``{"step", "world_size", "rank",
    "path", "params", "opt", "extra"}`` (the leaves as host tensors) and
    the seconds it took (``read_crc_s``, ``load_s``), or None.  A
    missing, short, torn, mangled or unloadable file is rejected with a
    warning, never raised on: the ladder moves to its next rung.
    The crc is checked over the payload as it streams from the disk,
    before anything in it is loaded."""

    def _reject(why: str) -> None:
        log.warning("rejecting spill %s: %s", path, why)
        if telemetry.enabled():
            telemetry.counter(
                "hvd_warm_restart_spill_rejected_total",
                "spill files rejected by validation (torn write / CRC / "
                "version mismatch)").inc()
        return None

    try:
        f = open(path, "rb")
    except OSError:
        return None
    with f:
        t0 = time.perf_counter()
        head = f.read(_SPILL_HEADER.size)
        if len(head) < _SPILL_HEADER.size:
            return _reject(f"short header ({len(head)} bytes)")
        magic, version, step, world, rank, plen, crc = \
            _SPILL_HEADER.unpack(head)
        if magic != SPILL_MAGIC:
            return _reject("bad magic")
        if version != SPILL_VERSION:
            return _reject(f"unsupported version {version}")
        got = os.fstat(f.fileno()).st_size - _SPILL_HEADER.size
        if got != plen:
            return _reject(f"torn payload ({got}/{plen} bytes)")
        buf = bytearray(min(_CHUNK, max(plen, 1)))
        view, running = memoryview(buf), 0
        while True:
            n = f.readinto(buf)
            if not n:
                break
            running = zlib.crc32(view[:n], running)
        if running != crc:
            return _reject("payload crc mismatch")
        t1 = time.perf_counter()
        try:
            payload = torch.load(_Window(f, _SPILL_HEADER.size),
                                 map_location="cpu", weights_only=True)
            shapes = iter(payload["layout"])

            def typed(raw):
                shape, name = next(shapes)
                dtype = getattr(torch, name)
                if not isinstance(dtype, torch.dtype):
                    raise ValueError(f"unknown dtype {name!r}")
                return raw.view(dtype).view(shape)

            params = [typed(t) for t in payload["params"]]
            opt = [typed(t) for t in payload["opt"]]
            extra = dict(payload["extra"])
        except Exception as e:  # noqa: BLE001 (reject and go on)
            return _reject(f"unloadable payload ({type(e).__name__}: {e})")
    return {"step": int(step), "world_size": int(world), "rank": int(rank),
            "path": path, "params": params, "opt": opt, "extra": extra,
            "read_crc_s": t1 - t0, "load_s": time.perf_counter() - t1}


def _spill_step(path: str) -> int:
    """The step in a spill file's header, unchecked (-1 when the header
    cannot be read): the order in which :func:`best_local_spill` tries
    the files."""
    try:
        with open(path, "rb") as f:
            head = f.read(_SPILL_HEADER.size)
        return _SPILL_HEADER.unpack(head)[2]
    except (OSError, struct.error):
        return -1


def best_local_spill(directory: str) -> Optional[Dict[str, Any]]:
    """The valid spill with the highest step in ``directory`` (every
    ``*.spill``, not only this rank's: after a shrink the ranks
    renumber).  The files are tried newest first by their header's step
    and the first that passes :func:`read_spill` wins, so one payload is
    loaded unless a newer file is rejected."""
    try:
        entries = sorted(e for e in os.listdir(directory)
                         if e.endswith(".spill"))
    except OSError:
        return None
    paths = [os.path.join(directory, e) for e in entries]
    for path in sorted(paths, key=_spill_step, reverse=True):
        rec = read_spill(path)
        if rec is not None:
            return rec
    return None


def _layout_signature(leaves) -> int:
    """crc32 over ``shape:dtype;`` of each leaf in order: the cheap check
    that a spilled state fits the live one before any byte moves."""
    crc = 0
    for leaf in leaves:
        t = leaf if torch.is_tensor(leaf) else _host_tensor(leaf)
        crc = zlib.crc32(
            f"{tuple(t.shape)}:{_dtype_name(t.dtype)};".encode(), crc)
    return crc


def _elect(value: float, op, name: str) -> float:
    from horovod_tpu_torch.ops import collective as _c
    out = _c.allreduce(torch.tensor([float(value)], dtype=torch.float64),
                       op=op, name=name)
    return float(out[0])


def _broadcast_extra(extra: Dict[str, Any], src: int, i_am_src: bool
                     ) -> Dict[str, Any]:
    """The source's ``extra`` on every rank, as torch-serialized bytes."""
    from horovod_tpu_torch.ops import collective as _c
    blob = b""
    if i_am_src:
        out = io.BytesIO()
        torch.save(extra, out)
        blob = out.getvalue()
    n = _c.broadcast(torch.tensor([len(blob)], dtype=torch.int64), src,
                     name="hvd.resilience.warm.extra.len")
    n = int(n[0])
    if not n:
        return {}
    buf = (torch.frombuffer(bytearray(blob), dtype=torch.uint8) if i_am_src
           else torch.zeros(n, dtype=torch.uint8))
    buf = _c.broadcast(buf, src, name="hvd.resilience.warm.extra")
    return dict(torch.load(io.BytesIO(buf.cpu().numpy().tobytes()),
                           weights_only=True))


def _peer_recover(params, opt_state, local: Optional[Dict[str, Any]],
                  local_step: int, best: int):
    """Elect the spill source and broadcast its state to the world.

    The source is the lowest rank whose spill holds step ``best`` (a Min
    election).  Its layout signature is broadcast and checked by every
    rank against its own state, and the ranks agree on the verdict (a
    Min), so either all take the spill or all fall to the next rung.
    Returns ``(params, opt_state, extra)``, the state written into the
    live tensors, or None on a layout mismatch."""
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.ops import collective as _c
    size, me = basics.size(), basics.rank()
    portable = checkpoint._gather_zero(opt_state)
    live = tree_leaves(params) + tree_leaves(portable)
    template_sig = _layout_signature(live)
    if size > 1:
        cand = me if (local is not None and local_step == best) else size
        src = int(_elect(cand, _c.Min, "hvd.resilience.warm.src"))
    else:
        src = 0
    i_am_src = me == src
    spilled = (local["params"] + local["opt"]) if i_am_src else None
    sig = torch.tensor([float(_layout_signature(spilled)) if i_am_src
                        else 0.0], dtype=torch.float64)
    if size > 1:
        sig = _c.broadcast(sig, src, name="hvd.resilience.warm.sig")
    sig_ok = float(sig[0]) == float(template_sig)
    if size > 1:
        sig_ok = StepGuard._global_ok(sig_ok)
    if not sig_ok:
        log.warning(
            "warm restart: spill at step %d (rank %d) does not match the "
            "live state layout; falling back down the recovery ladder",
            best, src)
        if telemetry.enabled():
            telemetry.counter(
                "hvd_warm_restart_layout_mismatch_total",
                "peer recoveries abandoned because the spilled layout "
                "disagreed with the live template").inc()
        return None
    t0 = time.perf_counter()
    values = []
    for i, leaf in enumerate(live):
        value = (spilled[i] if i_am_src else leaf.detach()
                 if torch.is_tensor(leaf) else _host_tensor(leaf))
        if size > 1:
            value = _c.broadcast(value, src,
                                 name=f"hvd.resilience.warm.state.{i}")
        values.append(value)
    it = iter(values)
    got = tree_map(lambda _: next(it), (params, portable))
    new_params = _write_into(params, got[0])
    new_opt = _write_into(opt_state,
                          checkpoint._scatter_zero(got[1], opt_state))
    last_restore["copy_s"] = time.perf_counter() - t0
    extra = dict(local["extra"]) if i_am_src else {}
    if size > 1:
        extra = _broadcast_extra(extra, src, i_am_src)
    return new_params, new_opt, extra


def warm_restore(params, opt_state, *, ckpt_dir: Optional[str] = None,
                 directory: Optional[str] = None):
    """The warm-restart recovery ladder, called on every rank of the new
    world right after it built its state:

    1. **spill**: each rank reads its host's freshest valid spill; the
       newest step wins a Max election and the lowest rank holding it
       broadcasts that state (ZeRO-1 states re-sharded for this world);
    2. **disk**: otherwise the newest intact checkpoint under
       ``ckpt_dir`` (the ``{"params", "opt_state", "step"}`` layout);
    3. **fresh**: otherwise the state passed in.

    Returns ``(params, opt_state, step, source, extra)``: ``source`` is
    ``spill``, ``disk`` or ``fresh``, ``step`` the recovered committed
    step (-1 when fresh) and ``extra`` the spilled
    ``StepGuard.spill_extra`` (empty otherwise).  The recovered values
    are written into the tensors of the state passed in."""
    from horovod_tpu_torch.ops import collective as _c
    t0 = time.perf_counter()
    last_restore.clear()
    directory = spill_dir() if directory is None else directory
    size = basics.size()
    local = best_local_spill(directory) if directory else None
    local_step = local["step"] if local is not None else -1
    if local is not None:
        last_restore.update(read_crc_s=local["read_crc_s"],
                            load_s=local["load_s"])
    best = (int(_elect(local_step, _c.Max, "hvd.resilience.warm.step"))
            if size > 1 else local_step)

    def done(state, step, source, extra):
        last_restore.update(source=source, step=step,
                            total_s=time.perf_counter() - t0)
        return (*state, step, source, extra)

    if best >= 0:
        recovered = _peer_recover(params, opt_state, local, local_step,
                                  best)
        if recovered is not None:
            if telemetry.enabled():
                telemetry.counter(
                    "hvd_warm_restart_peer_recoveries_total",
                    "warm restarts recovered from a peer spill").inc()
            log.info("warm restart: recovered committed step %d from a "
                     "peer spill (no disk checkpoint read)", best)
            return done(recovered[:2], best, "spill", recovered[2])

    if ckpt_dir:
        from horovod_tpu_torch import checkpoint
        found = torch.zeros(1, dtype=torch.int32)
        if basics.rank() == 0 and checkpoint.latest_step(ckpt_dir) \
                is not None:
            found[0] = 1
        if size > 1:
            found = _c.broadcast(found, 0, name="hvd.resilience.warm.disk")
        if int(found[0]):
            template = {"params": params, "opt_state": opt_state, "step": 0}
            state = checkpoint.restore(ckpt_dir, template)
            if telemetry.enabled():
                telemetry.counter(
                    "hvd_warm_restart_disk_fallbacks_total",
                    "warm restarts that fell back to the disk "
                    "checkpoint").inc()
            step = int(state["step"])
            log.info("warm restart: no usable peer spill; restored disk "
                     "checkpoint step %d", step)
            return done((_write_into(params, state["params"]),
                         _write_into(opt_state, state["opt_state"])),
                        step, "disk", {})

    if telemetry.enabled():
        telemetry.counter(
            "hvd_warm_restart_fresh_inits_total",
            "warm restarts with nothing to recover (fresh init)").inc()
    log.info("warm restart: nothing to recover; fresh init")
    return done((params, opt_state), -1, "fresh", {})


# ---------------------------------------------------------------------------
# Heartbeat sender (the worker's half of the launcher's health plane)
# ---------------------------------------------------------------------------

class HeartbeatSender:
    """A daemon thread sending ``{"kind": "heartbeat", rank, step,
    progress_ts, epoch, seq, world_epoch}`` to the launcher's health plane
    every ``interval`` seconds over the authenticated RPC plane: one dial
    with a short timeout and no retry, every failure swallowed, so a slow
    or dead launcher never stalls training.  A reply's ``preempt`` flag
    requests a preemption; its ``reform`` spec is latched for
    :func:`reform_world`.

    The partition fence: a rank that cannot reach the launcher for
    ``HOROVOD_PARTITION_GRACE_SECONDS`` after its first delivered
    heartbeat is the cut-off side of a partition and exits with
    :data:`PREEMPTION_RC`; 0 disables the fence."""

    def __init__(self, addr: str, port: int, key: bytes, rank: int,
                 interval: float):
        self.addr = addr
        self.port = int(port)
        self.key = key
        self.rank = int(rank)
        self.interval = max(0.05, float(interval))
        self.epoch = config.env_int("HOROVOD_COORD_EPOCH")
        # A fresh sender starts after every reform_world re-init, so the
        # membership epoch read once here tells the launcher old-world
        # heartbeats from reformed ones.
        self.world_epoch = config.env_int("HOROVOD_WORLD_EPOCH", 0) or 0
        self.partition_grace = config.env_float(
            "HOROVOD_PARTITION_GRACE_SECONDS")
        self._seq = 0
        self._last_ok: Optional[float] = None   # monotonic, None = never
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="hvd-heartbeat", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _fence_check(self, now: float) -> None:
        """Exit with rc 75 after a whole grace window without launcher
        contact; armed only once a first heartbeat landed."""
        if not self.partition_grace or self._last_ok is None:
            return
        if now - self._last_ok <= self.partition_grace:
            return
        msg = (f"rank {self.rank}: no launcher contact for "
               f"{now - self._last_ok:.0f}s (> partition grace "
               f"{self.partition_grace:g}s); self-fencing with rc "
               f"{PREEMPTION_RC}")
        log.error(msg)
        print(f"horovod_tpu_torch: {msg}", file=sys.stderr, flush=True)
        if telemetry.enabled():
            telemetry.counter(
                "hvd_partition_fences_total",
                "Ranks that self-fenced after losing launcher contact "
                "past the partition grace").inc()
            telemetry.flush()
        os._exit(PREEMPTION_RC)

    def _run(self) -> None:
        from horovod_tpu_torch.runner import rpc
        while not self._stop.wait(self.interval):
            if faults.drop_heartbeat(self.rank):
                if telemetry.enabled():
                    telemetry.counter(
                        "hvd_heartbeat_dropped_total",
                        "heartbeats suppressed by fault injection").inc()
                continue
            step, ts = progress()
            self._seq += 1
            try:
                resp = rpc.rpc_call(
                    self.addr, self.port,
                    {"kind": "heartbeat", "rank": self.rank,
                     "step": step, "progress_ts": ts,
                     "epoch": self.epoch, "seq": self._seq,
                     "world_epoch": self.world_epoch},
                    self.key, timeout=max(1.0, self.interval), retries=0)
                self._last_ok = time.monotonic()
                if telemetry.enabled():
                    telemetry.counter(
                        "hvd_heartbeat_sent_total",
                        "heartbeats delivered to the launcher").inc()
                    if self.rank == 0:
                        telemetry.counter(
                            "hvd_coord_lease_renewals_total",
                            "Coordinator lease renewals (rank 0 "
                            "heartbeats that reached the launcher)").inc()
                if isinstance(resp, dict) and resp.get("reform"):
                    _deliver_reform_spec(resp["reform"])
                if (isinstance(resp, dict) and resp.get("preempt")
                        and not _preempt_event.is_set()):
                    log.warning("launcher requested preemption via the "
                                "health plane")
                    _count_preempt_request()
                    request_preemption()
            except Exception as e:  # noqa: BLE001 (never stall training)
                if telemetry.enabled():
                    telemetry.counter(
                        "hvd_heartbeat_send_failures_total",
                        "heartbeat sends that failed (launcher slow, "
                        "restarting, or gone)").inc()
                log.debug("heartbeat send failed: %s: %s",
                          type(e).__name__, e)
                self._fence_check(time.monotonic())


_heartbeat_sender: Optional[HeartbeatSender] = None
_heartbeat_lock = threading.Lock()


def start_heartbeat(rank: Optional[int] = None
                    ) -> Optional[HeartbeatSender]:
    """Start the heartbeat sender when the launcher runs a health plane
    (``HOROVOD_HEALTH_RPC=addr:port``).  Idempotent for the same rank and
    world; ``hvd.init`` calls it, and a sender of an earlier world (a
    reformed one, or another rank) is stopped and replaced.  Returns the
    sender, or None without a health plane."""
    global _heartbeat_sender
    target = (config.env_str("HOROVOD_HEALTH_RPC") or "").strip()
    if not target:
        return None
    if rank is None:
        rank = config.env_int("HOROVOD_RANK", 0) or 0
    with _heartbeat_lock:
        old = _heartbeat_sender
        if old is not None:
            if (old.rank == int(rank) and old.world_epoch == (
                    config.env_int("HOROVOD_WORLD_EPOCH", 0) or 0)):
                return old
            old.stop()
            _heartbeat_sender = None
        addr, _, port = target.rpartition(":")
        if not addr or not port.isdigit():
            log.warning("HOROVOD_HEALTH_RPC=%r is not addr:port; "
                        "heartbeats disabled", target)
            return None
        try:
            interval = config.env_float("HOROVOD_HEARTBEAT_INTERVAL")
        except ValueError:
            log.warning("HOROVOD_HEARTBEAT_INTERVAL=%r is not a number; "
                        "using 2.0s",
                        config.env_raw("HOROVOD_HEARTBEAT_INTERVAL"))
            interval = 2.0
        from horovod_tpu_torch.runner import rpc
        key = rpc.job_key_bytes(config.env_str("HOROVOD_SECRET_KEY"))
        sender = HeartbeatSender(addr, int(port), key, rank, interval)
        sender.start()
        _heartbeat_sender = sender
        return sender


def stop_heartbeat() -> None:
    global _heartbeat_sender
    with _heartbeat_lock:
        if _heartbeat_sender is not None:
            _heartbeat_sender.stop()
            _heartbeat_sender = None


# ---------------------------------------------------------------------------
# Fail-in-place: the world reformed in-process after a peer died
# (HOROVOD_ON_RANK_FAILURE=shrink|shrink-then-restart)
# ---------------------------------------------------------------------------

_reform_lock = threading.Lock()
_reform_event = threading.Event()
_reform_spec: Optional[dict] = None


def _deliver_reform_spec(spec) -> None:
    """Latch a reformation spec from a heartbeat reply, unless its epoch
    is not beyond the world this process already runs (a late copy of a
    spec already applied would tear the reformed world down)."""
    global _reform_spec
    if not isinstance(spec, dict):
        return
    current = config.env_int("HOROVOD_WORLD_EPOCH", 0) or 0
    if int(spec.get("epoch", 0)) <= current:
        return
    with _reform_lock:
        _reform_spec = dict(spec)
        _reform_event.set()
    log.info("reformation spec received: epoch %s, new rank %s of %s",
             spec.get("epoch"), spec.get("rank"), spec.get("size"))


def _take_reform_spec(timeout: float) -> Optional[dict]:
    global _reform_spec
    if not _reform_event.wait(timeout):
        return None
    with _reform_lock:
        spec, _reform_spec = _reform_spec, None
        _reform_event.clear()
    return spec


def reform_world(params, opt_state, *, ckpt_dir: Optional[str] = None,
                 timeout: Optional[float] = None):
    """Reform the world in-process after a peer died: call it from the
    loop's ``except MembershipChangedError``.

    1. wait for this rank's spec, which the launcher delivers in a
       heartbeat reply (``timeout``, default ``HOROVOD_REFORM_TIMEOUT``);
    2. tear the old world down (``hvd.shutdown``: a broken NCCL world is
       aborted; the old heartbeat beats on until step 4 replaces it);
    3. adopt the spec: rank, size, local and cross topology,
       ``HOROVOD_WORLD_EPOCH``, ``HOROVOD_ELASTIC_PREV_SIZE``, and the
       spec's fresh rendezvous as ``HOROVOD_COORDINATOR_ADDR``;
    4. ``hvd.init`` on the same kind of device (a heartbeat under the new
       rank and world replaces the old one);
    5. recover the state through :func:`warm_restore`.

    Returns what :func:`warm_restore` returns.  Raises ``TimeoutError``
    when no spec arrives in time."""
    if timeout is None:
        timeout = config.env_float("HOROVOD_REFORM_TIMEOUT")
    t0 = time.monotonic()
    spec = _take_reform_spec(float(timeout))
    if spec is None:
        raise TimeoutError(
            f"no reformation spec from the launcher within {timeout:g}s "
            f"(HOROVOD_REFORM_TIMEOUT); falling back to the restart path")
    on_cpu = basics.is_initialized() and basics.device().type == "cpu"
    pre_step = progress()[0]
    basics.shutdown()
    env = {
        "HOROVOD_ELASTIC_PREV_SIZE": spec.get("prev_size",
                                              int(spec["size"]) + 1),
        "HOROVOD_WORLD_EPOCH": spec["epoch"],
        "HOROVOD_RANK": spec["rank"],
        "HOROVOD_SIZE": spec["size"],
        "HOROVOD_LOCAL_RANK": spec["local_rank"],
        "HOROVOD_LOCAL_SIZE": spec["local_size"],
        "HOROVOD_CROSS_RANK": spec.get(
            "cross_rank", int(spec["rank"]) // max(int(spec["local_size"]),
                                                   1)),
        "HOROVOD_CROSS_SIZE": spec.get("cross_size", 1),
        "HOROVOD_COORDINATOR_ADDR": (f"{spec['rendezvous_addr']}:"
                                     f"{spec['rendezvous_port']}"),
    }
    if spec.get("topology"):
        env["HOROVOD_TOPOLOGY"] = spec["topology"]
    os.environ.update({k: str(v) for k, v in env.items()})
    basics.init(device="cpu" if on_cpu else None)
    out = warm_restore(params, opt_state, ckpt_dir=ckpt_dir)
    if telemetry.enabled():
        telemetry.histogram(
            "hvd_failinplace_reformation_seconds",
            "Wall time from membership-change detection to the reformed "
            "world's state recovery completing",
            bounds=telemetry.DEFAULT_TIME_BUCKETS).observe(
            time.monotonic() - t0)
        telemetry.gauge(
            "hvd_failinplace_world_epoch",
            "Membership epoch this rank is running under (0 = never "
            "reformed)").set(int(spec["epoch"]))
        if basics.rank() == 0 and pre_step >= 0 and out[2] >= 0:
            # The new rank 0 only: the merged summary books it once.
            telemetry.counter(
                "hvd_failinplace_steps_lost_total",
                "Steps rolled back by in-process reformations (progress "
                "high-water minus the recovered committed step)").inc(
                max(pre_step - out[2], 0))
    log.info("fail-in-place: reformed world epoch %s as rank %d/%d in "
             "%.2fs (recovered step %d from %s)", spec["epoch"],
             basics.rank(), basics.size(), time.monotonic() - t0, out[2],
             out[3])
    return out


# ---------------------------------------------------------------------------
# Progress and preemption
# ---------------------------------------------------------------------------

_progress_lock = threading.Lock()
_progress_step = -1
_progress_ts = 0.0


def report_progress(step: int) -> None:
    """Record that training reached ``step`` (older steps are ignored);
    :meth:`StepGuard.after_step` calls it."""
    global _progress_step, _progress_ts
    with _progress_lock:
        if step > _progress_step:
            _progress_step = int(step)
            _progress_ts = time.monotonic()


def progress() -> Tuple[int, float]:
    with _progress_lock:
        return _progress_step, _progress_ts


_preempt_event = threading.Event()
_handler_lock = threading.Lock()
_handler_installed = False


def install_preemption_handler(signum: int = signal.SIGTERM) -> None:
    """Turn ``signum`` (default SIGTERM, what schedulers send) into a
    request that :func:`maybe_save_and_exit` acts on at the next step
    boundary.  Idempotent; main thread only."""
    global _handler_installed
    with _handler_lock:
        if _handler_installed:
            return

        def _on_signal(sig, frame):  # noqa: ARG001
            _preempt_event.set()
            _count_preempt_request()

        signal.signal(signum, _on_signal)
        _handler_installed = True


def _count_preempt_request() -> None:
    if telemetry.enabled():
        telemetry.counter(
            "hvd_preempt_requests_total",
            "preemption signals received").inc()


def preemption_requested() -> bool:
    return _preempt_event.is_set()


def request_preemption() -> None:
    """What receiving the preemption signal does, for callers with their
    own signal handling."""
    _preempt_event.set()


def exit_preempted() -> None:
    """Exit with :data:`PREEMPTION_RC` through ``sys.exit``, so the
    atexit hooks (the async checkpoint drain) still run."""
    log.warning("exiting with preemption rc %d (reschedule, do not "
                "blacklist)", PREEMPTION_RC)
    sys.exit(PREEMPTION_RC)


def maybe_save_and_exit(ckpt_dir: str, state, step: int) -> bool:
    """Call at every step boundary: False unless a preemption was
    requested; then every rank drains any async write, takes part in a
    synchronous :func:`~horovod_tpu_torch.checkpoint.save` and exits with
    :data:`PREEMPTION_RC`."""
    if not _preempt_event.is_set():
        return False
    from horovod_tpu_torch import checkpoint
    log.warning("preemption requested: coordinated save at step %d to %s",
                step, ckpt_dir)
    report_progress(step)
    checkpoint.wait_for_async_save()
    checkpoint.save(ckpt_dir, state, step=step)
    if telemetry.enabled():
        telemetry.counter(
            "hvd_preempt_saves_total",
            "coordinated preemption saves completed").inc()
    exit_preempted()
    return True  # pragma: no cover (sys.exit above)


def _reset_for_tests() -> None:
    """Clear the preemption flag, the handler marker, the progress, the
    heartbeat sender and any latched reformation spec."""
    global _handler_installed, _progress_step, _progress_ts, _reform_spec
    _preempt_event.clear()
    with _handler_lock:
        _handler_installed = False
    with _progress_lock:
        _progress_step = -1
        _progress_ts = 0.0
    stop_heartbeat()
    with _reform_lock:
        _reform_spec = None
        _reform_event.clear()
