"""Self-healing training: the step guard, last-known-good rollback, the
divergence sentinel and the preemption protocol.

Counterpart of ``horovod_tpu/resilience.py``: ``guard_policy``
(``:130``), ``all_finite`` (``:159``), ``apply_step_guard`` (``:178``),
``tree_digest`` (``:254``), ``_divergent_ranks`` (``:266``),
``LastKnownGood`` (``:280``), ``GuardEvent`` and ``StepGuard``
(``:356-554``), ``_broadcast_state`` (``:573``), ``report_progress`` and
``progress`` (``:920``), and the preemption functions (``:1259-1327``).

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
* **Preemption**: :func:`install_preemption_handler` turns SIGTERM into a
  flag; :func:`maybe_save_and_exit` saves a checkpoint at the next step
  boundary and exits with :data:`PREEMPTION_RC` (75), which the launcher
  reschedules without blacklisting.

State is a tree as :mod:`horovod_tpu_torch.tree` walks it.  A
rollback or a heal writes into the tensors of the state passed in (a
module's parameters and an optimizer's buffers stay the objects they
hold) and returns that state.  Not ported here: the warm-restart spill
and its recovery election, the heartbeat sender and ``reform_world``
(reference ``:556-1250``), and the ``hvd_guard_*``/``hvd_rollback_*``/
``hvd_sentinel_*`` counters (the port has no telemetry registry yet).
"""

from __future__ import annotations

import logging
import signal
import sys
import threading
import time
import zlib
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import basics, config
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
        leaves = tree_leaves(tree)
        if not _all_finite_leaves(leaves):
            self._staged = None
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
        return True

    def commit(self) -> None:
        if self._staged is None:
            return
        old = self._committed
        self._committed, self._staged = self._staged, None
        if old is not None:
            self._spare = old[2]

    def discard_stage(self) -> None:
        if self._staged is not None:
            self._spare = self._staged[2]
        self._staged = None

    def restore(self, into=None) -> Tuple[Any, Any, int]:
        """The committed snapshot as ``(params, opt_state, step)``: fresh
        tensors on the devices the state was staged from, or, with
        ``into=(params, opt_state)`` of the same structure, written into
        those tensors (and returned)."""
        if self._committed is None:
            raise RuntimeError("no last-known-good snapshot available")
        step, template, buf, others = self._committed
        tensors = iter(buf.views)
        rest = iter(others)

        def other(leaf):
            value = next(rest)
            return type(leaf)(value) if np.isscalar(leaf) else value.copy()

        def fresh(leaf):
            if torch.is_tensor(leaf):
                return next(tensors).to(leaf.device, copy=True)
            return other(leaf)

        def write(leaf, live):
            if not torch.is_tensor(leaf):
                return other(leaf)
            src = next(tensors)
            if not torch.is_tensor(live):
                return src.to(leaf.device, copy=True)
            with torch.no_grad():
                live.copy_(src, non_blocking=True)
            return live

        if into is None:
            params, opt_state = tree_map(fresh, template)
        else:
            params, opt_state = tree_map(write, template, tuple(into))
        for dev in {v.device for v in tree_leaves((params, opt_state))
                    if torch.is_tensor(v) and v.is_cuda}:
            torch.cuda.synchronize(dev)
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
    digests are compared.  Unlike the reference's, this guard keeps no
    warm-restart spill (it takes no spill directory)."""

    def __init__(self, policy: Optional[str] = None,
                 sentinel_interval: Optional[int] = None,
                 snapshot_interval: Optional[int] = None,
                 nan_burst: Optional[int] = None):
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
        message = (f"divergence sentinel at step {step}: replica digests "
                   f"disagree; diverging rank(s): {bad}")
        if self.policy != "rollback":
            log.error("%s", message)
            raise DivergenceError(message, bad)
        source = min(r for r in range(basics.size()) if r not in bad)
        log.error("%s; healing by re-broadcasting state from rank %d",
                  message, source)
        params, opt_state = _broadcast_state(params, opt_state, source)
        return params, opt_state, GuardEvent("heal", step)

    def after_step(self, params, opt_state, step: int, loss):
        """Validate one completed step; returns ``(params, opt_state,
        GuardEvent)``, the state possibly the restored last-known-good.
        Every rank calls it for every step."""
        report_progress(step)
        if self.policy == "off" and self.sentinel_interval == 0:
            return params, opt_state, GuardEvent("ok", step)
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
        log.warning("step guard: non-finite step %d skipped (streak %d)",
                    step, self._bad_streak)
        return params, opt_state, GuardEvent("skip", step)


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

        signal.signal(signum, _on_signal)
        _handler_installed = True


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
    exit_preempted()
    return True  # pragma: no cover (sys.exit above)


def _reset_for_tests() -> None:
    """Clear the preemption flag, the handler marker and the progress."""
    global _handler_installed, _progress_step, _progress_ts
    _preempt_event.clear()
    with _handler_lock:
        _handler_installed = False
    with _progress_lock:
        _progress_step = -1
        _progress_ts = 0.0
