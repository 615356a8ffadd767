"""Checkpoints: rank 0 writes, every rank restores the same state.

Counterpart of ``horovod_tpu/checkpoint.py``: ``save`` (``:126``),
``save_async`` and ``wait_for_async_save`` (``:180-318``), ``restore``
(``:321``), ``load_local`` (``:375``), ``latest_step`` and
``_valid_steps`` (``:90``).

    state = {"params": params, "opt_state": opt_state, "step": step}
    hvd.checkpoint.save(ckpt_dir, state, step=step)     # rank 0 writes
    state = hvd.checkpoint.restore(ckpt_dir, state)     # read + broadcast

A state is a tree of dicts (walked in sorted key order), lists, tuples
and NamedTuples whose leaves are tensors, numpy arrays or Python
numbers, as the reference's pytrees.  The reference writes with orbax;
the port writes one torch state dict a step, ``<ckpt_dir>/<step>/
state.pt``, keyed by each leaf's path.  The write goes to
``<step>.tmp-*`` first and is committed by an atomic rename, so a save
killed half way leaves a ``tmp`` directory that :func:`_valid_steps`
skips, as the reference skips orbax's.  Files are read with
``torch.load(weights_only=True)``: tensors and plain containers only, no
arbitrary objects.

ZeRO-1 optimizer states (:class:`~horovod_tpu_torch.parallel.zero.
ZeroShardedState`) are written in the full per-leaf layout
(``zero.gather_full_state``, collective over the state's group, so every
rank takes part in ``save`` and ``restore``) and re-sharded on restore
into the template's layout (``zero.scatter_full_state``): a checkpoint
saved at N ranks restores at any other count.
"""

from __future__ import annotations

import atexit
import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch import basics, telemetry
from horovod_tpu_torch.ops import collective as _c
from horovod_tpu_torch.tree import tree_leaves_with_path, tree_map
from horovod_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

STATE_FILE = "state.pt"


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _as_tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor."""
    if torch.is_tensor(leaf):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def _like(value: torch.Tensor, template):
    """``value`` in the template leaf's type, dtype, shape and device."""
    if torch.is_tensor(template):
        if tuple(value.shape) != tuple(template.shape):
            raise ValueError(f"shape {tuple(value.shape)} where the "
                             f"template has {tuple(template.shape)}")
        return value.to(device=template.device, dtype=template.dtype)
    arr = np.asarray(template)
    got = value.cpu().numpy()
    if got.shape != arr.shape:
        raise ValueError(f"shape {got.shape} where the template has "
                         f"{arr.shape}")
    if isinstance(template, np.ndarray) or isinstance(template,
                                                      np.generic):
        return got.astype(arr.dtype)
    return type(template)(got.item())


# ---------------------------------------------------------------------------
# ZeRO-1 states in the full layout
# ---------------------------------------------------------------------------

def _is_zero(x) -> bool:
    from horovod_tpu_torch.parallel import zero
    return zero.is_zero_state(x)


def _gather_zero(state: Any) -> Any:
    """Every ZeRO-1 sharded optimizer state in ``state`` replaced by its
    replicated per-leaf layout (collective over each state's group)."""
    from horovod_tpu_torch.parallel import zero
    return tree_map(lambda x: zero.gather_full_state(x) if _is_zero(x)
                    else x, state, is_leaf=_is_zero)


def _scatter_zero(state: Any, template: Any) -> Any:
    """Inverse of :func:`_gather_zero`: wherever ``template`` holds a
    ZeRO-1 state, the restored replicated layout re-sharded into the
    template's plan (no collective)."""
    from horovod_tpu_torch.parallel import zero
    return tree_map(lambda t, s: zero.scatter_full_state(s, like=t)
                    if _is_zero(t) else s, template, state,
                    is_leaf=_is_zero)


# ---------------------------------------------------------------------------
# The files
# ---------------------------------------------------------------------------

def _valid_steps(ckpt_dir: str) -> list:
    """Steps with a committed checkpoint directory, ascending.  A save
    killed before its rename leaves a ``tmp`` directory, and a committed
    directory may have lost its payload: both are skipped with a warning,
    so a restart resumes from the newest intact step."""
    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return []
    steps = []
    for entry in sorted(entries):
        path = os.path.join(ckpt_dir, entry)
        if not os.path.isdir(path):
            continue
        if not entry.isdigit():
            if "tmp" in entry:
                log.warning(
                    "skipping half-written checkpoint %s (temporary "
                    "directory left by an interrupted save)", path)
            continue
        try:
            empty = not os.listdir(path)
        except OSError:
            empty = True
        if empty:
            log.warning("skipping corrupt checkpoint %s: directory is "
                        "empty", path)
            continue
        steps.append(int(entry))
    return sorted(steps)


def _host_dict(state, copy: bool = False) -> dict:
    """The state dict a step's file holds: every leaf by its path, as a
    CPU tensor (a copy of its own if ``copy``: the caller's training
    goes on changing the live tensors)."""
    return {_key(p): _as_tensor(leaf).to("cpu", copy=copy)
            for p, leaf in tree_leaves_with_path(state)}


def _write(ckpt_dir: str, step: int, tensors: dict,
           max_to_keep: Optional[int]) -> str:
    """Write ``tensors`` as step ``step``: a ``tmp`` directory, then an
    atomic rename; older steps past ``max_to_keep`` are removed."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(step))
    tmp = os.path.join(ckpt_dir, f"{step}.tmp-{os.getpid()}-"
                                 f"{threading.get_ident()}")
    os.makedirs(tmp)
    torch.save(tensors, os.path.join(tmp, STATE_FILE))
    if os.path.exists(final):
        old = tmp + ".replaced"
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)
    if max_to_keep:
        for s in _valid_steps(ckpt_dir)[:-max_to_keep]:
            shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)
    return final


def _read(ckpt_dir: str, step: int, template):
    """Step ``step`` in the template's structure; raises if the file is
    missing, corrupt or does not fit the template."""
    saved = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                       map_location="cpu", weights_only=True)
    if not isinstance(saved, dict):
        raise ValueError(f"{STATE_FILE} holds a {type(saved).__name__}, "
                         f"not a state dict")
    paths = tree_leaves_with_path(template)
    missing = [_key(p) for p, _ in paths if _key(p) not in saved]
    if missing:
        raise KeyError(f"leaves missing from the checkpoint: {missing[:5]}")
    values = iter([_like(saved[_key(p)], leaf) for p, leaf in paths])
    return tree_map(lambda _: next(values), template)


def _candidates(ckpt_dir: str, step: Optional[int]) -> list:
    # Newest first; a pinned step is tried alone: falling back to another
    # step than the one asked for would be silently wrong.
    return [step] if step is not None else list(reversed(_valid_steps(
        ckpt_dir)))


def _skip_warning(use_step, ckpt_dir, e, step) -> None:
    log.warning("skipping unrestorable checkpoint step %s in %s (%s: %s); "
                "%s", use_step, ckpt_dir, type(e).__name__, e,
                "trying the next older step" if step is None
                else "starting fresh")


# ---------------------------------------------------------------------------
# The API
# ---------------------------------------------------------------------------

def save(ckpt_dir: str, state: Any, step: int = 0,
         max_to_keep: Optional[int] = None) -> Optional[str]:
    """Write ``state`` to ``ckpt_dir/<step>``: rank 0 writes, and every
    rank waits on rank 0's success flag (a broadcast), so no rank runs
    ahead onto a half-written checkpoint.  Returns the path on rank 0 if
    the write succeeded, else None.  A write that raises on rank 0 is
    logged and broadcast as a failure: every rank returns None and none
    waits forever.  Any :func:`save_async` write in flight is drained
    first; ZeRO-1 states are gathered (collective) before the write."""
    wait_for_async_save()
    state = _gather_zero(state)
    path = None
    ok = torch.zeros(1, dtype=torch.int32)
    if basics.rank() == 0:
        try:
            ckpt_dir = os.path.abspath(ckpt_dir)
            t0 = telemetry.clock() if telemetry.enabled() else 0.0
            path = _write(ckpt_dir, step, _host_dict(state), max_to_keep)
            ok[0] = 1
            if telemetry.enabled():
                telemetry.counter("hvd_checkpoint_saves_total",
                                  "Checkpoints written by rank 0").inc()
                telemetry.histogram(
                    "hvd_checkpoint_save_seconds",
                    "Wall time of a rank-0 checkpoint save").observe(
                    telemetry.clock() - t0)
            log.info("checkpoint step %d written to %s", step, path)
        except Exception as e:  # noqa: BLE001 (degrade, never deadlock)
            log.error("checkpoint save step %d to %s FAILED (%s: %s); "
                      "continuing without a checkpoint", step, ckpt_dir,
                      type(e).__name__, e)
            if telemetry.enabled():
                telemetry.counter(
                    "hvd_checkpoint_save_failures_total",
                    "rank-0 checkpoint writes that raised").inc()
    if basics.size() > 1:
        ok = _c.broadcast(ok, 0, name=f"hvd.checkpoint.save.ok.{step}")
    return path if int(ok[0]) else None


class _AsyncSave:
    """One background checkpoint write in flight (rank 0 only)."""

    __slots__ = ("thread", "step", "path", "error", "seconds")

    def __init__(self, step: int):
        self.thread = None
        self.step = step
        self.path = None
        self.error = None
        self.seconds = None


_async_lock = threading.Lock()
_async_current: Optional[_AsyncSave] = None
_async_atexit_registered = False
last_async_write_seconds: Optional[float] = None


def save_async(ckpt_dir: str, state: Any, step: int = 0,
               max_to_keep: Optional[int] = None) -> Optional[str]:
    """CheckFreq-style asynchronous save: copy ``state`` to host memory
    now (the part that blocks the step), then write it on a background
    thread.  Returns the eventual path on rank 0, None elsewhere.  At
    most one write is in flight (the previous one is drained first, and
    at exit).  No flag is broadcast: only rank 0 touches the directory,
    and the rename commits the step.  A failure is logged when the write
    is drained, never raised.  ZeRO-1 states are gathered on every
    rank first (collective)."""
    global _async_current, _async_atexit_registered
    wait_for_async_save()
    state = _gather_zero(state)
    if basics.rank() != 0:
        return None
    t_snap = telemetry.clock() if telemetry.enabled() else 0.0
    snapshot = _host_dict(state, copy=True)
    if telemetry.enabled():
        telemetry.histogram(
            "hvd_ckpt_async_snapshot_seconds",
            "device->host snapshot time per async save (the only part "
            "that blocks the step)").observe(telemetry.clock() - t_snap)
    ckpt_dir = os.path.abspath(ckpt_dir)
    record = _AsyncSave(step)

    def _run():
        t0 = time.perf_counter()
        try:
            record.path = _write(ckpt_dir, step, snapshot, max_to_keep)
            log.info("async checkpoint step %d written to %s", step,
                     record.path)
            if telemetry.enabled():
                telemetry.counter(
                    "hvd_ckpt_async_saves_total",
                    "background checkpoint writes completed").inc()
                telemetry.histogram(
                    "hvd_ckpt_async_write_seconds",
                    "background orbax write time per async save").observe(
                    time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 (reported when drained)
            record.error = e
            if telemetry.enabled():
                telemetry.counter(
                    "hvd_ckpt_async_failures_total",
                    "background checkpoint writes that raised").inc()
        record.seconds = time.perf_counter() - t0

    record.thread = threading.Thread(
        target=_run, name=f"hvd-ckpt-async-{step}", daemon=True)
    with _async_lock:
        _async_current = record
        if not _async_atexit_registered:
            atexit.register(wait_for_async_save)
            _async_atexit_registered = True
    record.thread.start()
    return os.path.join(ckpt_dir, str(step))


def wait_for_async_save(timeout: Optional[float] = None) -> Optional[str]:
    """Drain the :func:`save_async` write in flight, if any: its path, or
    None (nothing in flight, it failed, or it is still writing after
    ``timeout`` seconds).  A failure is logged here."""
    global _async_current, last_async_write_seconds
    with _async_lock:
        record, _async_current = _async_current, None
    if record is None or record.thread is None:
        return None
    record.thread.join(timeout)
    if record.thread.is_alive():
        with _async_lock:
            if _async_current is None:
                _async_current = record
        log.warning("async checkpoint step %d still writing after %.1fs "
                    "wait", record.step, timeout or 0.0)
        return None
    last_async_write_seconds = record.seconds
    if record.error is not None:
        log.error("async checkpoint save step %d FAILED (%s: %s); "
                  "continuing without it", record.step,
                  type(record.error).__name__, record.error)
        return None
    return record.path


def _tree_broadcast(tree: Any, root_rank: int, prefix: str) -> Any:
    """Every leaf of ``tree`` from ``root_rank``, named by its path so the
    names agree across ranks; each leaf keeps its type and device."""
    out = []
    for path, leaf in tree_leaves_with_path(tree):
        t = _c.broadcast(_as_tensor(leaf), root_rank,
                         name=f"{prefix}.{_key(path)}")
        out.append(_like(t, leaf))
    values = iter(out)
    return tree_map(lambda _: next(values), tree)


def restore(ckpt_dir: str, state_template: Any, step: Optional[int] = None,
            root_rank: int = 0) -> Any:
    """The newest intact (or the ``step``-th) checkpoint, read on
    ``root_rank`` and broadcast leaf by leaf to every rank;
    ``state_template`` (the freshly initialized state) gives the
    structure, dtypes and devices.  A step that cannot be read is
    skipped with a warning for the next older one; a pinned ``step``
    does not fall back.  With nothing restorable every rank gets the
    template.  ZeRO-1 states come back in the template's layout."""
    portable = _gather_zero(state_template)
    state = portable
    found = torch.zeros(1, dtype=torch.int32)
    t0 = telemetry.clock() if telemetry.enabled() else 0.0
    if basics.rank() == root_rank:
        ckpt_dir = os.path.abspath(ckpt_dir)
        for use_step in _candidates(ckpt_dir, step):
            try:
                state = _read(ckpt_dir, use_step, portable)
                found[0] = 1
                log.info("restored checkpoint step %s from %s", use_step,
                         ckpt_dir)
                break
            except Exception as e:  # noqa: BLE001 (skip and warn)
                state = portable
                _skip_warning(use_step, ckpt_dir, e, step)
    if basics.size() > 1:
        found = _c.broadcast(found, root_rank,
                             name="hvd.checkpoint.restore.found")
        if int(found[0]):
            state = _tree_broadcast(state, root_rank,
                                    "hvd.checkpoint.restore")
    state = _scatter_zero(state, state_template)
    if telemetry.enabled():
        telemetry.counter(
            "hvd_checkpoint_restores_total",
            "Checkpoint restore attempts (including broadcast)",
            found=str(bool(int(found[0])))).inc()
        telemetry.histogram(
            "hvd_checkpoint_restore_seconds",
            "Wall time of restore + cross-rank broadcast").observe(
            telemetry.clock() - t0)
    return state


def load_local(ckpt_dir: str, state_template: Any,
               step: Optional[int] = None):
    """The newest intact (or the ``step``-th) checkpoint from local disk,
    with no collective: ``(state, used_step)``, or ``(state_template,
    None)`` when nothing is restorable.  For replicated states (a serving
    replica reads its own copy); ZeRO-1 states are :func:`restore`'s."""
    if not os.path.isdir(ckpt_dir):
        return state_template, None
    ckpt_dir = os.path.abspath(ckpt_dir)
    for use_step in _candidates(ckpt_dir, step):
        try:
            state = _read(ckpt_dir, use_step, state_template)
            log.info("loaded checkpoint step %s locally from %s", use_step,
                     ckpt_dir)
            return state, int(use_step)
        except Exception as e:  # noqa: BLE001 (skip and warn)
            _skip_warning(use_step, ckpt_dir, e, step)
    return state_template, None


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest intact step in ``ckpt_dir`` (local read, no
    collective), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _valid_steps(ckpt_dir)
    return steps[-1] if steps else None
