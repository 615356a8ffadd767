"""The background runtime: negotiate by name, fuse, launch.

Counterpart of the reference's background loop
(``horovod_tpu/native/cc/src/operations.cc`` ``BackgroundThread`` and
``ExecuteResponse``, behind ``horovod_tpu/native/runtime.py``).  Every
eager ``hvd.*`` collective becomes a :class:`TensorEntry` in this rank's
:class:`TensorQueue`.  One thread per process runs lock-step cycles, at
most one every ``HOROVOD_CYCLE_TIME`` ms (at once while entries wait):

1. take the entries submitted since the last cycle and turn them into
   requests, or into response-cache bits for names negotiated before;
2. exchange them over the control group, a gloo group of its own: rank 0
   gathers every rank's list, runs the :class:`Controller` and broadcasts
   its :class:`ResponseList` (at size 1 there is nothing to exchange);
3. refresh the cache, fuse the list (the same walk on every rank) and
   launch each response on its data group, in that order.

The data groups are the runtime's own (``dist.new_group``: a communicator
no other thread issues onto), one for the job and one per process set,
NCCL on the card and gloo when the caller asked for the CPU.  On the card
the thread runs on its own stream, which waits on each entry's ready
event; the caller's stream waits on the collective and on the thread's
stream before it reads a result.

A rank that has joined takes part in every global collective it holds no
entry for, with zeros of the response's sizes.  An error response fails
its names with ``RuntimeError(<message>)`` and the runtime goes on.  If
the thread dies (an exchange fails because a peer left, or anything
else raises), every pending and later entry fails with that error:
nothing falls back to another route.  Under ``HOROVOD_ON_RANK_FAILURE``
``shrink`` or ``shrink-then-restart`` a failure that means a peer left (a
connection closed, reset or timed out, a remote abort: :func:`peer_lost`)
is a :class:`MembershipChangedError` instead, whether the exchange, a
data-group collective or a wait met it, and so is every failure once one
has been seen (reference ``native/runtime.py:58``, ``:990-1004``): the
caller reforms the world (``resilience.reform_world``).  Any other
failure keeps its plain error and its logged traceback.

The plane's own instruments (reference ``native/runtime.py:837-953``,
``operations.cc``): under ``HOROVOD_EAGER_OP_TIMEOUT`` a wait raises
:class:`EagerStallError` at its deadline, naming the tensor, this rank
and every peer as a suspect; a watchdog thread warns about every op in
flight past ``HOROVOD_EAGER_OP_WARN_SECONDS``, again each interval,
without touching the completion path.  On rank 0, ``HOROVOD_TIMELINE``
starts the timeline (:mod:`.timeline`) and ``HOROVOD_AUTOTUNE`` the
tuner (:mod:`.autotune`), whose parameters ride every response list and
are applied by every rank before it fuses that list.  The fusion
threshold that framework code buckets by follows the tuner only
through :meth:`Runtime.sync_tuned_config`, a collective.

The control plane's last parts (``controller.cc``): under
``HOROVOD_SCHEDULE_CHECK`` every list carries this rank's submission
records, its count and its digest, and a coordinator's abort fails every
pending entry with the report and stops the thread; under
``HOROVOD_COORD_TREE`` the exchange goes member -> host leader -> master
and back (:mod:`.coord_tree`).

The two-level plane (``HOROVOD_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER``,
reference ``native/runtime.py:374-382``, ``:483-487``, ``:525-546``):
``init`` agrees on it before the thread starts
(:func:`data_plane.agree_hierarchy`), and the global set's fused
allreduce and allgather at or above the agreed threshold take it, on
every rank alike.  The tuner may flip its two booleans where it is
available; they are applied with the other tuned parameters, and
:meth:`Runtime.sync_tuned_config` ANDs them over the ranks.

Telemetry (reference ``native/runtime.py:800-1020``), host-side only:
with any telemetry consumer on, a submission records its SUBMIT span and
timeline row, and the return of its wait (``TensorEntry.result``) the
op's count, latency and bytes (``observe_op``),
``hvd_native_wait_seconds``, the ``wait`` span and the timeline's WAIT
and FINISH; failed waits count in ``hvd_eager_op_errors_total``, stalls
and watchdog warnings in ``hvd_eager_stalls_total`` and
``hvd_eager_stall_warnings_total``.  The gauges (the tuned
configuration, the schedule check, the tree, the membership) are
published at start, by the watchdog and at stop.  Nothing here waits on
the device.
"""

from __future__ import annotations

import datetime
import functools
import itertools
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import config, faults, telemetry
from horovod_tpu_torch.native import data_plane
from horovod_tpu_torch.native.autotune import ParameterManager
from horovod_tpu_torch.native.controller import Controller, fuse
from horovod_tpu_torch.native.coord_tree import TreeGroups
from horovod_tpu_torch.native.message import (OP_NAMES, SCHED_DIGEST_INIT,
                                              OpType, ReduceOp, RequestList,
                                              Response, ResponseList,
                                              TunedParams, sched_fold)
from horovod_tpu_torch.native.response_cache import ResponseCache
from horovod_tpu_torch.native.stall_inspector import StallInspector
from horovod_tpu_torch.native.tensor_queue import (SHUTDOWN_ERROR,
                                                   TensorEntry, TensorQueue)
from horovod_tpu_torch.native.timeline import (AllOf, Completions,
                                               DeviceClock, DeviceStamp,
                                               Timeline)
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops._build import CallCounter
from horovod_tpu_torch.utils.logging import get_logger

log = get_logger("horovod_tpu_torch.runtime")

# One count per entry submitted to any runtime of this process: the
# direct path (fused_psum, the train steps) never adds to it.
requests = CallCounter("runtime.requests")

# How long shutdown waits for every rank to agree before it gives up on
# the thread (a peer that never shuts down, or one that died).
SHUTDOWN_TIMEOUT_S = 30.0
# The control group's timeout: every rank's thread cycles all the time,
# whatever its main thread does, so an exchange that waits this long
# means a peer's runtime is gone; the exchange then raises.
CONTROL_TIMEOUT = datetime.timedelta(seconds=60)


SHRINK_POLICIES = ("shrink", "shrink-then-restart")

# What gloo, NCCL and the store say when the other end of a connection is
# gone: closed, reset or refused, a broken pipe, a timed-out wait, a
# remote abort.
_PEER_LOSS_WORDS = ("connection closed", "closed by peer",
                    "connection reset", "connection refused", "broken pipe",
                    "timed out", "timeout", "remote process",
                    "ncclremoteerror", "aborted")


def peer_lost(exc: BaseException) -> bool:
    """True when ``exc`` is the failure a dead peer causes."""
    kinds = (ConnectionError, TimeoutError) + tuple(
        k for k in (getattr(dist, "DistNetworkError", None),
                    getattr(dist, "DistStoreError", None)) if k is not None)
    if isinstance(exc, kinds):
        return True
    text = str(exc).lower()
    return any(w in text for w in _PEER_LOSS_WORDS)


class EagerStallError(RuntimeError):
    """An eager op outlived ``HOROVOD_EAGER_OP_TIMEOUT`` (reference
    ``native/runtime.py:48``): the message names the stuck tensor, this
    rank and the suspected missing ranks."""


class MembershipChangedError(RuntimeError):
    """The collective world changed under this op: a peer died and
    ``HOROVOD_ON_RANK_FAILURE`` allows in-process reformation.  The
    caller (``resilience.reform_world``) tears the old world down,
    re-inits on the launcher's reformation spec and recovers the state
    from the warm-restore ladder instead of exiting."""


class Runtime:
    """This process's control plane over ``ctrl_group`` (gloo) and
    ``data_group``, for hvd rank ``rank`` of ``size``.  ``global_ranks``
    maps hvd ranks to ``torch.distributed`` ranks; ``subset`` says the
    job is a rank subset of the launched processes (``init(ranks=...)``),
    whose processes outside it never create a group of the job's."""

    def __init__(self, rank: int, size: int, ctrl_group, data_group,
                 global_ranks: Sequence[int], device: torch.device,
                 subset: bool = False, tree: Optional[TreeGroups] = None,
                 hier: Optional[data_plane.Hierarchy] = None):
        self.rank, self.size = rank, size
        # The agreed two-level plane (None: not available), and the
        # reference's counters of both paths.
        self.hier = hier
        self.hier_counters = (hier.counters if hier is not None else
                              dict.fromkeys(data_plane.HIER_COUNTERS, 0))
        self.device = device
        self.ctrl_group = ctrl_group
        self.global_ranks = list(global_ranks)
        self.subset = subset
        self.queue = TensorQueue()
        self.cache = ResponseCache(config.cache_capacity())
        self.cache_enabled = self.cache.enabled
        self.cache_lookups = self.cache_hits = 0
        self.fusion_threshold = fusion.env_fusion_threshold_bytes()
        self.cycle_time_s = config.cycle_time_ms() / 1000.0
        self.exploring = False
        self.tree = tree
        self.schedule_check = config.env_bool("HOROVOD_SCHEDULE_CHECK")
        self.sched_submissions = self.sched_divergences = 0
        self._sched_digest, self._sched_seq = SCHED_DIGEST_INIT, 0
        self._abort: Optional[BaseException] = None
        self._trace_cycle = 0
        self.controller = Controller(
            size, self.cache, StallInspector(
                config.stall_check_seconds(),
                config.stall_shutdown_seconds()),
            schedule_check=self.schedule_check,
            sched_quiet_s=config.env_float(
                "HOROVOD_SCHEDULE_CHECK_QUIET_SECONDS"),
            tree=tree is not None)
        self.groups: Dict[int, data_plane.DataGroup] = {
            0: data_plane.DataGroup(data_group, range(size), rank,
                                    self.global_ranks, device)}
        self.joined = False
        self.shrink = (config.env_str("HOROVOD_ON_RANK_FAILURE").strip()
                       .lower() in SHRINK_POLICIES)
        self.membership_changed = False
        self.cycles = 0
        self.busy_cycles = 0
        self.cycle_seconds = 0.0
        self._shutting_down = False
        self._wake = threading.Event()
        self._stream = None
        self._clock: Optional[DeviceClock] = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="hvd-torch-runtime")
        # The eager-op deadline and the watchdog's in-flight entries.
        self.op_timeout = config.env_float("HOROVOD_EAGER_OP_TIMEOUT")
        self.op_warn = config.env_float("HOROVOD_EAGER_OP_WARN_SECONDS")
        # Weak: the watchdog must keep no entry, and so none of its
        # tensors and buffers, alive after its caller has let it go.
        self._inflight: weakref.WeakValueDictionary = (
            weakref.WeakValueDictionary())
        self._inflight_seq = itertools.count()
        self._inflight_lock = threading.Lock()
        self._watchdog_stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        if self.op_warn or telemetry.enabled():
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True, name="hvd-torch-watchdog")
        # Rank 0's instruments: the timeline and the tuner, and the thread
        # that stamps when the card finished what they record.
        self._sync_seq = 0
        self._agreed_fusion_threshold: Optional[int] = None
        self.completions: Optional[Completions] = None
        self.timeline: Optional[Timeline] = None
        self.tuner: Optional[ParameterManager] = None
        self._tuner_lock = threading.Lock()
        path = config.env_str("HOROVOD_TIMELINE")
        tune = config.env_bool("HOROVOD_AUTOTUNE")
        if rank == 0 and (path or tune):
            self.completions = Completions()
            try:
                if path:
                    self.timeline = Timeline(
                        path, config.env_bool("HOROVOD_TIMELINE_MARK_CYCLES"),
                        self.completions)
                if tune:
                    self.tuner = ParameterManager(
                        rank, self.cycle_time_s * 1000.0,
                        self.fusion_threshold, self.cache_enabled,
                        self.hierarchical_enabled(),
                        self.hierarchical_allgather_enabled(),
                        hier is not None)
                    self.exploring = True
            except BaseException:
                self._close_instruments()
                raise

    # -- caller side ------------------------------------------------------------

    def start(self) -> None:
        fusion.set_live_threshold_provider(self._live_fusion_threshold)
        telemetry.register_metrics_flush_hook(self.publish_gauges)
        self.publish_gauges()
        if self._watchdog is not None:
            self._watchdog.start()
        self.thread.start()

    def coord_tree_enabled(self) -> bool:
        """True when tree coordination is active (reference
        ``native/runtime.py:402-409``); False in flat mode, the two
        fallbacks included."""
        return self.tree is not None

    def hierarchical_enabled(self) -> bool:
        """True while the global set's fused allreduces take the two-level
        plane (the agreement's answer, then the tuner's)."""
        return self.hier is not None and self.hier.allreduce

    def hierarchical_allgather_enabled(self) -> bool:
        """True while its allgathers do."""
        return self.hier is not None and self.hier.allgather

    def submit(self, entries: Sequence[TensorEntry], kind: str) -> None:
        """File ``entries`` for the next cycle (a short append).  Each
        entry passes the ``native_submit`` fault site first."""
        for e in entries:
            faults.inject("native_submit", e.name, rank=self.rank)
        now = time.monotonic()
        for e in entries:
            if self.shrink:
                e.on_error = self._membership_error
            if self.op_timeout is not None:
                e.timeout = self.op_timeout
                e.on_timeout = functools.partial(self._stall_error,
                                                 op=OP_NAMES[e.op_type])
            e.submitted_at = now
        self.queue.add(entries, kind)
        if telemetry.active():
            self._record_submit(entries, now)
        if self.op_warn:
            with self._inflight_lock:
                for e in entries:
                    self._inflight[next(self._inflight_seq)] = e
        requests.count += len(entries)
        self._wake.set()

    def wait(self, e: TensorEntry):
        """``e``'s raw result, waited for (:meth:`TensorEntry.result`)
        after the ``native_wait`` fault site."""
        faults.inject("native_wait", e.name, rank=self.rank)
        return e.result()

    # -- telemetry ----------------------------------------------------------------

    def _record_submit(self, entries: Sequence[TensorEntry],
                       t0: float) -> None:
        """The SUBMIT span and timeline row of each entry, its trace
        occurrence, and the hook its wait reports to."""
        t1 = time.monotonic()
        sp, tl = telemetry.spans(), telemetry.timeline()
        for e in entries:
            op, nbytes = OP_NAMES[e.op_type], _nbytes(e)
            e.telemetry, e.enqueued_at = self, t1
            if sp is not None:
                e.trace_seq = sp.next_seq(e.name)
                sp.record(e.name, "submit", e.trace_seq, t0, t1, nbytes)
            if tl is not None:
                tl.span(e.name, f"SUBMIT_{op.upper()}", t0, t1,
                        args={"op": op, "bytes": nbytes})

    def op_done(self, e: TensorEntry, t_wait: float, t_done: float) -> None:
        """An entry's wait returned (reference ``_wait_read``)."""
        op, nbytes = OP_NAMES[e.op_type], _nbytes(e)
        sp = telemetry.spans()
        if sp is not None and e.trace_seq >= 0:
            sp.record(e.name, "wait", e.trace_seq, t_wait, t_done, nbytes)
        telemetry.observe_op(op, max(t_done - e.enqueued_at, 1e-9), nbytes)
        if telemetry.enabled():
            telemetry.histogram(
                "hvd_native_wait_seconds",
                "Time blocked in hvd_wait on the native runtime",
                bounds=telemetry.DEFAULT_TIME_BUCKETS,
                op=op).observe(max(t_done - t_wait, 0.0))
        tl = telemetry.timeline()
        if tl is not None:
            tl.span(e.name, f"WAIT_{op.upper()}", t_wait, t_done)
            tl.instant(e.name, "FINISH", t_done, args={"op": op})

    def op_failed(self, e: TensorEntry) -> None:
        if telemetry.enabled():
            telemetry.counter(
                "hvd_eager_op_errors_total",
                "Eager ops completed with a native error status",
                op=OP_NAMES[e.op_type]).inc()

    def publish_gauges(self) -> None:
        """The tuned configuration, the schedule check, the tree and the
        membership as gauges (reference ``_publish_autotune_gauges`` and
        ``_publish_schedule_check_metrics``, the dimensions the port
        has)."""
        if not telemetry.enabled():
            return
        telemetry.gauge(
            "hvd_schedule_check_enabled",
            "1 while HOROVOD_SCHEDULE_CHECK verification is active",
        ).set(1.0 if self.schedule_check else 0.0)
        cfg = self.tuned_config()
        telemetry.gauge(
            "hvd_autotune_cycle_time_ms",
            "Active coordination cycle time (latest TunedParams)",
        ).set(cfg["cycle_time_ms"])
        telemetry.gauge(
            "hvd_autotune_fusion_threshold_bytes",
            "Active fusion threshold (latest TunedParams)",
        ).set(float(cfg["fusion_threshold_bytes"]))
        telemetry.gauge(
            "hvd_autotune_cache_hit_ratio",
            "Response-cache hit ratio for this rank's announcements",
        ).set(cfg["cache_hit_ratio"])
        telemetry.gauge(
            "hvd_autotune_hier_allreduce",
            "1 while the 2-level eager allreduce routing is active",
        ).set(1.0 if cfg["hier_allreduce"] else 0.0)
        telemetry.gauge(
            "hvd_autotune_hier_allgather",
            "1 while the 2-level eager allgather routing is active",
        ).set(1.0 if cfg["hier_allgather"] else 0.0)
        telemetry.gauge(
            "hvd_coord_tree",
            "1 while tree coordination (member -> host leader -> master) "
            "is active on this rank",
        ).set(1.0 if self.tree is not None else 0.0)
        telemetry.gauge(
            "hvd_membership_changed",
            "1 once this runtime saw a peer leave under a shrink policy",
        ).set(1.0 if self.membership_changed else 0.0)
        telemetry.gauge(
            "hvd_world_epoch",
            "Membership epoch this world was initialized under",
        ).set(float(config.env_int("HOROVOD_WORLD_EPOCH", 0) or 0))

    def has_set(self, set_id: int) -> bool:
        return set_id in self.groups

    def stop(self, timeout: float = SHUTDOWN_TIMEOUT_S) -> None:
        """Ask every rank to shut down and wait for the thread to end;
        after ``timeout`` seconds give up on it (it is a daemon)."""
        self._shutting_down = True
        self._wake.set()
        self.thread.join(timeout)
        self._watchdog_stop.set()
        if self._watchdog is not None and self._watchdog.is_alive():
            self._watchdog.join(5.0)
        fusion.set_live_threshold_provider(None)
        self.publish_gauges()
        telemetry.unregister_metrics_flush_hook(self.publish_gauges)
        if self.thread.is_alive():
            log.warning("horovod_tpu_torch runtime: the ranks did not agree "
                        "to shut down within %s s; leaving the thread",
                        timeout)
            self.queue.close(RuntimeError(SHUTDOWN_ERROR))

    # -- the tuned configuration --------------------------------------------------

    def tuned_config(self) -> dict:
        """The live control-plane configuration: the parameters last
        applied from the response stream (the environment's when the
        tuner is off), the response cache's counters and the two-level
        routing as the plane runs it now (reference
        ``native/runtime.py:455-493``, the dimensions the port has)."""
        lookups, hits = self.cache_lookups, self.cache_hits
        return {"cycle_time_ms": self.cycle_time_s * 1000.0,
                "fusion_threshold_bytes": int(self.fusion_threshold),
                "exploring": self.exploring,
                "cache_enabled": self.cache_enabled,
                "cache_lookups": lookups, "cache_hits": hits,
                "cache_hit_ratio": hits / lookups if lookups else 0.0,
                "hier_allreduce": self.hierarchical_enabled(),
                "hier_allgather": self.hierarchical_allgather_enabled(),
                "hier_available": self.hier is not None}

    def sync_tuned_config(self) -> dict:
        """Agree on the tuned fusion threshold and latch it for the
        framework's bucketing (``fusion.fusion_threshold_bytes``).

        Every rank applies the tuner's parameters at the same point of the
        response stream, but other threads read them at any moment, so two
        ranks may see different values mid-trial, and buckets cut under
        different thresholds would hang the job.  So the bucketing follows
        the tuner only through this collective, a Min all-reduce over each
        rank's view: every rank calls it at the same point of the program
        (reference ``native/runtime.py:495-550``).  The two routing
        booleans ride the same MIN, which ANDs them: the agreed view says
        "on" only once every rank routes through the two-level plane.
        Returns ``{"fusion_threshold_bytes", "hier_allreduce",
        "hier_allgather"}``."""
        self._sync_seq += 1
        local = torch.tensor([int(self.fusion_threshold),
                              int(self.hierarchical_enabled()),
                              int(self.hierarchical_allgather_enabled())],
                             dtype=torch.int64, device=self.device)
        e = TensorEntry(OpType.ALLREDUCE, f"hvd.autotune.sync."
                        f"{self._sync_seq}", local, arg=int(ReduceOp.MIN))
        self.submit([e], "allreduce")
        agreed = [int(v) for v in e.result().tolist()]
        if agreed[0] > 0:
            self._agreed_fusion_threshold = agreed[0]
        return {"fusion_threshold_bytes": agreed[0],
                "hier_allreduce": bool(agreed[1]),
                "hier_allgather": bool(agreed[2])}

    def _live_fusion_threshold(self) -> Optional[int]:
        return self._agreed_fusion_threshold

    def _apply(self, params: TunedParams) -> None:
        """Take the tuner's parameters before fusing the list they came
        with, on every rank at the same point of the response stream."""
        self.cycle_time_s = params.cycle_time_ms / 1000.0
        self.fusion_threshold = int(params.fusion_threshold)
        self.cache_enabled = params.cache_enabled and self.cache.enabled
        self.exploring = params.tuning
        # The tuner proposes the two-level routing only on an agreed
        # topology (operations.cc:886-896).
        if self.hier is not None:
            self.hier.allreduce = params.hier_allreduce
            self.hier.allgather = params.hier_allgather

    # -- the eager-op deadline and the watchdog ------------------------------------

    def _stall_report(self, name: str, elapsed: float) -> str:
        """Reference ``native/runtime.py:837-894``, without the transport
        note (the port has no native transports): this rank submitted the
        op and its completion never came, so the suspects are every
        peer."""
        suspects = [r for r in range(self.size) if r != self.rank]
        cfg = self.tuned_config()
        coord = (f" Coordination plane: coordinator rank "
                 f"{config.env_int('HOROVOD_COORD_RANK')}, lease epoch "
                 f"{config.env_int('HOROVOD_COORD_EPOCH')}, elections so "
                 f"far {config.env_int('HOROVOD_COORD_ELECTIONS')}.")
        tuned = (f" Active control-plane config: cycle_time="
                 f"{cfg['cycle_time_ms']:.2f}ms, fusion_threshold="
                 f"{cfg['fusion_threshold_bytes']} bytes"
                 + (", autotuner exploring" if cfg["exploring"] else "")
                 + ".")
        sched = "" if self.schedule_check else (
            " If a divergent submission order is suspected, rerun with "
            "HOROVOD_SCHEDULE_CHECK=1: the coordinator then verifies every "
            "rank's submission stream and aborts at the first divergence "
            "naming both ranks, the call index and the mismatched field "
            "instead of stalling here.")
        return (f"Stalled eager op '{name}': submitted by rank {self.rank} "
                f"but not completed after {elapsed:.1f}s. One or more ranks "
                f"likely never reached this collective — suspected missing "
                f"ranks: {suspects} (every peer of rank {self.rank}; the "
                f"coordinator's stall watchdog, HOROVOD_STALL_CHECK_TIME_"
                f"SECONDS, reports the authoritative list on rank 0). "
                f"Possible causes: a crashed or hung peer, a deadlocked "
                f"submission order, or a network partition." + coord + tuned
                + sched)

    def _stall_error(self, name: str, elapsed: float,
                     op: str = "unknown") -> EagerStallError:
        if telemetry.enabled():
            telemetry.counter(
                "hvd_eager_stalls_total",
                "Eager ops that raised EagerStallError at the "
                "HOROVOD_EAGER_OP_TIMEOUT deadline", op=op).inc()
        return EagerStallError(self._stall_report(name, elapsed))

    def _watch(self) -> None:
        """Warn about every entry in flight past the warning time, again
        each interval; drop the entries that are done.  It also keeps the
        gauges fresh (with telemetry on, it runs without a warning time
        too)."""
        warn = self.op_warn or float("inf")
        last: Dict[int, float] = {}
        while not self._watchdog_stop.wait(min(warn, 5.0)):
            try:
                self.publish_gauges()
            except Exception:   # telemetry never stops the watchdog
                pass
            now = time.monotonic()
            reports = []
            with self._inflight_lock:
                entries = list(self._inflight.items())
            for key, e in entries:
                if e.done():
                    with self._inflight_lock:
                        self._inflight.pop(key, None)
                    last.pop(key, None)
                elif (now - e.submitted_at >= warn
                      and now - last.get(key, 0.0) >= warn):
                    last[key] = now
                    reports.append((e.name, now - e.submitted_at))
            for name, elapsed in reports:
                if telemetry.enabled():
                    telemetry.counter(
                        "hvd_eager_stall_warnings_total",
                        "Watchdog warnings for eager ops inflight past "
                        "HOROVOD_EAGER_OP_WARN_SECONDS").inc()
                log.warning("%s", self._stall_report(name, elapsed))

    def _peer_left(self, exc: BaseException) -> MembershipChangedError:
        """Latch a membership change (shrink policies only): every pending
        and later entry fails with the error returned."""
        self.membership_changed = True
        error = MembershipChangedError(
            f"horovod_tpu_torch runtime: the world changed (a peer left): "
            f"{type(exc).__name__}: {exc}")
        self.queue.close(error)
        return error

    def _membership_error(self, exc: BaseException
                          ) -> Optional[MembershipChangedError]:
        """Under a shrink policy, the error that fails every entry when
        ``exc`` means a peer left or a change is latched already; None
        when ``exc`` keeps its own error."""
        if not self.shrink or not (self.membership_changed
                                   or peer_lost(exc)):
            return None
        return self._peer_left(exc)

    # -- the thread -------------------------------------------------------------

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                self._stream = torch.cuda.Stream(self.device)
                if self.completions is not None:
                    self._clock = DeviceClock(self._stream)
            while not self._cycle():
                pass
            error: BaseException = self._abort or RuntimeError(
                SHUTDOWN_ERROR)
        except Exception as e:  # the thread's boundary: fail, never hang
            self._close_control()
            if self._membership_error(e) is not None:
                log.warning("horovod_tpu_torch runtime: the control plane "
                            "stopped (%s: %s); the world changed",
                            type(e).__name__, e)
                self._close_instruments()
                return
            log.exception("horovod_tpu_torch runtime: the control plane "
                          "stopped")
            error = RuntimeError(
                f"horovod_tpu_torch runtime stopped: {type(e).__name__}: "
                f"{e}")
        self.queue.close(error)
        self._close_instruments()

    def _close_control(self) -> None:
        """Close this rank's connections of the control group, so that a
        peer blocked in an exchange with it fails at once instead of after
        ``CONTROL_TIMEOUT`` (a survivor waiting on the coordinator's answer
        while the coordinator met a dead peer; reference: the master's
        sockets close when its loop ends)."""
        if self.size > 1 and self.ctrl_group is not None:
            groups = [self.ctrl_group]
            if self.tree is not None:
                groups += self.tree.groups()
            self.ctrl_group = None
            for group in groups:
                try:
                    dist.destroy_process_group(group)
                except Exception:   # the world may be gone already
                    pass

    def _close_instruments(self) -> None:
        """Stamp what is left, then close the timeline and the trial log."""
        if self.completions is not None:
            self.completions.stop()
        if self.timeline is not None:
            self.timeline.close()
        if self.tuner is not None:
            self.tuner.close()

    def _cycle(self) -> bool:
        """One cycle; True once every rank has agreed to shut down."""
        start = time.perf_counter()
        tl = self.timeline
        if tl is not None:
            tl.mark_cycle_start()
        mine = RequestList(shutdown=self._shutting_down)
        for e in self.queue.pop_announcements():
            r = e.request(self.rank)
            if r.op_type == OpType.JOIN:
                self.joined = True
            if self.schedule_check:
                self._sched_record(mine, r)
            if tl is not None:
                tl.negotiate_start(e.name, OP_NAMES[r.op_type])
            slot = -1
            if self.cache_enabled:
                slot = self.cache.lookup(r)
                self.cache_lookups += 1
                self.cache_hits += slot >= 0
            if slot >= 0:
                mine.cache_hits |= 1 << slot
            else:
                mine.requests.append(r)
        if self.schedule_check:
            mine.sched_seq, mine.sched_digest = (self._sched_seq,
                                                 self._sched_digest)
        sp = telemetry.spans()
        t_coord = time.monotonic() if sp is not None else 0.0
        out = self._exchange(mine)
        if (sp is not None and out.responses
                and sp.sampled(self._trace_cycle)):
            # The exchange of a cycle that delivered work; the cycle
            # index is the same on every rank (lock-step).
            sp.record("coord/cycle", "coord", self._trace_cycle, t_coord,
                      time.monotonic())
        self._trace_cycle += 1
        if out.abort_message:
            # The coordinator found a schedule divergence: every rank
            # gets the report in the same cycle, fails its pending work
            # with it and stops.
            log.error("%s", out.abort_message)
            self.sched_divergences += 1
            if telemetry.enabled():
                telemetry.counter(
                    "hvd_schedule_check_divergence_total",
                    "Coordinator-reported schedule divergence aborts "
                    "observed by this rank").inc()
            self._abort = RuntimeError(out.abort_message)
            return True
        if out.params is not None:
            self._apply(out.params)
        moved, probes = 0, []
        for resp in fuse(out.responses, self.fusion_threshold):
            n, probe = self._execute(resp)
            moved += n
            if probe is not None:
                probes.append(probe)
        self.busy_cycles += moved > 0
        if self.tuner is not None and moved > 0:
            # Scored at the completion of the cycle's collectives, not at
            # their launch (on the card the two are far apart).
            self.completions.add(
                lambda now, n=moved: self._tuner_update(n, now),
                AllOf(probes) if probes else None)
        self.cycles += 1
        self.cycle_seconds += time.perf_counter() - start
        if out.shutdown:
            return True
        left = self.cycle_time_s - (time.perf_counter() - start)
        if left > 0 and self.queue.num_pending() == 0:
            self._wake.wait(left)
        self._wake.clear()
        return False

    def _sched_record(self, mine: RequestList, r) -> None:
        """This rank's record of one submission, taken before the cache
        can turn it into a bit; its own join starts a new stream."""
        if r.op_type == OpType.JOIN:
            self._sched_digest, self._sched_seq = SCHED_DIGEST_INIT, 0
            return
        mine.sched.append(r)
        self.sched_submissions += 1
        if r.set_id == 0:
            self._sched_digest = sched_fold(self._sched_digest, r)
            self._sched_seq += 1
        if telemetry.enabled():
            telemetry.counter(
                "hvd_schedule_check_submissions_total",
                "Collective submissions folded into this rank's verified "
                "schedule stream").inc()

    def _tuner_update(self, nbytes: int, now: float) -> None:
        with self._tuner_lock:
            self.tuner.update(nbytes, now)

    def _exchange(self, mine: RequestList) -> ResponseList:
        if self.size == 1:
            return self._answer([mine])
        if self.tree is not None:
            return self._tree_exchange(mine)
        root = self.global_ranks[0]
        if self.rank == 0:
            lists = [None] * self.size
            dist.gather_object(mine, lists, dst=root, group=self.ctrl_group)
            box = [self._answer(lists)]
        else:
            dist.gather_object(mine, None, dst=root, group=self.ctrl_group)
            box = [None]
        dist.broadcast_object_list(box, src=root, group=self.ctrl_group)
        return box[0]

    def _tree_exchange(self, mine: RequestList) -> ResponseList:
        """Members to their host's leader, leaders to the master, and the
        master's list back down unchanged (``Cycle``, ``LeaderCycle``,
        ``controller.cc:421-500``).  A leader folds its host's lists into
        one, moving each list's shutdown bit and cache bits into the
        per-rank fields."""
        t, g = self.tree, self.global_ranks
        box: List[Optional[ResponseList]] = [None]
        if self.rank != t.leader:
            dist.gather_object(mine, None, dst=g[t.leader],
                               group=t.host_group)
            dist.broadcast_object_list(box, src=g[t.leader],
                                       group=t.host_group)
            return box[0]
        host = [mine]
        if t.members:
            host = [None] * (len(t.members) + 1)
            dist.gather_object(mine, host, dst=g[self.rank],
                               group=t.host_group)
        if self.rank == 0:
            up = [None] * len(t.plan.leaders)
            dist.gather_object(None, up, dst=g[0], group=t.leaders_group)
            ranks = [0] + t.members + t.plan.leaders[1:]
            box[0] = self._answer(host + up[1:], ranks)
        else:
            agg = RequestList()
            for r, rl in zip([self.rank] + t.members, host):
                if rl.shutdown:
                    agg.shutdown_ranks.append(r)
                if rl.cache_hits:
                    agg.member_cache_hits.append((r, rl.cache_hits))
                agg.requests += rl.requests
            dist.gather_object(agg, None, dst=g[0], group=t.leaders_group)
        dist.broadcast_object_list(box, src=g[0], group=t.leaders_group)
        if t.members:
            dist.broadcast_object_list(box, src=g[self.rank],
                                       group=t.host_group)
        return box[0]

    def _answer(self, lists, ranks=None) -> ResponseList:
        """Rank 0: the coordinator's list, with the tuner's parameters."""
        out = self.controller.cycle(lists, ranks)
        if self.tuner is not None:
            with self._tuner_lock:
                out.params = self.tuner.current()
        return out

    def _execute(self, resp: Response):
        """Run one (fused) response; returns the payload bytes this rank
        moved (the tuner's score, 0 for errors, barriers and joins) and
        the probe of its completion, or None."""
        taken = self.queue.take(resp.names, resp.set_id)
        tl = self.timeline
        if tl is not None:
            for _, e in taken:
                tl.negotiate_end(e.name)
        if resp.error:
            for _, e in taken:
                e.fail(RuntimeError(resp.error_message))
            return 0, None
        # Every rank puts the entries it holds for a cacheable response,
        # in the response order, so the replicas stay identical
        # (operations.cc:306-328).
        if (self.cache_enabled and resp.cacheable and resp.op_type not in (
                OpType.BARRIER, OpType.JOIN, OpType.PROCESS_SET)):
            for _, e in taken:
                self.cache.put(e.request(self.rank), resp)
        moved = sum(_nbytes(e) for _, e in taken)
        if resp.op_type == OpType.PROCESS_SET:
            self._install_set(resp, [e for _, e in taken])
            return moved, None
        if resp.op_type == OpType.JOIN:
            self.joined = False
            for _, e in taken:
                e.launch([], lambda arg=resp.arg: arg)
            return 0, None
        if not taken and not (self.joined and resp.set_id == 0):
            return 0, None
        t0 = time.perf_counter()
        marks: List[object] = []
        try:
            works, outputs, done = self._launch(resp, taken, marks)
        except Exception as exc:  # a data group failed: fail these names
            log.exception("horovod_tpu_torch runtime: %s of %s failed",
                          resp.op_type.name.lower(), resp.names)
            error = (self._membership_error(exc)
                     or RuntimeError(f"{type(exc).__name__}: {exc}"))
            for _, e in taken:
                e.fail(error)
            return 0, None
        # On the card the probe is the launch's event, and under an
        # instrument its time is the card's (a DeviceStamp).
        event, probe = done, None
        if isinstance(done, DeviceStamp):
            event, probe = done.event, done
        elif done is not None:
            probe = done.query
        for i, e in taken:
            e.launch(works, outputs[i], event)
        if resp.op_type == OpType.BARRIER:
            return 0, None
        works = [w for w in works if w is not None]
        if probe is None and works:
            def probe():
                return all(w.is_completed() for w in works)
        if tl is not None:
            self._record(tl, resp, [e.name for _, e in taken], t0, marks,
                         probe, time.perf_counter())
        return moved, probe

    def _record(self, tl: Timeline, resp: Response, names, t0: float,
                marks, probe, t1: float) -> None:
        """The timeline's events of one launched response: ``<OP>`` from
        the launch to the completion, a fused allreduce's copy into its
        buffer, and the wire activity."""
        op = resp.op_type
        g = self.groups[resp.set_id]
        wire = ("NCCL_" if g.nccl else "GLOO_") + op.name
        if op == OpType.ALLTOALL and len(resp.first_dims) == g.size ** 2:
            wire += "V"
        # An allreduce's copy mark: the card's stamp after the copy into
        # the buffer, or the host time when the copy ran on the host.
        copied = {"at": t0}
        if marks:
            m = marks[0]
            copied = {"at": m} if isinstance(m, float) else {"probe": m}
        end = {"probe": probe} if probe is not None else {"at": t1}
        for n in names:
            tl.begin(n, op.name, at=t0)
            if op == OpType.ALLREDUCE and len(resp.names) > 1:
                tl.begin(n, "MEMCPY_IN_FUSION_BUFFER", at=t0)
                tl.end(n, **copied)
            tl.begin(n, wire, **copied)
            tl.end(n, **end)
            tl.end(n, **end)

    def _launch(self, resp: Response, taken, marks: list):
        g = self.groups[resp.set_id]
        held: List[Optional[torch.Tensor]] = [None] * len(resp.names)
        for i, e in taken:
            held[i] = e.tensor
        if resp.op_type == OpType.BARRIER:   # the negotiation was the barrier
            return [], [lambda: None] * len(held), None
        op = self._route(resp)
        arg = held if resp.op_type == OpType.ALLREDUCE else held[0]
        kw = ({"mark": self._mark(marks)} if self.timeline is not None
              and resp.op_type == OpType.ALLREDUCE else {})
        if self._stream is None:
            works, outputs = op(resp, arg, g, **kw)
            return works, outputs, None
        with torch.cuda.stream(self._stream):
            for t in held:
                if t is not None and t.is_cuda:
                    t.record_stream(self._stream)
            for _, e in taken:
                if e.ready is not None:
                    self._stream.wait_event(e.ready)
            works, outputs = op(resp, arg, g, **kw)
            # NCCL runs on a stream of its own: this stream waits for it
            # (no host wait), so the event after marks its completion.
            for w in works:
                if w is not None:
                    w.wait()
            if self._clock is not None:
                done = self._clock.stamp(self._stream)
            else:
                done = torch.cuda.Event()
                done.record(self._stream)
        return works, outputs, done

    def _route(self, resp: Response):
        """The data-plane function of a response: the two-level one for
        the global set's fused allreduce (not Adasum) or allgather at or
        above the agreed threshold while its boolean is on, else the flat
        one.  Everything it reads is the same on every rank."""
        flat = getattr(data_plane, resp.op_type.name.lower())
        h = self.hier
        if resp.set_id != 0 or resp.op_type not in (OpType.ALLREDUCE,
                                                    OpType.ALLGATHER):
            return flat
        nbytes = sum(resp.first_dims) * getattr(torch, resp.dtype).itemsize
        if resp.op_type == OpType.ALLREDUCE:
            if resp.arg == ReduceOp.ADASUM:
                return flat
            if (h is not None and h.allreduce and nbytes
                    and nbytes >= h.threshold):
                return functools.partial(data_plane.hierarchical_allreduce,
                                         h=h)
            data_plane.book_flat_allreduce(self.hier_counters, nbytes)
            return flat
        if (h is not None and h.allgather and nbytes
                and nbytes >= h.threshold
                and len(resp.first_dims) == self.size):
            return functools.partial(data_plane.hierarchical_allgather, h=h)
        return flat

    def _mark(self, marks: list):
        """A function the data plane calls after it copied a fused
        response into its buffer: it records a CUDA event on the runtime's
        stream, or the host time."""
        def mark():
            if self._clock is not None:
                marks.append(self._clock.stamp(self._stream))
            else:
                marks.append(time.perf_counter())
        return mark

    def _install_set(self, resp: Response, taken: List[TensorEntry]) -> None:
        """Register the set the coordinator numbered, on every rank at the
        same point of the response stream: its data group and a cleared
        cache.  Creating a group is collective over every process of the
        default group; in a rank-subset job the processes outside it never
        take part, so only the set's members create its group
        (``use_local_synchronization``), and every other rank of the job
        creates a group of its own at that point: such groups are named by
        a hash of how many groups a process holds, which must stay equal
        on the members of a later set."""
        self.cache.clear()
        if resp.arg not in self.groups:
            members = list(resp.first_dims)
            ranks = [self.global_ranks[m] for m in members]
            if not self.subset:
                group = dist.new_group(ranks)
            elif self.rank in members:
                group = dist.new_group(ranks, use_local_synchronization=True)
            else:
                dist.new_group([self.global_ranks[self.rank]],
                               use_local_synchronization=True)
                group = None
            self.groups[resp.arg] = data_plane.DataGroup(
                group, members, self.rank, self.global_ranks, self.device)
        for e in taken:
            e.launch([], lambda arg=resp.arg: arg)


def _nbytes(e: TensorEntry) -> int:
    """The payload bytes of an entry, as the reference counts them
    (``operations.cc:612-617``: a tensor-less entry is one int32)."""
    if e.tensor is None:
        return 4
    return e.tensor.numel() * e.tensor.element_size()
