"""The environment knobs the PyTorch port reads, with typed accessors.

Counterpart of ``horovod_tpu/config.py``, cut down to the variables the
port's training path reads.  Every name here is also registered in the
JAX package's registry, so one launcher contract serves both packages;
a knob the port adds for itself takes the ``HVD_TORCH_`` prefix.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, NamedTuple, Optional

from horovod_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class EnvVar(NamedTuple):
    name: str
    type: str          # "str" | "int" | "float" | "bool"
    default: Any       # None = unset / derived
    doc: str


REGISTRY: Dict[str, EnvVar] = {}


def _var(name: str, type_: str, default: Any, doc: str) -> None:
    if name in REGISTRY:
        raise ValueError(f"duplicate registry entry {name}")
    REGISTRY[name] = EnvVar(name, type_, default, doc)


_var("HOROVOD_RANK", "int", None, "This process's global rank")
_var("HOROVOD_SIZE", "int", None, "World size")
_var("HOROVOD_LOCAL_RANK", "int", None,
     "Rank within this host (default: the global rank)")
_var("HOROVOD_LOCAL_SIZE", "int", None,
     "Ranks on this host (default: the world size)")
_var("HOROVOD_CROSS_RANK", "int", None,
     "This host's index among hosts (default: rank // local_size)")
_var("HOROVOD_CROSS_SIZE", "int", None,
     "Number of hosts (default: ceil(size / local_size))")
_var("HOROVOD_COORDINATOR_ADDR", "str", None,
     "host:port of the torch.distributed TCP rendezvous")
_var("HOROVOD_HOSTNAME", "str", "",
     "Launcher-assigned host name used in the topology")
_var("HOROVOD_TOPOLOGY", "str", "",
     "host:slots,... map exported by the launcher; drives hvd.topology()")
_var("HOROVOD_FUSION_THRESHOLD", "int", 64 * 1024 * 1024,
     "Gradient fusion bucket limit in bytes (binary size suffixes accepted)")
_var("HOROVOD_MAX_BUCKET_BYTES", "int", 32 * 1024 * 1024,
     "Cap above which reduce-scatter buckets are chunked (binary size "
     "suffixes accepted); 0 disables chunking")
_var("HOROVOD_COMPRESSION", "str", "none",
     "Gradient wire codec: none|bf16|fp16|int8|powersgd[:rank]")
_var("HOROVOD_TRANSPORT_CODECS", "str", "",
     "Per-link-level codec overrides, e.g. cross:fp16,local:none")
_var("HOROVOD_STEP_GUARD", "str", "off",
     "NaN/Inf step-guard policy: off|skip|rollback|abort")
_var("HOROVOD_LKG_INTERVAL", "int", 1,
     "StepGuard: stage a last-known-good snapshot every N validated steps")
_var("HOROVOD_SENTINEL_INTERVAL", "int", 0,
     "StepGuard: compare replica digests every N steps; 0 disables")
_var("HOROVOD_GUARD_NAN_BURST", "int", 1,
     "StepGuard: consecutive bad steps before a rollback fires")
_var("HOROVOD_FAULT_SPEC", "str", "",
     "Value-fault rules for the eager collectives (nan, corrupt[:N])")
_var("HOROVOD_FLASH_AUTO_MIN_T", "int", 1024,
     "attention='auto' picks the flash kernel from this sequence length up")
_var("HOROVOD_CYCLE_TIME", "float", 1.0,
     "Control-plane cycle time in ms: the runtime negotiates at most this "
     "often")
_var("HOROVOD_STALL_CHECK_TIME_SECONDS", "float", 60.0,
     "Seconds before the stall inspector warns about a name some ranks "
     "have not submitted")
_var("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "float", 0.0,
     "Seconds after which such a name fails on every rank; 0 disables")
_var("HOROVOD_CACHE_CAPACITY", "int", 1024,
     "Response-cache capacity in names; 0 disables the cache")
# The eager-op deadline, the timeline and the autotuner (the launcher's
# --autotune, --autotune-log-file, --timeline-filename and
# --timeline-mark-cycles set the last six).
_var("HOROVOD_EAGER_OP_TIMEOUT", "float", None,
     "Seconds after which a blocked eager wait raises EagerStallError "
     "(unset = wait forever, the watchdog still warns)")
_var("HOROVOD_EAGER_OP_WARN_SECONDS", "float", 60.0,
     "Seconds an eager op may stay in flight before the watchdog warns, "
     "again each interval; 0 disables the watchdog")
_var("HOROVOD_TIMELINE", "str", "",
     "Chrome-tracing timeline path, written by rank 0")
_var("HOROVOD_TIMELINE_MARK_CYCLES", "bool", False,
     "1 adds a CYCLE_START marker per control-plane cycle to the timeline")
_var("HOROVOD_AUTOTUNE", "bool", False,
     "1 enables the online Bayesian autotuner of the control plane")
_var("HOROVOD_AUTOTUNE_LOG", "str", None,
     "CSV of the autotune trials, written by rank 0")
_var("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "int", 3,
     "Discarded warm-up samples before scoring starts")
_var("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "int", 10,
     "Busy control-plane cycles folded into one autotune sample")
_var("HOROVOD_AUTOTUNE_SAMPLES", "int", 5,
     "Samples per Bayesian trial (their median is its score)")
_var("HOROVOD_AUTOTUNE_BAYES_TRIALS", "int", 20,
     "Bayesian trials before pinning the best configuration")
_var("HOROVOD_AUTOTUNE_DRIFT_RATIO", "float", 0.5,
     "Monitored-score ratio against the pin anchor that re-opens the "
     "search")
_var("HOROVOD_AUTOTUNE_DRIFT_WINDOWS", "int", 2,
     "Consecutive drifted monitoring windows that re-open the search")
# Elastic continuity, warm restart and fail-in-place (set by the launcher).
_var("HOROVOD_SPILL_DIR", "str", None,
     "Host-local scratch dir for warm-restart peer spills (provisioned "
     "by hvdrun)")
_var("HOROVOD_SPILL_INTERVAL", "int", 1,
     "LKG commits between peer-spill writes")
_var("HOROVOD_RESTART_ATTEMPT", "int", 0,
     "Elastic attempt counter injected by the launcher")
_var("HOROVOD_ELASTIC_BATCH_POLICY", "str", "lr_scale",
     "World-size-change continuity policy: lr_scale|accumulate")
_var("HOROVOD_ELASTIC_PREV_SIZE", "int", None,
     "Previous world size injected by the launcher across an elastic "
     "restart")
_var("HOROVOD_WORLD_EPOCH", "int", 0,
     "Membership epoch, bumped by the launcher once per in-process "
     "reformation; stale reformation specs are discarded against it")
_var("HOROVOD_ON_RANK_FAILURE", "str", "restart",
     "Rank-death policy: restart, shrink (survivors reform the world "
     "in-process) or shrink-then-restart")
_var("HOROVOD_REFORM_TIMEOUT", "float", 60.0,
     "Seconds a survivor waits for the launcher's reformation spec "
     "before falling back to the restart path")
_var("HOROVOD_HEALTH_RPC", "str", None,
     "launcher host:port of the heartbeat health plane (set by hvdrun)")
_var("HOROVOD_HEARTBEAT_INTERVAL", "float", 2.0,
     "Rank-side heartbeat push cadence in seconds")
_var("HOROVOD_PARTITION_GRACE_SECONDS", "float", 30.0,
     "Launcher silence past this fences the rank (exit 75); 0 disables")
_var("HOROVOD_SECRET_KEY", "str", None,
     "Base64 HMAC key authenticating the launcher's RPC plane")
_var("HOROVOD_COORD_RANK", "int", 0,
     "Global rank currently holding the coordinator lease (injected by "
     "the launcher after failover)")
_var("HOROVOD_COORD_EPOCH", "int", 0,
     "Coordinator lease epoch, bumped by the launcher on each "
     "re-election")
_var("HOROVOD_COORD_ELECTIONS", "int", 0,
     "Coordinator elections so far this job (launcher-injected)")
_var("HOROVOD_COORD_TREE", "bool", False,
     "1 coordinates through the two-level host/leader tree instead of "
     "the flat rank-0 star (needs a HOROVOD_TOPOLOGY of >= 2 hosts)")
_var("HOROVOD_SCHEDULE_CHECK", "bool", False,
     "1 arms the collective-schedule verifier: the coordinator matches "
     "every rank's submission records by name and aborts at the first "
     "divergence (rank, call index, field) instead of stalling")
_var("HOROVOD_SCHEDULE_CHECK_QUIET_SECONDS", "float", 2.0,
     "Schedule verifier's quiet window: abort when every rank has an "
     "unmatched submission and none announced anything for this long")
_var("HOROVOD_METRICS", "bool", False,
     "1 turns metric collection on without any export path")
_var("HOROVOD_METRICS_PORT", "int", None,
     "Prometheus scrape port base (per-rank = base + local_rank; 0 = "
     "ephemeral)")
_var("HOROVOD_METRICS_FILE", "str", None,
     "Per-rank at-exit JSON dump path")
_var("HOROVOD_METRICS_RPC", "str", None,
     "launcher host:port the at-exit snapshot is pushed to (set by "
     "hvdrun)")
_var("HOROVOD_EAGER_TIMELINE", "str", None,
     "Chrome-tracing JSON path for the per-rank eager-plane timeline")
_var("HOROVOD_TRACE", "bool", False,
     "1 turns cross-rank span tracing on (set by hvdrun --trace)")
_var("HOROVOD_TRACE_DIR", "str", None,
     "Directory for the per-rank span-log file (spans.rank<k>.json)")
_var("HOROVOD_TRACE_RPC", "str", None,
     "launcher host:port span documents are pushed to (set by hvdrun)")
_var("HOROVOD_TRACE_SAMPLE", "int", 1,
     "Trace 1-in-N occurrences of each name (1 = every one)")
_var("HOROVOD_TRACE_BUFFER", "int", 65536,
     "Per-rank span buffer capacity; overflow drops spans")
# Logging (utils/logging.py reads the two names itself: config logs
# through it).
_var("HOROVOD_LOG_LEVEL", "str", "warning",
     "Log severity: trace|debug|info|warning|error")
_var("HOROVOD_LOG_HIDE_TIME", "bool", False,
     "1 strips timestamps from log lines (stable test output)")
# The serving plane (serving/).
_var("HOROVOD_SERVING_MAX_BATCH", "int", 8,
     "Continuous-batching cap: max sequences per replica decode step")
_var("HOROVOD_SERVING_QUOTA", "int", 64,
     "Default per-tenant quota (queued + in-flight requests) when the "
     "TenantConfig leaves it unset")
_var("HOROVOD_SERVING_SLO_MS", "float", 0.0,
     "Default per-tenant SLO for admission control: reject when the "
     "estimated queue wait exceeds this; 0 disables")
_var("HOROVOD_SERVING_STATS", "str", None,
     "Path where the router publishes its stats snapshot (the autoscaler "
     "handshake)")
_var("HOROVOD_SERVING_STATS_INTERVAL", "float", 1.0,
     "Seconds between router stats-file publishes in Router.serve")
_var("HOROVOD_SERVING_GATE_DIR", "str", None,
     "Scratch dir handshake of the multi-rank serving episodes")
# The eager plane's two-level collectives (native/data_plane.py).
_var("HOROVOD_HIERARCHICAL_ALLREDUCE", "bool", False,
     "1 routes eager allreduces through the 2-level "
     "local-RS/cross-allreduce/local-AG plane")
_var("HOROVOD_HIERARCHICAL_ALLGATHER", "bool", False,
     "1 routes eager allgathers through the 2-level plane")
_var("HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD", "int", 262144,
     "Payload bytes below which hier-routed allreduces stay on the flat "
     "ring")
# The launcher (runner/).
_var("HOROVOD_SSH_CMD", "str", "ssh",
     "Remote-shell command used to spawn ranks (CI points it at "
     "ci/fake_ssh.sh)")
_var("HOROVOD_TERMINATE_GRACE_SECONDS", "float", 10.0,
     "Grace between SIGTERM and SIGKILL when tearing ranks down")
_var("HOROVOD_HEARTBEAT_DEADLINE", "float", None,
     "Silence past this marks a rank dead (default 5x the interval)")
_var("HOROVOD_HANG_DEADLINE", "float", 0.0,
     "Step-progress stall past this marks a rank hung; 0 disables")
_var("HOROVOD_COORD_LEASE_SECONDS", "float", 10.0,
     "Coordinator lease term: heartbeats renew it, expiry triggers the "
     "deterministic re-election of the lowest healthy leader host")
_var("HOROVOD_COORD_MSG_RETRIES", "int", 4,
     "Bounded retransmits per control message (jittered exponential "
     "backoff between attempts)")
_var("HOROVOD_COORD_MSG_DEADLINE", "float", 10.0,
     "Total per-control-message deadline across all retransmits")
_var("HOROVOD_FLEET_JOB", "str", None,
     "Job name injected by the fleet controller (labels metric exports)")


class UnknownEnvVar(KeyError):
    """An accessor was asked for a name the registry does not hold."""


_UNSET = object()


def _entry(name: str) -> EnvVar:
    try:
        return REGISTRY[name]
    except KeyError:
        raise UnknownEnvVar(f"{name} is not a registered environment "
                            f"variable of horovod_tpu_torch") from None


def env_raw(name: str) -> Optional[str]:
    """The raw value of a registered variable, or None when unset."""
    _entry(name)
    return os.environ.get(name)


def env_str(name: str, default: Any = _UNSET) -> Any:
    entry = _entry(name)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return entry.default if default is _UNSET else default
    return raw


def env_int(name: str, default: Any = _UNSET) -> Any:
    entry = _entry(name)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return entry.default if default is _UNSET else default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def env_float(name: str, default: Any = _UNSET) -> Any:
    entry = _entry(name)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return entry.default if default is _UNSET else default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


def env_bool(name: str, default: Any = _UNSET) -> Any:
    """Unset or empty gives the default; then ``"0"`` and ``"false"`` (any
    case) are False and anything else True, as the launcher writes them."""
    entry = _entry(name)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return entry.default if default is _UNSET else default
    v = raw.strip()
    return v != "0" and v.lower() != "false"


def cycle_time_ms() -> float:
    """``HOROVOD_CYCLE_TIME``: the least time between two negotiation
    cycles, in milliseconds."""
    return env_float("HOROVOD_CYCLE_TIME")


def stall_check_seconds() -> float:
    return env_float("HOROVOD_STALL_CHECK_TIME_SECONDS")


def stall_shutdown_seconds() -> float:
    return env_float("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")


def cache_capacity() -> int:
    return env_int("HOROVOD_CACHE_CAPACITY")


_SIZE_SUFFIXES = {
    "": 1, "b": 1,
    "k": 1024, "kb": 1024, "kib": 1024,
    "m": 1024 ** 2, "mb": 1024 ** 2, "mib": 1024 ** 2,
    "g": 1024 ** 3, "gb": 1024 ** 3, "gib": 1024 ** 3,
}


def parse_size_bytes(value: str) -> Optional[int]:
    """``"64mb"`` / ``"32MiB"`` / ``"67108864"`` -> bytes, or None when the
    string is not a size.  Multipliers are binary (64 MB == 2**26)."""
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*", str(value))
    if not m:
        return None
    mult = _SIZE_SUFFIXES.get(m.group(2).lower())
    if mult is None:
        return None
    return int(float(m.group(1)) * mult)


_warned_bad_cap = False


def max_bucket_bytes() -> int:
    """``HOROVOD_MAX_BUCKET_BYTES``: the cap above which a reduce-scatter
    bucket is chunked (default 32 MiB; ``0`` disables chunking).  An
    unparseable value falls back to the default with one warning: a typo
    in an environment variable must not fail a step."""
    global _warned_bad_cap
    default = REGISTRY["HOROVOD_MAX_BUCKET_BYTES"].default
    v = env_raw("HOROVOD_MAX_BUCKET_BYTES")
    if not v:
        return default
    parsed = parse_size_bytes(v)
    if parsed is None:
        if not _warned_bad_cap:
            _warned_bad_cap = True
            log.warning(
                "HOROVOD_MAX_BUCKET_BYTES=%r is not a byte size (expected "
                "e.g. 33554432, 32mb or 16MiB); using the default %d bytes",
                v, default)
        return default
    return parsed


def compression() -> str:
    """``HOROVOD_COMPRESSION``: the gradient wire codec's name, stripped
    (``""`` when unset)."""
    return (os.environ.get("HOROVOD_COMPRESSION") or "").strip()


def describe() -> str:
    """The registry as a fixed-width table in the reference's format
    (``horovod_tpu/config.py:452``; also the output of ``python -m
    horovod_tpu_torch.config``): name, type, scope, default and doc, one
    row a variable in name order.  The scope is ``py`` on every row: the
    port reads each knob in Python (the reference's ``native`` rows are
    those its C++ runtime reads too)."""
    rows = [(e.name, e.type, "py",
             "" if e.default is None else repr(e.default), e.doc)
            for e in sorted(REGISTRY.values())]
    w0 = max(len(r[0]) for r in rows)
    w3 = max(len(r[3]) for r in rows)
    return "\n".join(
        f"{name:<{w0}}  {type_:<5} {scope:<6} {dflt:<{w3}}  {doc}"
        for name, type_, scope, dflt, doc in rows)


if __name__ == "__main__":
    print(describe())
