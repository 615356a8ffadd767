"""The environment knobs the PyTorch port reads, with typed accessors.

Counterpart of ``horovod_tpu/config.py``, cut down to the variables the
port's training path reads.  Every name here is also registered in the
JAX package's registry, so one launcher contract serves both packages;
a knob the port adds for itself takes the ``HVD_TORCH_`` prefix.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, NamedTuple, Optional

log = logging.getLogger(__name__)


class EnvVar(NamedTuple):
    name: str
    type: str          # "str" | "int" | "float"
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
