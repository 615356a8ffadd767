"""The environment knobs the PyTorch port reads, with typed accessors.

Counterpart of ``horovod_tpu/config.py``, cut down to the variables the
port's training path reads.  Every name here is also registered in the
JAX package's registry, so one launcher contract serves both packages;
a knob the port adds for itself takes the ``HVD_TORCH_`` prefix.
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional


class EnvVar(NamedTuple):
    name: str
    type: str          # "str" | "int"
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
_var("HOROVOD_STEP_GUARD", "str", "off",
     "NaN/Inf step-guard policy: off|skip|rollback|abort")
_var("HOROVOD_FLASH_AUTO_MIN_T", "int", 1024,
     "attention='auto' picks the flash kernel from this sequence length up")


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
