"""CLI args <-> HOROVOD_* environment, plus YAML config-file support.

Counterpart of ``horovod_tpu/runner/config_parser.py`` (the reference
Horovod's ``set_env_from_args`` and the ``--config-file`` handling of
``run/run.py:581-585``): flags given on the command line win over the
file, and a key the launcher does not know fails.  The file is read with
PyYAML, which only ``--config-file`` needs: without it the option raises
an error that names the missing module.  ``runtime_env`` writes every
rank the reference launcher's ``HOROVOD_*`` contract.
"""

from __future__ import annotations

import os
from typing import Dict

# arg attribute -> env var (reference config_parser.py constants).
_ARG_ENV = {
    "fusion_threshold_mb": "HOROVOD_FUSION_THRESHOLD",   # scaled to bytes
    "cycle_time_ms": "HOROVOD_CYCLE_TIME",
    "cache_capacity": "HOROVOD_CACHE_CAPACITY",
    "timeline_filename": "HOROVOD_TIMELINE",
    "timeline_mark_cycles": "HOROVOD_TIMELINE_MARK_CYCLES",
    "stall_check_time_seconds": "HOROVOD_STALL_CHECK_TIME_SECONDS",
    "stall_shutdown_time_seconds": "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
    "autotune": "HOROVOD_AUTOTUNE",
    "autotune_log_file": "HOROVOD_AUTOTUNE_LOG",
    "log_level": "HOROVOD_LOG_LEVEL",
    "log_hide_timestamp": "HOROVOD_LOG_HIDE_TIME",
    "network_interface": "HOROVOD_NETWORK_INTERFACE",
}

# config-file YAML key -> arg attribute (reference run.py:374-587 arg names).
_CONFIG_ARGS = {
    "fusion-threshold-mb": "fusion_threshold_mb",
    "cycle-time-ms": "cycle_time_ms",
    "cache-capacity": "cache_capacity",
    "timeline-filename": "timeline_filename",
    "timeline-mark-cycles": "timeline_mark_cycles",
    "metrics-file": "metrics_file",
    "stall-check-time-seconds": "stall_check_time_seconds",
    "stall-shutdown-time-seconds": "stall_shutdown_time_seconds",
    "autotune": "autotune",
    "autotune-log-file": "autotune_log_file",
    "verbose": "verbose",
    "min-np": "min_np",
    "blacklist-cooldown": "blacklist_cooldown",
    "log-level": "log_level",
    "log-hide-timestamp": "log_hide_timestamp",
    "network-interface": "network_interface",
}


def env_from_args(args) -> Dict[str, str]:
    """The HOROVOD_* env dict of the parsed launcher args (reference
    ``set_env_from_args``)."""
    env: Dict[str, str] = {}
    for attr, var in _ARG_ENV.items():
        v = getattr(args, attr, None)
        if v is None or v is False:
            continue
        if attr == "fusion_threshold_mb":
            env[var] = str(int(float(v) * 1024 * 1024))
        elif isinstance(v, bool):
            env[var] = "1"
        else:
            env[var] = str(v)
    return env


def _load_yaml(path: str) -> dict:
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"--config-file needs the PyYAML module ('yaml'), which is "
            f"not installed: {e}") from None
    with open(path) as f:
        return yaml.safe_load(f) or {}


def apply_config_file(args, parser) -> None:
    """Overlay the YAML file's values onto ``args``; a flag whose value
    differs from the parser's default was given on the command line and
    wins (reference run.py:581-585)."""
    if not getattr(args, "config_file", None):
        return
    config = _load_yaml(args.config_file)
    defaults = {a.dest: a.default for a in parser._actions}
    for key, value in config.items():
        attr = _CONFIG_ARGS.get(key)
        if attr is None:
            raise ValueError(
                f"unknown config file key {key!r}; valid keys: "
                f"{sorted(_CONFIG_ARGS)}")
        if getattr(args, attr, None) == defaults.get(attr):
            setattr(args, attr, value)


def runtime_env(info, rendezvous_addr: str, rendezvous_port: int,
                extra: Dict[str, str],
                multi_host: bool = False) -> Dict[str, str]:
    """One rank's environment (reference gloo_run.py:211-254 contract).

    An explicit ``HOROVOD_HOSTNAME`` (the advertise-only override)
    survives, except on a multi-host job when it merely leaked in from
    the launcher's shell: one address for every rank would point them
    all at one machine, so the per-host name wins there (with a
    warning).  With ``HOROVOD_NETWORK_INTERFACE`` or ``HOROVOD_HOSTNAME``
    set, the generic per-host name is not injected.
    """
    env = dict(os.environ)
    env.update(extra)
    if multi_host and "HOROVOD_HOSTNAME" not in extra and \
            os.environ.get("HOROVOD_HOSTNAME"):
        if info.rank == 0:
            import sys
            print("hvdrun: ignoring HOROVOD_HOSTNAME="
                  f"{os.environ['HOROVOD_HOSTNAME']} inherited from the "
                  "launcher's environment: a single advertise address is "
                  "wrong for a multi-host job (set it per host, or use "
                  "--network-interface)", file=sys.stderr)
        del env["HOROVOD_HOSTNAME"]
    env.update({
        "HOROVOD_RANK": str(info.rank),
        "HOROVOD_SIZE": str(info.size),
        "HOROVOD_LOCAL_RANK": str(info.local_rank),
        "HOROVOD_LOCAL_SIZE": str(info.local_size),
        "HOROVOD_CROSS_RANK": str(info.cross_rank),
        "HOROVOD_CROSS_SIZE": str(info.cross_size),
        "HOROVOD_RENDEZVOUS_ADDR": rendezvous_addr,
        "HOROVOD_RENDEZVOUS_PORT": str(rendezvous_port),
        "HOROVOD_CONTROLLER": "tcp",
        "HOROVOD_CPU_OPERATIONS": "tcp",
    })
    if not env.get("HOROVOD_NETWORK_INTERFACE") and \
            not env.get("HOROVOD_HOSTNAME"):
        env["HOROVOD_HOSTNAME"] = info.hostname
    return env


def job_secret() -> str:
    """A fresh shared secret for the job (reference
    ``run/common/util/secret.py``): the key of the launcher's
    authenticated RPC planes, which every rank's heartbeat and reports
    sign with."""
    import base64
    import secrets
    return base64.urlsafe_b64encode(secrets.token_bytes(32)).decode()
