"""Host reachability checks for the launcher.

Counterpart of ``horovod_tpu/runner/network.py`` (the reference Horovod's
``run/run.py:59-112`` parallel ssh probe and ``run/util/cache.py``): every
remote host is probed over ssh before a rank spawns, so a dead host fails
fast with its name instead of hanging the rendezvous, and a success is
cached for 60 minutes in a JSON file under the home directory
(``~/.horovod_tpu/reachability.json``, the reference's file, so the two
launchers share it).  ``HOROVOD_SSH_CMD`` replaces ``ssh``.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

CACHE_STALENESS_SECS = 60 * 60   # reference: 60 minutes (cache.py)


def _default_cache_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".horovod_tpu",
                        "reachability.json")


def _load_cache(path: str) -> Dict[str, float]:
    try:
        with open(path) as f:
            return {str(k): float(v) for k, v in json.load(f).items()}
    except (OSError, ValueError):
        return {}


def _store_cache(path: str, cache: Dict[str, float]) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(cache, f)
    except OSError:
        pass  # the cache saves time; it never fails a launch


def _default_ssh_builder(host: str) -> List[str]:
    ssh = os.environ.get("HOROVOD_SSH_CMD", "ssh")
    return [ssh, "-o", "StrictHostKeyChecking=no",
            "-o", "ConnectTimeout=10", host, "true"]


def probe_hosts(
        hosts: List[str],
        ssh_builder: Callable[[str], List[str]] = _default_ssh_builder,
        timeout: float = 30.0) -> Dict[str, bool]:
    """Probe every host over ssh at once; never raises, never caches.
    The elastic restart loop re-probes with this between attempts: the
    hour-long cache would answer from before the failure."""
    results: Dict[str, bool] = {}

    def probe(host: str) -> None:
        try:
            rc = subprocess.run(ssh_builder(host), timeout=timeout,
                                capture_output=True).returncode
            results[host] = rc == 0
        except (OSError, subprocess.TimeoutExpired):
            results[host] = False

    threads = [threading.Thread(target=probe, args=(h,)) for h in hosts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def check_hosts_reachable(
        hosts: List[str],
        ssh_builder: Callable[[str], List[str]] = _default_ssh_builder,
        cache_path: Optional[str] = None,
        timeout: float = 30.0) -> None:
    """Probe every host not probed successfully within the hour; raise
    listing the unreachable ones."""
    cache_path = cache_path or _default_cache_path()
    cache = _load_cache(cache_path)
    now = time.time()
    to_probe = [h for h in hosts
                if now - cache.get(h, 0.0) > CACHE_STALENESS_SECS]
    if not to_probe:
        return
    results = probe_hosts(to_probe, ssh_builder=ssh_builder,
                          timeout=timeout)
    dead = sorted(h for h, ok in results.items() if not ok)
    if dead:
        raise RuntimeError(
            f"host(s) not reachable over ssh: {', '.join(dead)}. "
            "Launch requires passwordless ssh to every remote host "
            "(reference horovodrun has the same contract).")
    for h in to_probe:
        cache[h] = now
    _store_cache(cache_path, cache)
