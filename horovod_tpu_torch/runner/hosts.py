"""Host list parsing and rank allocation.

Counterpart of ``horovod_tpu/runner/hosts.py``, function for function:
``HostSlots``, ``RankInfo``, ``parse_hosts``, ``parse_hostfile``,
``allocate``, ``topology_string``, ``promote_host``, ``free_slots`` and
``HostBlacklist`` (the reference Horovod's ``run/run.py:590-622`` and
``run/gloo_run.py:56-114``).  The demotion series
(``hvd_blacklisted_hosts_total``, ``hvd_blacklist_expirations_total``)
go to the port's telemetry.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch import telemetry

logger = logging.getLogger(__name__)


@dataclass
class HostSlots:
    hostname: str
    slots: int


@dataclass
class RankInfo:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    hostname: str


def parse_hosts(hosts: str) -> List[HostSlots]:
    """Parse ``"h1:2,h2:2"`` (reference run.py:590-607)."""
    out = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            out.append(HostSlots(name, int(slots)))
        else:
            out.append(HostSlots(part, 1))
    if not out:
        raise ValueError(f"no hosts found in {hosts!r}")
    return out


def parse_hostfile(path: str) -> List[HostSlots]:
    """Parse a hostfile of ``hostname slots=N`` lines (reference
    run.py:609-622)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            fields = line.split()
            name = fields[0]
            slots = 1
            for fld in fields[1:]:
                if fld.startswith("slots="):
                    slots = int(fld[len("slots="):])
            out.append(HostSlots(name, slots))
    if not out:
        raise ValueError(f"no hosts found in hostfile {path}")
    return out


def allocate(hosts: List[HostSlots], np_: int) -> List[RankInfo]:
    """Assign ranks host-major (reference _allocate, gloo_run.py:56-114):
    consecutive ranks fill a host before moving to the next; local_rank is
    the slot index, cross_rank the host index."""
    total = sum(h.slots for h in hosts)
    if total < np_:
        raise ValueError(
            f"requested -np {np_} but hosts only provide {total} slots")
    infos: List[RankInfo] = []
    rank = 0
    cross_size = 0
    for host_idx, h in enumerate(hosts):
        if rank >= np_:
            break
        cross_size += 1
        use = min(h.slots, np_ - rank)
        for slot in range(use):
            infos.append(RankInfo(
                rank=rank, size=np_, local_rank=slot, local_size=use,
                cross_rank=host_idx, cross_size=0, hostname=h.hostname))
            rank += 1
    for info in infos:
        info.cross_size = cross_size
    return infos


def topology_string(infos: List[RankInfo]) -> str:
    """Serialize an allocation back to the ``"h1:2,h2:2"`` dialect of
    :func:`parse_hosts`, in rank order — the value the launcher exports as
    ``HOROVOD_TOPOLOGY`` so every rank can reconstruct the host→slots map
    (``hvd.topology()``: hosts, leaders, local group) without a collective.
    Built from the ACTIVE allocation, not the user's ``-H`` argument, so an
    elastic restart or fleet resize that shrinks the world re-serializes
    the topology the surviving ranks actually have."""
    hosts: List[HostSlots] = []
    for info in infos:   # rank order == host-major order (allocate())
        if hosts and hosts[-1].hostname == info.hostname:
            hosts[-1].slots += 1
        else:
            hosts.append(HostSlots(info.hostname, 1))
    return ",".join(f"{h.hostname}:{h.slots}" for h in hosts)


def promote_host(host_list: List[HostSlots],
                 hostname: str) -> List[HostSlots]:
    """Reorder ``host_list`` so ``hostname`` leads.  Rank assignment is
    host-major (:func:`allocate`), so the promoted host's first slot
    becomes rank 0 — this is how the launcher pins the elected
    coordinator host after a failover.  The relative order of the other
    hosts is preserved; an unknown hostname returns the list unchanged.
    """
    head = [h for h in host_list if h.hostname == hostname]
    if not head:
        return list(host_list)
    return head + [h for h in host_list if h.hostname != hostname]


def free_slots(hosts: List[HostSlots],
               used: Dict[str, int]) -> List[HostSlots]:
    """Remaining per-host capacity after subtracting ``used`` (hostname →
    slots held by running jobs).  Hosts with nothing left are dropped so
    the result feeds straight into :func:`allocate`; order is preserved
    because rank assignment is host-major and the fleet wants jobs packed
    onto the same prefix of the pool."""
    out: List[HostSlots] = []
    for h in hosts:
        left = h.slots - used.get(h.hostname, 0)
        if left > 0:
            out.append(HostSlots(hostname=h.hostname, slots=left))
    return out


class HostBlacklist:
    """Launcher-side record of hosts demoted after rank failures.

    Reference equivalent: ``run/elastic/discovery.py:30-77``
    (``HostState.blacklist`` + ``HostManager`` pruning blacklisted hosts
    from the working set).  Here the launcher owns the list: a host whose
    rank crashed or that stopped answering probes is demoted, and the
    next elastic restart attempt allocates around it.

    ``cooldown`` is seconds until a demoted host becomes eligible again
    (None = demoted for the life of the job); ``clock`` is a
    monotonic-seconds callable, injectable so tests step time instead of
    sleeping.
    """

    def __init__(self, cooldown: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._cooldown = cooldown
        self._clock = clock
        self._entries: Dict[str, Tuple[float, str]] = {}

    def demote(self, hostname: str, reason: str = "") -> None:
        telemetry.counter(
            "hvd_blacklisted_hosts_total",
            "Host demotions recorded by the launcher blacklist").inc()
        self._entries[hostname] = (self._clock(), reason)

    def forgive(self, hostname: str) -> None:
        self._entries.pop(hostname, None)

    def is_blacklisted(self, hostname: str) -> bool:
        entry = self._entries.get(hostname)
        if entry is None:
            return False
        if (self._cooldown is not None and
                self._clock() - entry[0] > self._cooldown):
            # Cooldown elapsed: the host gets another chance.  If it is
            # still broken the next failure re-demotes it.
            del self._entries[hostname]
            telemetry.counter(
                "hvd_blacklist_expirations_total",
                "Blacklist cooldowns that expired, re-admitting the "
                "host").inc()
            logger.info("blacklist cooldown expired for %s; host is "
                        "eligible again", hostname)
            return False
        return True

    def filter(self, host_list: List[HostSlots]) -> List[HostSlots]:
        """The usable subset of ``host_list``, preserving order."""
        return [h for h in host_list if not self.is_blacklisted(h.hostname)]

    def summary(self) -> str:
        """Human-readable account of every active demotion, for the
        fail-fast report when capacity drops below the floor."""
        parts = []
        for host in sorted(self._entries):
            if not self.is_blacklisted(host):   # may expire an entry
                continue
            reason = self._entries[host][1]
            parts.append(f"{host} ({reason})" if reason else host)
        return ", ".join(parts) or "<none>"
