"""Tree coordination (``HOROVOD_COORD_TREE``): who gathers whose lists.

Counterpart of ``TreeSetup`` and ``TreeWire`` (``horovod_tpu/native/cc/
src/controller.cc:222-410``), with the host grouping of
``horovod_tpu/coordination.py`` ``TreePlan`` (``:56-158``, its level 0;
the controller's leaders all report to the master).  Hosts are the
blocks of the launcher's rank-major ``HOROVOD_TOPOLOGY`` (``"h1:2,h2:2"``);
each host's first rank leads it.  Each cycle the members of a host give
their request lists to their leader over the host's gloo group, the
leaders give one aggregated list each to the master (rank 0) over the
leaders' group, and the master's response list goes back down the same
way, unchanged.  Rank 0 leads host 0, so the master takes in
``hosts - 1 + local_size - 1`` lists a cycle instead of ``size - 1``.

Flat coordination stays when the schedule check is on (its records are
attributed per sender), and when the topology does not map the job onto
two or more hosts.  Every input is the same on every rank, so every rank
makes the same choice.
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Sequence

import torch.distributed as dist

from horovod_tpu_torch import config

log = logging.getLogger("horovod_tpu_torch.controller")


class TreePlan:
    """The host-major grouping of ``slot_sizes`` ranks per host."""

    def __init__(self, slot_sizes: Sequence[int]):
        if not slot_sizes or any(s < 1 for s in slot_sizes):
            raise ValueError(f"bad slot sizes {slot_sizes!r}")
        self.slot_sizes = tuple(slot_sizes)
        self.size = sum(slot_sizes)
        self.leaders: List[int] = []
        self._leader_of = {}
        base = 0
        for s in slot_sizes:
            self.leaders.append(base)
            for r in range(base, base + s):
                self._leader_of[r] = base
            base += s

    def leader_of(self, rank: int) -> int:
        return self._leader_of[rank]

    def members_of(self, leader: int) -> List[int]:
        """The other ranks of ``leader``'s host."""
        i = self.leaders.index(leader)
        return list(range(leader + 1, leader + self.slot_sizes[i]))

    def host_ranks(self, i: int) -> List[int]:
        return list(range(self.leaders[i],
                          self.leaders[i] + self.slot_sizes[i]))


def slot_sizes(spec: str) -> Optional[List[int]]:
    """Slots per host of a ``HOROVOD_TOPOLOGY`` string, or None when a
    part names no positive count (``TreeSetup``'s parse: ``atoi`` of
    what follows the last colon, 1 without one)."""
    sizes = []
    for part in spec.split(","):
        if not part:
            continue
        n = 1
        if ":" in part:
            m = re.match(r"\s*[+-]?\d+", part.rsplit(":", 1)[1])
            n = int(m.group()) if m else 0
        if n <= 0:
            return None
        sizes.append(n)
    return sizes


def plan_from_env(rank: int, size: int,
                  schedule_check: bool) -> Optional[TreePlan]:
    """The tree this job coordinates through, or None for flat; rank 0
    warns, in the reference's words, when the tree was asked for and
    cannot be used."""
    if not config.env_bool("HOROVOD_COORD_TREE") or size <= 1:
        return None
    if schedule_check:
        if rank == 0:
            log.warning("HOROVOD_COORD_TREE=1 is incompatible with "
                        "HOROVOD_SCHEDULE_CHECK=1; using flat coordination "
                        "so the schedule verifier can run")
        return None
    spec = config.env_str("HOROVOD_TOPOLOGY")
    sizes = slot_sizes(spec) if spec else []
    if not sizes or sum(sizes) != size or len(sizes) < 2:
        if rank == 0:
            log.warning('HOROVOD_COORD_TREE=1 but HOROVOD_TOPOLOGY ("%s") '
                        "does not map this %d-rank job onto >= 2 hosts; "
                        "using flat coordination", spec, size)
        return None
    return TreePlan(sizes)


class TreeGroups:
    """This rank's gloo groups of the tree: its host's (None when it is
    alone on its host) and the leaders' (None for a member).  Creating a
    group is collective over the default group, so every rank creates
    every group, in the same order."""

    def __init__(self, plan: TreePlan, rank: int, global_ranks: Sequence[int],
                 timeout):
        self.plan = plan
        self.rank = rank
        self.leader = plan.leader_of(rank)
        self.members = plan.members_of(self.leader)
        self.host_group = None
        for i in range(len(plan.leaders)):
            ranks = plan.host_ranks(i)
            if len(ranks) < 2:
                continue
            g = dist.new_group([global_ranks[r] for r in ranks], timeout,
                               backend="gloo")
            if rank in ranks:
                self.host_group = g
        g = dist.new_group([global_ranks[r] for r in plan.leaders], timeout,
                           backend="gloo")
        self.leaders_group = g if rank == self.leader else None

    def groups(self) -> list:
        return [g for g in (self.host_group, self.leaders_group)
                if g is not None]
