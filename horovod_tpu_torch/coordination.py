"""The launcher's part of the coordination protocol: the coordinator
lease and the election rule.

Counterpart of ``horovod_tpu/coordination.py`` ``LeaseState`` and
``elect`` (``:160-211``), which the launcher's coordination plane
(``runner/run.py`` ``_CoordinationPlane``) runs over the heartbeats:
rank 0's heartbeat renews the lease, and when the coordinator's host
drops out the lowest healthy leader owns the next epoch.  Like the
reference these are pure state machines with an injected clock (every
method takes ``now``).  The host grouping (``TreePlan``) lives in
:mod:`horovod_tpu_torch.native.coord_tree`; the rest of the reference's
module (the protocol simulator's nodes, votes, dedup and retry) has no
caller in the port yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

PREEMPTION_RC = 75   # same contract as runner.run / resilience: reschedule


class LeaseState:
    """The coordinator lease: ``holder`` owns coordination for ``epoch``
    until ``term_seconds`` pass without a renewal.  Followers run the
    same object fed by observed renewals; expiry at a follower is the
    election trigger."""

    def __init__(self, term_seconds: float, holder: int = 0,
                 epoch: int = 0, now: float = 0.0):
        if term_seconds <= 0:
            raise ValueError(f"lease term must be > 0, got {term_seconds}")
        self.term = float(term_seconds)
        self.holder = holder
        self.epoch = epoch
        self.expires_at = now + self.term
        self.renewals = 0

    def renew(self, now: float, holder: Optional[int] = None,
              epoch: Optional[int] = None) -> bool:
        """Record a renewal (observed or self-issued).  Renewals from a
        stale epoch are discarded; a renewal from a newer epoch adopts
        the new holder.  Returns True when the lease advanced."""
        if epoch is not None and epoch < self.epoch:
            return False
        if epoch is not None and epoch > self.epoch:
            self.epoch = epoch
            self.holder = holder if holder is not None else self.holder
        elif holder is not None:
            self.holder = holder
        self.expires_at = now + self.term
        self.renewals += 1
        return True

    def expired(self, now: float) -> bool:
        return now >= self.expires_at

    def remaining(self, now: float) -> float:
        return max(0.0, self.expires_at - now)


def elect(healthy_leaders: Sequence[int]) -> int:
    """The lowest healthy leader rank owns the next epoch.  Raises when
    no leader survives (the job is dead: abort, don't loop)."""
    if not healthy_leaders:
        raise RuntimeError("no healthy leader left to elect")
    return min(healthy_leaders)
