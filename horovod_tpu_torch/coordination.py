"""Control-plane protocol core: lease, election, dedup, bounded retry,
partition detection and the simulated protocol node.

Counterpart of ``horovod_tpu/coordination.py``.  Like the reference these
are pure state machines on the host with an injected clock (every method
takes ``now``; nothing reads the time), shared by:

* the launcher's coordination plane (``runner/run.py``
  ``_CoordinationPlane``): the coordinator lease renewed by rank 0's
  heartbeats, and the deterministic re-election (:func:`elect`) of the
  lowest healthy leader when the coordinator's host drops out;
* the control wire (``runner.rpc.control_call``): every send is stamped
  ``(epoch, seq)`` and retransmitted under a :class:`RetryPolicy`; a
  receiver's :class:`DedupFilter` makes the retransmits idempotent;
* :class:`Node`, one simulated controller (member, host leader or
  coordinator) that a test or a simulator drives tick by tick over
  virtual pipes: tree agreement along :class:`TreePlan` (READY up, one
  AGG per host, COMMIT down), lease and majority election (one vote per
  epoch, for the lowest candidate heard from), and self-fencing of a node
  that a :class:`PartitionDetector` finds cut off from the majority.

``TreePlan`` lives in :mod:`horovod_tpu_torch.native.coord_tree`, where
tree coordination of the eager plane uses it; it is re-exported here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Set

from horovod_tpu_torch.native.coord_tree import TreePlan

__all__ = ["PREEMPTION_RC", "TreePlan", "LeaseState", "elect", "Election",
           "DedupFilter", "RetryPolicy", "PartitionDetector", "Msg",
           "Commit", "Node"]

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


class Election:
    """Vote bookkeeping for one node across epochs.

    Safety comes from two rules: (1) a node votes at most once per
    epoch, always for the lowest candidate it has heard from, and (2) a
    candidate needs votes from a *majority* of the leader set to win.
    Two winners in one epoch would require two disjoint majorities —
    impossible — which is exactly the invariant the simulator asserts.
    """

    def __init__(self, node: int, n_leaders: int):
        self.node = node
        self.n_leaders = n_leaders
        self.voted: Dict[int, int] = {}        # epoch -> candidate voted for
        self.votes_for_me: Dict[int, Set[int]] = {}   # epoch -> voter set
        self.elections_started = 0

    def quorum(self) -> int:
        return self.n_leaders // 2 + 1

    def consider_vote(self, epoch: int, candidate: int) -> Optional[int]:
        """A VOTE_REQ arrived.  Grant (return the candidate to ack) iff
        we have not voted in ``epoch``, or re-grant idempotently to the
        same candidate (its retransmits must not starve it).  Strict
        single-vote is the safety half; determinism ("lowest healthy
        leader wins") comes from candidacy staggering by seniority, not
        from re-voting — two votes in one epoch could hand two
        overlapping majorities."""
        prev = self.voted.get(epoch)
        if prev is not None:
            return candidate if prev == candidate else None
        self.voted[epoch] = candidate
        return candidate

    def record_vote(self, epoch: int, voter: int) -> bool:
        """A VOTE_ACK for our own candidacy.  True when this vote
        completes a majority (win fires exactly once per epoch)."""
        got = self.votes_for_me.setdefault(epoch, set())
        before = len(got) >= self.quorum()
        got.add(voter)
        return not before and len(got) >= self.quorum()


# ---------------------------------------------------------------------------
# Dedup + retry
# ---------------------------------------------------------------------------

class DedupFilter:
    """(epoch, seq) replay/staleness filter, per source.

    ``accept`` is the single gate every control receive passes: stale
    epochs are discarded outright (responses from a dead coordinator
    must not be acted on), and within the live epoch a (src, seq) pair
    is accepted once — retransmits and chaos ``msg_dup`` become no-ops.
    A bounded out-of-order window keeps memory O(window) per source.
    """

    def __init__(self, window: int = 1024):
        self.window = window
        self.epoch = 0
        self._seen: Dict[int, Set[int]] = {}     # src -> recent seqs
        self._floor: Dict[int, int] = {}         # src -> seqs <= floor seen
        self.dropped_stale = 0
        self.dropped_dup = 0

    def advance_epoch(self, epoch: int) -> None:
        if epoch > self.epoch:
            self.epoch = epoch
            self._seen.clear()
            self._floor.clear()

    def accept(self, src: int, epoch: int, seq: int) -> bool:
        if epoch < self.epoch:
            self.dropped_stale += 1
            return False
        if epoch > self.epoch:
            self.advance_epoch(epoch)
        floor = self._floor.get(src, -1)
        if seq <= floor:
            self.dropped_dup += 1
            return False
        seen = self._seen.setdefault(src, set())
        if seq in seen:
            self.dropped_dup += 1
            return False
        seen.add(seq)
        # Slide the window: once it overflows, everything at or below
        # the smallest tracked seq is treated as already-seen.
        while len(seen) > self.window:
            low = min(seen)
            seen.discard(low)
            self._floor[src] = max(self._floor.get(src, -1), low)
        return True


class RetryPolicy(NamedTuple):
    """Bounded retry with jittered exponential backoff and a total
    per-message deadline — the contract every coordination send obeys
    (``runner.rpc.control_call`` live, ``Node`` retransmits simulated).
    """
    retries: int = 4
    base_delay: float = 0.2
    max_delay: float = 3.0
    deadline: float = 10.0

    def backoff(self, attempt: int, rng: Callable[[], float]) -> float:
        """Delay before retry ``attempt`` (0-based), jittered to
        [0.5, 1.5)x so retransmit herds decorrelate."""
        return min(self.max_delay,
                   self.base_delay * (2.0 ** attempt)) * (0.5 + rng())

    def give_up(self, attempt: int, elapsed: float) -> bool:
        return attempt > self.retries or elapsed >= self.deadline


# ---------------------------------------------------------------------------
# Partition detection
# ---------------------------------------------------------------------------

class PartitionDetector:
    """Distinguishes "the coordinator died" (elect a new one) from "I am
    the one cut off" (self-fence, exit rc 75 so the scheduler reschedules
    a reachable replacement).

    Fed with per-peer reachability observations; after ``grace`` seconds
    of coordinator silence the verdict is ``coordinator_dead`` only if a
    majority of peers is still reachable — otherwise the minority side
    must fence instead of electing a split-brain coordinator.
    """

    HEALTHY = "healthy"
    COORDINATOR_DEAD = "coordinator_dead"
    PARTITIONED = "partitioned"

    def __init__(self, grace: float, peers: Sequence[int],
                 coordinator: int, now: float = 0.0):
        if grace <= 0:
            raise ValueError(f"partition grace must be > 0, got {grace}")
        self.grace = float(grace)
        self.coordinator = coordinator
        self._last_ok: Dict[int, float] = {p: now for p in peers}
        self._last_ok.setdefault(coordinator, now)

    def observe(self, peer: int, ok: bool, now: float) -> None:
        if ok:
            self._last_ok[peer] = now

    def set_coordinator(self, coordinator: int, now: float) -> None:
        self.coordinator = coordinator
        self._last_ok.setdefault(coordinator, now)

    def reachable(self, now: float) -> List[int]:
        return [p for p, t in self._last_ok.items()
                if now - t < self.grace]

    def recent_contact(self, now: float, exclude: Sequence[int] = ()
                       ) -> bool:
        """Any evidence of life from a peer outside ``exclude`` within
        the grace window?  The fence decision keys off this: a node
        whose election traffic draws *zero* off-host responses is the
        partitioned one; a node that hears voters has a live majority
        side to join."""
        skip = set(exclude)
        return any(now - t < self.grace
                   for p, t in self._last_ok.items() if p not in skip)

    def verdict(self, now: float) -> str:
        if now - self._last_ok.get(self.coordinator, -math.inf) < self.grace:
            return self.HEALTHY
        peers = [p for p in self._last_ok if p != self.coordinator]
        if not peers:
            # Nothing to compare against (np=1-per-plane): treat silence
            # as a dead coordinator, not self-partition.
            return self.COORDINATOR_DEAD
        up = sum(1 for p in peers if now - self._last_ok[p] < self.grace)
        if up * 2 >= len(peers):
            return self.COORDINATOR_DEAD
        return self.PARTITIONED


# ---------------------------------------------------------------------------
# Simulated protocol node (driven tick by tick by a test or a simulator)
# ---------------------------------------------------------------------------

class Msg(NamedTuple):
    """One control message on the virtual wire.  ``seq`` is per-sender
    and monotone; (epoch, seq) is the dedup key."""
    kind: str          # ready | agg | commit | vote_req | vote_ack | new_epoch
    src: int
    dst: int
    epoch: int
    seq: int
    round: int         # agreement round the message belongs to
    payload: tuple = ()


class Commit(NamedTuple):
    epoch: int
    round: int
    coordinator: int


class Node:
    """One simulated controller: member, host leader, or coordinator —
    role derived from :class:`TreePlan` plus the live epoch's holder.

    The simulator calls :meth:`tick` once per virtual tick and routes
    every delivery through :meth:`on_message`; both return the messages
    to send.  All safety-relevant state (commit log, vote bookkeeping,
    fencing) is inspectable so the test suite asserts invariants over
    the whole population, not just the survivor's say-so.
    """

    def __init__(self, rank: int, plan: TreePlan, lease_term: float,
                 retry: RetryPolicy = RetryPolicy(), now: float = 0.0):
        self.rank = rank
        self.plan = plan
        self.retry = retry
        self.lease = LeaseState(lease_term, holder=0, epoch=0, now=now)
        self.election = Election(rank, len(plan.leaders))
        self.dedup = DedupFilter()
        self.detector = PartitionDetector(
            grace=lease_term, coordinator=0, now=now,
            peers=[r for r in plan.leaders if r != rank])
        self.commits: List[Commit] = []    # commits this node APPLIED
        self.committed_as_coord: List[Commit] = []   # commits it ISSUED
        self.round = 0                     # next round to complete
        self.fenced = False                # self-fenced (rc 75 analog)
        self.alive = True
        self._seq = 0
        self._ready_children: Dict[int, Set[int]] = {}  # round -> ranks
        self._sent_ready_at: Dict[int, float] = {}      # round -> last send
        self._first_ready_at: Dict[int, float] = {}     # round -> first send
        self._ready_attempts: Dict[int, int] = {}
        self._candidacy_epoch = 0
        self._candidacy_at = -math.inf
        self._last_broadcast = now
        leader = plan.leader_of(rank)
        self._host_ranks = {leader, *plan.members_of(leader)}
        self.sent_messages = 0

    # -- helpers -----------------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _msg(self, kind: str, dst: int, round_: int,
             payload: tuple = ()) -> Msg:
        self.sent_messages += 1
        return Msg(kind, self.rank, dst, self.lease.epoch,
                   self._next_seq(), round_, payload)

    @property
    def is_coordinator(self) -> bool:
        return self.lease.holder == self.rank

    def _is_leader(self) -> bool:
        return self.plan.is_leader(self.rank)

    def _parent(self) -> Optional[int]:
        """Tree parent under the live epoch: the elected coordinator
        stands in for the original root when rank 0 is gone."""
        p = self.plan.parent_of(self.rank)
        if p == 0 and self.lease.holder != 0 and self._is_leader():
            return None if self.is_coordinator else self.lease.holder
        return p

    def _children(self) -> List[int]:
        kids = list(self.plan.children_of(self.rank))
        if self.is_coordinator and self.rank != 0:
            # Adopted root: the old coordinator's child leaders re-home
            # here (minus ourselves).
            for r in self.plan.children_of(0):
                if r != self.rank and self.plan.is_leader(r):
                    kids.append(r)
        return kids

    # -- tick --------------------------------------------------------------

    def tick(self, now: float) -> List[Msg]:
        if not self.alive or self.fenced:
            return []
        out: List[Msg] = []
        if self.is_coordinator:
            out.extend(self._coordinator_tick(now))
        else:
            out.extend(self._follower_tick(now))
        return out

    def _follower_tick(self, now: float) -> List[Msg]:
        out: List[Msg] = []
        parent = self._parent()
        # (Re)send READY for the current round until its COMMIT lands —
        # the bounded-retry loop that makes message drops survivable.
        if parent is not None:
            attempts = self._ready_attempts.get(self.round, 0)
            last = self._sent_ready_at.get(self.round, -math.inf)
            elapsed = now - self._first_ready_at.get(self.round, now)
            if attempts == 0 or (now - last >= 1.0
                                 and not self.retry.give_up(
                                     attempts - 1, elapsed)):
                self._ready_attempts[self.round] = attempts + 1
                self._sent_ready_at[self.round] = now
                self._first_ready_at.setdefault(self.round, now)
                kind = "agg" if self._is_leader() else "ready"
                ranks = self._agg_ranks(self.round)
                out.append(self._msg(kind, parent, self.round,
                                     payload=tuple(sorted(ranks))))
        # Lease watch: only leaders arbitrate epochs.  No fence here —
        # at first expiry "coordinator dead" and "I am cut off" look
        # identical; candidacy traffic is what disambiguates them
        # (voters answer the former, silence proves the latter).
        if self._is_leader() and self.lease.expired(now):
            out.extend(self._candidacy_tick(now))
        return out

    def _candidacy_tick(self, now: float) -> List[Msg]:
        """Bid for the next epoch, staggered by seniority: the leader
        with the lowest rank (holder excluded) bids first, one tick per
        seniority step, so in the common case exactly one candidate
        exists and it is the lowest healthy leader — the deterministic
        rule :func:`elect` states.  A live candidacy retransmits its
        VOTE_REQs every tick (grants are idempotent); if it cannot win
        within ~3 lease terms (vote split after concurrent expiry, or
        chaos ate the quorum) it bumps to a fresh epoch and retries."""
        peers = [r for r in self.plan.leaders if r != self.lease.holder]
        try:
            stagger = float(sorted(peers).index(self.rank))
        except ValueError:      # the expired holder itself: bid last
            stagger = float(len(peers))
        if now - self.lease.expires_at < stagger:
            return []
        if self._candidacy_epoch > self.lease.epoch:
            if now - self._candidacy_at <= 3.0 * self.lease.term:
                return self._rebroadcast_candidacy(now)
            # A full candidacy window with no win.  If nobody off-host
            # answered at all we are the partitioned side: self-fence
            # (exit rc 75 live) instead of campaigning into a minority.
            if not self.detector.recent_contact(
                    now, exclude=self._host_ranks):
                self.fenced = True
                return []
            # Voters exist but the bid split or chaos ate the quorum:
            # move to a fresh epoch and retry.
        return self._start_candidacy(now)

    def _reset_retransmits(self) -> None:
        """Forget per-round retransmit bookkeeping.  Runs on every epoch
        change: retry exhaustion is a verdict about the *old* epoch's
        wire (its coordinator may simply be gone), and carrying it into
        the new epoch would leave followers permanently mute — the new
        coordinator would hear silence, read it as a partition, and
        fence, cascading the failover instead of healing it."""
        self._ready_attempts.clear()
        self._sent_ready_at.clear()
        self._first_ready_at.clear()

    def _rebroadcast_candidacy(self, now: float) -> List[Msg]:
        out = []
        for peer in self.plan.leaders:
            if peer != self.rank:
                out.append(self._msg("vote_req", peer, self.round,
                                     payload=(self._candidacy_epoch,)))
        return out

    def _agg_ranks(self, round_: int) -> Set[int]:
        """The rank set this node's READY/AGG vouches for: itself plus
        every descendant whose aggregate already arrived."""
        ranks = {self.rank}
        ranks.update(self._ready_children.get(round_, ()))
        return ranks

    def _start_candidacy(self, now: float) -> List[Msg]:
        new_epoch = max(self.lease.epoch, self._candidacy_epoch) + 1
        self._candidacy_epoch = new_epoch
        self._candidacy_at = now
        self.election.elections_started += 1
        # Vote for ourselves first — consider_vote enforces the
        # lowest-candidate rule against later, lower bids too.
        self.election.consider_vote(new_epoch, self.rank)
        self.election.record_vote(new_epoch, self.rank)
        out = []
        for peer in self.plan.leaders:
            if peer != self.rank:
                out.append(self._msg("vote_req", peer, self.round,
                                     payload=(new_epoch,)))
        # Quorum of 1 (single-leader world): win immediately.
        if self.election.quorum() <= 1:
            out.extend(self._become_coordinator(new_epoch, now))
        return out

    def _become_coordinator(self, epoch: int, now: float) -> List[Msg]:
        self.lease.renew(now, holder=self.rank, epoch=epoch)
        self.dedup.advance_epoch(epoch)
        self.detector.set_coordinator(self.rank, now)
        self._ready_children.clear()
        self._reset_retransmits()
        self._last_broadcast = now
        out = []
        # NEW_EPOCH carries the round everyone restarts agreement from:
        # commit propagation may have torn mid-failover, so the gang
        # re-synchronizes on the new coordinator's view.  Our own host
        # members get it directly — the usual leader relay fires in
        # _on_new_epoch, which the winner never receives.
        peers = [r for r in self.plan.leaders if r != self.rank]
        peers.extend(self.plan.members_of(self.rank))
        for peer in peers:
            out.append(self._msg("new_epoch", peer, self.round,
                                 payload=(epoch, self.rank, self.round)))
        return out

    def _coordinator_tick(self, now: float) -> List[Msg]:
        # A coordinator that heard nothing off-host for a whole lease
        # term is the minority side of a partition: fence rather than
        # keep committing blind (its epoch dies with it; receivers'
        # dedup drops any in-flight responses).
        offhost_world = self._live_world() - self._host_ranks
        if offhost_world and not self.detector.recent_contact(
                now, exclude=self._host_ranks):
            self.fenced = True
            return []
        # Self-renew; followers learn of it via COMMIT broadcasts and,
        # between commits, explicit RENEW carriers — a slow round must
        # not read as a dead coordinator.
        self.lease.renew(now, holder=self.rank, epoch=self.lease.epoch)
        out: List[Msg] = []
        ready = self._ready_children.setdefault(self.round, set())
        expected = self._live_world()
        if ready | {self.rank} >= expected:
            commit = Commit(self.lease.epoch, self.round, self.rank)
            self.committed_as_coord.append(commit)
            self.commits.append(commit)
            done = self.round
            self.round += 1
            self._last_broadcast = now
            for child in self._children():
                out.append(self._msg("commit", child, done,
                                     payload=(self.lease.holder,)))
        elif now - self._last_broadcast >= self.lease.term / 4.0:
            self._last_broadcast = now
            for child in self._children():
                if self.plan.is_leader(child):
                    out.append(self._msg("renew", child, self.round,
                                         payload=(self.lease.holder,)))
        return out

    def _live_world(self) -> Set[int]:
        """Ranks the coordinator must hear from before committing
        (dead hosts drop out of the gang exactly like the launcher's
        blacklist path; the simulator narrows this when it kills
        hosts)."""
        return set(self._expected_world)

    # The simulator narrows the expected world when it kills hosts; the
    # default is everyone.
    @property
    def _expected_world(self) -> Set[int]:
        return getattr(self, "_world_override",
                       set(range(self.plan.size)))

    def set_expected_world(self, ranks: Set[int]) -> None:
        self._world_override = set(ranks)

    # -- receive -----------------------------------------------------------

    def on_message(self, msg: Msg, now: float) -> List[Msg]:
        if not self.alive or self.fenced:
            return []
        if not self.dedup.accept(msg.src, msg.epoch, msg.seq):
            if msg.epoch < self.lease.epoch and msg.kind in ("ready",
                                                             "agg"):
                # The sender is stuck in a dead epoch — its one-shot
                # NEW_EPOCH must have dropped on the wire.  Its stale
                # report doubles as the retransmission request: re-teach
                # it the live epoch (idempotent at the receiver).
                return [self._msg("new_epoch", msg.src, self.round,
                                  payload=(self.lease.epoch,
                                           self.lease.holder,
                                           self.round))]
            return []
        if msg.epoch > self.lease.epoch and msg.kind not in (
                "vote_req", "new_epoch", "renew", "commit"):
            # A newer epoch exists but we have not adopted it yet.
            # Election and coordinator-originated carriers (NEW_EPOCH,
            # RENEW, COMMIT — only a winner issues them) move us there;
            # peer data stamped with the future epoch is not acted on.
            return []
        self.detector.observe(msg.src, True, now)
        handler = getattr(self, f"_on_{msg.kind}")
        return handler(msg, now)

    def _on_ready(self, msg: Msg, now: float) -> List[Msg]:
        if msg.round < self.round:
            # The sender missed this round's COMMIT (dropped on the
            # wire); its retransmitted READY is the retransmission
            # request — answer with the commit it lacks.
            return [self._msg("commit", msg.src, msg.round,
                              payload=(self.lease.holder,))]
        self._ready_children.setdefault(msg.round, set()).update(
            msg.payload or (msg.src,))
        return []

    _on_agg = _on_ready

    def _note_coordinator_alive(self, now: float) -> None:
        """A renewal reached us: the coordinator lives, the round is
        merely slow.  Restart the current round's retransmit budget —
        give-up is a verdict about a dead wire, and a live lease is
        proof the wire isn't dead."""
        self._ready_attempts.pop(self.round, None)
        self._first_ready_at.pop(self.round, None)

    def _on_commit(self, msg: Msg, now: float) -> List[Msg]:
        holder = msg.payload[0] if msg.payload else msg.src
        self.lease.renew(now, holder=holder, epoch=msg.epoch)
        self.detector.set_coordinator(holder, now)
        self._note_coordinator_alive(now)
        if msg.round >= self.round:
            self.commits.append(Commit(msg.epoch, msg.round, holder))
            self.round = msg.round + 1
        out = []
        for child in self.plan.children_of(self.rank):
            out.append(self._msg("commit", child, msg.round,
                                 payload=(holder,)))
        return out

    def _on_renew(self, msg: Msg, now: float) -> List[Msg]:
        holder = msg.payload[0] if msg.payload else msg.src
        self.lease.renew(now, holder=holder, epoch=msg.epoch)
        self.detector.set_coordinator(holder, now)
        self._note_coordinator_alive(now)
        out = []
        # Relay to the whole subtree — members too, so a long round
        # never reads as a dead coordinator anywhere in the gang.
        for child in self.plan.children_of(self.rank):
            out.append(self._msg("renew", child, msg.round,
                                 payload=(holder,)))
        return out

    def _on_vote_req(self, msg: Msg, now: float) -> List[Msg]:
        (new_epoch,) = msg.payload
        if new_epoch <= self.lease.epoch:
            return []
        if not self.lease.expired(now):
            # We still see a live coordinator; refusing keeps a fast
            # rogue candidate from displacing it (raft's lease check).
            return []
        granted = self.election.consider_vote(new_epoch, msg.src)
        if granted is None:
            return []
        return [self._msg("vote_ack", msg.src, msg.round,
                          payload=(new_epoch,))]

    def _on_vote_ack(self, msg: Msg, now: float) -> List[Msg]:
        (new_epoch,) = msg.payload
        if new_epoch <= self.lease.epoch:
            return []
        if self.election.record_vote(new_epoch, msg.src):
            return self._become_coordinator(new_epoch, now)
        return []

    def _on_new_epoch(self, msg: Msg, now: float) -> List[Msg]:
        epoch, holder = msg.payload[0], msg.payload[1]
        sync_round = msg.payload[2] if len(msg.payload) > 2 else None
        if epoch < self.lease.epoch:
            return []
        stepping_down = self.is_coordinator and holder != self.rank
        self.lease.renew(now, holder=holder, epoch=epoch)
        self.dedup.advance_epoch(epoch)
        self.detector.set_coordinator(holder, now)
        if stepping_down:
            # A healed ex-coordinator must not keep committing its old
            # epoch; its in-flight responses die at everyone's dedup.
            self._ready_children.clear()
        self._reset_retransmits()
        if sync_round is not None and sync_round != self.round:
            # Re-anchor agreement on the new coordinator's round.
            self.round = sync_round
        out = []
        # Leaders relay the epoch change to their members so the whole
        # subtree re-homes (members just track the holder for reports).
        members = self.plan.members_of(self.rank) if self._is_leader() else []
        for child in members:
            out.append(self._msg("new_epoch", child, msg.round,
                                 payload=(epoch, holder, self.round)))
        return out
