"""The port's ``coordination`` and ``runner.rpc.control_call`` against the
reference's (``horovod_tpu/coordination.py``, ``runner/rpc.py``).

``Election``, ``DedupFilter``, ``RetryPolicy`` (fed the same ``rng``
draws), ``PartitionDetector`` and ``TreePlan`` get the same inputs in both
packages and must return the same values.  Then 5 to 9 ``Node``s of each
package run one deterministic episode, driven by the loop below with a
seeded numpy rng for delivery order, delays, drops and duplicates: the
coordinator's host dies, a host is cut off for a while, and the expected
world shrinks.  Every message sent and every commit applied is equal,
tick by tick.  Last, ``control_call`` of both packages against the port's
``RpcServer``: retransmits, de-duplication and giving up within its
deadline.
"""

import numpy as np
import pytest

from horovod_tpu import coordination as jco
from horovod_tpu import faults as jfaults
from horovod_tpu import telemetry as jtel
from horovod_tpu.runner import rpc as jrpc
from horovod_tpu_torch import coordination as co
from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runner import rpc


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    monkeypatch.delenv("HOROVOD_RANK", raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# -- the pieces -----------------------------------------------------------------

@pytest.mark.parametrize("sizes,arity", [([4, 4, 4], 4), ([2] * 11, 4),
                                         ([8] * 32, 4), ([1, 3, 2, 1], 2),
                                         ([1], 3)])
def test_tree_plan_is_the_references(sizes, arity):
    a, b = co.TreePlan(sizes, arity=arity), jco.TreePlan(sizes, arity=arity)
    assert (a.leaders, a.size, a.slot_sizes, a.depth(), a.max_fan_in()) == \
        (b.leaders, b.size, b.slot_sizes, b.depth(), b.max_fan_in())
    for r in range(a.size):
        assert (a.is_leader(r), a.leader_of(r), a.parent_of(r),
                a.children_of(r)) == (b.is_leader(r), b.leader_of(r),
                                      b.parent_of(r), b.children_of(r))
    topo = ",".join(f"h{i}:{s}" for i, s in enumerate(sizes))
    assert co.TreePlan.from_topology_string(topo).leaders == \
        jco.TreePlan.from_topology_string(topo).leaders
    assert co.TreePlan.flat_fan_in(a.size) == jco.TreePlan.flat_fan_in(a.size)


def test_tree_plan_is_the_eager_planes():
    from horovod_tpu_torch.native import coord_tree
    assert co.TreePlan is coord_tree.TreePlan
    for bad in (([], 4), ([2, 0], 4), ([2], 1)):
        with pytest.raises(ValueError):
            co.TreePlan(bad[0], arity=bad[1])
        with pytest.raises(ValueError):
            jco.TreePlan(bad[0], arity=bad[1])


def test_election_is_the_references():
    rng = np.random.default_rng(1)
    a, b = co.Election(2, 5), jco.Election(2, 5)
    assert a.quorum() == b.quorum() == 3
    for _ in range(400):
        epoch, who = int(rng.integers(0, 6)), int(rng.integers(0, 5))
        if rng.random() < 0.5:
            assert a.consider_vote(epoch, who) == b.consider_vote(epoch, who)
        else:
            assert a.record_vote(epoch, who) == b.record_vote(epoch, who)
    assert a.voted == b.voted and a.votes_for_me == b.votes_for_me


@pytest.mark.parametrize("window", [4, 1024])
def test_dedup_filter_is_the_references(window):
    rng = np.random.default_rng(window)
    a, b = co.DedupFilter(window), jco.DedupFilter(window)
    for _ in range(2000):
        src, seq = int(rng.integers(0, 4)), int(rng.integers(0, 40))
        epoch = int(rng.integers(0, 4))
        if rng.random() < 0.02:
            a.advance_epoch(epoch)
            b.advance_epoch(epoch)
        assert a.accept(src, epoch, seq) == b.accept(src, epoch, seq)
    assert (a.epoch, a.dropped_stale, a.dropped_dup) == \
        (b.epoch, b.dropped_stale, b.dropped_dup)
    assert a._seen == b._seen and a._floor == b._floor


@pytest.mark.parametrize("kw", [{}, {"retries": 2, "base_delay": 0.05,
                                     "max_delay": 0.4, "deadline": 3.0}])
def test_retry_policy_is_the_references(kw):
    a, b = co.RetryPolicy(**kw), jco.RetryPolicy(**kw)
    assert tuple(a) == tuple(b)
    draws = np.random.default_rng(5).random(64).tolist()
    ia, ib = iter(draws), iter(draws)
    for attempt in range(32):
        assert a.backoff(attempt, lambda: next(ia)) == \
            b.backoff(attempt, lambda: next(ib))
        for elapsed in (0.0, 2.9, 3.0, 9.99, 10.0, 11.0):
            assert a.give_up(attempt, elapsed) == b.give_up(attempt, elapsed)


@pytest.mark.parametrize("peers", [[1, 2, 3, 4], []])
def test_partition_detector_is_the_references(peers):
    rng = np.random.default_rng(len(peers))
    a = co.PartitionDetector(2.0, peers, coordinator=0, now=0.0)
    b = jco.PartitionDetector(2.0, peers, coordinator=0, now=0.0)
    now = 0.0
    for _ in range(300):
        now += float(rng.random())
        peer = int(rng.integers(0, 6))
        ok = bool(rng.random() < 0.6)
        a.observe(peer, ok, now)
        b.observe(peer, ok, now)
        if rng.random() < 0.03:
            c = int(rng.integers(0, 6))
            a.set_coordinator(c, now)
            b.set_coordinator(c, now)
        excl = [int(x) for x in rng.integers(0, 6, 2)]
        assert a.verdict(now) == b.verdict(now)
        assert a.reachable(now) == b.reachable(now)
        assert a.recent_contact(now, excl) == b.recent_contact(now, excl)
    with pytest.raises(ValueError):
        co.PartitionDetector(0.0, peers, 0)


def test_lease_and_elect_are_the_references():
    a, b = co.LeaseState(3.0, now=1.0), jco.LeaseState(3.0, now=1.0)
    for now, holder, epoch in ((2.0, None, None), (2.5, 1, 0), (3.0, 2, 1),
                               (3.5, 0, 0), (9.0, None, 2)):
        assert a.renew(now, holder, epoch) == b.renew(now, holder, epoch)
        assert vars(a) == vars(b)
        assert a.expired(now + 3.0) == b.expired(now + 3.0)
    assert co.elect([4, 2, 7]) == jco.elect([4, 2, 7]) == 2


# -- nodes, tick by tick ------------------------------------------------------------

def _episode(mod, sizes, seed, ticks=160, dt=0.5, kill_at=30,
             cut=(70, 90)):
    """One deterministic episode of ``mod``'s Nodes; the trace of every
    tick: the messages sent, then each node's commits and state."""
    plan = mod.TreePlan(sizes, arity=2)
    nodes = [mod.Node(r, plan, lease_term=3.0) for r in range(plan.size)]
    rng = np.random.default_rng(seed)
    dead_host = set([0] + plan.members_of(0))
    cut_host = set([plan.leaders[-1]] + plan.members_of(plan.leaders[-1]))
    pending = []            # (due tick, message)
    trace = []
    for t in range(ticks):
        now = t * dt
        if t == kill_at:
            for r in dead_host:
                nodes[r].alive = False
            for n in nodes:
                n.set_expected_world(set(range(plan.size)) - dead_host)
        sent = []
        for n in nodes:
            sent.extend(n.tick(now))
        due = [m for d, m in pending if d <= t]
        pending = [(d, m) for d, m in pending if d > t]
        order = rng.permutation(len(due))
        for i in order:
            m = due[int(i)]
            if cut[0] <= t < cut[1] and (m.src in cut_host) != \
                    (m.dst in cut_host):
                continue
            sent.extend(nodes[m.dst].on_message(m, now))
        for m in sent:
            u = rng.random()
            if u < 0.05:
                continue                          # dropped
            copies = 2 if u > 0.95 else 1         # duplicated
            for _ in range(copies):
                pending.append((t + 1 + int(rng.integers(0, 2)), m))
        trace.append((t, [tuple(m) for m in sent],
                      [(tuple(tuple(c) for c in n.commits), n.round,
                        n.fenced, n.lease.epoch, n.lease.holder,
                        n.election.elections_started, n.sent_messages)
                       for n in nodes]))
    return trace, nodes


@pytest.mark.parametrize("sizes,seed,fails_over", [
    ([1, 1, 1, 1, 1], 1, True), ([2, 2, 2], 3, True),
    ([1, 2, 1, 2, 1], 4, True), ([2, 2, 1, 2], 6, True),
    # Concurrent candidacies split the vote until the end: the same
    # livelock in both packages.
    ([3, 2, 2, 2], 2, False)])
def test_nodes_emit_the_references_messages_tick_by_tick(sizes, seed,
                                                         fails_over):
    got, nodes = _episode(co, sizes, seed)
    want, _ = _episode(jco, sizes, seed)
    for g, w in zip(got, want):
        assert g == w, f"tick {g[0]}"
    assert len(got) == len(want)
    # The episode did what it is for: the coordinator's death started
    # elections, and where a survivor won, commits of its epoch follow.
    assert any(n.election.elections_started for n in nodes)
    assert fails_over == any(c.epoch > 0 and c.coordinator != 0
                             for n in nodes for c in n.commits)


# -- control_call against the port's RpcServer -------------------------------------

KEY = b"control-call-key"


def _server(seen):
    dedup = co.DedupFilter()

    def handler(req):
        fresh = dedup.accept(0, req["epoch"], req["seq"])
        seen.append((req["kind"], req["epoch"], req["seq"], fresh))
        return {"ok": True, "fresh": fresh}

    return rpc.RpcServer(KEY, handler, bind="127.0.0.1")


def _retries(tel):
    from horovod_tpu_torch.telemetry import aggregate
    return aggregate.counter_total(tel.metrics_snapshot(),
                                   "hvd_coord_msg_retries_total",
                                   {"kind": "renew"})


@pytest.mark.parametrize("spec", [
    "",
    "site=control,kind=msg_dup",
    "site=control,kind=msg_drop:2",
    "site=control,kind=msg_delay:5,count=2;site=control,kind=msg_dup",
    "site=control,kind=partition:1",
])
def test_control_call_retransmits_and_dedups_as_the_reference(spec,
                                                             monkeypatch):
    out = {}
    for name, mod, tel, fmod in (("port", rpc, telemetry, faults),
                                 ("ref", jrpc, jtel, jfaults)):
        monkeypatch.setenv(faults.ENV_VAR, spec)
        fmod.reset()
        tel.configure(enabled_flag=True)
        tel.registry().clear()
        seen, sleeps = [], []
        server = _server(seen)
        try:
            draws = iter(np.random.default_rng(0).random(16).tolist())
            resp = mod.control_call("127.0.0.1", server.port,
                                    {"kind": "renew"}, KEY, epoch=3, seq=7,
                                    sleep=sleeps.append,
                                    rng=lambda: next(draws))
            out[name] = (resp, seen, sleeps, _retries(tel))
        finally:
            server.shutdown()
            tel.configure(enabled_flag=False)
            tel.registry().clear()
    assert out["port"] == out["ref"]
    resp, seen, _, _ = out["port"]
    assert resp["ok"] and seen[0][1:] == (3, 7, True)
    assert all(not s[3] for s in seen[1:])      # copies are no-ops


def test_control_call_gives_up_within_its_deadline_as_the_reference():
    errs = {}
    for name, mod in (("port", rpc), ("ref", jrpc)):
        now, sleeps = [0.0], []

        def sleep(s):
            sleeps.append(s)
            now[0] += s

        draws = iter(np.random.default_rng(0).random(16).tolist())
        with pytest.raises(ConnectionError, match="kind=renew") as e:
            mod.control_call("127.0.0.1", 9, {"kind": "renew"}, KEY,
                             epoch=1, seq=2, retries=2, deadline=5.0,
                             timeout=0.1, sleep=sleep,
                             rng=lambda: next(draws), clock=lambda: now[0])
        errs[name] = (str(e.value).split(": ")[0], sleeps)
    assert errs["port"] == errs["ref"]
    assert "failed after 3 attempts" in errs["port"][0]


def test_control_call_reads_the_references_knobs(monkeypatch):
    monkeypatch.setenv("HOROVOD_COORD_MSG_RETRIES", "0")
    now = [0.0]
    with pytest.raises(ConnectionError, match="after 1 attempts"):
        rpc.control_call("127.0.0.1", 9, {"kind": "renew"}, KEY,
                         sleep=lambda s: None, clock=lambda: now[0],
                         timeout=0.1)


def test_probe_and_addresses_are_the_references(monkeypatch):
    seen = []
    server = _server(seen)
    try:
        assert rpc.probe_reachable("127.0.0.1", server.port) == \
            jrpc.probe_reachable("127.0.0.1", server.port) is True
    finally:
        server.shutdown()
    assert rpc.probe_reachable("127.0.0.1", 9, timeout=0.5) == \
        jrpc.probe_reachable("127.0.0.1", 9, timeout=0.5) is False
    import socket

    class NoRoute:
        def __init__(self, *a, **k):
            pass

        def connect(self, addr):
            raise OSError("no route")

    monkeypatch.setattr(socket, "socket", NoRoute)
    monkeypatch.setattr(socket, "gethostname", lambda: "node-a")
    monkeypatch.setattr(socket, "getaddrinfo", lambda *a, **k: [
        (2, 1, 6, "", ("10.1.2.3", 0)), (2, 1, 6, "", ("127.0.0.1", 0)),
        (2, 1, 6, "", ("10.0.0.9", 0))])
    assert rpc.local_addresses() == jrpc.local_addresses() == \
        ["10.0.0.9", "10.1.2.3"]
