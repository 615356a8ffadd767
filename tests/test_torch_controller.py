"""The port's coordinator, response cache and stall inspector, without
processes: request lists from 3 virtual ranks go into
``horovod_tpu_torch.native.controller.Controller`` and the responses are
checked against the reference's rules (``horovod_tpu/native/cc/src/
controller.cc``).  Each expected error message is the reference's
format string (``controller.cc:917-1203``) filled in by hand.
"""

import logging

import pytest
import torch

from horovod_tpu_torch.native.controller import Controller, fuse
from horovod_tpu_torch.native.message import (OpType, ReduceOp, Request,
                                              RequestList, Response)
from horovod_tpu_torch.native.response_cache import ResponseCache
from horovod_tpu_torch.native.stall_inspector import StallInspector
from horovod_tpu_torch.ops import collective
from torch_support import caplog  # noqa: F401

A, G, B, T, RS = (OpType.ALLREDUCE, OpType.ALLGATHER, OpType.BROADCAST,
                  OpType.ALLTOALL, OpType.REDUCESCATTER)


def req(rank, name, op=A, dtype="float32", arg=ReduceOp.SUM, shape=(4,),
        set_id=0, splits=()):
    return Request(rank=rank, op_type=op, name=name, dtype=dtype,
                   arg=int(arg), set_id=set_id, shape=tuple(shape),
                   splits=tuple(splits))


def join(rank):
    return req(rank, "hvd.join", op=OpType.JOIN, dtype="int32", arg=0,
               shape=(1,))


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def make(size=3, cache=None, warn=60.0, shutdown=0.0, clock=None):
    return Controller(size, cache, StallInspector(warn, shutdown,
                                                  clock or Clock()))


def cycle(c, *per_rank, bits=None):
    lists = [RequestList(requests=list(rs)) for rs in per_rank]
    for rank, b in (bits or {}).items():
        lists[rank].cache_hits = b
    return c.cycle(lists).responses


def names(responses):
    return [(r.op_type, r.names, r.error) for r in responses]


def register(c, members, seq=1):
    name = f"hvd.process_set.{seq}"
    out = cycle(c, *[[req(r, name, op=OpType.PROCESS_SET, dtype="int32",
                          arg=0, shape=(1,), splits=members)]
                     for r in range(c.size)])
    assert len(out) == 1 and not out[0].error, out
    return out[0]


# ---------------------------------------------------------------------------
# Readiness
# ---------------------------------------------------------------------------

def test_a_name_is_ready_when_every_rank_submitted_it_in_any_order():
    c = make()
    assert cycle(c, [req(0, "x"), req(0, "y")], [req(1, "y")], []) == []
    out = cycle(c, [], [req(1, "x")], [req(2, "y"), req(2, "x")])
    # Ready order: y completes first (rank 1 had it, rank 2 sends it
    # first), then x; the same list goes to every rank.
    assert names(out) == [(A, ["y"], False), (A, ["x"], False)]
    assert out[0].first_dims == [4] and out[0].cacheable
    assert c.table == {}


def test_joined_ranks_stand_in_and_joins_come_last_then_reset():
    c = make()
    # Rank 2 joins while 0 and 1 still reduce "a": the join completes "a".
    out = cycle(c, [req(0, "a")], [req(1, "a")], [join(2)])
    assert names(out) == [(A, ["a"], False)]
    assert not out[0].cacheable        # rank 2 put no entry in its cache
    # Rank 1 joins, then submits "b" in the same cycle: "b" is ready after
    # the join in arrival order but is answered before it.
    out = cycle(c, [join(0)], [join(1), req(1, "b")], [])
    assert names(out) == [(A, ["b"], False),
                          (OpType.JOIN, ["hvd.join"], False)]
    assert out[-1].arg == 1            # the last rank to join
    assert c.joined == [False] * 3
    # The joined state was reset: "c" waits for rank 2 again.
    assert cycle(c, [req(0, "c")], [req(1, "c")], []) == []
    assert names(cycle(c, [], [], [req(2, "c")])) == [(A, ["c"], False)]


def test_a_join_and_a_registration_need_every_rank():
    c = make()
    assert cycle(c, [join(0)], [join(1)], []) == []
    out = cycle(c, [], [], [join(2)])
    assert names(out) == [(OpType.JOIN, ["hvd.join"], False)]
    assert out[0].arg == 2


def test_process_set_names_need_every_member_and_only_them():
    c = make()
    resp = register(c, (0, 2))
    assert (resp.arg, resp.first_dims) == (1, [0, 2])
    assert register(c, (0, 2), seq=2).arg == 1      # idempotent
    assert register(c, (1, 2), seq=3).arg == 2
    assert cycle(c, [req(0, "p", set_id=1)], [], []) == []
    out = cycle(c, [], [], [req(2, "p", set_id=1)])
    assert names(out) == [(A, ["p"], False)] and not out[0].cacheable
    # Names are scoped per set: "p" of set 2 is another collective, and a
    # joined rank does not stand in for a member.
    cycle(c, [join(0)], [req(1, "p", set_id=2)], [])
    assert cycle(c, [], [], []) == []
    out = cycle(c, [], [], [req(2, "p", set_id=2)])
    assert names(out) == [(A, ["p"], False)] and out[0].set_id == 2


# ---------------------------------------------------------------------------
# Validation: the reference's words
# ---------------------------------------------------------------------------

def _mismatch(requests_per_rank, joined=(), sets=()):
    c = make()
    for members in sets:
        register(c, members, seq=len(c.process_sets) + 1)
    for r in joined:
        cycle(c, *[[join(r)] if q == r else [] for q in range(3)])
    out = cycle(c, *requests_per_rank)
    assert len(out) == 1 and out[0].error, out
    return out[0].error_message


MISMATCHES = {
    "op": ([[req(0, "t")], [req(1, "t", op=G)], [req(2, "t")]],
           "Mismatched collective operations: rank 0 requested allreduce "
           "but rank 1 requested allgather for tensor t."),
    "dtype": ([[req(0, "t")], [req(1, "t", dtype="float64")],
               [req(2, "t")]],
              "Mismatched data types: rank 0 has float32 but rank 1 has "
              "float64 for tensor t."),
    "reduce_op": ([[req(0, "t")], [req(1, "t", arg=ReduceOp.MAX)],
                   [req(2, "t")]],
                  "Mismatched reduction operations for tensor t."),
    "root": ([[req(0, "t", op=B, arg=0)], [req(1, "t", op=B, arg=1)],
              [req(2, "t", op=B, arg=0)]],
             "Mismatched broadcast root ranks for tensor t."),
    "shape": ([[req(0, "t", shape=(3, 2))], [req(1, "t", shape=(4, 2))],
               [req(2, "t", shape=(3, 2))]],
              "Mismatched allreduce tensor shapes: rank 0 has [3, 2] but "
              "rank 1 has [4, 2] for tensor t."),
    "broadcast_shape": ([[req(0, "t", op=B, arg=0, shape=(2,))],
                         [req(1, "t", op=B, arg=0, shape=(3,))],
                         [req(2, "t", op=B, arg=0, shape=(2,))]],
                        "Mismatched broadcast tensor shapes: rank 0 has "
                        "[2] but rank 1 has [3] for tensor t."),
    "root_range": ([[req(r, "t", op=B, arg=5)] for r in range(3)],
                   "Broadcast root rank 5 out of range for job size 3 "
                   "(tensor t)."),
    "allgather_ndim": ([[req(0, "t", op=G, shape=(2, 3))],
                        [req(1, "t", op=G, shape=(2,))],
                        [req(2, "t", op=G, shape=(2, 3))]],
                       "Mismatched allgather tensor ranks for tensor t."),
    "allgather_trailing": ([[req(0, "t", op=G, shape=(2, 3))],
                            [req(1, "t", op=G, shape=(1, 4))],
                            [req(2, "t", op=G, shape=(2, 3))]],
                           "Mismatched allgather trailing dimensions: rank "
                           "0 has [2, 3] but rank 1 has [1, 4] for tensor "
                           "t."),
    "alltoall_splits": ([[req(0, "t", op=T, shape=(3,), splits=(1, 1, 1))],
                         [req(1, "t", op=T, shape=(3,), splits=(3,))],
                         [req(2, "t", op=T, shape=(3,), splits=(1, 1, 1))]],
                        "Mismatched alltoall splits: rank 1 supplied 1 "
                        "splits for group size 3 (tensor t; all ranks must "
                        "pass splits, or none)."),
    "alltoall_trailing": ([[req(0, "t", op=T, shape=(3, 2),
                                splits=(1, 1, 1))],
                           [req(1, "t", op=T, shape=(3, 5),
                                splits=(1, 1, 1))],
                           [req(2, "t", op=T, shape=(3, 2),
                                splits=(1, 1, 1))]],
                          "Mismatched alltoall trailing dimensions: rank 0 "
                          "has [3, 2] but rank 1 has [3, 5] for tensor t."),
    "alltoall_negative": ([[req(r, "t", op=T, shape=(3,),
                                splits=(4, -1, 0) if r == 2 else (1, 1, 1))]
                           for r in range(3)],
                          "Negative alltoall split on rank 2 (tensor t)."),
    "alltoall_sum": ([[req(r, "t", op=T, shape=(3,),
                           splits=(1, 1, 2) if r == 1 else (1, 1, 1))]
                      for r in range(3)],
                     "Alltoall splits of rank 1 sum to 4 but its first "
                     "dimension is 3 (tensor t)."),
    "alltoall_shape": ([[req(r, "t", op=T, shape=(3 + 3 * (r == 2), 2))]
                        for r in range(3)],
                       "Mismatched alltoall tensor shapes for tensor t."),
    "reducescatter_divisible": ([[req(r, "t", op=RS, shape=(4, 2))]
                                 for r in range(3)],
                                "reducescatter requires the first dimension "
                                "(4) to be divisible by the group size 3 "
                                "(tensor t)."),
    "reducescatter_adasum": ([[req(r, "t", op=RS, arg=ReduceOp.ADASUM,
                                   shape=(3,))] for r in range(3)],
                             "Reducescatter does not support the Adasum "
                             "reduction (tensor t)."),
    "process_set_registration": (
        [[req(r, "hvd.process_set.1", op=OpType.PROCESS_SET, dtype="int32",
              arg=0, shape=(1,), splits=(0, 1) if r else (0, 2))]
         for r in range(3)],
        "Mismatched process-set registration: rank 1 proposed a different "
        "member list than rank 0 (hvd.process_set.1)."),
    "process_set_range": (
        [[req(r, "hvd.process_set.1", op=OpType.PROCESS_SET, dtype="int32",
              arg=0, shape=(1,), splits=(0, 7))] for r in range(3)],
        "Process-set member rank 7 out of range for job size 3 "
        "(hvd.process_set.1)."),
    "unknown_set": ([[req(0, "t", set_id=9)], [], []],
                    "Unknown process set id 9 for tensor t (register it "
                    "with add_process_set on every rank first)."),
}

JOINED = {
    "average": ([[req(0, "t", arg=ReduceOp.AVERAGE)],
                 [req(1, "t", arg=ReduceOp.AVERAGE)], []],
                "Allreduce with joined ranks supports only the Sum "
                "reduction (joined ranks contribute zeros; Average would "
                "divide the partial sum by the full world size) for tensor "
                "t."),
    "min": ([[req(0, "t", arg=ReduceOp.MIN)], [req(1, "t", arg=ReduceOp.MIN)],
             []],
            "Allreduce with joined ranks supports only the Sum reduction "
            "(joined ranks contribute zeros; zeros corrupt Min/Max) for "
            "tensor t."),
    "alltoall": ([[req(0, "t", op=T, shape=(3,))],
                  [req(1, "t", op=T, shape=(3,))], []],
                 "Alltoall is not supported while any rank has joined "
                 "(tensor t)."),
    "reducescatter": ([[req(0, "t", op=RS, arg=ReduceOp.AVERAGE, shape=(3,))],
                       [req(1, "t", op=RS, arg=ReduceOp.AVERAGE,
                            shape=(3,))], []],
                      "Reducescatter with joined ranks supports only the "
                      "Sum reduction (tensor t)."),
    "broadcast_root": ([[req(0, "t", op=B, arg=2)], [req(1, "t", op=B, arg=2)],
                        []],
                       "Broadcast root rank 2 has already joined and holds "
                       "no data for tensor t."),
}


@pytest.mark.parametrize("case", sorted(MISMATCHES))
def test_mismatch_messages_are_the_references(case):
    per_rank, want = MISMATCHES[case]
    assert _mismatch(per_rank) == want


@pytest.mark.parametrize("case", sorted(JOINED))
def test_joined_rank_rules_are_the_references(case):
    per_rank, want = JOINED[case]
    assert _mismatch(per_rank, joined=(2,)) == want


def test_set_member_rules_are_the_references():
    assert _mismatch([[req(0, "t", op=B, arg=1, set_id=1)], [],
                      [req(2, "t", op=B, arg=1, set_id=1)]],
                     sets=[(0, 2)]) == (
        "Broadcast root rank 1 is not a member of process set 1 (tensor t).")
    assert _mismatch([[req(0, "t", set_id=1)], [req(1, "t", set_id=1)],
                      [req(2, "t", set_id=1)]], sets=[(0, 2)]) == (
        "Rank 1 submitted tensor t for process set 1 but is not a member "
        "of it.")


def test_an_error_answers_every_rank_and_the_next_name_goes_on():
    c = make()
    out = cycle(c, [req(0, "t", shape=(3,)), req(0, "u")],
                [req(1, "t"), req(1, "u")], [req(2, "t"), req(2, "u")])
    assert [(r.names, r.error) for r in out] == [(["t"], True),
                                                 (["u"], False)]


# ---------------------------------------------------------------------------
# Fuse
# ---------------------------------------------------------------------------

def _ar(name, n=4, dtype="float32", arg=ReduceOp.SUM, set_id=0, error=False):
    return Response(op_type=A, names=[name], dtype=dtype, arg=int(arg),
                    set_id=set_id, error=error, first_dims=[n])


@pytest.mark.parametrize("case", ["dtype", "op", "set", "threshold",
                                  "adasum", "error", "other_op"])
def test_fuse_groups_consecutive_allreduces_of_one_kind(case):
    base = [_ar("a"), _ar("b")]
    other = {
        "dtype": _ar("c", dtype="bfloat16"),
        "op": _ar("c", arg=ReduceOp.MAX),
        "set": _ar("c", set_id=1),
        "threshold": _ar("c", n=13),
        "adasum": _ar("c", arg=ReduceOp.ADASUM),
        "error": _ar("c", error=True),
        "other_op": Response(op_type=B, names=["c"], first_dims=[4]),
    }[case]
    out = fuse(base + [other, _ar("d")], threshold=4 * 16)
    assert [r.names for r in out] == [["a", "b"], ["c"], ["d"]]
    assert out[0].first_dims == [4, 4]
    # Without the odd one out, one buffer up to the threshold: 16 floats.
    out = fuse([_ar("a"), _ar("b"), _ar("d"), _ar("e", n=5)], 4 * 16)
    assert [r.names for r in out] == [["a", "b", "d"], ["e"]]


def test_fuse_never_joins_two_adasum_names():
    out = fuse([_ar("a", arg=ReduceOp.ADASUM), _ar("b", arg=ReduceOp.ADASUM)],
               1 << 20)
    assert [r.names for r in out] == [["a"], ["b"]]


@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16,
                                   torch.float32])
def test_the_prescale_sets_the_wire_dtype_as_numpy(dtype):
    """The caller scales before it submits (the reference's numpy
    ``arr * prescale``): a scaled int32 tensor is announced as float64
    and never shares a buffer with an unscaled one."""
    t = torch.ones(3, dtype=dtype)
    plain = collective._allreduce_entry(t, collective.Sum, "p", 1.0, 0)
    half = collective._allreduce_entry(t, collective.Sum, "h", 0.5, 0)
    want = {torch.int32: "float64", torch.bfloat16: "float32",
            torch.float32: "float32"}[dtype]
    assert plain.request(0).dtype == str(dtype).removeprefix("torch.")
    assert half.request(0).dtype == want


# ---------------------------------------------------------------------------
# Response cache
# ---------------------------------------------------------------------------

def _put_all(caches, rank_requests, resp):
    for cache, r in zip(caches, rank_requests):
        cache.put(r, resp)


def test_cached_names_are_announced_by_bit_and_expanded():
    caches = [ResponseCache(8) for _ in range(3)]
    c = make(cache=caches[0])
    reqs = [req(r, "g", op=G, shape=(r + 1, 2)) for r in range(3)]
    out = cycle(c, *[[q] for q in reqs])
    assert out[0].first_dims == [2, 4, 6]
    _put_all(caches, reqs, out[0])
    slots = [cache.lookup(q) for cache, q in zip(caches, reqs)]
    assert slots == [0, 0, 0]
    # Every rank announces the bit; rank 0 expands each to that rank's
    # own first dimension from the cached response.
    again = cycle(c, [], [], [], bits={r: 1 << 0 for r in range(3)})
    assert again == out


def test_a_changed_shape_misses_and_refreshes_its_slot():
    cache = ResponseCache(4)
    a = req(0, "a", shape=(8,))
    cache.put(a, _ar("a", 8))
    assert cache.lookup(a) == 0
    changed = req(0, "a", shape=(3, 3))
    assert cache.lookup(changed) == -1
    cache.put(changed, _ar("a", 9))
    assert cache.lookup(changed) == 0 and cache.lookup(a) == -1
    assert len(cache) == 1


def test_the_oldest_slot_is_evicted_at_capacity():
    cache = ResponseCache(2)
    for name in ("a", "b", "c"):
        cache.put(req(0, name), _ar(name))
    assert cache.lookup(req(0, "a")) == -1
    assert cache.lookup(req(0, "b")) == 1 and cache.lookup(req(0, "c")) == 0
    assert ResponseCache(0).lookup(req(0, "a")) == -1


def test_capacity_comes_from_the_environment(monkeypatch):
    from horovod_tpu_torch import config
    monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", "7")
    assert config.cache_capacity() == 7
    monkeypatch.delenv("HOROVOD_CACHE_CAPACITY")
    assert config.cache_capacity() == 1024


# ---------------------------------------------------------------------------
# Stall inspector and shutdown
# ---------------------------------------------------------------------------

def test_stall_warns_then_fails_the_name(caplog):
    clock = Clock()
    c = make(warn=1.0, shutdown=2.0, clock=clock)
    with caplog.at_level(logging.WARNING,
                         logger="horovod_tpu_torch.stall_inspector"):
        assert cycle(c, [req(0, "s")], [], [req(2, "s")]) == []
        clock.t += 1.5
        assert cycle(c, [], [], []) == []
        assert ("Tensor: s ready ranks: [0 2 ] missing ranks: [1 ]"
                in caplog.text)
        clock.t += 1.0
        out = cycle(c, [], [], [])
    assert names(out) == [(A, ["s"], True)]
    assert out[0].error_message == (
        "Stalled collective: tensor s exceeded "
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS without being submitted on all "
        "ranks. Rerun with HOROVOD_SCHEDULE_CHECK=1 to pinpoint the first "
        "diverging submission (rank, call index, field).")
    assert c.table == {}


def test_stall_warnings_are_rate_limited_and_shutdown_zero_never_fails(
        caplog):
    clock = Clock()
    c = make(warn=1.0, shutdown=0.0, clock=clock)
    with caplog.at_level(logging.WARNING,
                         logger="horovod_tpu_torch.stall_inspector"):
        cycle(c, [req(0, "s")], [], [])
        for _ in range(4):
            clock.t += 0.6
            assert cycle(c, [], [], []) == []
    assert caplog.text.count("missing ranks: [1 2 ]") == 2


def test_shutdown_needs_every_rank():
    c = make()
    lists = [RequestList(shutdown=r != 1) for r in range(3)]
    assert not c.cycle(lists).shutdown
    assert c.cycle([RequestList(), RequestList(shutdown=True),
                    RequestList()]).shutdown
