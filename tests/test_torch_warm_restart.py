"""The port's warm-restart plane against the JAX package's, on the CPU.

* ``elastic_shard``, ``elastic_continuity`` and ``elastic_transition``
  equal ``horovod_tpu.parallel.data``'s on a grid of sizes, steps, seeds
  and both policies, errors word for word.
* The spill file: a round trip bit for bit (f32, bf16, int, 0-d leaves,
  the extra dict), the reference's header layout, and each of the six
  rejections ``read_spill`` makes (short header, bad magic, wrong
  version, torn payload, crc mismatch, unloadable payload), warned and
  never raised (the oracle is ``tests/test_warm_restart.py:48-127``).
* ``best_local_spill``; ``warm_restore``'s three rungs (spill, disk,
  fresh) and the layout-mismatch fall-through, written into the live
  tensors; a ZeRO-1 state spilled and restored.
* ``StepGuard`` spilling every Nth commit from its snapshot, a failed
  spill degrading to a warning, the ZeRO-1 rollback; ``spill_corrupt``
  chained into a rejection; the plane kinds and the ``attempt`` key
  parsed and fired as the reference does; ``report_progress``.
* The RPC client against the reference's ``RpcServer`` and wire, and
  the port's ``HeartbeatSender`` against the reference launcher's
  health plane (``horovod_tpu/runner/run.py:593``): delivery, the
  ``preempt`` and ``reform`` replies, a wrong key rejected, the fence.
"""

import logging
import os
import pickle
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from horovod_tpu import faults as jfaults
from horovod_tpu.parallel import data as jdata
from horovod_tpu.runner import rpc as jrpc
import horovod_tpu_torch as thvd
from horovod_tpu_torch import checkpoint, faults, resilience as tres
from horovod_tpu_torch.parallel import data as tdata
from horovod_tpu_torch.runner import rpc
from torch_support import caplog, world1  # noqa: F401

ENV = ("HOROVOD_STEP_GUARD", "HOROVOD_SPILL_DIR", "HOROVOD_SPILL_INTERVAL",
       "HOROVOD_HEALTH_RPC", "HOROVOD_HEARTBEAT_INTERVAL",
       "HOROVOD_LKG_INTERVAL", "HOROVOD_ELASTIC_BATCH_POLICY",
       "HOROVOD_ELASTIC_PREV_SIZE", "HOROVOD_RESTART_ATTEMPT",
       "HOROVOD_PARTITION_GRACE_SECONDS", "HOROVOD_SECRET_KEY",
       "HOROVOD_WORLD_EPOCH", faults.ENV_VAR)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    jfaults.reset()
    tres._reset_for_tests()
    yield
    faults.reset()
    jfaults.reset()
    tres._reset_for_tests()


def _state(seed=0):
    g = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(g.standard_normal((4, 3)).astype(
        np.float32)), "b": torch.zeros(3, dtype=torch.bfloat16)}
    opt = {"m": [torch.from_numpy(g.standard_normal((4, 3)).astype(
        np.float32)), torch.ones(3, dtype=torch.bfloat16)],
        "count": torch.tensor(5, dtype=torch.int32), "lr": 0.5}
    return params, opt


def _leaves(tree):
    from horovod_tpu_torch.tree import tree_leaves
    return tree_leaves(tree)


# -- elastic continuity -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("step", [0, 7, 123456])
@pytest.mark.parametrize("num_items", [1, 16, 100])
def test_elastic_shard_equals_the_reference(num_items, step, world, seed):
    got = [tdata.elastic_shard(num_items, step, world, r, seed)
           for r in range(world)]
    for r, part in enumerate(got):
        np.testing.assert_array_equal(
            part, jdata.elastic_shard(num_items, step, world, r, seed))
    assert sorted(np.concatenate(got).tolist()) == list(range(num_items))


@pytest.mark.parametrize("args", [(10, 0, 0, 0), (10, 0, 2, 2),
                                  (10, 0, 2, -1)])
def test_elastic_shard_errors_word_for_word(args):
    with pytest.raises(ValueError) as want:
        jdata.elastic_shard(*args)
    with pytest.raises(ValueError) as got:
        tdata.elastic_shard(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("policy", ["lr_scale", "accumulate", None])
def test_elastic_continuity_equals_the_reference(policy, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_BATCH_POLICY", "accumulate")
    for prev in range(1, 9):
        for new in range(1, 9):
            assert (tdata.elastic_continuity(prev, new, policy)
                    == jdata.elastic_continuity(prev, new, policy))


@pytest.mark.parametrize("args", [(0, 2, None), (2, 0, None),
                                  (4, 2, "bogus")])
def test_elastic_continuity_errors_word_for_word(args):
    with pytest.raises(ValueError) as want:
        jdata.elastic_continuity(*args)
    with pytest.raises(ValueError) as got:
        tdata.elastic_continuity(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("prev", [None, "", "4", "2", "0", "1", "8"])
@pytest.mark.parametrize("policy", ["lr_scale", "accumulate"])
def test_elastic_transition_equals_the_reference(prev, policy, monkeypatch):
    if prev is not None:
        monkeypatch.setenv("HOROVOD_ELASTIC_PREV_SIZE", prev)
    for new in (1, 2, 3):
        assert (tdata.elastic_transition(new, policy)
                == jdata.elastic_transition(new, policy))


def test_elastic_transition_bad_env_and_default_size(world1, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_PREV_SIZE", "nope")
    with pytest.raises(ValueError) as want:
        jdata.elastic_transition(new_size=2)
    with pytest.raises(ValueError) as got:
        tdata.elastic_transition(new_size=2)
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("HOROVOD_ELASTIC_PREV_SIZE", "2")
    assert thvd.elastic_transition(policy="lr_scale") == (2, 0.5, 1)


def test_world_epoch_and_coordinator(world1, monkeypatch):
    assert thvd.world_epoch() == 0
    monkeypatch.setenv("HOROVOD_COORD_RANK", "2")
    monkeypatch.setenv("HOROVOD_COORD_EPOCH", "3")
    monkeypatch.setenv("HOROVOD_COORD_ELECTIONS", "1")
    assert thvd.coordinator() == thvd.CoordinatorInfo(2, 3, 1)
    thvd.shutdown()
    assert thvd.coordinator().epoch == 3     # before init too
    monkeypatch.setenv("HOROVOD_WORLD_EPOCH", "4")
    thvd.init(device="cpu")
    assert thvd.world_epoch() == 4


# -- the spill file -----------------------------------------------------------

def test_spill_roundtrip_bitwise(world1, tmp_path):
    params, opt = _state()
    extra = {"rng": b"\x01\x02", "cursor": 17, "name": "a"}
    path = tres.write_spill(str(tmp_path), params, opt, 42, extra=extra,
                            rank=1, world_size=2)
    assert os.path.basename(path) == "rank1.spill"
    assert not os.path.exists(path + ".tmp")
    with open(path, "rb") as f:
        head = f.read(tres._SPILL_HEADER.size)
        blob = f.read()
    magic, version, step, world, rank, plen, crc = struct.unpack(
        "!8sIqIIQI", head)
    assert (magic, version, step, world, rank) == (b"HVDSPILL", 1, 42, 2, 1)
    assert (plen, crc) == (len(blob), zlib.crc32(blob))
    assert tres.last_spill["bytes"] == os.path.getsize(path)
    rec = tres.read_spill(path)
    assert (rec["step"], rec["world_size"], rec["rank"]) == (42, 2, 1)
    assert rec["extra"] == extra
    want = _leaves(params) + [checkpoint._as_tensor(x) for x in _leaves(opt)]
    got = rec["params"] + rec["opt"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _spill_bytes(tmp_path):
    params, opt = _state()
    path = tres.write_spill(str(tmp_path), params, opt, 7, rank=0,
                            world_size=1)
    with open(path, "rb") as f:
        return path, f.read()


def _torn(raw):
    return raw[:len(raw) // 2]


def _short(raw):
    return raw[:4]


def _bad_magic(raw):
    return b"NOTSPILL" + raw[8:]


def _reheader(raw, version=tres.SPILL_VERSION, blob=None):
    blob = raw[tres._SPILL_HEADER.size:] if blob is None else blob
    return tres._SPILL_HEADER.pack(tres.SPILL_MAGIC, version, 7, 1, 0,
                                   len(blob), zlib.crc32(blob)) + blob


def _bad_version(raw):
    return _reheader(raw, version=tres.SPILL_VERSION + 1)


def _crc(raw):
    i = tres._SPILL_HEADER.size + 10
    return raw[:i] + bytes([raw[i] ^ 0xFF]) + raw[i + 1:]


def _unloadable(raw):
    return _reheader(raw, blob=b"not a torch payload at all" * 8)


@pytest.mark.parametrize("mangle, why", [
    (_short, "short header (4 bytes)"),
    (_bad_magic, "bad magic"),
    (_bad_version, "unsupported version 2"),
    (_torn, "torn payload"),
    (_crc, "payload crc mismatch"),
    (_unloadable, "unloadable payload"),
])
def test_read_spill_rejects_without_raising(world1, tmp_path, caplog,
                                            mangle, why):
    path, raw = _spill_bytes(tmp_path)
    with open(path, "wb") as f:
        f.write(mangle(raw))
    with caplog.at_level(logging.WARNING, "horovod_tpu_torch.resilience"):
        assert tres.read_spill(path) is None
    assert f"rejecting spill {path}: {why}" in caplog.text
    assert tres.read_spill(str(tmp_path / "missing.spill")) is None


def test_reference_rejects_what_the_port_rejects(tmp_path):
    """The same six corruptions of the reference's own spill: each is
    rejected there too, with the same reason."""
    import jax.numpy as jnp

    from horovod_tpu import resilience as jres
    path = jres.write_spill(str(tmp_path), {"w": jnp.ones(3)}, {}, 7,
                            rank=0, world_size=1)
    raw = open(path, "rb").read()
    for mangle in (_short, _bad_magic, _bad_version, _torn, _crc,
                   _unloadable):
        with open(path, "wb") as f:
            f.write(mangle(raw))
        assert jres.read_spill(path) is None


def test_best_local_spill_prefers_freshest_and_skips_corrupt(world1,
                                                             tmp_path):
    params, opt = _state()
    tres.write_spill(str(tmp_path), params, opt, 5, rank=0, world_size=2)
    newest = tres.write_spill(str(tmp_path), params, opt, 9, rank=1,
                              world_size=2)
    assert tres.best_local_spill(str(tmp_path))["step"] == 9
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) - 3)
    assert tres.best_local_spill(str(tmp_path))["step"] == 5
    assert tres.best_local_spill(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("newest", ["intact", "crc", "torn"])
def test_best_local_spill_loads_one_payload_newest_first(world1, tmp_path,
                                                         monkeypatch,
                                                         newest):
    """The files are ordered by their header's step: the newest intact
    one is the only payload loaded, and a rejected newest falls through
    to the next."""
    params, opt = _state()
    for rank, step in ((0, 3), (1, 7), (2, 5)):
        tres.write_spill(str(tmp_path), params, opt, step, rank=rank,
                         world_size=3)
    (tmp_path / "junk.spill").write_bytes(b"abc")
    path = str(tmp_path / "rank1.spill")
    if newest == "crc":
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
    elif newest == "torn":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
    loads = []
    real_load = torch.load

    def counting_load(*args, **kwargs):
        loads.append(1)
        return real_load(*args, **kwargs)

    monkeypatch.setattr(torch, "load", counting_load)
    rec = tres.best_local_spill(str(tmp_path))
    assert rec["step"] == (7 if newest == "intact" else 5)
    assert len(loads) == 1


def test_layout_signature_names_every_dtype():
    a = [torch.zeros(2, 3), torch.zeros((), dtype=torch.int32)]
    b = [torch.zeros(2, 3, dtype=torch.bfloat16),
         torch.zeros((), dtype=torch.int32)]
    assert tres._layout_signature(a) != tres._layout_signature(b)
    assert tres._layout_signature(a) == tres._layout_signature(
        [torch.ones(2, 3), np.zeros((), np.int32)])
    assert tres._layout_signature(a) < 2 ** 32


# -- the recovery ladder ------------------------------------------------------

def test_warm_restore_prefers_spill_and_writes_into_live(world1, tmp_path,
                                                         monkeypatch):
    params, opt = _state()
    trained = {k: v + 1 for k, v in params.items()}
    tres.write_spill(str(tmp_path), trained, opt, 12, extra={"cursor": 3},
                     rank=0, world_size=1)
    monkeypatch.setenv("HOROVOD_SPILL_DIR", str(tmp_path))
    live, live_opt = _state(seed=1)
    w = live["w"]
    p, o, step, source, extra = tres.warm_restore(live, live_opt)
    assert (step, source, extra) == (12, "spill", {"cursor": 3})
    assert p["w"] is w and torch.equal(w, trained["w"])
    assert torch.equal(p["b"], trained["b"])
    assert o["m"][1] is live_opt["m"][1]
    assert torch.equal(o["m"][0], opt["m"][0])
    assert o["lr"] == 0.5 and isinstance(o["lr"], float)
    assert tres.last_restore["source"] == "spill"


def test_warm_restore_layout_mismatch_falls_through(world1, tmp_path,
                                                    monkeypatch):
    params, opt = _state()
    tres.write_spill(str(tmp_path), params, opt, 12, rank=0, world_size=1)
    monkeypatch.setenv("HOROVOD_SPILL_DIR", str(tmp_path))
    other = {"w": torch.zeros(2, 2)}
    other_opt = {"m": [torch.zeros(2, 2)]}
    p, o, step, source, extra = tres.warm_restore(other, other_opt)
    assert (step, source, extra) == (-1, "fresh", {})
    assert p is other and torch.equal(p["w"], torch.zeros(2, 2))


def test_warm_restore_disk_fallback(world1, tmp_path, monkeypatch):
    params, opt = _state()
    trained = {k: v * 2 + 1 for k, v in params.items()}
    ckpt = tmp_path / "ckpt"
    checkpoint.save(str(ckpt), {"params": trained, "opt_state": opt,
                                "step": 8}, step=8)
    spills = tmp_path / "spills"
    spills.mkdir()
    monkeypatch.setenv("HOROVOD_SPILL_DIR", str(spills))
    live, live_opt = _state(seed=3)
    w = live["w"]
    p, o, step, source, extra = tres.warm_restore(live, live_opt,
                                                  ckpt_dir=str(ckpt))
    assert (step, source, extra) == (8, "disk", {})
    assert p["w"] is w and torch.equal(w, trained["w"])
    assert torch.equal(o["m"][0], opt["m"][0])


def test_warm_restore_fresh_when_nothing_to_recover(world1, tmp_path):
    params, opt = _state()
    p, o, step, source, extra = tres.warm_restore(
        params, opt, ckpt_dir=str(tmp_path / "nope"),
        directory=str(tmp_path / "empty"))
    assert (step, source, extra) == (-1, "fresh", {})
    assert p is params and o is opt


def _zero_state(params):
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.parallel import zero
    zopt = zero.sharded_optimizer(optim.sgd(0.5, 0.5), axis_size=1)
    return zopt, zopt.init(params)


def test_zero_state_spills_full_and_restores_sharded(world1, tmp_path):
    from horovod_tpu_torch.parallel import zero
    params = [torch.arange(6.0), torch.ones(3)]
    zopt, state = _zero_state(params)
    grads = [torch.full((6,), 0.25), torch.full((3,), 0.5)]
    upd, state = zopt.update(grads, state, params)
    full = zero.gather_full_state(state)
    tres.write_spill(str(tmp_path), params, state, 3, rank=0, world_size=1)
    rec = tres.read_spill(tres._spill_path(str(tmp_path), 0))
    for g, w in zip(rec["opt"], _leaves(full)):
        assert torch.equal(g, w)
    _, fresh = _zero_state(params)
    shards = [t.clone() for t in _leaves(fresh.inner)]
    p, o, step, source, _ = tres.warm_restore(
        [torch.zeros(6), torch.zeros(3)], fresh, directory=str(tmp_path))
    assert (step, source) == (3, "spill")
    assert zero.is_zero_state(o)
    for g, w in zip(_leaves(zero.gather_full_state(o)), _leaves(full)):
        assert torch.equal(g, w)
    assert any(not torch.equal(a, b) for a, b in zip(
        _leaves(fresh.inner), shards))   # written into the live shards


# -- StepGuard ----------------------------------------------------------------

def test_step_guard_spills_on_commit(world1, tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_STEP_GUARD", "rollback")
    monkeypatch.setenv("HOROVOD_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_SPILL_INTERVAL", "2")
    params, opt = _state()
    guard = tres.StepGuard()
    guard.spill_extra["cursor"] = 123
    steps = []
    for step in range(4):
        params["w"].add_(1.0)
        tres.last_spill.clear()
        guard.after_step(params, opt, step, 0.5)
        if tres.last_spill:
            steps.append(step)
    assert steps == [1, 3]
    rec = tres.best_local_spill(str(tmp_path))
    assert rec["step"] == 3 and rec["extra"] == {"cursor": 123}
    assert torch.equal(rec["params"][1], params["w"])
    assert tres.progress()[0] == 3


def test_step_guard_spill_failure_degrades(world1, tmp_path, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    guard = tres.StepGuard(policy="rollback", spill_dir=str(blocker))
    params, opt = _state()
    with caplog.at_level(logging.WARNING, "horovod_tpu_torch.resilience"):
        _, _, ev = guard.after_step(params, opt, 0, 0.5)
    assert ev.action == "ok"
    assert "warm-restart spill at step 0 FAILED" in caplog.text


def test_step_guard_rolls_back_a_zero_state(world1):
    params = [torch.arange(6.0)]
    zopt, state = _zero_state(params)
    guard = tres.StepGuard(policy="rollback")
    upd, state = zopt.update([torch.full((6,), 0.25)], state, params)
    params[0].add_(upd[0])
    good = [t.clone() for t in _leaves(state.inner)]
    guard.after_step(params, state, 0, 0.5)
    upd, state = zopt.update([torch.full((6,), float("nan"))], state,
                             params)
    p, o, ev = guard.after_step(params, state, 1, float("nan"))
    assert ev.action == "rollback"
    assert type(o) is type(state)
    for a, b in zip(_leaves(o.inner), good):
        assert torch.equal(a, b)


# -- the plane fault kinds and the attempt key --------------------------------

def test_faults_parse_plane_kinds_as_the_reference(monkeypatch):
    spec = "rank=1,kind=heartbeat_drop:3;kind=spill_corrupt:64,count=1,after=5"
    for mod in (jfaults, faults):
        rules = mod.parse_spec(spec)
        hb = next(r for r in rules if r.kind == "heartbeat_drop")
        assert (hb.arg, hb.count, hb.rank) == (3, 3, 1)
        sc = next(r for r in rules if r.kind == "spill_corrupt")
        assert (sc.arg, sc.count, sc.after) == (64, 1, 5)


@pytest.mark.parametrize("spec", ["kind=heartbeat_drop:0",
                                  "kind=spill_corrupt:-1"])
def test_faults_reject_bad_plane_args_word_for_word(spec):
    with pytest.raises(jfaults.FaultSpecError) as want:
        jfaults.parse_spec(spec)
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse_spec(spec)
    assert str(got.value) == str(want.value)


def test_drop_heartbeat_fires_limited_times_and_by_rank(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "kind=heartbeat_drop:2")
    assert [faults.drop_heartbeat(rank=0) for _ in range(4)] == [
        True, True, False, False]
    faults.reset()
    monkeypatch.setenv(faults.ENV_VAR, "rank=1,kind=heartbeat_drop")
    assert not faults.drop_heartbeat(rank=0)
    assert faults.drop_heartbeat(rank=1)


def test_mangle_spill_truncates_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "kind=spill_corrupt:10,count=1")
    monkeypatch.setenv(jfaults.ENV_VAR, "kind=spill_corrupt:10,count=1")
    for mod in (faults, jfaults):
        path = tmp_path / f"{mod.__name__}.spill"
        path.write_bytes(b"x" * 100)
        assert mod.mangle_spill(str(path), rank=0)
        assert os.path.getsize(path) == 10
        path.write_bytes(b"y" * 100)
        assert not mod.mangle_spill(str(path), rank=0)
        assert os.path.getsize(path) == 100


def test_spill_corrupt_chains_into_rejection(world1, tmp_path, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "kind=spill_corrupt")
    params, opt = _state()
    path = tres.write_spill(str(tmp_path), params, opt, 4, rank=0,
                            world_size=1)
    assert os.path.getsize(path) == tres.last_spill["bytes"] // 2
    assert tres.best_local_spill(str(tmp_path)) is None


@pytest.mark.parametrize("attempt", ["0", "1", "2"])
def test_attempt_key_fires_only_on_its_attempt(attempt, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("HOROVOD_RESTART_ATTEMPT", attempt)
    monkeypatch.setenv(faults.ENV_VAR, "kind=spill_corrupt:3,attempt=1")
    monkeypatch.setenv(jfaults.ENV_VAR, "kind=spill_corrupt:3,attempt=1")
    for mod in (faults, jfaults):
        path = tmp_path / "x.spill"
        path.write_bytes(b"z" * 50)
        assert mod.mangle_spill(str(path), rank=0) == (attempt == "1")


@pytest.mark.parametrize("kind", ["krash", "rank_kill", "frame_corrupt",
                                  "shm_stall:5"])
def test_other_kinds_stay_refused_with_the_references_words(kind):
    # Every kind of the reference but its transport kinds is ported: an
    # unknown kind is refused in the reference's words, a transport kind
    # (rank_kill anywhere but at site fleet) by name.
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse_spec(f"kind={kind}")
    if kind == "krash":
        from horovod_tpu import faults as ref_faults
        with pytest.raises(ref_faults.FaultSpecError) as want:
            ref_faults.parse_spec(f"kind={kind}")
        assert str(got.value).split("; valid kinds: ")[0] == \
            str(want.value).split("; valid kinds: ")[0]
        assert str(got.value).endswith("coord_crash, rank_kill")
    else:
        assert f"fault kind '{kind.split(':')[0]}' acts on the " \
            f"reference's native transports" in str(got.value)


def test_report_progress_is_monotonic():
    tres.report_progress(5)
    tres.report_progress(3)
    step, ts = tres.progress()
    assert step == 5 and ts > 0.0


# -- the RPC client against the reference's server ----------------------------

def test_rpc_call_speaks_the_references_wire():
    key = rpc.job_key_bytes("s3cret")
    assert key == jrpc.job_key_bytes("s3cret")
    assert rpc.job_key_bytes(None) == jrpc.job_key_bytes(None) == b""
    server = jrpc.RpcServer(key, lambda req: {"echo": req})
    try:
        assert rpc.rpc_call("127.0.0.1", server.port, {"kind": "x", "n": 3},
                            key) == {"echo": {"kind": "x", "n": 3}}
        with pytest.raises(ConnectionError):   # dropped without a reply
            rpc.rpc_call("127.0.0.1", server.port, {"kind": "x"}, b"wrong",
                         retries=0)
    finally:
        server.shutdown()


def test_recv_msg_checks_the_digest_before_unpickling():
    a, b = socket.socketpair()
    try:
        jrpc._send_msg(a, b"\x80garbage, not a pickle", b"key-a")
        with pytest.raises(rpc.AuthError, match="digest mismatch"):
            rpc._recv_msg(b, b"key-b")
        jrpc._send_msg(a, pickle.dumps({"ok": 1}), b"k")
        assert pickle.loads(rpc._recv_msg(b, b"k")) == {"ok": 1}
        a.sendall(struct.pack("!Q", 1 << 40))
        with pytest.raises(rpc.AuthError, match="sanity cap"):
            rpc._recv_msg(b, b"k")
    finally:
        a.close()
        b.close()


def test_connect_with_retry_backs_off_as_the_reference():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]       # closed once the block ends
    delays = {}
    for name, mod in (("port", rpc), ("ref", jrpc)):
        slept = []
        with pytest.raises(ConnectionError, match="after 4 attempts"):
            mod.connect_with_retry("127.0.0.1", port, timeout=1.0,
                                   retries=3, sleep=slept.append,
                                   rng=lambda: 0.25, deadline=30.0)
        delays[name] = slept
    assert delays["port"] == delays["ref"]
    assert delays["port"] == pytest.approx([0.15, 0.3, 0.6])


# -- the heartbeat against the reference launcher's health plane --------------

def _health(**kw):
    from horovod_tpu.runner.run import _HealthPlane
    return _HealthPlane("s3cret", kw.get("interval", 0.05), 5.0, 0.0)


def _wait(cond, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _point_at(hp, monkeypatch, key="s3cret"):
    monkeypatch.setenv("HOROVOD_HEALTH_RPC", f"127.0.0.1:{hp.port}")
    monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", "0.05")
    monkeypatch.setenv("HOROVOD_SECRET_KEY", key)


def test_heartbeat_reaches_the_launchers_health_plane(monkeypatch):
    hp = _health()
    try:
        _point_at(hp, monkeypatch)
        tres.report_progress(41)
        sender = tres.start_heartbeat(rank=3)
        assert sender is not None
        assert tres.start_heartbeat(rank=3) is sender   # idempotent
        assert _wait(lambda: 3 in hp.monitor.step_lags())
        assert not tres.preemption_requested()
        hp.request_preempt()
        assert _wait(tres.preemption_requested)
    finally:
        tres.stop_heartbeat()
        hp.shutdown()


def test_heartbeat_with_a_wrong_key_is_rejected(monkeypatch):
    hp = _health()
    try:
        _point_at(hp, monkeypatch, key="not-the-key")
        tres.start_heartbeat(rank=0)
        time.sleep(0.5)
        assert hp.monitor.step_lags() == {}
    finally:
        tres.stop_heartbeat()
        hp.shutdown()


def test_heartbeat_latches_the_reform_spec(monkeypatch):
    from horovod_tpu.runner import hosts
    from horovod_tpu.runner.run import _plan_reformation
    hp = _health()
    try:
        _point_at(hp, monkeypatch)
        tres.start_heartbeat(rank=1)
        assert _wait(lambda: 1 in hp.monitor.step_lags())
        infos = hosts.allocate([hosts.HostSlots("localhost", 3)], 3)
        specs, alias = _plan_reformation(infos[:2], "127.0.0.1", 4242, 1)
        hp.request_reform(specs, alias, 1)
        spec = tres._take_reform_spec(5.0)
        assert spec == specs[1]
        # A stale copy (epoch not beyond this world's) is dropped.
        monkeypatch.setenv("HOROVOD_WORLD_EPOCH", "1")
        tres._deliver_reform_spec(dict(spec))
        assert tres._take_reform_spec(0.01) is None
    finally:
        tres.stop_heartbeat()
        hp.shutdown()


def test_heartbeat_drop_skips_sends(monkeypatch):
    hp = _health()
    try:
        _point_at(hp, monkeypatch)
        monkeypatch.setenv(faults.ENV_VAR, "rank=0,kind=heartbeat_drop")
        tres.start_heartbeat(rank=0)
        time.sleep(0.4)
        assert hp.monitor.step_lags() == {}
    finally:
        tres.stop_heartbeat()
        hp.shutdown()


def test_partition_fence_exits_75_after_the_grace(monkeypatch):
    hp = _health()
    exits = []
    fenced = threading.Event()

    def fake_exit(code):
        exits.append(code)
        fenced.set()
        tres._heartbeat_sender._stop.set()     # ends the sender's loop

    monkeypatch.setattr(tres.os, "_exit", fake_exit)
    try:
        _point_at(hp, monkeypatch)
        monkeypatch.setenv("HOROVOD_PARTITION_GRACE_SECONDS", "0.3")
        sender = tres.start_heartbeat(rank=0)
        assert _wait(lambda: sender._last_ok is not None)
    finally:
        hp.shutdown()
    assert fenced.wait(10.0)
    assert exits == [tres.PREEMPTION_RC]
    tres.stop_heartbeat()


def test_reform_world_times_out_without_a_spec():
    with pytest.raises(TimeoutError, match="HOROVOD_REFORM_TIMEOUT"):
        tres.reform_world({}, {}, timeout=0.05)
