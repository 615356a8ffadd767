"""The port's control plane (``horovod_tpu_torch/native/``) on the CPU.

* One ``python -m horovod_tpu.runner -np 3`` job runs each case through
  the reference's native eager plane (``horovod_tpu`` and its torch
  binding) and through the port's gloo world, and the results are held
  bitwise, error messages word for word: names issued in rank-dependent
  order (allreduce, allgather, broadcast, alltoall), ``join`` with uneven
  batches, Average under join, the mismatch errors and the runtime after
  them, and the response cache's steady state with a shape change.
* A 2-rank job of the port alone: the two names ``x`` and ``y`` issued
  in opposite orders on the two ranks reduce to ``x = 3`` and ``y = 30``
  on both (ranks paired by issue order would swap them), and a name that
  rank 1 never submits fails on rank 0 with the stall inspector's error
  after its warning names the missing rank.  A rank that dies fails the
  other's pending handle.
* In this process, at size 1: a runtime whose thread dies fails pending
  and later handles (nothing falls back to another route), a failed data
  group fails its names and the runtime goes on, ``shutdown`` leaves no
  thread behind, and the direct path (``fused_psum``,
  ``fused_pytree_mean``, the ResNet and LM train steps) submits nothing.
"""

import re
import threading

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.native import data_plane, runtime as truntime
from horovod_tpu_torch.ops import fusion

from torch_support import (jax_world, run_job, run_port_job,  # noqa: F401
                           world1)

JOB = r'''
import sys
import threading

import numpy as np
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jt
import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
jhvd.init()
thvd.init(device="cpu")
r, n = thvd.rank(), thvd.size()
assert (jhvd.rank(), jhvd.size(), n) == (r, n, 3)
out = {}


def both(key, fn):
    """``fn`` through the reference's torch binding, then the port."""
    for pkg, mod in (("ref", jt), ("port", thvd)):
        try:
            v = fn(mod)
        except RuntimeError as e:
            v = f"RuntimeError: {e}"
        out[f"{pkg}/{key}"] = np.asarray(v.numpy() if torch.is_tensor(v)
                                         else v)


def xy(mod):
    """PR 6's input: x and y, in rank-dependent order."""
    x, y = torch.full((4,), 1.0 + r), torch.full((4,), 10.0 * (r + 1))
    pairs = [("x", x), ("y", y)][::-1 if r % 2 else 1]
    hs = {k: mod.allreduce_async(v, name=f"xy.{k}", op=mod.Sum)
          for k, v in pairs}
    return torch.cat([mod.synchronize(hs["x"]), mod.synchronize(hs["y"])])


def rotated(kind):
    """test_model_parallelism_disjoint_names: every rank submits every
    name, starting from its own rank's."""
    def run(mod):
        names = [f"rot.{kind}.{i}" for i in range(n)]
        order = names[r:] + names[:r]
        x = torch.arange(12, dtype=torch.float32).reshape(6, 2) * (r + 1)
        if kind == "alltoall":
            # Synchronous in both packages: one thread per name.
            res = {}
            threads = [threading.Thread(target=lambda nm=nm: res.__setitem__(
                nm, mod.alltoall(x + 100 * r, name=nm))) for nm in order]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return torch.stack([torch.as_tensor(np.asarray(res[nm]))
                                for nm in names])
        start = {"allreduce": lambda nm: mod.allreduce_async(
                     x, name=nm, op=mod.Sum),
                 "allgather": lambda nm: mod.allgather_async(
                     x[:r + 1], name=nm),
                 "broadcast": lambda nm: mod.broadcast_async(x, 1, name=nm),
                 }[kind]
        hs = {nm: start(nm) for nm in order}
        return torch.stack([torch.as_tensor(np.asarray(mod.synchronize(
            hs[nm]))).reshape(-1)[:12] for nm in names])
    return run


def join_uneven(mod):
    """test_join_uneven_batches: rank r has r + 1 batches."""
    sums = []
    for b in range(n):
        sums.append(mod.allreduce(torch.ones(4), op=mod.Sum,
                                  name=f"join.b{b}") if b <= r
                    else torch.full((4,), -1.0))
    last = mod.join()
    after = mod.allreduce(torch.ones(3), op=mod.Sum, name="join.after")
    return torch.cat(sums + [torch.tensor([float(last)]), after])


def average_under_join(mod):
    if r == 0:
        mod.join()
        return "joined"
    try:
        mod.allreduce(torch.ones(2), name="join.avg")
        msg = "no error"
    except RuntimeError as e:
        msg = str(e)
    mod.join()
    return msg


def bad(kind):
    def run(mod):
        if kind == "shape":
            return mod.allreduce(torch.zeros(3 + r % 2, 2), op=mod.Sum,
                                 name="t.badshape")
        if kind == "dtype":
            return mod.allreduce(torch.zeros(4, dtype=torch.float32 if r % 2
                                             else torch.float64),
                                 op=mod.Sum, name="t.baddtype")
        return mod.broadcast(torch.zeros(2), root_rank=r % 2,
                             name="t.badroot")
    return run


def cache(mod):
    """test_response_cache_steady_state."""
    res = []
    for step in range(6):
        for i in range(4):
            res.append(mod.allreduce(torch.full((8,), float(step + i + r)),
                                     op=mod.Sum, name=f"t.cache.{i}"))
    res.append(mod.allreduce(torch.ones(3, 3), op=mod.Sum,
                             name="t.cache.0").reshape(-1))
    res.append(mod.allreduce(torch.ones(8), op=mod.Sum, name="t.cache.0"))
    return torch.cat(res)


both("xy", xy)
for kind in ("allreduce", "allgather", "broadcast", "alltoall"):
    both(f"rotated_{kind}", rotated(kind))
both("join_uneven", join_uneven)
both("average_under_join", average_under_join)
for kind in ("shape", "dtype", "root"):
    both(f"mismatched_{kind}", bad(kind))
both("works_after_error", lambda mod: mod.allreduce(
    torch.ones(3), op=mod.Sum, name="t.recover"))
both("response_cache", cache)
rt = thvd.basics.runtime()
out["port/cache_entries"] = np.array(len(rt.cache))

np.savez(f"{out_dir}/rank{r}.npz", **out)
thvd.shutdown()
jhvd.shutdown()
print(f"rank {r}: control-plane job done", flush=True)
'''

CASES = ["xy", "rotated_allreduce", "rotated_allgather", "rotated_broadcast",
         "rotated_alltoall", "join_uneven", "average_under_join",
         "mismatched_shape", "mismatched_dtype", "mismatched_root",
         "works_after_error", "response_cache"]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return run_job(JOB, str(tmp_path_factory.mktemp("control_plane_job")))


def _words(msg) -> str:
    """A mismatch message with its ranks' parts blanked: which rank the
    coordinator heard from first depends on timing, in both packages."""
    return re.sub(r"rank \d+ has (\[[^\]]*\]|\w+)", "rank _ has _",
                  str(msg))


@pytest.mark.parametrize("case", CASES)
def test_matches_the_reference_eager_plane(job, case):
    for r in range(3):
        got, want = job[r][f"port/{case}"], job[r][f"ref/{case}"]
        assert got.dtype.kind == want.dtype.kind, (r, got, want)
        if got.dtype.kind == "U":
            assert _words(got) == _words(want), r
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


def test_the_errors_carry_the_references_words(job):
    msg = str(job[1]["port/mismatched_shape"])
    assert re.fullmatch(
        r"RuntimeError: Mismatched allreduce tensor shapes: rank (\d) has "
        r"(\[[34], 2\]) but rank (\d) has (\[[34], 2\]) for tensor "
        r"t\.badshape\.", msg), msg
    assert str(job[2]["port/mismatched_root"]) == (
        "RuntimeError: Mismatched broadcast root ranks for tensor "
        "t.badroot.")
    assert str(job[1]["port/average_under_join"]).startswith(
        "Allreduce with joined ranks supports only the Sum reduction")
    # The last rank to join had the most batches; the sums count the
    # ranks still active: 3, 2, 1.
    got = job[0]["port/join_uneven"]
    np.testing.assert_array_equal(got[:4], 3.0)
    assert got[12] == 2.0 and (got[-3:] == 3.0).all()
    np.testing.assert_array_equal(job[2]["port/join_uneven"][8:12], 1.0)
    # The cache kept the four steady names.
    assert int(job[0]["port/cache_entries"]) >= 4


PAIR = r'''
import logging
import sys

import numpy as np
import torch

import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
thvd.init(device="cpu")
r = thvd.rank()
records = []


class Keep(logging.Handler):
    def emit(self, record):
        records.append(record.getMessage())


logging.getLogger("horovod_tpu_torch.stall_inspector").addHandler(Keep())
x, y = torch.full((4,), 1.0 + r), torch.full((4,), 10.0 * (r + 1))
pairs = [("x", x), ("y", y)][::-1 if r else 1]
hs = {k: thvd.allreduce_async(v, name=k, op=thvd.Sum) for k, v in pairs}
out = {"x": thvd.synchronize(hs["x"]).numpy(),
       "y": thvd.synchronize(hs["y"]).numpy()}
if r == 0:
    try:
        thvd.allreduce(torch.ones(2), name="stalled")
        out["stall"] = np.array("no error")
    except RuntimeError as e:
        out["stall"] = np.array(str(e))
    out["log"] = np.array("\n".join(records))
np.savez(f"{out_dir}/rank{r}.npz", **out)
thvd.shutdown()
'''


def test_names_pair_across_ranks_and_a_missing_name_stalls(tmp_path):
    (r0, r1), _ = run_port_job(PAIR, str(tmp_path), env={
        "HOROVOD_STALL_CHECK_TIME_SECONDS": "1",
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "2"})
    for res in (r0, r1):
        np.testing.assert_array_equal(res["x"], np.full(4, 3.0))
        np.testing.assert_array_equal(res["y"], np.full(4, 30.0))
    assert str(r0["stall"]).startswith(
        "Stalled collective: tensor stalled exceeded "
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")
    assert "Tensor: stalled ready ranks: [0 ] missing ranks: [1 " in str(
        r0["log"])


DEAD = r'''
import os
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
thvd.init(device="cpu")
if thvd.rank() == 1:
    np.savez(f"{out_dir}/rank1.npz")
    time.sleep(0.5)
    os._exit(0)             # gone without a word: no shutdown agreement
t0 = time.monotonic()
try:
    thvd.synchronize(thvd.allreduce_async(torch.ones(2), name="orphan"))
    msg = "no error"
except RuntimeError as e:
    msg = str(e)
np.savez(f"{out_dir}/rank0.npz", msg=np.array(msg),
         seconds=np.array(time.monotonic() - t0))
thvd.shutdown()
'''


def test_a_peer_that_dies_fails_the_survivors_handles(tmp_path):
    """The survivor's next exchange raises, so its pending handle fails
    with that error instead of hanging."""
    (r0, _), _ = run_port_job(DEAD, str(tmp_path))
    assert str(r0["msg"]).startswith("horovod_tpu_torch runtime stopped")
    assert float(r0["seconds"]) < 30


# ---------------------------------------------------------------------------
# Size 1, in this process
# ---------------------------------------------------------------------------

def _runtime_threads():
    return [t for t in threading.enumerate()
            if t.name == "hvd-torch-runtime" and t.is_alive()]


def test_join_at_size_1_returns_0_as_the_reference(jax_world):
    """``tests/test_collective.py::test_join_single_proc`` on the port: the
    join goes through the runtime at size 1 too."""
    assert thvd.join() == jax_world.join() == 0
    assert thvd.allreduce(torch.ones(2), op=thvd.Sum).tolist() == [1.0, 1.0]


def test_shutdown_leaves_no_runtime_thread(world1):
    assert len(_runtime_threads()) == 1
    for _ in range(2):
        world1.shutdown()
        assert _runtime_threads() == []
        world1.init(device="cpu")
        assert world1.allreduce(torch.ones(2), op=world1.Sum).tolist() == [
            1.0, 1.0]


def test_a_dead_runtime_fails_pending_and_later_handles(world1):
    rt = world1.basics.runtime()

    def lost(mine):
        raise ConnectionError("peer left")

    rt._exchange = lost
    with pytest.raises(RuntimeError, match="peer left"):
        world1.synchronize(world1.allreduce_async(torch.ones(2), name="a"))
    rt.thread.join(10)
    assert not rt.thread.is_alive()
    with pytest.raises(RuntimeError, match="peer left"):
        world1.allreduce(torch.ones(2))
    with pytest.raises(RuntimeError, match="peer left"):
        world1.join()


def test_a_failed_data_group_fails_its_names_and_the_runtime_goes_on(
        world1, monkeypatch):
    def broken(resp, held, g):
        raise RuntimeError("Connection closed by peer")

    monkeypatch.setattr(data_plane, "allreduce", broken)
    with pytest.raises(RuntimeError, match="Connection closed by peer"):
        world1.allreduce(torch.ones(2), name="a")
    monkeypatch.undo()
    assert world1.allreduce(torch.ones(2), name="a").tolist() == [1.0, 1.0]
    assert world1.basics.runtime().thread.is_alive()


def test_the_direct_path_submits_nothing_to_the_control_plane(world1):
    from horovod_tpu_torch.benchmark import (run_lm_benchmark,
                                             run_synthetic_benchmark)
    truntime.requests.reset()
    fusion.allreduce_calls.reset()
    xs = [torch.ones(3), torch.arange(4.0)]
    fusion.fused_psum(xs)
    fusion.fused_pytree_mean({"a": xs[0], "b": xs[1]})
    run_synthetic_benchmark("resnet18", 2, image_size=32, num_classes=4,
                            num_warmup_batches=1, num_batches_per_iter=1,
                            num_iters=1, stem="s2d_fused", device="cpu")
    run_lm_benchmark(d_model=32, n_layers=1, n_heads=2, vocab_size=64,
                     seq_len=16, batch_size=2, num_warmup_batches=1,
                     num_batches_per_iter=1, num_iters=1, device="cpu")
    assert truntime.requests.count == 0 and fusion.allreduce_calls.count > 4
    world1.allreduce(torch.ones(2))
    world1.grouped_allreduce([torch.ones(2), torch.ones(3)])
    assert truntime.requests.count == 3
