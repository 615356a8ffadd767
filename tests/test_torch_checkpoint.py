"""The port's checkpoints against the JAX package's, on the CPU.

* Every case of ``tests/test_checkpoint_robustness.py`` on the port, at
  size 1: the newest intact step after a save killed half way (a ``tmp``
  directory, an empty step directory, a step whose file is garbage), the
  template when nothing is restorable, no fall-back from a pinned step,
  the warnings in the reference's words; and the reference's async-save
  cases (``tests/test_resilience.py:393-439``).
* Contents: a state saved and restored by the reference (orbax), then
  converted to torch, equals the port's restore of the converted state
  bit for bit (an LM parameter tree with its SGD trace, numpy leaves and
  a step).
* One 2-rank gloo job: a save that raises on rank 0 returns None on both
  ranks (no deadlock); a restore reads on rank 0 and broadcasts (rank 1
  passes a directory that does not exist); ZeRO-1 Adam state after two
  steps at 2 ranks is saved in the full layout and restored here at one
  rank equal to the full state the job gathered.
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch

from horovod_tpu_torch import checkpoint
from torch_support import caplog, jax_world, run_port_job, world1  # noqa: F401


@pytest.fixture
def port_log(caplog):
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        yield caplog


def _state(w, step):
    return {"w": torch.full((4,), float(w)), "step": np.asarray(step,
                                                                np.int64)}


def _seed_ckpts(ckpt):
    assert checkpoint.save(str(ckpt), _state(1.0, 1), 1)
    assert checkpoint.save(str(ckpt), _state(2.0, 2), 2)


def _garble(step_dir):
    for entry in os.listdir(step_dir):
        p = step_dir / entry
        shutil.rmtree(p) if p.is_dir() else p.unlink()
    (step_dir / checkpoint.STATE_FILE).write_text("garbage")


def test_latest_step_skips_tmp_and_empty_dirs(world1, tmp_path, port_log):
    ckpt = tmp_path / "ckpt"
    _seed_ckpts(ckpt)
    (ckpt / "3.tmp-1234-5").mkdir()
    (ckpt / "4").mkdir()
    assert checkpoint.latest_step(str(ckpt)) == 2
    assert "half-written checkpoint" in port_log.text
    assert "directory is empty" in port_log.text


def test_latest_step_missing_dir():
    assert checkpoint.latest_step("/nonexistent/ckpts") is None


def test_restore_falls_back_to_newest_intact_step(world1, tmp_path,
                                                  port_log):
    ckpt = tmp_path / "ckpt"
    _seed_ckpts(ckpt)
    _garble(ckpt / "2")
    out = checkpoint.restore(str(ckpt), _state(0.0, 0))
    np.testing.assert_array_equal(out["w"].numpy(), np.full(4, 1.0))
    assert int(out["step"]) == 1 and isinstance(out["step"], np.ndarray)
    assert "skipping unrestorable checkpoint step 2" in port_log.text


def test_restore_all_corrupt_returns_template(world1, tmp_path, port_log):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "5.tmp-99-1").mkdir()
    out = checkpoint.restore(str(ckpt), _state(7.0, 0))
    np.testing.assert_array_equal(out["w"].numpy(), np.full(4, 7.0))
    assert "half-written checkpoint" in port_log.text


def test_restore_pinned_corrupt_step_does_not_fall_back(world1, tmp_path,
                                                        port_log):
    ckpt = tmp_path / "ckpt"
    _seed_ckpts(ckpt)
    _garble(ckpt / "2")
    out = checkpoint.restore(str(ckpt), _state(0.0, 0), step=2)
    np.testing.assert_array_equal(out["w"].numpy(), np.full(4, 0.0))
    assert "skipping unrestorable checkpoint step 2" in port_log.text
    assert "starting fresh" in port_log.text


def test_restore_intact_roundtrip(world1, tmp_path):
    ckpt = tmp_path / "ckpt"
    _seed_ckpts(ckpt)
    out = checkpoint.restore(str(ckpt), _state(0.0, 0))
    np.testing.assert_array_equal(out["w"].numpy(), np.full(4, 2.0))
    assert int(out["step"]) == 2


def test_a_state_that_does_not_fit_the_template_is_skipped(world1, tmp_path,
                                                           port_log):
    ckpt = tmp_path / "ckpt"
    _seed_ckpts(ckpt)
    checkpoint.save(str(ckpt), {"w": torch.ones(5), "step": np.int64(3)}, 3)
    out = checkpoint.restore(str(ckpt), _state(0.0, 0))
    assert int(out["step"]) == 2
    assert "skipping unrestorable checkpoint step 3" in port_log.text


def test_a_save_commits_by_rename_and_max_to_keep_prunes(world1, tmp_path):
    ckpt = tmp_path / "ckpt"
    for s in range(4):
        checkpoint.save(str(ckpt), _state(s, s), s, max_to_keep=2)
    assert sorted(os.listdir(ckpt)) == ["2", "3"]
    assert os.listdir(ckpt / "3") == [checkpoint.STATE_FILE]
    # Saving a step again replaces it.
    checkpoint.save(str(ckpt), _state(9.0, 3), 3)
    out, used = checkpoint.load_local(str(ckpt), _state(0.0, 0))
    assert used == 3 and float(out["w"][0]) == 9.0


def test_load_local_skips_corrupt_steps_without_a_collective(tmp_path,
                                                             port_log):
    ckpt = tmp_path / "ckpt"
    os.makedirs(ckpt / "1")
    torch.save({"w": torch.full((4,), 1.0), "step": torch.tensor(1)},
               ckpt / "1" / checkpoint.STATE_FILE)
    os.makedirs(ckpt / "2")
    (ckpt / "2" / checkpoint.STATE_FILE).write_text("garbage")
    out, used = checkpoint.load_local(str(ckpt), _state(0.0, 0))
    assert used == 1 and float(out["w"][0]) == 1.0
    assert checkpoint.load_local(str(tmp_path / "none"), 5) == (5, None)
    assert checkpoint.load_local(str(ckpt), _state(0.0, 0), step=2)[1] is None


def test_restore_reads_no_pickled_objects(world1, tmp_path, port_log):
    """``weights_only``: a file that needs arbitrary unpickling is
    refused, and the older step restores."""
    ckpt = tmp_path / "ckpt"
    _seed_ckpts(ckpt)
    torch.save({"w": torch.zeros(4), "step": np.int64(9),
                "x": _Opaque()}, ckpt / "2" / checkpoint.STATE_FILE)
    out = checkpoint.restore(str(ckpt), _state(0.0, 0))
    assert int(out["step"]) == 1


class _Opaque:
    pass


# -- async (reference tests/test_resilience.py:393-439) ----------------------

def test_save_failure_returns_none_not_raise(world1, tmp_path):
    blocker = tmp_path / "ckpt"
    blocker.write_text("not a directory")
    assert checkpoint.save(str(blocker), {"w": torch.ones(4)}, step=1) is None


def test_save_async_roundtrip(world1, tmp_path):
    ckpt = tmp_path / "ckpt"
    w = torch.from_numpy(np.random.RandomState(4).randn(8).astype(
        np.float32))
    state = {"w": w, "step": 3}
    saved = w.clone()
    promised = checkpoint.save_async(str(ckpt), state, step=3)
    w.add_(1.0)            # the training goes on: the snapshot is a copy
    assert checkpoint.wait_for_async_save() == promised
    assert checkpoint.latest_step(str(ckpt)) == 3
    out = checkpoint.restore(str(ckpt), {"w": torch.zeros(8), "step": 0})
    np.testing.assert_array_equal(out["w"].numpy(), saved.numpy())
    assert out["step"] == 3 and isinstance(out["step"], int)


def test_save_async_failure_surfaces_at_drain(world1, tmp_path):
    blocker = tmp_path / "ckpt"
    blocker.write_text("not a directory")
    checkpoint.save_async(str(blocker), {"w": torch.ones(2)}, step=1)
    assert checkpoint.wait_for_async_save() is None
    assert checkpoint.wait_for_async_save() is None


def test_sync_save_drains_async_first(world1, tmp_path):
    ckpt = tmp_path / "ckpt"
    checkpoint.save_async(str(ckpt), {"w": torch.ones(2)}, step=1)
    assert checkpoint.save(str(ckpt), {"w": torch.full((2,), 2.0)},
                           step=2) is not None
    assert checkpoint.latest_step(str(ckpt)) == 2
    assert 1 in checkpoint._valid_steps(str(ckpt))


# -- contents against the reference ------------------------------------------

def _lm_tree(seed=0):
    rng = np.random.default_rng(seed)
    d, f, v, t = 8, 16, 32, 8

    def dense(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": dense(v, d), "pos": dense(t, d),
            "ln_f_scale": dense(d),
            "layers": [{"ln1_scale": dense(d), "ln2_scale": dense(d),
                        "wq": dense(d, d), "wk": dense(d, d),
                        "wv": dense(d, d), "wo": dense(d, d),
                        "w1": dense(d, f), "w2": dense(f, d)}
                       for _ in range(2)]}


def test_contents_equal_the_references_restore(jax_world, tmp_path):
    """The reference saves and restores (orbax); the port saves and
    restores the converted state; the two restores agree bit for bit."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu import checkpoint as jckpt
    from horovod_tpu_torch.models import convert

    params = _lm_tree(1)
    trace = jax.tree_util.tree_map(lambda a: (a * 0.5).astype(np.float32),
                                   params)
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, params),
              "trace": jax.tree_util.tree_map(
                  lambda a: jnp.asarray(a, jnp.bfloat16), trace),
              "step": np.asarray(7, np.int64)}
    assert jckpt.save(str(tmp_path / "ref"), jstate, step=7)
    template = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    ref = jckpt.restore(str(tmp_path / "ref"), template)

    def port_of(state):
        return {"params": convert.lm_params_to_torch(
                    jax.tree_util.tree_map(np.asarray, state["params"])),
                "trace": convert.lm_params_to_torch(jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float32), state["trace"])),
                "step": torch.tensor(int(state["step"]))}

    pstate = port_of(jstate)
    pstate["trace"] = {k: v.to(torch.bfloat16)
                       for k, v in pstate["trace"].items()}
    assert checkpoint.save(str(tmp_path / "port"), pstate, step=7)
    ptemplate = {k: ({n: torch.zeros_like(t) for n, t in v.items()}
                     if isinstance(v, dict) else torch.zeros_like(v))
                 for k, v in pstate.items()}
    got = checkpoint.restore(str(tmp_path / "port"), ptemplate)
    want = port_of(ref)
    for name, t in got["params"].items():
        np.testing.assert_array_equal(t.numpy(), want["params"][name].numpy())
    for name, t in got["trace"].items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      want["trace"][name].numpy())
    assert int(got["step"]) == int(ref["step"]) == 7


# -- 2 ranks ------------------------------------------------------------------

JOB = r'''
import os
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint, optim
from horovod_tpu_torch.parallel import zero

out_dir = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
res = {}

# A save that raises on rank 0: a file where the directory should be.
blocker = os.path.join(out_dir, "blocker")
if r == 0:
    with open(blocker, "w") as f:
        f.write("not a directory")
hvd.barrier()
res["failed_save"] = np.array(checkpoint.save(blocker, {"w": torch.ones(2)},
                                              step=1) is None)

# Restore reads on rank 0 and broadcasts: rank 1 names no real directory.
ckpt = os.path.join(out_dir, "ckpt")
state = {"w": torch.arange(6.0).reshape(2, 3) + 10 * r, "n": 5 + r}
path = checkpoint.save(ckpt, state, step=4)
res["path"] = np.array(str(path))
where = ckpt if r == 0 else os.path.join(out_dir, "nowhere")
back = checkpoint.restore(where, {"w": torch.zeros(2, 3), "n": 0})
res["restored_w"] = back["w"].numpy()
res["restored_n"] = np.array(back["n"])

# ZeRO-1 Adam at 2 ranks, two steps, saved in the full layout.
rng = np.random.default_rng(0)
params = {"a": torch.from_numpy(rng.standard_normal((6, 4)).astype(
              np.float32)),
          "b": torch.from_numpy(rng.standard_normal(5).astype(np.float32))}
zopt = zero.sharded_optimizer(optim.adam(1e-2), None)
st = zopt.init(params)
for step in range(2):
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) + r for k, v in params.items()}
    upd, st = zopt.update(grads, st, params)
    params = {k: params[k] + upd[k] for k in params}
full = zero.gather_full_state(st)
for f in ("mu", "nu"):
    for k, v in getattr(full, f).items():
        res[f"full/{f}/{k}"] = v.numpy()
res["full/count"] = full.count.numpy()
checkpoint.save(os.path.join(out_dir, "zero"),
                {"params": params, "opt": st}, step=2)
for k, v in params.items():
    res[f"params/{k}"] = v.numpy()
np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_job")
    ranks, _ = run_port_job(JOB, str(out), env={"OMP_NUM_THREADS": "1"})
    return str(out), ranks


def test_a_failed_save_on_rank_0_returns_none_on_every_rank(job):
    _, ranks = job
    assert all(bool(r["failed_save"]) for r in ranks)


def test_rank_0_writes_and_restore_broadcasts(job):
    out, (r0, r1) = job
    assert str(r0["path"]) == os.path.join(out, "ckpt", "4")
    assert str(r1["path"]) == "None"
    for r in (r0, r1):
        np.testing.assert_array_equal(r["restored_w"],
                                      np.arange(6.0).reshape(2, 3))
        assert int(r["restored_n"]) == 5


def test_zero_state_saved_at_two_ranks_restores_at_one(job, world1):
    """The full layout of the 2-rank state comes back into a 1-rank
    ZeRO state: its shards are the whole buckets, equal to the full
    state the job gathered."""
    from horovod_tpu_torch import optim
    from horovod_tpu_torch.parallel import zero
    out, (r0, _) = job
    params = {"a": torch.zeros(6, 4), "b": torch.zeros(5)}
    zopt = zero.sharded_optimizer(optim.adam(1e-2), None)
    template = {"params": params, "opt": zopt.init(params)}
    got = checkpoint.restore(os.path.join(out, "zero"), template)
    assert zero.is_zero_state(got["opt"])
    assert got["opt"].plan.axis_size == 1
    full = zero.gather_full_state(got["opt"])
    for f in ("mu", "nu"):
        for k, v in getattr(full, f).items():
            np.testing.assert_array_equal(v.numpy(), r0[f"full/{f}/{k}"])
    np.testing.assert_array_equal(full.count.numpy(), r0["full/count"])
    for k in params:
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      r0[f"params/{k}"])
