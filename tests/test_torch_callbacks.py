"""The port's callbacks and schedules against the JAX package's.

The learning-rate callbacks run the same epoch and batch protocol in both
packages; the reference reports each new LR through ``set_lr``, the port
writes it into a torch optimizer's ``param_groups`` (and ``set_lr``).  The
values are the same Python floats, so they compare exactly;
``warmup_schedule`` is held against the reference's optax schedule, which
computes in float32 (tolerance 1e-6 relative).  The collective callbacks
run in a world of one here; ``tests/test_torch_data.py`` holds
``MetricAverageCallback`` to the reference at 2 ranks.
"""

import numpy as np
import pytest
import torch

import horovod_tpu.callbacks as jcb
import horovod_tpu_torch as thvd
from horovod_tpu_torch import callbacks as tcb

from torch_support import jax_world, world1  # noqa: F401



def _drive(cb, epochs=7, steps=3):
    """The callback protocol over ``epochs`` epochs of ``steps`` batches."""
    cb.on_train_begin()
    for epoch in range(epochs):
        cb.on_epoch_begin(epoch)
        for batch in range(steps):
            cb.on_batch_begin(batch)
            yield cb.current_lr
            cb.on_batch_end(batch)
        cb.on_epoch_end(epoch, {})


def _optimizer(lr=0.1):
    return torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=lr,
                           momentum=0.9)


@pytest.mark.parametrize("kw", [
    dict(warmup_epochs=5, size=4, steps_per_epoch=3),
    dict(warmup_epochs=2, size=8, steps_per_epoch=3),
    dict(warmup_epochs=0, size=4, steps_per_epoch=3),
    dict(warmup_epochs=3, size=2, steps_per_epoch=None),
])
def test_lr_warmup_matches_reference(kw):
    seen_ref, seen_port = [], []
    ref = jcb.LearningRateWarmupCallback(0.1, set_lr=seen_ref.append, **kw)
    opt = _optimizer()
    port = tcb.LearningRateWarmupCallback(0.1, set_lr=seen_port.append,
                                          optimizer=opt, **kw)
    for a, b in zip(_drive(ref), _drive(port)):
        assert a == b
        assert opt.param_groups[0]["lr"] == b
    assert seen_port == seen_ref and len(seen_ref) > 0


@pytest.mark.parametrize("staircase", [True, False])
@pytest.mark.parametrize("multiplier", [0.5, lambda e: 0.1 ** (e // 2)])
def test_lr_schedule_matches_reference(staircase, multiplier):
    kw = dict(start_epoch=1, end_epoch=5, staircase=staircase,
              steps_per_epoch=3)
    seen_ref, seen_port = [], []
    ref = jcb.LearningRateScheduleCallback(0.2, multiplier,
                                           set_lr=seen_ref.append, **kw)
    opt = _optimizer(0.2)
    port = tcb.LearningRateScheduleCallback(0.2, multiplier, optimizer=opt,
                                            set_lr=seen_port.append, **kw)
    assert list(_drive(ref)) == list(_drive(port))
    assert seen_port == seen_ref
    assert opt.param_groups[0]["lr"] == port.current_lr


@pytest.mark.parametrize("warmup_epochs,steps,size", [(5, 10, 4), (0, 3, 8),
                                                      (2, 1, 1)])
def test_warmup_schedule_matches_reference(warmup_epochs, steps, size):
    want = jcb.warmup_schedule(0.1, warmup_epochs, steps, size=size)
    got = tcb.warmup_schedule(0.1, warmup_epochs, steps, size=size)
    for step in range(0, warmup_epochs * steps + 5):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_scaled_lr_and_defaults_match_reference(jax_world):
    assert tcb.scaled_lr(0.1, size=8) == jcb.scaled_lr(0.1, size=8)
    assert tcb.scaled_lr(0.1) == jcb.scaled_lr(0.1) == 0.1
    assert (tcb.warmup_schedule(0.1, 1, 2)(5)
            == pytest.approx(float(jcb.warmup_schedule(0.1, 1, 2)(5))))


def test_metric_average_size1_matches_reference(jax_world):
    logs = {"loss": 2.5, "acc": 0.75}
    ref, port = dict(logs), dict(logs)
    jcb.MetricAverageCallback().on_epoch_end(0, ref)
    tcb.MetricAverageCallback().on_epoch_end(0, port)
    assert port == ref == logs
    assert all(type(v) is float for v in port.values())


def test_broadcast_callback_runs_once(world1):
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cb = tcb.BroadcastGlobalVariablesCallback(root_rank=0)
    assert cb.on_train_begin(model) is model and cb.broadcast_done
    sd = model.state_dict()
    assert cb.on_batch_end(1, sd) is sd
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_callback_protocol_passes_state_through():
    cb, state = tcb.Callback(), object()
    assert cb.on_train_begin(state) is state
    assert cb.on_epoch_begin(0, state) is state
    assert cb.on_batch_begin(0, state) is state
    assert cb.on_batch_end(0, state) is state
    assert cb.on_epoch_end(0, {}, state) is state
    assert thvd.Callback is tcb.Callback
