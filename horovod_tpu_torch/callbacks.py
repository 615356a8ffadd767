"""Training-loop callbacks and learning-rate schedules.

Counterpart of ``horovod_tpu/callbacks.py:28-199`` (itself the
reference's Keras callbacks).  The LR callbacks act on a torch
optimizer's ``param_groups`` when given one, or on a ``set_lr`` callable;
:func:`warmup_schedule` is a plain ``step -> lr`` function, the torch
spelling of the reference's optax schedule (use it with
``torch.optim.lr_scheduler.LambdaLR`` as ``lambda s: sched(s) / base_lr``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective


class Callback:
    """Minimal callback protocol for custom training loops."""

    def on_train_begin(self, state=None):
        return state

    def on_epoch_begin(self, epoch: int, state=None):
        return state

    def on_batch_begin(self, batch: int, state=None):
        return state

    def on_batch_end(self, batch: int, state=None):
        return state

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None,
                     state=None):
        return state


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast rank ``root_rank``'s state to every rank once, at the
    first batch end (or at train begin).  ``state`` is a module or a
    ``state_dict()``; it is broadcast in place and returned."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch: int, state=None):
        if not self.broadcast_done:
            from horovod_tpu_torch.parallel.data import broadcast_parameters
            sd = state.state_dict() if isinstance(
                state, torch.nn.Module) else state
            broadcast_parameters(sd, root_rank=self.root_rank)
            self.broadcast_done = True
        return state

    def on_train_begin(self, state=None):
        return self.on_batch_end(0, state)


class MetricAverageCallback(Callback):
    """Average each metric of ``logs`` over the ranks at epoch end, in
    float64, in sorted key order."""

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None,
                     state=None):
        if logs:
            dev = basics.device()
            for key in sorted(logs):
                value = torch.as_tensor(logs[key], dtype=torch.float64,
                                        device=dev)
                logs[key] = float(collective.allreduce(
                    value, op=collective.Average))
        return state


class LearningRateScheduleCallback(Callback):
    """Set the LR to ``initial_lr * multiplier(epoch)`` within
    ``[start_epoch, end_epoch)``; per batch (``staircase=False`` with
    ``steps_per_epoch``) the epoch is fractional.  The new LR goes to
    every param group of ``optimizer`` and to ``set_lr``, whichever is
    given."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 set_lr: Optional[Callable[[float], None]] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None):
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.set_lr = set_lr
        self.optimizer = optimizer
        self.current_lr = initial_lr
        self._epoch = 0
        if isinstance(multiplier, (int, float)):
            self.multiplier = lambda epoch: multiplier
        else:
            self.multiplier = multiplier

    def _in_range(self, epoch: float) -> bool:
        return (epoch >= self.start_epoch and
                (self.end_epoch is None or epoch < self.end_epoch))

    def _adjust(self, epoch: float):
        if not self._in_range(epoch):
            return
        self.current_lr = self.initial_lr * self.multiplier(epoch)
        if self.optimizer is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.current_lr
        if self.set_lr is not None:
            self.set_lr(self.current_lr)

    def on_epoch_begin(self, epoch: int, state=None):
        self._epoch = epoch
        if self.staircase:
            self._adjust(epoch)
        return state

    def on_batch_begin(self, batch: int, state=None):
        if not self.staircase and self.steps_per_epoch:
            self._adjust(self._epoch + batch / self.steps_per_epoch)
        return state


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Warm up from ``initial_lr`` to ``initial_lr * size`` over
    ``warmup_epochs`` (the linear scaling rule); ``size`` defaults to the
    world size."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 set_lr: Optional[Callable[[float], None]] = None,
                 verbose: bool = False, size: Optional[int] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose
        if size is None:
            size = basics.size() if basics.is_initialized() else 1

        def multiplier(epoch):
            if warmup_epochs <= 0:
                return size
            progress = min(epoch / warmup_epochs, 1.0)
            return 1.0 + progress * (size - 1.0)

        super().__init__(initial_lr, multiplier, start_epoch=0,
                         end_epoch=warmup_epochs + 1, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch, set_lr=set_lr,
                         optimizer=optimizer)

    def on_epoch_begin(self, epoch: int, state=None):
        self._epoch = epoch
        self._adjust(epoch)
        return state

    def on_epoch_end(self, epoch: int, logs=None, state=None):
        if (self.verbose and epoch == self.warmup_epochs
                and basics.rank() == 0):
            print(f"Epoch {epoch}: finished gradual learning rate warmup to "
                  f"{self.current_lr}.")
        return state


def warmup_schedule(base_lr: float, warmup_epochs: int,
                    steps_per_epoch: int, size: Optional[int] = None
                    ) -> Callable[[int], float]:
    """``step -> lr``: linear from ``base_lr`` to ``base_lr * size`` over
    ``warmup_epochs * steps_per_epoch`` steps, then flat (optax's
    ``linear_schedule``, which the reference returns)."""
    size = size if size is not None else (
        basics.size() if basics.is_initialized() else 1)
    end = base_lr * size
    steps = max(warmup_epochs * steps_per_epoch, 1)

    def schedule(step: int) -> float:
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (base_lr - end) * frac + end

    return schedule


def scaled_lr(base_lr: float, size: Optional[int] = None) -> float:
    """The linear scaling rule: ``base_lr * size`` (default: world size)."""
    size = size if size is not None else (
        basics.size() if basics.is_initialized() else 1)
    return base_lr * size
