"""SGD with momentum in optax's arithmetic, with a momentum accumulator in
its own dtype.

Counterpart of ``optax.sgd(lr, momentum, accumulator_dtype=...)``, which
the JAX package's LM benchmark uses with a bf16 accumulator
(``horovod_tpu/benchmark.py:492-495``).  ``torch.optim.SGD`` keeps the
momentum in the parameter's dtype and cannot express it.  optax's
``trace`` computes, per leaf::

    new = g + decay * trace     # decay * trace in the trace's dtype
    update = -lr * new          # in f32, from the unrounded new
    trace = new.astype(accumulator_dtype)

so the update of a step uses the f32 value, and only the stored trace is
rounded.  The first step equals torch's (the trace starts at zero).
Parameters and their trace are updated in place.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class SGD:
    """``optax.sgd(learning_rate, momentum, accumulator_dtype)`` over a
    fixed list of parameters.  ``step(grads)`` takes the gradients in
    the order of ``params``."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: float,
                 momentum: float,
                 accumulator_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.trace: List[torch.Tensor] = [
            torch.zeros_like(p, dtype=accumulator_dtype or p.dtype)
            for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        for p, g, t in zip(self.params, grads, self.trace):
            # optax: ``decay * t`` with a Python float is computed in t's
            # dtype (the decay itself rounded to it).
            new = g + t * torch.tensor(self.momentum, dtype=t.dtype,
                                       device=t.device)
            t.copy_(new)
            p.add_(new * -self.learning_rate)
