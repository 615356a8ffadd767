"""Element-wise optimizers in optax's arithmetic, in functional form.

Counterpart of the optax transforms the JAX package trains with:
``optax.sgd(lr, momentum, accumulator_dtype=...)`` (the LM benchmark's,
``horovod_tpu/benchmark.py:492-495``, with a bf16 accumulator) and
``optax.adam(lr, b1, b2, eps)``.  ``torch.optim.SGD`` keeps the momentum
in the parameter's dtype and steps in place, so it can express neither
the bf16 accumulator nor give an update back: the ZeRO-1 wrapper
(:mod:`horovod_tpu_torch.parallel.zero`) steps the optimizer on this
rank's flat shard and all-gathers the UPDATE, which a wire codec may
quantize.

:func:`sgd` and :func:`adam` return a :class:`Transform`:
``init(tensors) -> state`` and ``update(grads, state, params) ->
(updates, state)`` over lists of tensors; apply with ``p + u``.
optax's ``trace`` computes, per leaf::

    new = g + decay * trace     # decay * trace in the trace's dtype
    update = -lr * new          # in f32, from the unrounded new
    trace = new.astype(accumulator_dtype)

so the update of a step uses the f32 value, and only the stored trace is
rounded.  ``scale_by_adam``::

    mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g**2 + b2 * nu
    update = -lr * (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)

:class:`SGD` is :func:`sgd` over a fixed list of parameters, stepped in
place (the LM steps' optimizer; their sharded update wraps its
``transform``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch


class Transform(NamedTuple):
    """An element-wise optimizer: ``init(tensors) -> state``,
    ``update(grads, state, params=None) -> (updates, state)`` (optax's
    convention; neither :func:`sgd` nor :func:`adam` reads ``params``)."""
    init: Callable
    update: Callable


class SGDState(NamedTuple):
    trace: Optional[List[torch.Tensor]]   # None without momentum


class AdamState(NamedTuple):
    count: torch.Tensor                   # int32 scalar
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


# The state fields that mirror the parameters, leaf for leaf (optax's
# ``tree_map_params``): what ZeRO-1 shards and checkpoints re-bucket.
_PARAM_FIELDS = {SGDState: ("trace",), AdamState: ("mu", "nu")}


def map_params(state, fn):
    """``state`` with ``fn`` applied to each parameter-shaped list field
    (its other fields, such as Adam's count, as they are)."""
    fields = _PARAM_FIELDS.get(type(state))
    if fields is None:
        raise TypeError(f"{type(state).__name__} is not the state of an "
                        f"optimizer of horovod_tpu_torch.optim")
    return state._replace(**{f: fn(getattr(state, f)) for f in fields
                             if getattr(state, f) is not None})


def _check(grads, leaves, what: str) -> None:
    if len(grads) != len(leaves):
        raise ValueError(f"{len(grads)} gradients for {len(leaves)} "
                         f"{what}")


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as jnp rounds it against an array: to the array's
    dtype."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def sgd(learning_rate: float, momentum: Optional[float] = None,
        accumulator_dtype: Optional[torch.dtype] = None) -> Transform:
    """``optax.sgd(learning_rate, momentum, accumulator_dtype=...)``."""

    def init(tensors: Sequence[torch.Tensor]) -> SGDState:
        if momentum is None:
            return SGDState(None)
        return SGDState([torch.zeros_like(t, dtype=accumulator_dtype
                                          or t.dtype) for t in tensors])

    @torch.no_grad()
    def update(grads, state: SGDState, params=None):
        del params
        if state.trace is None:
            return [g * -learning_rate for g in grads], state
        _check(grads, state.trace, "momentum traces")
        updates, trace = [], []
        for g, t in zip(grads, state.trace):
            new = g + t * _scalar(momentum, t)
            updates.append(new * -learning_rate)
            trace.append(new.to(t.dtype))
        return updates, SGDState(trace)

    return Transform(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """``optax.adam(learning_rate, b1, b2, eps)``: the bias-corrected
    ``m̂ / (√v̂ + eps)``, scaled by ``-learning_rate``."""

    def init(tensors: Sequence[torch.Tensor]) -> AdamState:
        dev = tensors[0].device if len(tensors) else None
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         [torch.zeros_like(t) for t in tensors],
                         [torch.zeros_like(t) for t in tensors])

    @torch.no_grad()
    def update(grads, state: AdamState, params=None):
        del params
        _check(grads, state.mu, "first moments")
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * g ** 2 + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        t = count.to(torch.float32)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
        updates = [(m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype))
                                           + eps) * -learning_rate
                   for m, v in zip(mu, nu)]
        return updates, AdamState(count, mu, nu)

    return Transform(init, update)


class SGD:
    """:func:`sgd` over a fixed list of parameters, updated in place.
    ``step(grads)`` takes the gradients in the order of ``params``;
    ``trace`` is the momentum, one tensor a parameter."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: float,
                 momentum: float,
                 accumulator_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.accumulator_dtype = accumulator_dtype
        self.transform = sgd(learning_rate, momentum, accumulator_dtype)
        # Built at the first step: a sharded step wraps ``transform`` and
        # never steps this object, so it holds no full-size trace then.
        self.state: Optional[SGDState] = None

    @property
    def trace(self) -> List[torch.Tensor]:
        if self.state is None:
            self.state = self.transform.init(self.params)
        return self.state.trace

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        trace = self.trace
        # Leaf by leaf, so a step holds one leaf's update at a time.
        for i, (p, g) in enumerate(zip(self.params, grads)):
            (u,), st = self.transform.update(
                [g], SGDState(None if trace is None else [trace[i]]))
            p.add_(u)
            if trace is not None:
                trace[i] = st.trace[0]
