"""NaN/Inf step guard for the training step.

Counterpart of ``horovod_tpu/resilience.py``'s in-graph guard:
``guard_policy`` (``:130``), ``all_finite`` (``:159``) and
``apply_step_guard`` (``:178``).  Under any policy but ``off`` a step
whose loss or gradients are not finite on some rank keeps the old state
on every rank and reports a NaN mean loss, which is what a host-side
guard keys off.  The ranks agree on the verdict with one ``all_reduce``.

The JAX step selects per leaf between the new and the old state, because
a collective cannot sit inside a ``lax.cond`` branch under SPMD.  An eager
step can branch on the agreed verdict instead, so a bad step skips the
update (and its gradient all-reduce) on every rank alike; the price is one
host sync per step, paid only under a guard policy.  The host-side ladder
(``StepGuard``, last-known-good, rollback) is not ported yet: here
``rollback`` and ``abort`` keep the old state exactly as ``skip`` does,
as the JAX step itself does.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import config

GUARD_POLICIES = ("off", "skip", "rollback", "abort")


def guard_policy() -> str:
    """The policy from ``HOROVOD_STEP_GUARD`` (default ``off``), read when
    the training step is built."""
    value = (config.env_str("HOROVOD_STEP_GUARD") or "off").strip().lower()
    value = value or "off"
    if value not in GUARD_POLICIES:
        raise ValueError(f"HOROVOD_STEP_GUARD={value!r}: expected one of "
                         f"{', '.join(GUARD_POLICIES)}")
    return value


def all_finite(loss: torch.Tensor, grads: Sequence[torch.Tensor],
               group=None) -> torch.Tensor:
    """True iff ``loss`` and every floating gradient are finite on EVERY
    rank of ``group``: a local int32 flag, min-reduced across ranks."""
    flags = [torch.isfinite(t).all() for t in (loss, *grads)
             if t.is_floating_point()]
    local = torch.stack(flags).all() if flags else torch.tensor(True)
    flag = local.to(device=loss.device, dtype=torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return flag[0] == 1


def mean_across(t: torch.Tensor, group=None) -> torch.Tensor:
    """``pmean``: the mean of ``t`` over the ranks of ``group``."""
    out = t.detach().clone().reshape(1)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return (out / dist.get_world_size(group)).reshape(t.shape)


def apply_step_guard(do_update: Callable[[], None], *, loss: torch.Tensor,
                     grads: Sequence[torch.Tensor],
                     restore: Optional[Callable[[], None]] = None,
                     group=None, policy: Optional[str] = None,
                     agree_group=None) -> torch.Tensor:
    """Run one optimizer update under the step guard; returns the mean loss
    over ``group``.

    ``do_update()`` applies the update in place.  ``restore()`` puts back
    whatever the forward pass already changed (the BatchNorm running
    statistics).  The ranks of ``agree_group`` (default: ``group``; the
    LM's step passes every mesh axis, as the reference's ``agree_axes``)
    agree on the verdict.  Under policy ``off`` this is ``do_update()``
    plus the loss mean, with no check at all.
    """
    policy = guard_policy() if policy is None else policy
    mean_loss = mean_across(loss, group)
    if policy == "off":
        do_update()
        return mean_loss
    agree = group if agree_group is None else agree_group
    if bool(all_finite(loss, grads, agree)):
        do_update()
        return mean_loss
    if restore is not None:
        restore()
    return torch.full_like(mean_loss, float("nan"))
