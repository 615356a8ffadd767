"""Megatron tensor parallelism.

Counterpart of ``horovod_tpu/parallel/tensor.py``: ``region_input``
(``:28``), ``column_parallel`` (``:40``), ``row_parallel`` (``:50``),
``shard_dim`` (``:59``) and ``clip_by_global_norm`` (``:70``).  The axis
is the model axis's process group (``mesh.axis("model")``; None is the
default group).

Megatron's two boundary operators are autograd Functions here:

* "f" (:func:`region_input`): identity forward, one all-reduce of the
  gradient backward, on the replicated activation entering a
  column-parallel matmul, so the partial gradients of the branches are
  summed once.  The reference's ``region_input`` is a no-op, because JAX
  inserts this all-reduce itself (the transpose of the invariant-to-
  varying promotion) and an explicit one would double-count there.
  Torch inserts nothing, so the port does exactly one.
* "g" (:func:`row_parallel`): all-reduce forward, identity backward.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def _size(axis) -> int:
    return dist.get_world_size(axis)


class _RegionInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis)
        return g, None


class _RowReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=axis)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def region_input(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Megatron's "f": the activation boundary of a tensor-parallel
    region (identity forward, all-reduce over ``axis_name`` backward)."""
    if _size(axis_name) == 1:
        return x
    return _RegionInput.apply(x, axis_name)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Megatron's "g": the sum over ``axis_name`` forward, identity
    backward (``lax.psum`` under the reference's vma transpose)."""
    if _size(axis_name) == 1:
        return x
    return _RowReduce.apply(x, axis_name)


def column_parallel(x, w_local, axis_name, bias_local=None):
    """Column-parallel matmul: weights split on the OUTPUT dim; the result
    stays sharded (no communication forward).  The input passes the
    region boundary, so the backward reduces once."""
    y = region_input(x, axis_name) @ w_local
    if bias_local is not None:
        y = y + bias_local
    return y


def row_parallel(x_local, w_local, axis_name, bias=None):
    """Row-parallel matmul: weights split on the INPUT dim; the partial
    results are summed across shards (all-reduce forward, identity
    backward)."""
    y = psum(x_local @ w_local, axis_name)
    if bias is not None:
        y = y + bias
    return y


def shard_dim(shape, axis_size: int, dim: int):
    """Local shape for a weight sharded on ``dim`` over ``axis_size``."""
    if shape[dim] % axis_size != 0:
        raise ValueError(
            f"dim {dim} of {shape} not divisible by model-parallel size "
            f"{axis_size}")
    out = list(shape)
    out[dim] //= axis_size
    return tuple(out)


def _spec_axes(spec, mesh_axes) -> tuple:
    out = []
    for entry in spec or ():
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax in mesh_axes:
                out.append(ax)
    return tuple(out)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        specs: Sequence, mesh,
                        mesh_axes: Sequence[str] = ("model",)
                        ) -> List[torch.Tensor]:
    """Sharding-aware global-norm clipping of a gradient list.

    ``specs`` gives each gradient's sharding as the reference's
    ``PartitionSpec`` does: a tuple with one entry per dim, each None, an
    axis name or a tuple of names (:func:`~horovod_tpu_torch.models.
    transformer.param_specs` gives them for the LM).  Leaves sharded over
    any axis of ``mesh_axes`` contribute the sum of their local square
    sums over those axes (the shards are disjoint), replicated leaves
    their own once: one all-reduce per group of axes (``mesh.axis``), not
    one per leaf.  So every shard scales by the same true global norm.
    Returns new tensors in the gradients' dtypes.
    """
    by_axes = {}
    for g, spec in zip(grads, specs):
        sq = g.float().square().sum()
        axes = _spec_axes(spec, mesh_axes)
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = None
    for axes, sq in by_axes.items():
        if axes:
            sq = sq.clone()
            dist.all_reduce(sq, group=mesh.axis(axes))
        total = sq if total is None else total + sq
    if total is None:
        return []
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gnorm + 1e-16), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads]

