"""Two-level collectives over a host's ranks and across hosts.

Counterpart of ``horovod_tpu/parallel/hierarchical.py``:
``hierarchical_allreduce`` (``:71``), ``hierarchical_pytree_mean``
(``:115``) and ``hierarchical_allgather`` (``:131``), the mesh form of
Horovod's ``NCCLHierarchicalAllreduce`` (intra-node reduce-scatter, then
cross-node all-reduce, then intra-node all-gather) and
``MPIHierarchicalAllgather``.

The two levels are the axes of a ``build_mesh(axes=("dcn", "ici"))``
mesh (hosts x ranks per host, from ``hvd.topology()``): ``ici_axis`` is
this rank's group on its host (``mesh.axis("ici")``, NVLink on the
card), ``dcn_axis`` its group of peers on the other hosts
(``mesh.axis("dcn")``).  The reduce-scatter/all-reduce/all-gather
decomposition pins the bandwidth-optimal pattern: the inter-host leg
carries 1/ici of the bytes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.parallel.zero import tree_flatten, tree_unflatten


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` stacked along dim 0, in rank order."""
    n = dist.get_world_size(group)
    full = fusion.wait_all([fusion.start_all_gather(x.reshape(-1),
                                                    group)])[0]
    return full.view((n * x.shape[0],) + tuple(x.shape[1:]))


def hierarchical_allreduce(x: torch.Tensor, ici_axis, dcn_axis,
                           average: bool = False) -> torch.Tensor:
    """Reduce-scatter over ``ici_axis``, all-reduce of the shard over
    ``dcn_axis``, all-gather over ``ici_axis``: the sum over both levels
    with the inter-host leg carrying 1/ici of the bytes.

    ``average=True`` folds both levels' divide into one ``1/(ici*dcn)``
    multiply on the shard, before the gather (an integer payload divides
    after the gather instead, where a multiply would truncate)."""
    ici = dist.get_world_size(ici_axis)
    dcn = dist.get_world_size(dcn_axis)
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % ici
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    esize = flat.element_size()
    shard = fusion.wait_all([fusion.start_reduce_scatter(flat, ici_axis)])[0]
    fusion.record_collective_bytes("hier_allreduce", "none",
                                   flat.numel() * esize, level="ici")
    fusion.allreduce_calls.add()
    dist.all_reduce(shard, group=dcn_axis)
    fusion.record_collective_bytes("hier_allreduce", "none",
                                   shard.numel() * esize, level="dcn")
    if average and shard.dtype.is_floating_point:
        shard = fusion.scale(shard, 1.0 / (ici * dcn))
        average = False
    full = fusion.wait_all([fusion.start_all_gather(shard, ici_axis)])[0]
    out = full[:n].view(x.shape)
    if average:
        out = out / (ici * dcn)
    return out


def hierarchical_pytree_mean(tree, ici_axis, dcn_axis):
    """Gradient averaging over both levels: the two-level form of
    :func:`horovod_tpu_torch.ops.fusion.fused_pytree_mean` (one flat
    buffer of every leaf).  ``tree`` is a list, tuple or dict."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        return tree
    red = hierarchical_allreduce(torch.cat([t.reshape(-1) for t in leaves]),
                                 ici_axis, dcn_axis, average=True)
    parts = red.split([t.numel() for t in leaves])
    return tree_unflatten(treedef, [p.view(t.shape)
                                    for p, t in zip(parts, leaves)])


def hierarchical_allgather(x: torch.Tensor, ici_axis,
                           dcn_axis) -> torch.Tensor:
    """Two-level dim-0 all-gather: over the host's ranks first, then across
    hosts, so the rows come in (dcn, ici, local row) order, as a flat
    all-gather over a mesh whose ici axis is minor."""
    esize = x.element_size()
    local = _all_gather_rows(x, ici_axis)
    fusion.record_collective_bytes("hier_allgather", "none",
                                   local.numel() * esize, level="ici")
    out = _all_gather_rows(local, dcn_axis)
    fusion.record_collective_bytes("hier_allgather", "none",
                                   out.numel() * esize, level="dcn")
    return out
