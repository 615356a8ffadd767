"""Sharded-update data parallelism (ZeRO stage 1).

Counterpart of ``horovod_tpu/parallel/zero.py``: ``ZeroShardedState``
(``:57``), ``ShardedOptimizer`` (``:109``) with ``init`` (``:167``) and
``update`` (``:185``), ``sharded_optimizer`` (``:291``),
``gather_full_state``, ``local_state_digest``, ``scatter_full_state`` and
``reshard_state`` (``:327-420``).

A ring all-reduce is a reduce-scatter followed by an all-gather; ZeRO-1
(Rajbhandari et al., SC'20) runs the optimizer between the two:

1. **reduce-scatter** the fused gradient buckets
   (:func:`horovod_tpu_torch.ops.fusion.fused_reduce_scatter`, or a wire
   codec's, :mod:`horovod_tpu_torch.ops.compression`): each rank keeps
   the mean of its 1/N of every bucket;
2. step the optimizer **only on this rank's shard** of the flat buckets:
   its state (momentum, Adam's m and v) exists only as this shard, on
   this rank's device;
3. **all-gather** the update shards back to full updates, which the
   caller adds to the parameters (``p + u``).

The same wire bytes as the all-reduce it replaces, and the same
trajectory up to the order of the sums, because an element-wise
optimizer commutes with the slicing.  The wrapped optimizer must be
element-wise and functional: :func:`horovod_tpu_torch.optim.sgd` or
:func:`~horovod_tpu_torch.optim.adam` (a :class:`~horovod_tpu_torch.
optim.Transform`), whose update comes back as a tensor a codec can
quantize.

Axes are process groups, or names of the mesh's axes
(``hvd.mesh()`` unless ``mesh=`` is given).  In the two-level mode
(``cross_axis_name``) the axis is the intra-host one: the state is
sharded 1/ici-way on each host, the reduce-scatter's shards are summed
over ``cross_axis_name`` (optionally through a stateless codec,
:func:`~horovod_tpu_torch.ops.compression.cross_level_psum`) and the
all-gather stays on the host.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import optim, telemetry
from horovod_tpu_torch.ops import compression as compression_mod
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.tree import children


class TreeDef(NamedTuple):
    """The structure of a flat parameter container: a list or tuple of
    ``n`` tensors, or a dict walked in sorted key order."""
    kind: str
    keys: Tuple[Any, ...]


def tree_flatten(tree) -> Tuple[List[torch.Tensor], TreeDef]:
    node = children(tree)
    if node is None:
        raise TypeError(f"expected a list, tuple or dict of tensors, got "
                        f"{type(tree).__name__}")
    _, keys, leaves = node
    kind = "dict" if isinstance(tree, dict) else type(tree).__name__
    return leaves, TreeDef(kind, tuple(keys))


def tree_unflatten(treedef: TreeDef, leaves: Sequence[torch.Tensor]):
    if treedef.kind == "dict":
        return dict(zip(treedef.keys, leaves))
    return tuple(leaves) if treedef.kind == "tuple" else list(leaves)


@dataclasses.dataclass
class ZeroShardedState:
    """Optimizer state over this rank's shards of the flat buckets.

    ``inner`` is the wrapped optimizer's state with the list of bucket
    SHARDS in the place of the parameters; ``wire`` the codec's state
    (:class:`~horovod_tpu_torch.ops.compression.CodecState`, this rank's
    piece, None for a stateless codec).  ``plan``, ``treedef``,
    ``optimizer``, ``codec``, ``index`` (this rank's shard) and ``group``
    (the group the state is sharded over; None is the default group) ride
    along, so the state converts to the replicated per-leaf layout and
    back (:func:`gather_full_state`, :func:`scatter_full_state`)."""
    inner: Any
    plan: fusion.ReduceScatterPlan
    treedef: TreeDef
    optimizer: optim.Transform
    wire: Any = None
    codec: Any = None
    index: int = 0
    group: Any = None

    def __repr__(self):
        codec = getattr(self.codec, "name", None) or "none"
        return (f"ZeroShardedState(buckets={len(self.plan.buckets)}, "
                f"axis_size={self.plan.axis_size}, codec={codec})")

    def nbytes(self) -> int:
        """Bytes of this rank's optimizer and codec state."""
        return sum(t.numel() * t.element_size() for t in _tensors(
            (self.inner, self.wire)))


def is_zero_state(x) -> bool:
    return isinstance(x, ZeroShardedState)


def _tensors(x) -> List[torch.Tensor]:
    """Every tensor inside nested tuples, lists, NamedTuples, codec states."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, compression_mod.CodecState):
        x = (x.rs, x.ag, x.factors)
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


class ShardedOptimizer:
    """ZeRO-1 around an element-wise functional optimizer.

    ``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``, as the optimizer's own; ``update`` issues the
    reduce-scatter and all-gather over the axis's group, so every rank of
    it calls it at the same point, and requires ``params``."""

    def __init__(self, optimizer: optim.Transform, axis_name="data", *,
                 axis_size: Optional[int] = None, mesh=None,
                 threshold: Optional[int] = None, mean: bool = True,
                 compression=None, cross_axis_name=None,
                 cross_compression=None):
        if isinstance(axis_name, (tuple, list)):
            raise NotImplementedError(
                f"sharded_optimizer shards over ONE mesh axis; got "
                f"axis_name={axis_name!r}.  For dp x sp grids, shard over "
                f"the data axis and average the seq axis upstream.")
        if not isinstance(optimizer, optim.Transform):
            raise TypeError(
                f"ShardedOptimizer wraps an element-wise functional "
                f"optimizer, horovod_tpu_torch.optim.sgd or "
                f"horovod_tpu_torch.optim.adam (an optim.Transform); got "
                f"{type(optimizer).__name__}: a torch.optim.Optimizer steps "
                f"in place and cannot give its update back")
        self.inner = optimizer
        self.axis_name = axis_name
        self._axis_size = axis_size
        self._mesh = mesh
        self.threshold = threshold
        self.mean = mean
        self.codec = compression_mod.resolve_codec(compression)
        # The cross codec is its own choice ("int8 between hosts, none
        # within") and never read from HOROVOD_COMPRESSION.
        self.cross_axis_name = cross_axis_name
        self.cross_codec = (compression_mod.resolve_codec(
            cross_compression if cross_compression is not None else "none")
            if cross_axis_name is not None else None)

    # -- axes -----------------------------------------------------------------
    def _resolve(self, axis):
        """A process group for an axis name (through the mesh) or the
        group itself."""
        if not isinstance(axis, str):
            return axis
        from horovod_tpu_torch import basics
        mesh = self._mesh if self._mesh is not None else basics.mesh()
        return mesh.axis(axis)

    @property
    def group(self):
        return self._resolve(self.axis_name)

    @property
    def cross_group(self):
        return self._resolve(self.cross_axis_name)

    def _resolve_axis_size(self) -> int:
        if self._axis_size is not None:
            return int(self._axis_size)
        try:
            self._axis_size = dist.get_world_size(self.group)
        except Exception as e:
            raise ValueError(
                f"sharded_optimizer could not resolve the size of axis "
                f"{self.axis_name!r}: pass axis_size= (or mesh=) "
                f"explicitly, or hvd.init() first") from e
        return self._axis_size

    # -- the optimizer --------------------------------------------------------
    def init(self, params) -> ZeroShardedState:
        """The sharded state from the (replicated) parameters: this rank's
        shard of every bucket, on the parameters' device.  A state built
        for an axis size other than its group's takes shard ``rank mod
        size``: a layout for :func:`scatter_full_state`, never a state to
        step (``update`` refuses it)."""
        leaves, treedef = tree_flatten(params)
        n = self._resolve_axis_size()
        group = self.group
        index = dist.get_rank(group) % n if dist.is_initialized() else 0
        plan = fusion.make_reduce_scatter_plan(leaves, n, self.threshold,
                                               codec=self.codec)
        with torch.no_grad():
            shards = [plan.shard_slice(b, flat, index) for b, flat in
                      enumerate(plan.concat([p.detach() for p in leaves]))]
            inner = self.inner.init(shards)
        dev = leaves[0].device if leaves else None
        return ZeroShardedState(inner, plan, treedef, self.inner,
                                wire=self.codec.init_state(plan, dev),
                                codec=self.codec, index=index, group=group)

    @torch.no_grad()
    def update(self, grads, state: ZeroShardedState, params=None):
        """Reduce-scatter ``grads``, step the optimizer on this rank's
        shard, all-gather the updates.  Returns the full updates (in
        ``grads``' structure; add them to the parameters) and the new
        state."""
        if params is None:
            raise ValueError(
                "sharded_optimizer.update requires params: the update "
                "slices this rank's parameter shard out of them")
        plan = state.plan
        gleaves, gdef = tree_flatten(grads)
        if gdef != state.treedef:
            raise ValueError(
                f"gradient tree structure {gdef} does not match the "
                f"structure this state was initialized with "
                f"({state.treedef})")
        group = self.group
        n = dist.get_world_size(group)
        if int(n) != plan.axis_size:
            raise ValueError(
                f"axis {self.axis_name!r} has size {n} here but the "
                f"optimizer state was sharded {plan.axis_size}-way — "
                f"re-init (or re-shard the checkpoint) for this mesh")
        self._record(plan)

        if self.cross_axis_name is not None:
            # Two-level: the intra-host reduce-scatter (unscaled), each
            # shard summed across hosts through the cross codec, then one
            # 1/(ici*dcn) multiply on the shard.
            grad_shards, wire = compression_mod.compressed_reduce_scatter(
                gleaves, group, self.codec, plan=plan, state=state.wire,
                mean=False)
            cross = self.cross_group
            dcn = dist.get_world_size(cross)
            grad_shards = [compression_mod.cross_level_psum(
                s, cross, self.cross_codec) for s in grad_shards]
            if self.mean:
                grad_shards = [fusion.scale(s, 1.0 / (plan.axis_size * dcn))
                               for s in grad_shards]
        else:
            grad_shards, wire = compression_mod.compressed_reduce_scatter(
                gleaves, group, self.codec, plan=plan, state=state.wire,
                mean=self.mean)
        del gleaves
        # The reference also slices this rank's parameter shard for the
        # optax update; the port's element-wise optimizers read none.
        upd_shards, new_inner = self.inner.update(grad_shards, state.inner)
        del grad_shards
        upd_leaves, wire = compression_mod.compressed_all_gather(
            upd_shards, plan, group, self.codec, state=wire)
        return (tree_unflatten(state.treedef, upd_leaves),
                dataclasses.replace(state, inner=new_inner, wire=wire,
                                    group=group))

    def _record(self, plan: fusion.ReduceScatterPlan) -> None:
        """The ``hvd_zero_*`` series (reference ``zero.py:242-263``), once
        per update."""
        if not telemetry.enabled():
            return
        telemetry.counter(
            "hvd_zero_updates_total",
            "Sharded (ZeRO-1) optimizer updates traced").inc()
        if self.cross_axis_name is not None:
            telemetry.counter(
                "hvd_zero_hier_updates_total",
                "ZeRO-1 updates using the two-level (ICI+DCN) reduce "
                "path").inc()
        telemetry.counter(
            "hvd_zero_buckets_total",
            "Flat buckets in sharded optimizer updates").inc(
            len(plan.buckets))
        hist = telemetry.histogram(
            "hvd_zero_shard_bytes",
            "Per-rank shard size of each sharded-update bucket",
            bounds=telemetry.DEFAULT_BYTE_BUCKETS)
        for b in range(len(plan.buckets)):
            hist.observe(float(plan.shard_size(b)
                               * plan.bucket_dtype(b).itemsize))


class ShardedUpdate:
    """The update half of a sharded training step: a
    :class:`ShardedOptimizer` over fixed parameters, with its state.
    ``init()`` builds the state (the first call does when it was not
    called); ``update(grads)`` reduce-scatters ``grads``, steps the
    optimizer on this rank's shard, all-gathers the updates and adds
    them to the parameters in place.  A step holds one, and the
    update's closures refer to it rather than to the step, so no
    reference cycle keeps a dropped step's state alive."""

    def __init__(self, optimizer: ShardedOptimizer, params):
        self.optimizer = optimizer
        self.params = list(params)
        self.state: Optional[ZeroShardedState] = None

    def init(self, params=None) -> ZeroShardedState:
        self.state = self.optimizer.init(self.params if params is None
                                         else params)
        return self.state

    @torch.no_grad()
    def update(self, grads) -> None:
        if self.state is None:
            self.init()
        updates, self.state = self.optimizer.update(list(grads), self.state,
                                                    self.params)
        for p, u in zip(self.params, updates):
            p.add_(u)


def sharded_optimizer(optimizer: optim.Transform, axis_name="data", *,
                      axis_size: Optional[int] = None, mesh=None,
                      threshold: Optional[int] = None, mean: bool = True,
                      compression=None, cross_axis_name=None,
                      cross_compression=None) -> ShardedOptimizer:
    """Wrap an element-wise functional ``optimizer`` for ZeRO-1 sharded
    updates over ``axis_name`` (a mesh axis name or a process group; see
    the module docstring).  ``axis_size`` (or ``mesh``) pins the shard
    count at init; omitted, it is the axis group's size.  ``compression``
    is the wire codec of the reduce-scatter/all-gather pair (default
    none, or ``HOROVOD_COMPRESSION``).  ``cross_axis_name`` turns on the
    two-level mode, with ``cross_compression`` (none/bf16/fp16/int8) on
    the cross-host sum."""
    if mesh is not None and axis_size is None and isinstance(axis_name,
                                                             str):
        axis_size = mesh.axis_size(axis_name)
    return ShardedOptimizer(optimizer, axis_name, axis_size=axis_size,
                            mesh=mesh, threshold=threshold, mean=mean,
                            compression=compression,
                            cross_axis_name=cross_axis_name,
                            cross_compression=cross_compression)


# ---------------------------------------------------------------------------
# Checkpoint interchange: sharded layout <-> replicated per-leaf layout.
# ---------------------------------------------------------------------------

def gather_full_state(state: ZeroShardedState, group=None):
    """The REPLICATED optimizer state: what ``optimizer.init(params)``
    would hold after the same steps, per leaf, in the parameters'
    structure.  All-gathers every shard over ``group`` (default: the
    state's), so every rank of it calls this; the full state exists only
    in what it returns.  The codec state is left out: a restore starts
    with zero residuals (see :func:`reshard_state`)."""
    plan, treedef = state.plan, state.treedef
    group = state.group if group is None else group

    def expand(shards):
        fulls = fusion.wait_all([fusion.start_all_gather(s, group)
                                 for s in shards])
        return tree_unflatten(treedef, [leaf.clone() for leaf in
                                        plan.split(fulls)])

    return optim.map_params(state.inner, expand)


def local_state_digest(state: ZeroShardedState) -> int:
    """crc32 chained over this rank's optimizer-state bytes, leaf by leaf
    (the divergence sentinel digests the shards it holds, not gathered
    buckets)."""
    crc = 0
    for t in _tensors(state.inner):
        raw = t.detach().reshape(-1).contiguous().view(torch.uint8)
        crc = zlib.crc32(raw.cpu().numpy().tobytes(), crc)
    return crc


def scatter_full_state(full_state, like: ZeroShardedState
                       ) -> ZeroShardedState:
    """Inverse of :func:`gather_full_state`: this rank's shards of a
    replicated per-leaf state in ``like``'s layout (``like`` gives the
    plan, structure and shard index: typically the freshly ``init``-ed
    state a restore replaces).  No collective."""
    plan = like.plan

    def collapse(per_leaf):
        leaves, _ = tree_flatten(per_leaf)
        return [plan.shard_slice(b, flat, like.index).clone()
                for b, flat in enumerate(plan.concat(leaves))]

    return dataclasses.replace(like, inner=optim.map_params(full_state,
                                                            collapse))


def reshard_state(state: ZeroShardedState, like: ZeroShardedState
                  ) -> ZeroShardedState:
    """``state`` in ``like``'s layout, for another axis size: through the
    replicated layout (:func:`gather_full_state` over ``state``'s group,
    then :func:`scatter_full_state`), the element-wise moments only
    re-arranged.  The codec state rides along: the pending error feedback
    is gathered over ``state``'s group, re-bucketed for ``like``'s plan
    (:meth:`~horovod_tpu_torch.ops.compression.BucketCodec.reshard_state`)
    and cut to ``like``'s shard."""
    if telemetry.enabled():
        telemetry.counter(
            "hvd_zero_reshards_total",
            "ZeRO-1 states re-bucketed for a different axis size").inc()
    out = scatter_full_state(gather_full_state(state), like=like)
    codec = like.codec if like.codec is not None else state.codec
    if codec is not None and codec.stateful and state.wire is not None:
        full = compression_mod.gather_state(state.wire, state.plan,
                                            state.group)
        out = dataclasses.replace(out, codec=codec, wire=(
            compression_mod.local_state(
                codec.reshard_state(full, state.plan, like.plan),
                like.plan, like.index)))
    return out
