"""Data parallelism on torch: ``DistributedOptimizer`` and its companions.

Counterpart of ``horovod_tpu/parallel/data.py`` and of the reference
torch binding's optimizer and state broadcasts
(``horovod_tpu/torch/__init__.py:38-60``, ``:269-501``).

``DistributedOptimizer`` keeps the binding's contract: a dynamic subclass
of the wrapped optimizer, gradient hooks that start the all-reduce during
backward, ``synchronize``/``skip_synchronize``, the force-allreduce in
``step``, and no hooks at all in a world of one.  The hooks fill fusion
buckets (``_bucket_leaves`` at ``HOROVOD_FUSION_THRESHOLD``, planned once
from the parameters in reverse registration order) and submit a bucket
to the control plane as soon as it is full, under names that are the
same on every rank and every step (``DistributedOptimizer.<b>.<i>``).
The control plane pairs them by name, so ranks whose backward fills the
buckets in other orders need no agreement on order; the runtime fuses
what is ready into flat all-reduces.  ``synchronize`` (and so ``step``)
submits every bucket not yet out and waits on the handles.  A parameter
with no gradient on this rank goes out as zeros and, unless it is
frozen, receives the average, so the replicas stay equal where the
reference's runtime would wait for a tensor that this rank never
submits.

``make_training_step`` (reference ``:256-490``) runs the replicated
update, the ZeRO-1 sharded update (``shard_optimizer=True``) or, for a
stateful wire codec, the compressed replicated update.  The per-leaf
paths (``DistributedOptimizer``, ``DistributedGradientTape``) take the
per-tensor casts; a stateful codec there warns once and falls back to
none (``:45-75``).

``elastic_shard``, ``elastic_continuity`` and ``elastic_transition``
(reference ``:490-573``) keep the global batch's meaning across a world
size change: the launcher exports the previous size on a restart, and
``reform_world`` does so in-process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Optional

import numpy as np
import torch

from horovod_tpu_torch import basics, config, faults, resilience
from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.ops import compression as compression_mod
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.collective import Average
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.fusion import (_bucket_leaves, fused_psum,
                                          fusion_threshold_bytes)
from horovod_tpu_torch.topology import data_axis
from horovod_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


_warned_stateful_per_leaf = False


def _compression(compression):
    """The per-tensor :class:`Compressor` for a ``compression=`` of a
    per-leaf path (reference ``data.py:45-75``): a Compressor class
    passes through; a codec or a name maps to its cast twin, the default
    forms consulting ``HOROVOD_COMPRESSION``.  The stateful codecs
    (``int8``, ``powersgd``) need the bucketed reduce-scatter wire: here
    they warn once and fall back to no compression."""
    global _warned_stateful_per_leaf
    if (isinstance(compression, type)
            and issubclass(compression, compression_mod.Compressor)
            and compression is not compression_mod.NoneCompressor):
        return compression
    codec = compression_mod.resolve_codec(
        None if (isinstance(compression, type)
                 and issubclass(compression, compression_mod.NoneCompressor))
        else compression)
    legacy = compression_mod.as_legacy(codec)
    if legacy is None:
        if not _warned_stateful_per_leaf:
            _warned_stateful_per_leaf = True
            log.warning(
                "compression codec %r needs the bucketed reduce-scatter "
                "wire and does not apply to per-leaf allreduce; falling "
                "back to uncompressed here (use shard_optimizer=True / "
                "sharded_update=True, or make_training_step's stateful-"
                "codec path)", codec.name)
        return compression_mod.NoneCompressor
    return legacy


# ---------------------------------------------------------------------------
# DistributedOptimizer (reference torch binding :269-433)
# ---------------------------------------------------------------------------

class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1, op=Average):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self._op = op
        self.backward_passes_per_step = backward_passes_per_step

        if named_parameters is not None:
            named_parameters = list(named_parameters)
            if any(not isinstance(nv, tuple) or len(nv) != 2 or
                   not isinstance(nv[0], str)
                   for nv in named_parameters):
                raise ValueError(
                    "named_parameters should be a sequence of (name, "
                    "parameter) tuples, e.g. model.named_parameters()")
            names = [n for n, _ in named_parameters]
            if len(names) != len(set(names)):
                dups = sorted({n for n in names if names.count(n) > 1})
                raise ValueError(
                    f"parameter names must be unique, found duplicates: "
                    f"{dups}")
            all_params = {id(p) for group in self.param_groups
                          for p in group["params"]}
            named = {id(p) for _, p in named_parameters}
            if len(all_params - named) > 0:
                raise ValueError(
                    "named_parameters was specified but it does not cover "
                    "all optimizer parameters")

        self._lock = threading.Lock()
        self._passes = {}
        self._hooks = []
        # Bucket plan: the same on every rank (see the module docstring).
        order = [p for group in self.param_groups for p in group["params"]
                 if p.requires_grad][::-1]
        self._buckets = [[order[i] for i in b] for b in
                         _bucket_leaves(order, fusion_threshold_bytes())]
        self._bucket_of = {id(p): b for b, ps in enumerate(self._buckets)
                           for p in ps}
        self._reset_buckets()
        if basics.size() > 1:
            self._register_hooks()

    def _reset_buckets(self):
        self._ready = [set() for _ in self._buckets]
        self._inflight = []     # (bucket, pending, ctxs) in issue order

    def _register_hooks(self):
        for params in self._buckets:
            for p in params:
                self._passes[id(p)] = 0
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._hook))

    def _hook(self, p):
        with self._lock:
            self._passes[id(p)] += 1
            if self._passes[id(p)] != self.backward_passes_per_step:
                return
            self._passes[id(p)] = 0
            b = self._bucket_of[id(p)]
            self._ready[b].add(id(p))
            if len(self._ready[b]) == len(self._buckets[b]):
                self._issue(b)

    def _issue(self, b):
        """Submit bucket ``b`` (the caller holds the lock)."""
        wires, ctxs = [], []
        for p in self._buckets[b]:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            wire, ctx = self._compression.compress(g)
            wires.append(wire)
            ctxs.append(ctx)
        self._inflight.append((b, collective._start_grouped(
            wires, self._op, f"DistributedOptimizer.{b}", 1.0, 1.0, None),
            ctxs))

    def synchronize(self):
        """Submit every bucket not yet out, wait for all of them and
        write the reduced gradients back (reference ``:336-345``)."""
        if basics.size() > 1:
            with self._lock:
                issued = {b for b, _, _ in self._inflight}
                for b in range(len(self._buckets)):
                    if b not in issued:
                        self._issue(b)
                inflight = self._inflight
                self._reset_buckets()
            for b, pending, ctxs in inflight:
                for p, out, ctx in zip(self._buckets[b], pending.result(),
                                       ctxs):
                    g = self._compression.decompress(out, ctx)
                    with torch.no_grad():
                        if p.grad is not None:
                            p.grad.copy_(g)
                        elif p.requires_grad:
                            p.grad = g.to(p.dtype)
        self._synchronized = True

    @contextlib.contextmanager
    def skip_synchronize(self):
        """For the explicit-synchronize recipe::

            optimizer.synchronize()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
            with optimizer.skip_synchronize():
                optimizer.step()

        A ``step()`` inside it raises unless ``synchronize()`` ran since
        the last step with no backward pass or partial accumulation
        after it (the reference's three guards, ``:352-396``)."""
        self._should_skip_synchronize = True
        try:
            yield
        finally:
            self._should_skip_synchronize = False

    def _gradients_pending(self) -> bool:
        return bool(self._inflight) or any(self._ready)

    def step(self, closure=None):
        if getattr(self, "_should_skip_synchronize", False):
            if (not getattr(self, "_synchronized", False)
                    or self._gradients_pending()
                    or any(self._passes.values())):
                raise AssertionError(
                    "optimizer.step() inside skip_synchronize() requires a "
                    "prior optimizer.synchronize() call (with no backward "
                    "pass or partial gradient accumulation in between)")
            self._synchronized = False
            return super(self.__class__, self).step(closure)
        if basics.size() > 1:
            # The force-allreduce: synchronize issues every bucket whose
            # hooks did not all fire (reference :397-408).
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, set_to_none: bool = True):
        if self._gradients_pending():
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(). This is "
                "prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(set_to_none)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average):
    """Wrap a torch optimizer so ``step()`` applies the gradients averaged
    over every rank (reference binding ``:423-433``: a dynamic subclass
    of the optimizer's own class, built over its param groups)."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    cls._hvd_wrapped = True   # lets state-fill paths reach the base step
    return cls(optimizer.param_groups, named_parameters,
               _compression(compression), backward_passes_per_step, op)


# ---------------------------------------------------------------------------
# Parameter and optimizer-state broadcast (reference binding :436-501)
# ---------------------------------------------------------------------------

def broadcast_parameters(params, root_rank=0):
    """Broadcast a ``state_dict()`` or a ``named_parameters()`` iterable
    from ``root_rank``, in place."""
    items = sorted(params.items()) if isinstance(params, dict) else list(
        params)
    collective.synchronize([collective.broadcast_async_(p.data, root_rank)
                            for _, p in items if torch.is_tensor(p)])


def broadcast_variables(variables, root_rank=0):
    """TF-API-parity alias of :func:`broadcast_parameters` (reference
    ``data.py:230``)."""
    return broadcast_parameters(variables, root_rank=root_rank)


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Broadcast an optimizer's state (momenta, step counters, param
    groups) from ``root_rank``.  A rank whose state is empty first fills
    it with one LOCAL step on zero gradients (never the wrapped
    optimizer's step, which would issue collectives on this rank alone);
    the tensors then ride the wire in place and everything else rides
    one pickled broadcast."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()
    if not state_dict.get("state"):
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        if getattr(type(optimizer), "_hvd_wrapped", False):
            type(optimizer).__mro__[1].step(optimizer)
        else:
            optimizer.step()
        state_dict = optimizer.state_dict()

    tensors = {}
    meta = {"param_groups": state_dict["param_groups"], "state_scalars": {}}
    for pid, pstate in state_dict.get("state", {}).items():
        for key, value in pstate.items():
            if torch.is_tensor(value):
                tensors[f"{pid}.{key}"] = value
            else:
                meta["state_scalars"][f"{pid}.{key}"] = value

    meta = collective.broadcast_object(meta, root_rank=root_rank)
    collective.synchronize([collective.broadcast_async_(tensors[name],
                                                        root_rank)
                            for name in sorted(tensors)])

    if basics.rank() != root_rank:
        state_dict["param_groups"] = meta["param_groups"]
        for flat, value in meta["state_scalars"].items():
            pid, key = flat.split(".", 1)
            pid = int(pid) if pid.isdigit() else pid
            state_dict["state"].setdefault(pid, {})[key] = value
        optimizer.load_state_dict(state_dict)


# ---------------------------------------------------------------------------
# DistributedGradientTape and make_training_step (reference data.py)
# ---------------------------------------------------------------------------

def _allreduce_grads(grads, compression, op, process_set=None):
    """Reduce a list, tuple or dict of gradient tensors as one group."""
    if isinstance(grads, dict):
        keys = list(grads)
        out = collective.grouped_allreduce(
            [grads[k] for k in keys], op=op, compression=compression,
            process_set=process_set)
        return dict(zip(keys, out))
    out = collective.grouped_allreduce(list(grads), op=op,
                                       compression=compression,
                                       process_set=process_set)
    return type(grads)(out) if isinstance(grads, tuple) else out


def DistributedGradientTape(grad_fn: Callable, *,
                            compression=Compression.none, op=Average,
                            has_value: Optional[bool] = None,
                            process_set=None) -> Callable:
    """Wrap a callable that returns gradients so they come back averaged
    over every rank (reference ``data.py:178``).  ``grad_fn`` returns a
    list, tuple or dict of tensors, or ``(value, grads)``; ``has_value``
    says which, and when unset a 2-tuple whose first element is a 0-dim
    tensor is taken as ``(value, grads)``."""
    compression = _compression(compression)

    @functools.wraps(grad_fn)
    def wrapped(*args, **kwargs):
        out = grad_fn(*args, **kwargs)
        is_pair = (has_value if has_value is not None
                   else isinstance(out, tuple) and len(out) == 2
                   and torch.is_tensor(out[0]) and out[0].dim() == 0)
        if is_pair:
            value, grads = out
            return value, _allreduce_grads(grads, compression, op,
                                           process_set)
        return _allreduce_grads(out, compression, op, process_set)

    return wrapped


def make_training_step(loss_fn: Callable, model: torch.nn.Module,
                       optimizer, mesh=None, axis_name=None,
                       compression=Compression.none,
                       shard_optimizer: bool = False):
    """The data-parallel training step (reference ``data.py:256``).

    ``loss_fn(model, batch) -> scalar loss`` on this rank's shard.  The
    returned ``step(batch) -> mean loss`` takes the gradients of every
    parameter that requires one, averages them over ``axis_name``
    (default: the mesh's group), updates the parameters in place and
    runs the step guard (``HOROVOD_STEP_GUARD``, read here once).

    * Plain: the fused all-reduce, in the gradients' own dtype as the
      reference's SPMD step (``DistributedOptimizer`` follows the eager
      plane's numpy promotion), through ``compression``'s per-tensor
      cast, then ``optimizer.step()`` (a ``torch.optim`` optimizer).
    * ``shard_optimizer=True``: the ZeRO-1 update
      (:mod:`horovod_tpu_torch.parallel.zero`) with ``compression`` as
      its wire codec; ``optimizer`` is a functional
      :func:`horovod_tpu_torch.optim.sgd` or ``adam``.  ``step.init()``
      builds the sharded state (the first step does if it was not
      called); ``step.sharded.state`` holds it, ``step.optimizer`` is
      the ``ShardedOptimizer``.
    * A stateful codec (``int8``, ``powersgd``) without
      ``shard_optimizer``: the gradients ride the codec's
      reduce-scatter/all-gather pair with error feedback, then
      ``optimizer.step()``; ``step.init()`` must run first (it builds
      the bucket plan and the codec state, ``step.wire.plan`` and
      ``step.wire.state``).
    """
    group = axis_name if axis_name is not None else data_axis(
        mesh if mesh is not None else basics.mesh())
    params = [p for p in model.parameters() if p.requires_grad]
    policy = resilience.guard_policy()
    if shard_optimizer:
        return _make_sharded_training_step(loss_fn, model, params,
                                           optimizer, group, compression,
                                           policy)
    try:
        codec = compression_mod.resolve_codec(
            None if (isinstance(compression, type) and issubclass(
                compression, compression_mod.NoneCompressor))
            else compression)
    except TypeError:
        codec = None   # a custom Compressor: the per-leaf path below
    if codec is not None and codec.stateful:
        return _make_compressed_training_step(loss_fn, model, params,
                                              optimizer, group, codec,
                                              policy)
    compression = _compression(compression)

    def step(batch):
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)

        def do_update():
            wires, ctxs = zip(*[compression.compress(g) for g in grads])
            mean = fused_psum(list(wires), group, mean=True)
            for p, g, ctx in zip(params, mean, ctxs):
                p.grad = compression.decompress(g, ctx)
            optimizer.step()
            for p in params:
                p.grad = None

        return resilience.apply_step_guard(
            do_update, loss=loss.detach(), grads=grads, group=group,
            policy=policy)

    return step


def _make_sharded_training_step(loss_fn, model, params, optimizer, group,
                                compression, policy):
    """The ZeRO-1 variant of :func:`make_training_step`."""
    from horovod_tpu_torch.parallel import zero
    zopt = zero.sharded_optimizer(optimizer, group, compression=compression)
    sharded = zero.ShardedUpdate(zopt, params)

    def step(batch):
        if faults.drop_residual():
            sharded.state = _drop_residuals(sharded.state)
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        return resilience.apply_step_guard(
            lambda: sharded.update(grads), loss=loss.detach(), grads=grads,
            group=group, policy=policy)

    step.init = sharded.init
    step.optimizer = zopt
    step.sharded = sharded
    return step


def _drop_residuals(opt_state):
    """Every error-feedback residual inside an optimizer state zeroed: a
    ``ZeroShardedState``'s codec state or a bare ``CodecState``, the
    state of the compressed replicated step (reference ``data.py:391``,
    the payload of the chaos layer's ``residual_drop``)."""
    from horovod_tpu_torch.parallel import zero
    if isinstance(opt_state, compression_mod.CodecState):
        return compression_mod.zero_residuals(opt_state)
    if zero.is_zero_state(opt_state) and opt_state.wire is not None:
        return dataclasses.replace(
            opt_state, wire=compression_mod.zero_residuals(opt_state.wire))
    return opt_state


def _make_compressed_training_step(loss_fn, model, params, optimizer, group,
                                   codec, policy):
    """The stateful-codec (int8, powersgd) variant of
    :func:`make_training_step` on the replicated-update path: the
    gradients ride :func:`~horovod_tpu_torch.ops.compression.
    compressed_allreduce`, the bucket plan and the rank's error-feedback
    residuals in ``step.wire``."""
    import types
    wire = types.SimpleNamespace(plan=None, state=None)

    def init(tree=None):
        leaves = params if tree is None else list(tree)
        wire.plan = fusion.make_reduce_scatter_plan(
            leaves, torch.distributed.get_world_size(group), codec=codec)
        wire.state = codec.init_state(wire.plan, leaves[0].device)
        return wire.state

    def do_update(grads):
        mean, wire.state = compression_mod.compressed_allreduce(
            list(grads), group, codec, plan=wire.plan, state=wire.state,
            mean=True)
        for p, g in zip(params, mean):
            p.grad = g
        optimizer.step()
        for p in params:
            p.grad = None

    def step(batch):
        if wire.plan is None:
            raise RuntimeError(
                "call step.init(params) before the first step: the "
                "compressed wire's bucket plan is derived from the "
                "parameter tree at init")
        if faults.drop_residual():
            wire.state = _drop_residuals(wire.state)
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        return resilience.apply_step_guard(
            lambda: do_update(grads), loss=loss.detach(), grads=grads,
            group=group, policy=policy)

    step.init = init
    step.codec = codec
    step.wire = wire
    return step


# ---------------------------------------------------------------------------
# Elastic world-size-change continuity (reference :490-573)
# ---------------------------------------------------------------------------

ELASTIC_BATCH_POLICY_VAR = "HOROVOD_ELASTIC_BATCH_POLICY"
ELASTIC_BATCH_POLICIES = ("lr_scale", "accumulate")
_ELASTIC_PREV_SIZE_VAR = "HOROVOD_ELASTIC_PREV_SIZE"


def elastic_shard(num_items: int, global_step: int, world_size: int,
                  rank: int, seed: int = 0) -> np.ndarray:
    """This rank's items of ``[0, num_items)`` after a world-size change:
    the strided slice ``rank::world_size`` of one permutation seeded from
    ``(global_step, world_size, seed)``, numpy's ``RandomState`` as the
    reference draws it, so every rank (and the reference) derives the
    same assignment without any exchange."""
    if world_size < 1:
        raise ValueError(f"world_size={world_size} must be >= 1")
    if not 0 <= rank < world_size:
        raise ValueError(
            f"rank={rank} out of range for world_size={world_size}")
    mix = (int(global_step) * 1000003 + int(world_size) * 7919
           + int(seed)) % (2 ** 32)
    perm = np.random.RandomState(mix).permutation(int(num_items))
    return perm[rank::world_size]


def elastic_continuity(prev_size: int, new_size: int,
                       policy: Optional[str] = None):
    """``(lr_scale, accum_steps)`` for a world of ``new_size`` that was
    ``prev_size``.  ``lr_scale`` (the default, or
    ``HOROVOD_ELASTIC_BATCH_POLICY``) keeps the per-rank batch and scales
    the learning rate by ``new/prev``; ``accumulate`` keeps the global
    batch with ``ceil(prev/new)`` micro-steps an update, the returned
    scale carrying the overshoot when ``prev`` is not a multiple of
    ``new``.  A world that grew always rescales."""
    if prev_size < 1 or new_size < 1:
        raise ValueError(
            f"sizes must be >= 1 (prev={prev_size}, new={new_size})")
    if policy is None:
        policy = ((config.env_str(ELASTIC_BATCH_POLICY_VAR) or "")
                  .strip().lower() or "lr_scale")
    if policy not in ELASTIC_BATCH_POLICIES:
        raise ValueError(
            f"{ELASTIC_BATCH_POLICY_VAR}={policy!r}: expected one of "
            f"{', '.join(ELASTIC_BATCH_POLICIES)}")
    if policy == "lr_scale" or new_size >= prev_size:
        return float(new_size) / float(prev_size), 1
    accum = -(-prev_size // new_size)  # ceil
    return float(new_size * accum) / float(prev_size), accum


def elastic_transition(new_size: Optional[int] = None,
                       policy: Optional[str] = None):
    """``(prev_size, lr_scale, accum_steps)`` from the previous attempt's
    world size (``HOROVOD_ELASTIC_PREV_SIZE``); ``(new_size, 1.0, 1)`` on
    a first launch or when the size did not change.  ``new_size``
    defaults to ``hvd.size()``."""
    if new_size is None:
        new_size = basics.size()
    raw = (config.env_raw(_ELASTIC_PREV_SIZE_VAR) or "").strip()
    if not raw:
        return new_size, 1.0, 1
    try:
        prev = int(raw)
    except ValueError:
        raise ValueError(
            f"{_ELASTIC_PREV_SIZE_VAR}={raw!r} is not an integer")
    if prev < 1 or prev == new_size:
        return new_size, 1.0, 1
    lr_scale, accum = elastic_continuity(prev, new_size, policy)
    return prev, lr_scale, accum
