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
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch

from horovod_tpu_torch import basics, resilience
from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.ops.collective import Average
from horovod_tpu_torch.ops.fusion import (_bucket_leaves, fused_psum,
                                          fusion_threshold_bytes)
from horovod_tpu_torch.topology import data_axis


class Compression:
    """Wire compression for gradients (reference torch binding
    ``:38-60``): cast before the all-reduce, cast back after."""

    class none:
        @staticmethod
        def compress(t):
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t

    class fp16:
        @staticmethod
        def compress(t):
            if t.dtype in (torch.float32, torch.float64):
                return t.half(), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t if ctx is None else t.to(ctx)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to horovod_tpu_torch yet (ROADMAP.md "
        f"Queue 1 item 8)")


def _compression(compression):
    """The Compression class for ``compression``: a class passes through,
    ``"none"``/``"fp16"`` name one; the stateful codecs (``"int8"``,
    ``"powersgd[:r]"``) are not ported."""
    if not isinstance(compression, str):
        return compression
    spec = compression.strip().lower()
    if spec in ("", "none", "fp16"):
        return getattr(Compression, spec or "none")
    if spec == "int8" or spec.startswith("powersgd"):
        raise _not_ported(f"compression={compression!r}")
    raise ValueError(f"unknown compression {compression!r}: expected "
                     f"'none' or 'fp16'")


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
                       optimizer: torch.optim.Optimizer, mesh=None,
                       axis_name=None, compression=Compression.none,
                       shard_optimizer: bool = False):
    """The replicated-update recipe (reference ``data.py:256``).

    ``loss_fn(model, batch) -> scalar loss`` on this rank's shard.  The
    returned ``step(batch) -> mean loss`` takes the gradients of every
    parameter that requires one, averages them with the fused all-reduce
    over ``axis_name`` (default: the mesh's group; in the gradients' own
    dtype, as the reference's SPMD step, where ``DistributedOptimizer``
    follows the eager plane's numpy promotion), applies
    ``optimizer.step()`` and runs the step guard (``HOROVOD_STEP_GUARD``,
    read here once), all in place.  ZeRO (``shard_optimizer=True``) and
    the stateful codecs are not ported.
    """
    if shard_optimizer:
        raise _not_ported("shard_optimizer=True (ZeRO-1)")
    compression = _compression(compression)
    group = axis_name if axis_name is not None else data_axis(
        mesh if mesh is not None else basics.mesh())
    params = [p for p in model.parameters() if p.requires_grad]
    policy = resilience.guard_policy()

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
