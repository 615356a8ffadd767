"""Pipeline parallelism: GPipe, 1F1B and their interleaved forms.

Counterpart of ``horovod_tpu/parallel/pipeline.py``: ``pipeline_apply``
(``:28``), ``stack_stage_params`` (``:88``),
``pipeline_apply_interleaved`` (``:95``), ``pipeline_1f1b`` (``:182``)
with ``_1f1b_setup``/``_1f1b_finalize`` (``:285-327``),
``pipeline_1f1b_interleaved`` (``:330``) and ``make_pipeline_1f1b_loss``
(``:485``).

The axis is the pipe axis's process group (``mesh.axis("pipe")``; None
is the default group) or a :class:`~horovod_tpu_torch.parallel.sequence.
VirtualRank`, whose ranks are threads of this process on one device.
``stage_params`` is this rank's share of the stacked stage pytree, as
``shard_map`` hands it to a device in the reference: leaves with a
leading dim of 1 (one stage) or ``virtual`` (the interleaved chunks).
``microbatches`` ``[M, mb, ...]`` are the same on every rank; stage 0
feeds them in.

The schedules are the reference's, tick for tick: at tick ``s`` device
``p`` runs forward unit ``u = s - p`` (chunk ``(u // P) % v`` of
microbatch ``(u // (P·v))·P + u % P``), and one hop along the ring after
each sub-step carries activations to rank+1 and cotangents to rank-1.
A hop sends only what the schedule needs (no stage runs on a microbatch
its wavefront has not reached, and nothing is sent that the receiver
would mask away), so the values are the reference's.

The reference differentiates through ``lax.ppermute``.  Here every
backward is run explicitly, unit by unit, with ``torch.autograd.grad`` on
the cotangent that arrived, so process groups and virtual ranks take the
same code, and no autograd node ever waits on a peer (autograd runs every
CUDA node of every thread on the device's one thread, where such a wait
would deadlock the virtual ranks).  :func:`pipeline_apply` and
:func:`pipeline_apply_interleaved` are differentiable by an outer
backward too, through an autograd Function whose backward is that
explicit reverse schedule: use it with process groups, or with virtual
ranks on the CPU.  :func:`pipeline_1f1b` and
:func:`pipeline_1f1b_interleaved` return their gradients, and
:func:`make_pipeline_1f1b_loss` replays them to an outer backward that
exchanges nothing; :func:`make_pipeline_loss` does so under any of the
four schedules.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from horovod_tpu_torch.parallel.sequence import (VirtualRank, _global,
                                                 axis_index, axis_size)

PIPELINE_SCHEDULES = ("gpipe", "1f1b", "interleaved", "interleaved_1f1b")

# gloo tags of the two hop directions.
_FWD_TAG, _BWD_TAG = 0, 1


# ---------------------------------------------------------------------------
# The exchanges
# ---------------------------------------------------------------------------

def _ready(axis, device) -> None:
    """One all-reduce over the axis before a schedule's first hop: NCCL
    wants every rank of a group in its first batched P2P call, and the
    first hop involves two."""
    if not isinstance(axis, VirtualRank) and axis_size(axis) > 1:
        dist.all_reduce(torch.zeros(1, device=device), group=axis)


def _hop(axis, value: Optional[torch.Tensor], expect: bool,
         like: torch.Tensor, reverse: bool = False,
         tag: int = _FWD_TAG) -> Optional[torch.Tensor]:
    """One step along the ring: send ``value`` (None: nothing) to rank+1
    (rank-1 if ``reverse``) and, if ``expect``, receive rank-1's (rank+1's)
    into a tensor shaped like ``like``.  Every rank of the axis calls it at
    the same point of the schedule; what one rank sends, its neighbour
    expects."""
    n = axis_size(axis)
    if n == 1:
        return value if expect else None
    i = axis_index(axis)
    src = (i + 1) % n if reverse else (i - 1) % n
    dst = (i - 1) % n if reverse else (i + 1) % n
    if isinstance(axis, VirtualRank):
        got = axis.axis.exchange(i, value)[src]
        if expect and got is None:
            raise RuntimeError(f"pipeline schedule: rank {i} expected a "
                               f"tensor from rank {src}, which sent none")
        return got if expect else None
    ops, buf = [], None
    if value is not None:
        ops.append(dist.P2POp(dist.isend, value.contiguous(),
                              _global(axis, dst), axis, tag))
    if expect:
        buf = torch.empty_like(like)
        ops.append(dist.P2POp(dist.irecv, buf, _global(axis, src), axis,
                              tag))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return buf


def _from_rank(x: torch.Tensor, axis, root: int) -> torch.Tensor:
    """Rank ``root``'s ``x`` on every rank of the axis: the reference's
    masked ``psum``, in which every other rank adds zeros, so the value is
    ``root``'s exactly.  Every rank passes a tensor of the same shape."""
    if axis_size(axis) == 1:
        return x
    if isinstance(axis, VirtualRank):
        got = axis.axis.exchange(axis.index, x)[root]
        return got if axis.index == root else got.clone()
    x = x.contiguous()
    dist.broadcast(x, _global(axis, root), group=axis)
    return x


def _output_cotangent(d_outputs: torch.Tensor, axis) -> torch.Tensor:
    """The cotangent the last stage takes for the broadcast outputs.  Every
    rank computed the same loss from the same broadcast outputs, so the
    last stage's own cotangent is the whole one: it is taken once, not
    summed over the P ranks (which would scale every gradient by P)."""
    return d_outputs


# ---------------------------------------------------------------------------
# Stage parameters
# ---------------------------------------------------------------------------

def stack_stage_params(per_stage_params):
    """Stack a list of per-stage pytrees into leading-dim-stacked leaves
    (rank p takes row p, or rows ``[p·v, (p+1)·v)`` interleaved).  Dicts
    pair by key, lists and tuples by position, as ``jax.tree_map``
    pairs them."""
    first = per_stage_params[0]
    if isinstance(first, Mapping):
        return {k: stack_stage_params([t[k] for t in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(
            stack_stage_params([t[i] for t in per_stage_params])
            for i in range(len(first)))
    return torch.stack(list(per_stage_params))


class _Params:
    """``stage_params`` as the schedules use it: the leaves, detached, one
    set per chunk (``l[k:k+1]`` of each leaf when interleaved), so the
    gradients of each chunk accumulate apart; :meth:`grads` joins them
    back into the leaves' layout."""

    def __init__(self, stage_params, virtual: int, interleaved: bool):
        leaves, self.spec = pytree.tree_flatten(stage_params)
        if interleaved:
            views = [[l[k:k + 1] for l in leaves] for k in range(virtual)]
        else:
            views = [leaves]
        self.interleaved = interleaved
        self.leaves = [[v.detach().requires_grad_() for v in chunk]
                       for chunk in views]
        self.acc: List[List[Optional[torch.Tensor]]] = [
            [None] * len(leaves) for _ in views]

    def tree(self, k: int):
        return pytree.tree_unflatten(self.leaves[k], self.spec)

    def add(self, k: int, grads: Sequence[Optional[torch.Tensor]]) -> None:
        acc = self.acc[k]
        for j, g in enumerate(grads):
            if g is not None:
                acc[j] = g if acc[j] is None else acc[j] + g

    def grads(self, scale: Optional[float] = None) -> list:
        """The accumulated gradients in the leaves' layout (zeros where a
        chunk got none), times ``scale`` in the leaf's dtype."""
        out = []
        for j in range(len(self.acc[0])):
            parts = [a[j] if a[j] is not None else
                     torch.zeros_like(self.leaves[k][j])
                     for k, a in enumerate(self.acc)]
            g = torch.cat(parts, 0) if self.interleaved else parts[0]
            out.append(g if scale is None else (g * scale).to(g.dtype))
        return out


def _aux_leaves(aux):
    leaves, spec = pytree.tree_flatten(aux)
    return [l.detach().requires_grad_() for l in leaves], spec


# ---------------------------------------------------------------------------
# GPipe and its interleaved form
# ---------------------------------------------------------------------------

def _unit(s: int, idx: int, size: int, virtual: int, m: int):
    """Device ``idx``'s forward unit at tick ``s`` (reference ``:153-156``):
    ``(chunk, microbatch)``, or None before its wavefront arrives and
    after its last unit."""
    u = s - idx
    if u < 0 or u >= virtual * m:
        return None
    return (u // size) % virtual, (u // (size * virtual)) * size + u % size


class _Place:
    """This rank's place on the pipe: its index, the axis size, the chunks
    a rank; chunk k here is global stage ``k·P + idx``."""

    def __init__(self, axis, virtual: int):
        self.axis, self.virtual = axis, virtual
        self.size, self.idx = axis_size(axis), axis_index(axis)

    def first(self, k: int) -> bool:
        return self.idx == 0 and k == 0

    def last(self, k: int) -> bool:
        return self.idx == self.size - 1 and k == self.virtual - 1


def _check_interleaved(stage_params, m: int, size: int, virtual: int):
    """The reference's guards of the interleaved forward (``:134-141``)."""
    leads = {l.shape[0] for l in pytree.tree_leaves(stage_params)}
    if leads != {virtual}:
        raise ValueError(
            f"interleaved stage_params leaves must have leading dim "
            f"virtual={virtual}; got {sorted(leads)} — stack with "
            f"stack_layer_params_interleaved(params, pipe_size, virtual)")
    if m % size:
        raise ValueError(
            f"interleaved schedule needs n_microbatches ({m}) divisible "
            f"by the pipe axis size ({size})")


class _Run(_Place):
    """A forward pass kept for its backward: each unit's input and output
    with its graph, by tick."""

    def __init__(self, axis, params: _Params, microbatches, virtual):
        super().__init__(axis, virtual)
        self.params = params
        self.m = microbatches.shape[0]
        self.ticks = virtual * self.m + self.size - 1
        self.like = microbatches[0]
        self.units: dict = {}


def _pipeline_fwd(stage_fn, params: _Params, microbatches, axis,
                  virtual: int, keep: bool):
    """The forward schedule of ``virtual * M + P - 1`` ticks; returns the
    last stage's outputs ``[M, mb, ...]`` on every rank and, if ``keep``,
    the :class:`_Run` for :func:`_pipeline_bwd`."""
    run = _Run(axis, params, microbatches, virtual)
    _ready(axis, microbatches.device)
    outputs = torch.zeros_like(microbatches)
    incoming = None
    for s in range(run.ticks):
        unit = _unit(s, run.idx, run.size, virtual, run.m)
        send = None
        if unit is not None:
            k, mb = unit
            x = microbatches[mb] if run.first(k) else incoming
            x = x.detach().requires_grad_(keep)
            with torch.set_grad_enabled(keep):
                y = stage_fn(params.tree(k), x)
            if run.last(k):
                outputs[mb] = y.detach()
            else:
                send = y
            if keep:
                run.units[s] = (k, mb, x, y)
        nxt = _unit(s + 1, run.idx, run.size, virtual, run.m)
        incoming = _hop(axis, send, nxt is not None and not run.first(nxt[0]),
                        run.like, tag=_FWD_TAG)
    return _from_rank(outputs, axis, run.size - 1), (run if keep else None)


def _pipeline_bwd(run: _Run, d_outputs: torch.Tensor) -> torch.Tensor:
    """The reverse schedule: the units of the forward in reverse tick
    order, each ``torch.autograd.grad`` of its output on the cotangent
    from rank+1 (the last stage: its own cotangent of the outputs),
    its dx sent to rank-1.  Accumulates the stage gradients into
    ``run.params``; returns ``d_microbatches`` on every rank (stage 0's)."""
    axis, params = run.axis, run.params
    d_own = _output_cotangent(d_outputs, axis)
    d_mb = run.like.new_zeros((run.m,) + tuple(run.like.shape))
    incoming = None
    for s in reversed(range(run.ticks)):
        entry = run.units.pop(s, None)
        send = None
        if entry is not None:
            k, mb, x, y = entry
            dy = d_own[mb] if run.last(k) else incoming
            *g, dx = torch.autograd.grad(y, params.leaves[k] + [x], dy,
                                         allow_unused=True)
            params.add(k, g)
            if run.first(k):
                d_mb[mb] = dx
            else:
                send = dx
        prev = _unit(s - 1, run.idx, run.size, run.virtual, run.m)
        incoming = _hop(axis, send, prev is not None and not run.last(prev[0]),
                        run.like, reverse=True, tag=_BWD_TAG)
    return _from_rank(d_mb, axis, 0)


class _PipelineApply(torch.autograd.Function):
    """The GPipe schedule as one autograd node: its backward is
    :func:`_pipeline_bwd`."""

    @staticmethod
    def forward(ctx, plan, microbatches, *leaves):
        stage_fn, spec, axis, virtual, interleaved = plan
        params = _Params(pytree.tree_unflatten(list(leaves), spec), virtual,
                         interleaved)
        with torch.enable_grad():
            out, run = _pipeline_fwd(stage_fn, params, microbatches, axis,
                                     virtual, keep=True)
        ctx.run = run
        return out

    @staticmethod
    def backward(ctx, d_outputs):
        run, ctx.run = ctx.run, None
        d_mb = _pipeline_bwd(run, d_outputs)
        return (None, d_mb, *run.params.grads())


def _apply(stage_fn, stage_params, microbatches, axis, virtual,
           interleaved):
    leaves, spec = pytree.tree_flatten(stage_params)
    if torch.is_grad_enabled() and (microbatches.requires_grad or
                                    any(l.requires_grad for l in leaves)):
        return _PipelineApply.apply(
            (stage_fn, spec, axis, virtual, interleaved), microbatches,
            *leaves)
    params = _Params(stage_params, virtual, interleaved)
    return _pipeline_fwd(stage_fn, params, microbatches, axis, virtual,
                         keep=False)[0]


def pipeline_apply(stage_fn: Callable, stage_params, microbatches,
                   axis_name=None) -> torch.Tensor:
    """Run ``stage_fn(params_slice, x) -> y`` as a GPipe pipeline over
    ``axis_name``: ``M + P - 1`` ticks, stage ``s`` on microbatch
    ``t - s`` at tick ``t``.

    ``stage_fn`` must map activations of shape ``[mb, ...]`` to the same
    shape (uniform stages).  Returns ``[M, mb, ...]``: the last stage's
    outputs for every microbatch, on every rank (broadcast from the last
    stage).  Differentiable: the backward hands the last stage its own
    cotangent of the outputs (every rank computed the same loss from
    them), runs the reverse schedule and gives every rank stage 0's
    ``d_microbatches``.
    """
    return _apply(stage_fn, stage_params, microbatches, axis_name, 1, False)


def pipeline_apply_interleaved(stage_fn: Callable, stage_params,
                               microbatches, axis_name=None,
                               virtual: int = 2) -> torch.Tensor:
    """Interleaved (virtual-stage) pipeline forward, Megatron's
    round-robin placement as one lockstep schedule of ``v·M + P - 1``
    ticks (reference ``:95``).

    Device p holds the ``virtual`` chunks with global stage ids
    ``{k·P + p : k < v}`` (leaves ``[v, ...]``, row k = global chunk
    ``k·P + p``; stack with ``models.transformer.
    stack_layer_params_interleaved``).
    At tick s device p runs unit ``u = s − p`` (``0 ≤ u < v·M``): chunk
    ``(u // P) mod v`` of microbatch ``(u // (P·v))·P + u mod P``, so the
    fill is ``P − 1`` ticks of a 1/v-size chunk.  Requires
    ``M % P == 0``.  Returns ``[M, mb, ...]``: the last chunk's outputs on
    every rank; differentiable as :func:`pipeline_apply`.
    """
    _check_interleaved(stage_params, microbatches.shape[0],
                       axis_size(axis_name), virtual)
    return _apply(stage_fn, stage_params, microbatches, axis_name, virtual,
                  True)


# ---------------------------------------------------------------------------
# 1F1B and its interleaved form
# ---------------------------------------------------------------------------

class _OneFOneB(_Place):
    """The state of a 1F1B run (reference ``_1f1b_setup``, ``:285``): the
    stage and aux leaves, the ring of saved stage inputs, the aux
    gradients, ``d_microbatches`` (f32) and the loss accumulator."""

    def __init__(self, axis, stage_params, aux, microbatches, targets,
                 virtual: int, interleaved: bool, nbuf: int):
        super().__init__(axis, virtual)
        self.m = microbatches.shape[0]
        self.microbatches, self.targets = microbatches, targets
        self.params = _Params(stage_params, virtual, interleaved)
        self.aux_leaves, self.aux_spec = _aux_leaves(aux)
        self.g_aux: List[Optional[torch.Tensor]] = [None] * len(
            self.aux_leaves)
        self.buf: List[Optional[torch.Tensor]] = [None] * nbuf
        self.d_mb = torch.zeros(microbatches.shape, dtype=torch.float32,
                                device=microbatches.device)
        self.loss_acc = torch.zeros((), dtype=torch.float32,
                                    device=microbatches.device)
        self.fwd_in = self.bwd_in = None
        _ready(axis, microbatches.device)

    def forward(self, stage_fn, unit, slot: int, expect: bool) -> None:
        """One forward sub-step: feed or take the arrived activation, save
        it in ``slot``, run the chunk without a graph (its backward
        recomputes it) and hop it to rank+1."""
        send = None
        if unit is not None:
            k, mb = unit
            x = self.microbatches[mb] if self.first(k) else self.fwd_in
            self.buf[slot] = x.detach()
            if not self.last(k):
                with torch.no_grad():
                    send = stage_fn(self.params.tree(k), x)
        self.fwd_in = _hop(self.axis, send, expect, self.microbatches[0],
                           tag=_FWD_TAG)

    def backward(self, stage_fn, loss_fn, unit, slot: int,
                 expect: bool) -> None:
        """One backward sub-step: recompute the chunk from its saved input
        and pull the cotangent back through it (at the last stage the
        loss's, else the one from rank+1); dx goes to rank-1, or into
        ``d_microbatches`` at stage 0."""
        send = None
        if unit is not None:
            k, mb = unit
            x = self.buf[slot].requires_grad_()
            self.buf[slot] = None
            leaves = self.params.leaves[k]
            with torch.enable_grad():
                y = stage_fn(self.params.tree(k), x)
                if self.last(k):
                    aux = pytree.tree_unflatten(self.aux_leaves,
                                                self.aux_spec)
                    loss = loss_fn(y, self.targets[mb], aux)
                    g = torch.autograd.grad(
                        loss, leaves + [x] + self.aux_leaves,
                        allow_unused=True)
                    n = len(leaves) + 1
                    for j, ga in enumerate(g[n:]):
                        if ga is not None:
                            self.g_aux[j] = (ga if self.g_aux[j] is None
                                             else self.g_aux[j] + ga)
                    self.loss_acc = self.loss_acc + loss.detach().float()
                    g = g[:n]
                else:
                    g = torch.autograd.grad(y, leaves + [x], self.bwd_in,
                                            allow_unused=True)
            self.params.add(k, g[:-1])
            if self.first(k):
                self.d_mb[mb] = g[-1].float()
            else:
                send = g[-1]
        self.bwd_in = _hop(self.axis, send, expect, self.microbatches[0],
                           reverse=True, tag=_BWD_TAG)

    def finalize(self):
        """Reference ``_1f1b_finalize`` (``:311``): the mean over
        microbatches; the loss and aux gradients from the last stage and
        ``d_microbatches`` from stage 0 on every rank; the stage
        gradients stay with their rank."""
        inv_m = 1.0 / self.m
        last = self.size - 1
        loss = _from_rank(self.loss_acc * inv_m, self.axis, last)
        g_aux = [_from_rank((g if g is not None else torch.zeros_like(l))
                            * inv_m, self.axis, last)
                 for g, l in zip(self.g_aux, self.aux_leaves)]
        d_mb = _from_rank(self.d_mb * inv_m, self.axis, 0).to(
            self.microbatches.dtype)
        return (loss,
                pytree.tree_unflatten(self.params.grads(inv_m),
                                      self.params.spec),
                pytree.tree_unflatten(g_aux, self.aux_spec), d_mb)


def pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, stage_params, aux,
                  microbatches, targets, axis_name=None):
    """One-forward-one-backward (1F1B) pipeline schedule (reference
    ``:182``): ``M + 2(P - 1)`` ticks, each one forward sub-step (stage p
    on microbatch ``t - p``) and one backward sub-step (microbatch
    ``t - 2(P-1) + p``; the last stage backwards the microbatch it just
    forwarded, seeding from the loss).  Only stage inputs are saved, in a
    ring of ``2P`` slots, and the stage forward is recomputed inside the
    backward, so peak activation state is O(P) microbatches, not O(M).

    ``stage_fn(stage_params, x) -> y`` with ``y.shape == x.shape``;
    ``loss_fn(y, target_mb, aux) -> scalar`` at the last stage.  Returns
    ``(loss, stage_grads, aux_grads, d_microbatches)``: the mean
    microbatch loss and its exact gradients, each scaled by ``1/M``; the
    loss, aux gradients and ``d_microbatches`` on every rank.
    """
    size = axis_size(axis_name)
    m = microbatches.shape[0]
    nbuf = 2 * size    # in-flight saved inputs <= 2(P-1)+1 < 2P
    st = _OneFOneB(axis_name, stage_params, aux, microbatches, targets, 1,
                   False, nbuf)
    idx = st.idx

    def unit(u):
        return (0, u) if 0 <= u < m else None

    for t in range(m + 2 * (size - 1)):
        mf = t - idx
        st.forward(stage_fn, unit(mf), max(mf, 0) % nbuf,
                   expect=idx > 0 and unit(mf + 1) is not None)
        mbk = t - 2 * (size - 1) + idx
        st.backward(stage_fn, loss_fn, unit(mbk), max(mbk, 0) % nbuf,
                    expect=idx < size - 1 and unit(mbk + 1) is not None)
    return st.finalize()


def pipeline_1f1b_interleaved(stage_fn: Callable, loss_fn: Callable,
                              stage_params, aux, microbatches, targets,
                              axis_name=None, virtual: int = 2):
    """Interleaved (virtual-stage) 1F1B, Megatron's full schedule in three
    phases over round-robin chunks (reference ``:330``).

    Device p holds chunks ``{k·P+p : k < v}`` (leaves ``[v, ...]``).  Fwd
    unit ``uf`` runs at fwd time ``uf + p``, bwd unit ``ub`` at bwd time
    ``ub + (P−1−p)``, with ``(chunk, microbatch) = ((u//P) mod v``
    (reversed for bwd)``, (u//(P·v))·P + u mod P)``:

    * **warmup**: ``v·P`` fwd-only ticks,
    * **steady**: ``v·M − v·P + P − 1`` one-fwd-one-bwd ticks,
    * **drain**: ``v·P`` bwd-only ticks,

    with a ``2vP``-slot ring of saved chunk inputs and the chunk forwards
    recomputed in the backward.  Requires ``M % P == 0`` and ``M >= P``.
    Returns ``(loss, stage_grads [v, ...], aux_grads, d_microbatches)`` as
    :func:`pipeline_1f1b`.
    """
    size = axis_size(axis_name)
    m = microbatches.shape[0]
    v = virtual
    leads = {l.shape[0] for l in pytree.tree_leaves(stage_params)}
    if leads != {v}:
        raise ValueError(
            f"interleaved stage_params leaves must have leading dim "
            f"virtual={v}; got {sorted(leads)}")
    if m % size or m < size:
        raise ValueError(
            f"interleaved 1F1B needs n_microbatches ({m}) divisible by "
            f"and >= the pipe axis size ({size})")
    warmup = v * size                     # fwd-only ticks
    steady = v * m - v * size + size - 1  # 1f1b ticks
    drain = v * size                      # bwd-only ticks
    nbuf = 2 * v * size                   # max fwd->bwd slot gap
    st = _OneFOneB(axis_name, stage_params, aux, microbatches, targets, v,
                   True, nbuf)
    idx = st.idx

    def b_unit(b):
        ub = b - (size - 1 - idx)
        if ub < 0 or ub >= v * m:
            return None
        return (v - 1 - (ub // size) % v,
                (ub // (size * v)) * size + ub % size)

    def fwd(f):
        u, nxt = _unit(f, idx, size, v, m), _unit(f + 1, idx, size, v, m)
        # slot index is p-independent: P(v*(m//P)+k) + m%P == uf
        st.forward(stage_fn, u, max(f - idx, 0) % nbuf,
                   expect=nxt is not None and not st.first(nxt[0]))

    def bwd(b):
        u, nxt = b_unit(b), b_unit(b + 1)
        slot = 0
        if u is not None:
            k_b, mb = u
            slot = (size * (v * (mb // size) + k_b) + mb % size) % nbuf
        st.backward(stage_fn, loss_fn, u, slot,
                    expect=nxt is not None and not st.last(nxt[0]))

    for f in range(warmup):
        fwd(f)
    for j in range(steady):
        fwd(warmup + j)
        bwd(j)
    for b in range(steady, steady + drain):
        bwd(b)
    return st.finalize()


# ---------------------------------------------------------------------------
# The differentiable loss
# ---------------------------------------------------------------------------

def _gpipe_loss(stage_fn, loss_fn, stage_params, aux, microbatches,
                targets, axis, virtual: int = 1):
    """The GPipe (or, ``virtual > 1``, interleaved) forward, ``loss_fn``
    on the broadcast outputs on every rank, and the reverse schedule, all
    at once: ``(loss, stage_grads, aux_grads, d_microbatches)`` as
    :func:`pipeline_1f1b` returns them.  ``loss_fn(outputs [M, mb, ...],
    targets, aux)`` sees every microbatch, as a loss over the forward's
    outputs does."""
    interleaved = virtual > 1
    if interleaved:
        _check_interleaved(stage_params, microbatches.shape[0],
                           axis_size(axis), virtual)
    params = _Params(stage_params, virtual, interleaved)
    aux_leaves, aux_spec = _aux_leaves(aux)
    with torch.enable_grad():
        outputs, run = _pipeline_fwd(stage_fn, params, microbatches, axis,
                                     virtual, keep=True)
        y = outputs.detach().requires_grad_()
        loss = loss_fn(y, targets, pytree.tree_unflatten(aux_leaves,
                                                         aux_spec))
        d_out, *g_aux = torch.autograd.grad(loss, [y] + aux_leaves,
                                            allow_unused=True)
    d_mb = _pipeline_bwd(run, d_out)
    g_aux = [g if g is not None else torch.zeros_like(l)
             for g, l in zip(g_aux, aux_leaves)]
    return (loss.detach(), pytree.tree_unflatten(params.grads(),
                                                 params.spec),
            pytree.tree_unflatten(g_aux, aux_spec), d_mb)


class _Replay(torch.autograd.Function):
    """A loss whose gradients the schedule already computed: the backward
    scales them by the incoming cotangent and exchanges nothing
    (reference ``make_pipeline_1f1b_loss``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, body, n_stage, stage_spec, aux_spec, microbatches,
                targets, *leaves):
        loss, gs, ga, dmb = body(
            pytree.tree_unflatten(list(leaves[:n_stage]), stage_spec),
            pytree.tree_unflatten(list(leaves[n_stage:]), aux_spec),
            microbatches, targets)
        ctx.grads = (dmb, pytree.tree_leaves(gs) + pytree.tree_leaves(ga))
        return loss

    @staticmethod
    def backward(ctx, ct):
        dmb, grads = ctx.grads
        ctx.grads = None
        return (None, None, None, None, dmb * ct, None,
                *(g * ct for g in grads))


def _replayed(body, stage_params, aux, microbatches, targets):
    stage, stage_spec = pytree.tree_flatten(stage_params)
    aux_l, aux_spec = pytree.tree_flatten(aux)
    return _Replay.apply(body, len(stage), stage_spec, aux_spec,
                         microbatches, targets, *stage, *aux_l)


def _resolve(mesh, axis):
    return mesh.axis(axis) if isinstance(axis, str) else axis


def make_pipeline_loss(stage_fn: Callable, loss_fn: Callable, mesh=None,
                       axis_name="pipe", data_axes=(),
                       schedule: str = "1f1b", virtual: int = 1):
    """:func:`make_pipeline_1f1b_loss`'s contract under any of
    :data:`PIPELINE_SCHEDULES`: ``f(stage_params, aux, microbatches,
    targets) -> loss``, whose backward replays the schedule's gradients
    and exchanges nothing.  ``"1f1b"``/``"interleaved_1f1b"`` run
    :func:`pipeline_1f1b`/:func:`pipeline_1f1b_interleaved`, with
    ``loss_fn(outputs, targets, aux)`` on one microbatch at a time;
    ``"gpipe"``/``"interleaved"`` run the forward schedule, ``loss_fn``
    over every microbatch ``[M, mb, ...]`` at once on every rank (what
    the reference's step differentiates through) and the reverse
    schedule.  ``virtual`` counts only under the interleaved schedules.
    """
    from horovod_tpu_torch.ops.fusion import fused_psum

    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"schedule={schedule!r}: expected 'gpipe', "
                         f"'1f1b', 'interleaved' or 'interleaved_1f1b'")
    pipe = _resolve(mesh, axis_name)
    datas = [_resolve(mesh, a) for a in data_axes]
    v = virtual if schedule.startswith("interleaved") else 1

    def run(stage_params, aux, microbatches, targets):
        if schedule in ("gpipe", "interleaved"):
            return _gpipe_loss(stage_fn, loss_fn, stage_params, aux,
                               microbatches, targets, pipe, v)
        if v > 1:
            return pipeline_1f1b_interleaved(
                stage_fn, loss_fn, stage_params, aux, microbatches, targets,
                pipe, v)
        return pipeline_1f1b(stage_fn, loss_fn, stage_params, aux,
                             microbatches, targets, pipe)

    def body(stage_params, aux, microbatches, targets):
        loss, gs, ga, dmb = run(stage_params, aux, microbatches, targets)
        for ax in datas:
            gl, gspec = pytree.tree_flatten(gs)
            al, aspec = pytree.tree_flatten(ga)
            red = fused_psum([loss.reshape(1)] + gl + al, ax, mean=True)
            loss = red[0].reshape(())
            gs = pytree.tree_unflatten(red[1:1 + len(gl)], gspec)
            ga = pytree.tree_unflatten(red[1 + len(gl):], aspec)
            dmb = dmb / dist.get_world_size(ax)
        return loss, gs, ga, dmb

    def f(stage_params, aux, microbatches, targets):
        return _replayed(body, stage_params, aux, microbatches, targets)

    return f


def make_pipeline_1f1b_loss(stage_fn: Callable, loss_fn: Callable,
                            mesh=None, axis_name="pipe", data_axes=(),
                            virtual: int = 1):
    """Differentiable scalar-loss wrapper around :func:`pipeline_1f1b` (or
    :func:`pipeline_1f1b_interleaved` when ``virtual > 1``), reference
    ``:485``.

    Returns ``f(stage_params, aux, microbatches, targets) -> loss``, whose
    backward replays the schedule's exact gradients w.r.t.
    ``stage_params``, ``aux`` and ``microbatches``, so an embedding
    upstream of the pipeline gets its gradient through ordinary autograd
    of ``d_microbatches``; that backward exchanges nothing.  Axes are
    names the ``mesh`` resolves, or the axes themselves (a process group,
    a ``VirtualRank`` for the pipe axis).  ``data_axes`` are averaged over
    (loss and gradients; ``d_microbatches`` divided by the axis size,
    since the global loss is the mean of the per-shard losses).  The
    reference's ``stage_spec``/``mb_spec``/``tgt_spec``/``aux_spec`` place
    shards on a mesh and have no counterpart: a rank passes its own.
    """
    return make_pipeline_loss(
        stage_fn, loss_fn, mesh, axis_name, data_axes,
        "interleaved_1f1b" if virtual > 1 else "1f1b", virtual)
