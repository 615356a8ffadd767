"""The ``hvd.*`` collectives on ``torch.distributed``.

Counterpart of ``horovod_tpu/ops/collective.py`` and of the torch
binding's wrappers (``horovod_tpu/torch/__init__.py:75-265``).  The JAX
package has two planes: ``lax`` collectives under ``shard_map`` and an
eager plane on its native runtime, which matches requests by name.  This
module is the eager plane: every call submits its tensor by name to the
control plane (:mod:`horovod_tpu_torch.native.runtime`), which
negotiates across ranks, so ranks may issue names in any order, fuses
allreduces and launches them on its own data group (or a process set's),
NCCL when the job runs on the GPU, gloo when the caller asked for the
CPU.  ``join`` lets ranks with fewer batches finish early.  A result
lies on the device of its input and has its dtype.  (The counterpart of
the SPMD plane, ``fusion.fused_psum``, issues straight onto the job's
group in program order and never negotiates.)

Telemetry: every op, at every size, goes through the runtime, whose
wait records it once (``native/runtime.py``); there is no one-rank path
around it here, so nothing is counted twice.  The async handles are
counted in ``hvd_eager_handle_queue_depth``.

The arithmetic is the reference's, whose eager plane computes in numpy.
The prescale is applied before the tensor is submitted; ``Average`` is a
sum, then a divide by the set size, then the postscale.  Scale factors
and the divide run in the dtype numpy gives: integers in float64,
bfloat16 in float32 (ml_dtypes' promotion), other floats in their own
dtype with the factor rounded to it.  The result is cast back to the
input's dtype at the end, as the torch binding casts numpy's result
(float to integer truncates toward zero).  ``Adasum`` is the native
runtime's scaled-projection butterfly (``native/data_plane.py``).
"""

from __future__ import annotations

import math
import pickle
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from horovod_tpu_torch import basics, faults, telemetry
from horovod_tpu_torch.native.data_plane import (  # noqa: F401
    calls, divide, scaled)
from horovod_tpu_torch.native.message import OpType
from horovod_tpu_torch.native.tensor_queue import (  # noqa: F401
    DUPLICATE_NAME_ERROR_FMT, TensorEntry)
from horovod_tpu_torch.ops.fusion import dtype_name
# The SPMD plane's ragged all-to-all (reference ``collective.py:916``) is
# not negotiated by name: it lives with the other exchanges of an axis.
from horovod_tpu_torch.parallel.sequence import alltoall_ragged  # noqa: F401


class ReduceOp:
    def __init__(self, name: str, code: int):
        self.name = name
        self.code = code

    def __repr__(self):
        return f"ReduceOp.{self.name}"


Average = ReduceOp("Average", 0)
Sum = ReduceOp("Sum", 1)
Adasum = ReduceOp("Adasum", 2)
Min = ReduceOp("Min", 3)
Max = ReduceOp("Max", 4)


def _resolve_op(op, average):
    """Reconcile the v0.18 ``average=`` bool with the op enum."""
    if op is not None:
        return op
    if average is None or average:
        return Average
    return Sum


# ---------------------------------------------------------------------------
# Process sets (reference ``collective.py:116-210``).  Registration is
# negotiated over every rank; the runtime then creates the set's group
# (inside a rank-subset job, only its members do).
# ---------------------------------------------------------------------------

class ProcessSet:
    """A registered subset of ranks.  Create it with
    :func:`add_process_set`."""

    def __init__(self, ranks, set_id=None):
        self.ranks = sorted(int(r) for r in ranks)
        self.id = set_id   # None until registered

    def included(self) -> bool:
        return basics.rank() in self.ranks

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        """This process's position within the set (its "set rank")."""
        try:
            return self.ranks.index(basics.rank())
        except ValueError:
            raise RuntimeError(
                f"rank {basics.rank()} is not a member of process set "
                f"{self.ranks}")

    def __repr__(self):
        return f"ProcessSet(ranks={self.ranks}, id={self.id})"


class _GlobalProcessSet(ProcessSet):
    """The implicit set of all ranks (id 0); its size tracks hvd.size()."""

    def __init__(self):
        self.id = 0

    @property
    def ranks(self):
        return list(range(basics.size()))

    def included(self) -> bool:
        return True

    def size(self) -> int:
        return basics.size()

    def rank(self) -> int:
        return basics.rank()


global_process_set = _GlobalProcessSet()


_lock = threading.Lock()
# Auto names count per process set, so a rank outside a set does not fall
# behind the members in the names of later collectives.
_name_counters: Dict[int, int] = {}
_set_registrations = 0


def add_process_set(ranks) -> ProcessSet:
    """Collectively register a process set: EVERY rank of the job calls
    this with the same ranks, in the same order as its other
    registrations (the registration's sequence number is its name, as
    in the reference's ``runtime.py:1163-1183``).  Registering a member
    list again returns a set with its existing id."""
    global _set_registrations
    basics._check_initialized()
    ps = ranks if isinstance(ranks, ProcessSet) else ProcessSet(ranks)
    if ps.id == 0:
        return global_process_set
    n = basics.size()
    if n == 1:
        if ps.ranks != [0]:
            raise ValueError(
                f"process set {ps.ranks} is invalid for a 1-process job")
        ps.id = 0
        return ps
    if (not ps.ranks or len(set(ps.ranks)) != len(ps.ranks)
            or ps.ranks[0] < 0 or ps.ranks[-1] >= n):
        raise ValueError(f"process set {ps.ranks} is invalid for a "
                         f"{n}-process job")
    with _lock:
        _set_registrations += 1
        name = f"hvd.process_set.{_set_registrations}"
    ps.id = _run([TensorEntry(OpType.PROCESS_SET, name, splits=ps.ranks)],
                 "process_set")[0]
    return ps


def _set_args(process_set) -> Tuple[int, List[int]]:
    """(set id, members) of ``process_set``; validates membership as the
    reference's ``_set_args`` (``collective.py:197-210``)."""
    basics._check_initialized()
    if process_set is None or process_set.id == 0:
        return 0, list(range(basics.size()))
    if (process_set.id is None
            or not basics.runtime().has_set(process_set.id)):
        raise ValueError(
            f"process set {process_set.ranks} is not registered; call "
            "hvd.add_process_set(...) on every rank first")
    if not process_set.included():
        raise RuntimeError(
            f"rank {basics.rank()} is not a member of process set "
            f"{process_set.ranks} and cannot submit collectives on it")
    return process_set.id, list(process_set.ranks)


# ---------------------------------------------------------------------------
# Submission and the handles of the async API (reference
# ``collective.py:268-347``): an int handle per call, completed by the
# runtime's entries.
# ---------------------------------------------------------------------------

class _Pending:
    """Submitted entries and the function that turns their raw results
    into the caller's result."""

    def __init__(self, entries: Sequence[TensorEntry], finish):
        self.entries = list(entries)
        self.finish = finish

    def done(self) -> bool:
        return all(e.done() for e in self.entries)

    def result(self):
        return self.finish([e.result() for e in self.entries])


def _submit(entries: Sequence[TensorEntry], kind: str, finish) -> _Pending:
    basics.runtime().submit(entries, kind)
    return _Pending(entries, finish)


def _run(entries: Sequence[TensorEntry], kind: str):
    """Submit and wait: the raw results."""
    return _submit(entries, kind, lambda raws: raws).result()


class _Handle:
    __slots__ = ("id", "name", "pending")

    def __init__(self, hid: int, name: str, pending):
        self.id = hid
        self.name = name
        self.pending = pending


class HandleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._handles: Dict[int, _Handle] = {}
        self._inflight: Dict[str, _Handle] = {}

    def allocate(self, name: str, op_kind: str, start) -> int:
        """Check ``name``, then submit with ``start()`` and file its
        handle."""
        with self._lock:
            other = self._inflight.get(name)
            if other is not None and not other.pending.done():
                raise ValueError(DUPLICATE_NAME_ERROR_FMT % (op_kind, name))
        pending = start()
        with self._lock:
            h = _Handle(self._next, name, pending)
            self._next += 1
            self._handles[h.id] = h
            self._inflight[name] = h
        telemetry.gauge("hvd_eager_handle_queue_depth",
                        "Async eager handles allocated and not yet "
                        "completed").inc()
        return h.id

    def get(self, hid) -> _Handle:
        with self._lock:
            h = self._handles.get(hid)
        if h is None:
            raise ValueError(
                f"Handle {hid} was not created or has been cleared")
        return h

    def clear(self, h: _Handle) -> None:
        with self._lock:
            if self._handles.pop(h.id, None) is None:
                return
            if self._inflight.get(h.name) is h:
                del self._inflight[h.name]
        telemetry.gauge("hvd_eager_handle_queue_depth",
                        "Async eager handles allocated and not yet "
                        "completed").dec()


_handles = HandleManager()


def _auto_name(kind: str, name: Optional[str], set_id: int = 0) -> str:
    if name is not None:
        return name
    with _lock:
        n = _name_counters.get(set_id, 0)
        _name_counters[set_id] = n + 1
    return f"{kind}.noname.{n}" if set_id == 0 else (
        f"{kind}.noname.{set_id}.{n}")


def poll(handle) -> bool:
    """True when the async op behind ``handle`` has completed."""
    return _handles.get(handle).pending.done()


def synchronize(handle):
    """Wait for an async op and return its result; a list or tuple of
    handles gives the list of their results."""
    if isinstance(handle, (list, tuple)):
        return [synchronize(h) for h in handle]
    h = _handles.get(handle)
    try:
        return h.pending.result()
    finally:
        _handles.clear(h)


def _reset() -> None:
    """Forget names and handles: they die with the job's runtime."""
    global _handles, _set_registrations
    with _lock:
        _name_counters.clear()
        _set_registrations = 0
    _handles = HandleManager()


basics.on_shutdown(_reset)


# ---------------------------------------------------------------------------
# The ops: each builds its entries and the function that finishes them
# ---------------------------------------------------------------------------

def _local_checks() -> bool:
    """Shape and root checks run here only in a job of one process, as
    the reference checks only where it has no runtime; in a larger job
    the op is submitted and the coordinator answers every rank with the
    same error in the same cycle (``native/controller.py``), so a bad
    input on one rank never leaves its peers waiting on a name."""
    return basics.size() == 1


def _back(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The result in the caller's dtype (float64 -> int truncates toward
    zero, as the torch binding's cast) and on the caller's device."""
    return r.to(device=like.device, dtype=like.dtype)


def _into(tensor: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        tensor.copy_(r)
    return tensor


def _check_adasum_dtype(t: torch.Tensor) -> None:
    if not t.is_floating_point():
        raise NotImplementedError(
            f"Adasum is defined for floating-point tensors only "
            f"(got dtype {dtype_name(t.dtype)})")


def _allreduce_entry(tensor, op, name, prescale, set_id) -> TensorEntry:
    """The reference's caller scales before it submits, so the wire
    dtype is the scaled tensor's."""
    if op is Adasum:
        _check_adasum_dtype(tensor)
    return TensorEntry(OpType.ALLREDUCE, name, scaled(tensor, prescale),
                       arg=op.code, set_id=set_id)


def _poisoned(site: str, r: torch.Tensor, name: str) -> torch.Tensor:
    """The result through the fault hook (``HOROVOD_FAULT_SPEC``'s value
    kinds); itself when no spec is set."""
    return faults.corrupt_output(site, r, name, basics.rank())


def _allreduce_result(raw, tensor, op, postscale, n, name) -> torch.Tensor:
    r = divide(raw, n) if op is Average else raw
    return _poisoned("allreduce", _back(scaled(r, postscale), tensor), name)


def _allreduces(tensors, names, op, prescale, postscale, set_id, n,
                pick) -> _Pending:
    """Every tensor under its name, submitted together (the runtime fuses
    them); ``pick`` turns the list of results into the caller's."""
    entries = [_allreduce_entry(t, op, nm, prescale, set_id)
               for t, nm in zip(tensors, names)]
    return _submit(entries, "allreduce", lambda raws: pick([
        _allreduce_result(r, t, op, postscale, n, nm)
        for r, t, nm in zip(raws, tensors, names)]))


def _start_allreduce(tensor, op, name, prescale, postscale, process_set,
                     inplace=False) -> _Pending:
    set_id, members = _set_args(process_set)
    name = _auto_name("allreduce", name, set_id)
    pick = ((lambda out: _into(tensor, out[0])) if inplace
            else (lambda out: out[0]))
    return _allreduces([tensor], [name], op, prescale, postscale, set_id,
                       len(members), pick)


def _start_grouped(tensors, op, name, prescale, postscale,
                   process_set) -> _Pending:
    """The group's tensors under ``<name>.<i>``, as the reference names
    them."""
    set_id, members = _set_args(process_set)
    name = _auto_name("grouped_allreduce", name, set_id)
    return _allreduces(tensors, [f"{name}.{i}" for i in range(len(tensors))],
                       op, prescale, postscale, set_id, len(members), list)


def _gathered(flat: torch.Tensor, counts, x: torch.Tensor):
    """The flat gather as rows of ``x``'s trailing shape, and the rows
    each member sent."""
    trailing = math.prod(x.shape[1:])
    rows = [c // trailing if trailing else 0 for c in counts]
    return flat.reshape((sum(rows),) + tuple(x.shape[1:])), rows


def _start_allgather(tensor, name, process_set, with_rows=False
                     ) -> _Pending:
    set_id, members = _set_args(process_set)
    x = tensor.reshape(1) if tensor.dim() == 0 else tensor
    name = _auto_name("allgather", name, set_id)
    entry = TensorEntry(OpType.ALLGATHER, name, x, set_id=set_id)

    def finish(raws):
        r, rows = _gathered(*raws[0], x)
        if tensor.dim() == 0 and len(members) == 1:
            r = r.reshape(())
        r = _poisoned("allgather", _back(r, tensor), name)
        return (r, rows) if with_rows else r

    return _submit([entry], "allgather", finish)


def _start_broadcast(tensor, root_rank, name, process_set,
                     inplace=False) -> _Pending:
    set_id, members = _set_args(process_set)
    if _local_checks() and root_rank not in members:
        if set_id == 0:
            raise ValueError(f"broadcast root_rank {root_rank} out of "
                             f"range for size {len(members)}")
        raise ValueError(f"broadcast root_rank {root_rank} is not a member "
                         f"of process set {members}")
    name = _auto_name("broadcast", name, set_id)
    entry = TensorEntry(OpType.BROADCAST, name, tensor, arg=root_rank,
                        set_id=set_id)

    def finish(raws):
        r = _poisoned("broadcast", _back(raws[0], tensor), name)
        return _into(tensor, r) if inplace else r

    return _submit([entry], "broadcast", finish)


# ---------------------------------------------------------------------------
# Public collectives
# ---------------------------------------------------------------------------

def _compressed(compression, tensor):
    if compression is None:
        return tensor, None
    return compression.compress(tensor)


def _decompressed(compression, out, ctx):
    return out if compression is None else compression.decompress(out, ctx)


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0, compression=None,
              process_set=None) -> torch.Tensor:
    """Reduce ``tensor`` over every member (reference ``:630``).
    ``compression`` casts before the wire and back after."""
    wire, ctx = _compressed(compression, tensor)
    out = _start_allreduce(wire, _resolve_op(op, average), name,
                           prescale_factor, postscale_factor,
                           process_set).result()
    return _decompressed(compression, out, ctx)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0,
               process_set=None) -> torch.Tensor:
    """In-place allreduce: ``tensor`` receives the result."""
    return _start_allreduce(tensor, _resolve_op(op, average), name,
                            prescale_factor, postscale_factor, process_set,
                            inplace=True).result()


def _async(kind, name, process_set, start, op_kind=None) -> int:
    """A handle for ``start(name)``, the name checked first."""
    set_id, _ = _set_args(process_set)
    name = _auto_name(kind, name, set_id)
    return _handles.allocate(name, op_kind or kind, lambda: start(name))


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None) -> int:
    rop = _resolve_op(op, average)
    return _async("allreduce", name, process_set, lambda nm: (
        _start_allreduce(tensor, rop, nm, prescale_factor, postscale_factor,
                         process_set)))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None) -> int:
    """In-place async: ``tensor`` receives the result at synchronize."""
    rop = _resolve_op(op, average)
    return _async("allreduce", name, process_set, lambda nm: (
        _start_allreduce(tensor, rop, nm, prescale_factor, postscale_factor,
                         process_set, inplace=True)))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      compression=None, process_set=None
                      ) -> List[torch.Tensor]:
    """Reduce a list of tensors as one request (reference ``:710``): each
    under ``<name>.<i>``, submitted together, so the runtime fuses them
    into flat buffers up to ``HOROVOD_FUSION_THRESHOLD``."""
    tensors = list(tensors)
    if not tensors:
        return []
    wires, ctxs = zip(*[_compressed(compression, t) for t in tensors])
    outs = _start_grouped(list(wires), _resolve_op(op, average), name,
                          prescale_factor, postscale_factor,
                          process_set).result()
    return [_decompressed(compression, o, c) for o, c in zip(outs, ctxs)]


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=None) -> int:
    """One handle for the group; :func:`synchronize` returns the list."""
    rop = _resolve_op(op, average)
    tensors = list(tensors)
    return _async("grouped_allreduce", name, process_set, lambda nm: (
        _start_grouped(tensors, rop, nm, prescale_factor, postscale_factor,
                       process_set)), op_kind="allreduce")


def allgather(tensor, name=None, process_set=None) -> torch.Tensor:
    """Concatenate every member's tensor along dim 0 (reference
    ``:749``); first dimensions may differ, the others must match."""
    return _start_allgather(tensor, name, process_set).result()


def allgather_async(tensor, name=None, process_set=None) -> int:
    return _async("allgather", name, process_set, lambda nm: (
        _start_allgather(tensor, nm, process_set)))


def broadcast(tensor, root_rank=0, name=None,
              process_set=None) -> torch.Tensor:
    """``root_rank``'s tensor on every member (reference ``:788``)."""
    return _start_broadcast(tensor, root_rank, name, process_set).result()


def broadcast_(tensor, root_rank=0, name=None,
               process_set=None) -> torch.Tensor:
    return _start_broadcast(tensor, root_rank, name, process_set,
                            inplace=True).result()


def broadcast_async(tensor, root_rank=0, name=None,
                    process_set=None) -> int:
    return _async("broadcast", name, process_set, lambda nm: (
        _start_broadcast(tensor, root_rank, nm, process_set)))


def broadcast_async_(tensor, root_rank=0, name=None,
                     process_set=None) -> int:
    return _async("broadcast", name, process_set, lambda nm: (
        _start_broadcast(tensor, root_rank, nm, process_set, inplace=True)))


def _pickled(obj) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)


def _unpickled(t: torch.Tensor):
    return pickle.loads(t.cpu().numpy().tobytes())


def broadcast_object(obj, root_rank=0, name=None, process_set=None):
    """``root_rank``'s object on every member, pickled, with a size
    prologue (reference ``:836``)."""
    set_id, _ = _set_args(process_set)
    name = _auto_name("broadcast_object", name, set_id)
    if basics.rank() == root_rank:
        data = _pickled(obj)
        size = torch.tensor([data.numel()], dtype=torch.int64)
    else:
        size = torch.zeros(1, dtype=torch.int64)
    size = broadcast(size, root_rank, name + ".size", process_set)
    if basics.rank() != root_rank:
        data = torch.empty(int(size.item()), dtype=torch.uint8)
    return _unpickled(broadcast(data, root_rank, name, process_set))


def allgather_object(obj, name=None, process_set=None) -> list:
    """Every member's object, in rank order (reference ``:772``)."""
    gathered, rows = _start_allgather(_pickled(obj), name, process_set,
                                      with_rows=True).result()
    return [_unpickled(part) for part in gathered.split(rows)]


def reducescatter(tensor, op=None, name=None,
                  process_set=None) -> torch.Tensor:
    """Reduce, then give member i the i-th block of dim 0 (reference
    ``:857``): Average or Sum, and dim 0 divisible by the set size."""
    rop = _resolve_op(op, None)
    if rop is not Average and rop is not Sum:
        raise ValueError(f"reducescatter supports Average/Sum, got {rop}")
    set_id, members = _set_args(process_set)
    n = len(members)
    if _local_checks() and (tensor.dim() == 0 or tensor.shape[0] % n):
        raise ValueError(f"reducescatter needs a first dimension divisible "
                         f"by {n} ranks; got shape "
                         f"{tuple(tensor.shape)}")
    name = _auto_name("reducescatter", name, set_id)
    raw, = _run([TensorEntry(OpType.REDUCESCATTER, name, tensor,
                             arg=rop.code, set_id=set_id)], "reducescatter")
    out = raw.reshape((tensor.shape[0] // n,) + tuple(tensor.shape[1:]))
    if rop is Average:
        out = divide(out, n)
    return _poisoned("reducescatter", _back(out, tensor), name)


def alltoall(tensor, splits=None, name=None, process_set=None):
    """Send the i-th dim-0 block to member i (reference ``:882``).  With
    ``splits`` (rows per member) returns ``(output, received)``, where
    ``received[i]`` is the rows that came from member i; without, the
    rows split evenly."""
    set_id, members = _set_args(process_set)
    n = len(members)
    x = tensor.reshape(1) if tensor.dim() == 0 else tensor
    rows = x.shape[0]
    send = ()
    if splits is None:
        if _local_checks() and rows % n:
            raise ValueError(f"alltoall first dimension {rows} is not "
                             f"divisible by {n} ranks; pass splits=")
    else:
        send = [int(v) for v in torch.as_tensor(splits).reshape(-1).tolist()]
        if _local_checks() and (len(send) != n or sum(send) != rows
                                or min(send) < 0):
            raise ValueError(f"alltoall splits {send} do not match first "
                             f"dimension {rows} for size-{n} job")
    name = _auto_name("alltoall", name, set_id)
    (flat, recv), = _run([TensorEntry(OpType.ALLTOALL, name, x,
                                      set_id=set_id, splits=send)],
                         "alltoall")
    out, received = _gathered(flat, recv, x)
    out = _poisoned("alltoall", _back(out, tensor), name)
    if splits is None:
        return out
    return out, torch.tensor(received, dtype=torch.int64,
                             device=tensor.device)


def barrier(name=None, process_set=None) -> None:
    """Block until every member has arrived (reference ``:1021``): the
    negotiation is the barrier."""
    set_id, _ = _set_args(process_set)
    _run([TensorEntry(OpType.BARRIER, _auto_name("barrier", name, set_id),
                      set_id=set_id)], "barrier")


def join() -> int:
    """Signal that this rank has no more work (uneven final batches):
    until every rank has joined, this rank takes part in the others'
    collectives with zeros (Sum only; reference ``runtime.py:1185-1199``).
    Returns the last rank to join, as the coordinator saw it."""
    basics._check_initialized()
    return _run([TensorEntry(OpType.JOIN, "hvd.join")], "join")[0]
