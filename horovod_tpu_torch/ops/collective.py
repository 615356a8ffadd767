"""The ``hvd.*`` collectives on ``torch.distributed``.

Counterpart of ``horovod_tpu/ops/collective.py`` and of the torch
binding's wrappers (``horovod_tpu/torch/__init__.py:75-265``).  The JAX
package has two planes: ``lax`` collectives under ``shard_map`` and an
eager plane on its native runtime, which matches requests by name.  Here
both collapse onto one eager plane: every call issues a
``torch.distributed`` collective over the job's group (or a process
set's), NCCL when the job runs on the GPU, gloo when the caller asked for
the CPU.  A result lies on the device of its input and has its dtype.

Two things differ from the reference's eager plane:

* Requests are paired by issue order, not by name: every rank must issue
  the same collectives in the same order.  Names serve the duplicate
  check of the async API and nothing else.
* There is no ``join``: it needs the name-negotiating control plane.

The arithmetic is the reference's, whose eager plane computes in numpy.
``Average`` is a sum, then a divide by the set size.  Scale factors and
the divide run in the dtype numpy gives: integers in float64, bfloat16
in float32 (ml_dtypes' promotion), other floats in their own dtype with
the factor rounded to it.  The result is cast back to the input's dtype
at the end, as the torch binding casts numpy's result (float to integer
truncates toward zero).  ``Adasum`` is the native runtime's
scaled-projection butterfly (``native/cc/src/data_plane.cc:854-928``) on
point-to-point sends.
"""

from __future__ import annotations

import math
import pickle
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops._build import CallCounter
from horovod_tpu_torch.ops.fusion import dtype_name

# One count per torch.distributed collective (or point-to-point exchange)
# that this module issues, so a run can show what reached the wire.  The
# bucket all-reduces of grouped_allreduce and DistributedOptimizer count in
# fusion.allreduce_calls instead, as every fused all-reduce does.
calls = CallCounter("collective.calls")


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

_TORCH_OPS = {Average: dist.ReduceOp.SUM, Sum: dist.ReduceOp.SUM,
              Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}


def _resolve_op(op, average):
    """Reconcile the v0.18 ``average=`` bool with the op enum."""
    if op is not None:
        return op
    if average is None or average:
        return Average
    return Sum


# ---------------------------------------------------------------------------
# Process sets (reference ``collective.py:116-210``).  Each set is a
# ``dist.new_group``; creating one is collective over the whole job.
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
_set_ids: Dict[Tuple[int, ...], int] = {}
_set_groups: Dict[int, dist.ProcessGroup] = {}


def add_process_set(ranks) -> ProcessSet:
    """Collectively register a process set: EVERY rank of the job calls
    this with the same ranks, in the same order as its other
    registrations, because creating a process group is collective.
    Registering a member list again returns a set with its existing id."""
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
    if basics.process_group() is not None:
        raise NotImplementedError(
            "process sets inside a rank-subset job (init(ranks=...)) are "
            "not ported: the processes outside the subset would have to "
            "create the group too")
    key = tuple(ps.ranks)
    with _lock:
        if key not in _set_ids:
            group = dist.new_group([basics.global_rank(r) for r in key])
            _set_ids[key] = len(_set_ids) + 1
            _set_groups[_set_ids[key]] = group
        ps.id = _set_ids[key]
    return ps


class _Set(tuple):
    """(group, members): the process group and the hvd ranks in it."""

    @property
    def group(self):
        return self[0]

    @property
    def members(self) -> List[int]:
        return self[1]

    @property
    def size(self) -> int:
        return len(self[1])

    @property
    def pos(self) -> int:
        return self[1].index(basics.rank())

    @property
    def nccl(self) -> bool:
        return dist.get_backend(self[0]) == "nccl"

    def wire_device(self) -> torch.device:
        return basics.device() if self.nccl else torch.device("cpu")


def _set_args(process_set) -> _Set:
    """The group and members of ``process_set``; validates membership as
    the reference's ``_set_args`` (``collective.py:197-210``)."""
    basics._check_initialized()
    if process_set is None or process_set.id == 0:
        return _Set((basics.process_group(), list(range(basics.size()))))
    if process_set.id is None or process_set.id not in _set_groups:
        raise ValueError(
            f"process set {process_set.ranks} is not registered; call "
            "hvd.add_process_set(...) on every rank first")
    if not process_set.included():
        raise RuntimeError(
            f"rank {basics.rank()} is not a member of process set "
            f"{process_set.ranks} and cannot submit collectives on it")
    return _Set((_set_groups[process_set.id], list(process_set.ranks)))


# ---------------------------------------------------------------------------
# Handles of the async API (reference ``collective.py:268-347``): an int
# handle per call, completed by torch.distributed work objects.
# ---------------------------------------------------------------------------

# Error-message contract (reference horovod/common/common.h:155-158).
DUPLICATE_NAME_ERROR_FMT = (
    "Requested to %s a tensor with the same name as another tensor that is "
    "currently being processed.  If you want to request another tensor, use "
    "a different tensor name. Tensor name: %s"
)


class _Pending:
    """Issued collectives and the function that turns their buffers into
    the caller's result once they are complete."""

    def __init__(self, works, finish):
        self.works = [w for w in works if w is not None]
        self.finish = finish
        self.counts = None     # a gather's rows per member

    def done(self) -> bool:
        return all(w.is_completed() for w in self.works)

    def result(self):
        for w in self.works:
            w.wait()
        return self.finish()


class _Handle:
    __slots__ = ("id", "name", "pending")

    def __init__(self, hid: int, name: str, pending: _Pending):
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
        """Check ``name``, then issue ``start()`` and file its handle."""
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
            self._handles.pop(h.id, None)
            if self._inflight.get(h.name) is h:
                del self._inflight[h.name]


_handles = HandleManager()
_name_counter = 0


def _auto_name(kind: str, name: Optional[str]) -> str:
    global _name_counter
    if name is not None:
        return name
    with _lock:
        n = _name_counter
        _name_counter += 1
    return f"{kind}.noname.{n}"


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
    """Forget process sets and handles: their groups die with the job's."""
    global _handles
    with _lock:
        _set_ids.clear()
        _set_groups.clear()
    _handles = HandleManager()


basics.on_shutdown(_reset)


# ---------------------------------------------------------------------------
# Arithmetic shared by the ops
# ---------------------------------------------------------------------------

def _promoted(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype numpy gives ``t * python_scalar``: integers
    become float64 and bfloat16 float32 (ml_dtypes' promotion); the
    other floats keep their dtype."""
    if not (t.is_floating_point() or t.is_complex()):
        return t.to(torch.float64)
    if t.dtype == torch.bfloat16:
        return t.float()
    return t


def _divide(t: torch.Tensor, n: int) -> torch.Tensor:
    return _promoted(t) / n


def _to_wire(t: torch.Tensor, dev: torch.device,
             prescale: float = 1.0) -> torch.Tensor:
    """A fresh contiguous copy of ``t * prescale`` on the wire device."""
    w = fusion._times(t, prescale, _promoted)
    return w.to(dev, memory_format=torch.contiguous_format,
                copy=w is t)


def _back(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The result in the caller's dtype (float64 -> int truncates toward
    zero, as the torch binding's cast) and on the caller's device."""
    return r.to(device=like.device, dtype=like.dtype)


def _all_reduce(buf, op, group):
    calls.count += 1
    return dist.all_reduce(buf, op=op, group=group, async_op=True)


def _all_gather(out, buf, s: _Set):
    """``out`` ([n * rows, ...]) <- every member's ``buf`` in set order."""
    calls.count += 1
    if s.nccl:
        return dist.all_gather_into_tensor(out, buf, group=s.group,
                                           async_op=True)
    return dist.all_gather(list(out.chunk(s.size)), buf, group=s.group,
                           async_op=True)


# ---------------------------------------------------------------------------
# Adasum (reference native/cc/src/data_plane.cc:854-928)
# ---------------------------------------------------------------------------

def _check_adasum_dtype(t: torch.Tensor) -> None:
    if not t.is_floating_point():
        raise NotImplementedError(
            f"Adasum is defined for floating-point tensors only "
            f"(got dtype {dtype_name(t.dtype)})")


def _adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ac * a + bc * b`` in float64, rounded to a's dtype; ``a`` is the
    lower position's vector on both members of a pair, so both compute
    the same expression on the same operands."""
    x, y = a.double(), b.double()
    dot, na, nb = torch.dot(x, y), torch.dot(x, x), torch.dot(y, y)
    # Zero-norm guards: a zero vector is an identity, adasum(a, 0) = a.
    one = torch.ones((), dtype=torch.float64, device=x.device)
    ac = torch.where(na > 0, 1.0 - dot / (2.0 * na), one)
    bc = torch.where(nb > 0, 1.0 - dot / (2.0 * nb), one)
    return (ac * x + bc * y).to(a.dtype)


def _adasum(buf: torch.Tensor, s: _Set) -> torch.Tensor:
    """The butterfly over the set's members.  Extras past the largest
    power of two fold into ``[0, p2)`` first and get the result back at
    the end; 16-bit inputs are staged through float32."""
    n, me = s.size, s.pos
    if n == 1 or buf.numel() == 0:
        return buf
    vec = buf.reshape(-1).float() if buf.element_size() == 2 else (
        buf.reshape(-1))
    peer = [basics.global_rank(r) for r in s.members]
    other = torch.empty_like(vec)
    p2 = 1
    while p2 * 2 <= n:
        p2 *= 2
    extra = me >= p2
    fold = me - p2 if extra else (me + p2 if me + p2 < n else -1)
    calls.count += 1
    if extra:
        dist.send(vec, peer[fold], group=s.group)
        dist.recv(vec, peer[fold], group=s.group)
        return vec.reshape(buf.shape).to(buf.dtype)
    if fold >= 0:
        dist.recv(other, peer[fold], group=s.group)
        vec = _adasum_combine(vec, other)
    d = 1
    while d < p2:
        partner = me ^ d
        # The lower member sends first, the higher receives first: a pair
        # of plain sends and receives, which NCCL runs on a communicator of
        # the two (a batched exchange would need every member of the set
        # in the group's first call).
        if me < partner:
            dist.send(vec, peer[partner], group=s.group)
            dist.recv(other, peer[partner], group=s.group)
            vec = _adasum_combine(vec, other)
        else:
            dist.recv(other, peer[partner], group=s.group)
            dist.send(vec, peer[partner], group=s.group)
            vec = _adasum_combine(other, vec)
        d *= 2
    if fold >= 0:
        dist.send(vec, peer[fold], group=s.group)
    return vec.reshape(buf.shape).to(buf.dtype)


# ---------------------------------------------------------------------------
# Issue functions: each returns a _Pending
# ---------------------------------------------------------------------------

def _start_allreduce(tensor, op, prescale, postscale, s: _Set,
                     inplace=False) -> _Pending:
    if op is Adasum:
        _check_adasum_dtype(tensor)
    buf = _to_wire(tensor, s.wire_device(), prescale)
    work = None
    if op is Adasum:
        buf = _adasum(buf, s)
    elif buf.numel():
        work = _all_reduce(buf, _TORCH_OPS[op], s.group)

    def finish():
        r = _divide(buf, s.size) if op is Average else buf
        r = _back(fusion._times(r, postscale, _promoted), tensor)
        if inplace:
            with torch.no_grad():
                tensor.copy_(r)
            return tensor
        return r

    return _Pending([work], finish)


def _start_bucket(tensors, op, prescale, postscale, s: _Set) -> _Pending:
    """One planned bucket (tensors of one dtype) as ONE flat all-reduce
    over ``s``: :func:`fusion.start_bucket` with numpy's promotion, the
    results cast back to each input's dtype and device.  Adasum is not
    elementwise, so it reduces tensor by tensor."""
    if op is Adasum:
        parts = [_start_allreduce(t, op, prescale, postscale, s)
                 for t in tensors]
        return _Pending([], lambda: [p.result() for p in parts])
    work, finish = fusion.start_bucket(
        tensors, s.group, s.size, op=_TORCH_OPS[op], mean=op is Average,
        prescale_factor=prescale, postscale_factor=postscale,
        promote=_promoted, device=s.wire_device())
    return _Pending([work], lambda: [
        _back(r, t) for r, t in zip(finish(), tensors)])


def _start_grouped(tensors, op, prescale, postscale,
                   process_set) -> _Pending:
    """One :func:`_start_bucket` per fusion bucket (``_bucket_leaves`` at
    ``HOROVOD_FUSION_THRESHOLD``)."""
    s = _set_args(process_set)
    buckets = fusion._bucket_leaves(tensors,
                                    fusion.fusion_threshold_bytes())
    started = [_start_bucket([tensors[i] for i in b], op, prescale,
                             postscale, s) for b in buckets]

    def finish():
        out = [None] * len(tensors)
        for bucket, pending in zip(buckets, started):
            for i, r in zip(bucket, pending.finish()):
                out[i] = r
        return out

    return _Pending([w for p in started for w in p.works], finish)


def _dim0_sizes(x: torch.Tensor, s: _Set) -> List[int]:
    """Every member's first dimension (the one host read of a gather),
    after checking that all members agree on the other dimensions."""
    dev = s.wire_device()
    mine = torch.tensor([x.dim(), x.shape[0], math.prod(x.shape[1:])],
                        dtype=torch.int64, device=dev)
    every = torch.empty(3 * s.size, dtype=torch.int64, device=dev)
    _all_gather(every, mine, s).wait()
    rows = every.view(s.size, 3).tolist()
    if any((r[0], r[2]) != (rows[0][0], rows[0][2]) for r in rows):
        raise ValueError(f"allgather: ranks disagree on the dimensions "
                         f"after the first ((ndim, rows, row size) per "
                         f"rank: {rows})")
    return [r[1] for r in rows]


def _start_allgather(tensor, process_set) -> _Pending:
    s = _set_args(process_set)
    x = tensor.reshape(1) if tensor.dim() == 0 else tensor
    counts = _dim0_sizes(x, s)
    most = max(counts)
    buf = _to_wire(x, s.wire_device())
    if x.shape[0] != most:
        pad = buf.new_zeros((most,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = buf
        buf = pad
    out = buf.new_empty((most * s.size,) + tuple(x.shape[1:]))
    work = _all_gather(out, buf, s) if out.numel() else None

    def finish():
        r = out
        if any(c != most for c in counts):
            r = torch.cat([out[i * most:i * most + c]
                           for i, c in enumerate(counts)])
        if tensor.dim() == 0 and s.size == 1:
            r = r.reshape(())
        return _back(r, tensor)

    pending = _Pending([work], finish)
    pending.counts = counts
    return pending


def _start_broadcast(tensor, root_rank, process_set,
                     inplace=False) -> _Pending:
    s = _set_args(process_set)
    if root_rank not in s.members:
        if process_set is None or process_set.id == 0:
            raise ValueError(f"broadcast root_rank {root_rank} out of "
                             f"range for size {s.size}")
        raise ValueError(f"broadcast root_rank {root_rank} is not a member "
                         f"of process set {s.members}")
    buf = _to_wire(tensor, s.wire_device())
    work = None
    if buf.numel():
        calls.count += 1
        work = dist.broadcast(buf, src=basics.global_rank(root_rank),
                              group=s.group, async_op=True)

    def finish():
        r = _back(buf, tensor)
        if inplace:
            with torch.no_grad():
                tensor.copy_(r)
            return tensor
        return r

    return _Pending([work], finish)


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
    del name
    wire, ctx = _compressed(compression, tensor)
    out = _start_allreduce(wire, _resolve_op(op, average), prescale_factor,
                           postscale_factor,
                           _set_args(process_set)).result()
    return _decompressed(compression, out, ctx)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0,
               process_set=None) -> torch.Tensor:
    """In-place allreduce: ``tensor`` receives the result."""
    del name
    return _start_allreduce(tensor, _resolve_op(op, average),
                            prescale_factor, postscale_factor,
                            _set_args(process_set), inplace=True).result()


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None) -> int:
    basics._check_initialized()
    rop = _resolve_op(op, average)
    return _handles.allocate(
        _auto_name("allreduce", name), "allreduce",
        lambda: _start_allreduce(tensor, rop, prescale_factor,
                                 postscale_factor, _set_args(process_set)))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None) -> int:
    """In-place async: ``tensor`` receives the result at synchronize."""
    basics._check_initialized()
    rop = _resolve_op(op, average)
    return _handles.allocate(
        _auto_name("allreduce", name), "allreduce",
        lambda: _start_allreduce(tensor, rop, prescale_factor,
                                 postscale_factor, _set_args(process_set),
                                 inplace=True))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      compression=None, process_set=None
                      ) -> List[torch.Tensor]:
    """Reduce a list of tensors as one request (reference ``:710``): one
    flat buffer and one all-reduce per fusion bucket."""
    del name
    tensors = list(tensors)
    if not tensors:
        return []
    wires, ctxs = zip(*[_compressed(compression, t) for t in tensors])
    outs = _start_grouped(list(wires), _resolve_op(op, average),
                          prescale_factor, postscale_factor,
                          process_set).result()
    return [_decompressed(compression, o, c) for o, c in zip(outs, ctxs)]


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=None) -> int:
    """One handle for the group; :func:`synchronize` returns the list."""
    basics._check_initialized()
    rop = _resolve_op(op, average)
    tensors = list(tensors)
    return _handles.allocate(
        _auto_name("grouped_allreduce", name), "allreduce",
        lambda: _start_grouped(tensors, rop, prescale_factor,
                               postscale_factor, process_set))


def allgather(tensor, name=None, process_set=None) -> torch.Tensor:
    """Concatenate every member's tensor along dim 0 (reference
    ``:749``); first dimensions may differ, the others must match."""
    del name
    return _start_allgather(tensor, process_set).result()


def allgather_async(tensor, name=None, process_set=None) -> int:
    basics._check_initialized()
    return _handles.allocate(
        _auto_name("allgather", name), "allgather",
        lambda: _start_allgather(tensor, process_set))


def broadcast(tensor, root_rank=0, name=None,
              process_set=None) -> torch.Tensor:
    """``root_rank``'s tensor on every member (reference ``:788``)."""
    del name
    return _start_broadcast(tensor, root_rank, process_set).result()


def broadcast_(tensor, root_rank=0, name=None,
               process_set=None) -> torch.Tensor:
    del name
    return _start_broadcast(tensor, root_rank, process_set,
                            inplace=True).result()


def broadcast_async(tensor, root_rank=0, name=None,
                    process_set=None) -> int:
    basics._check_initialized()
    return _handles.allocate(
        _auto_name("broadcast", name), "broadcast",
        lambda: _start_broadcast(tensor, root_rank, process_set))


def broadcast_async_(tensor, root_rank=0, name=None,
                     process_set=None) -> int:
    basics._check_initialized()
    return _handles.allocate(
        _auto_name("broadcast", name), "broadcast",
        lambda: _start_broadcast(tensor, root_rank, process_set,
                                 inplace=True))


def _pickled(obj, dev) -> torch.Tensor:
    data = bytearray(pickle.dumps(obj))
    return torch.frombuffer(data, dtype=torch.uint8).to(dev)


def _unpickled(t: torch.Tensor):
    return pickle.loads(t.cpu().numpy().tobytes())


def broadcast_object(obj, root_rank=0, name=None, process_set=None):
    """``root_rank``'s object on every member, pickled, with a size
    prologue (reference ``:836``)."""
    del name
    s = _set_args(process_set)
    dev = s.wire_device()
    if basics.rank() == root_rank:
        data = _pickled(obj, dev)
        size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    size = broadcast(size, root_rank, process_set=process_set)
    if basics.rank() != root_rank:
        data = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    return _unpickled(broadcast(data, root_rank, process_set=process_set))


def allgather_object(obj, name=None, process_set=None) -> list:
    """Every member's object, in rank order (reference ``:772``)."""
    del name
    s = _set_args(process_set)
    pending = _start_allgather(_pickled(obj, s.wire_device()), process_set)
    gathered = pending.result()
    return [_unpickled(part) for part in gathered.split(pending.counts)]


def reducescatter(tensor, op=None, name=None,
                  process_set=None) -> torch.Tensor:
    """Reduce, then give member i the i-th block of dim 0 (reference
    ``:857``): Average or Sum, and dim 0 divisible by the set size."""
    del name
    rop = _resolve_op(op, None)
    if rop is not Average and rop is not Sum:
        raise ValueError(f"reducescatter supports Average/Sum, got {rop}")
    s = _set_args(process_set)
    if tensor.dim() == 0 or tensor.shape[0] % s.size:
        raise ValueError(f"reducescatter needs a first dimension divisible "
                         f"by {s.size} ranks; got shape "
                         f"{tuple(tensor.shape)}")
    buf = _to_wire(tensor, s.wire_device())
    rows = tensor.shape[0] // s.size
    if s.nccl:
        out = buf.new_empty((rows,) + tuple(tensor.shape[1:]))
        if buf.numel():
            calls.count += 1
            dist.reduce_scatter_tensor(out, buf, op=dist.ReduceOp.SUM,
                                       group=s.group)
    else:
        # gloo's reduce-scatter is missing from some torch releases: the
        # sum of the whole buffer, then this member's block.
        if buf.numel():
            _all_reduce(buf, dist.ReduceOp.SUM, s.group).wait()
        out = buf[s.pos * rows:(s.pos + 1) * rows].clone()
    if rop is Average:
        out = _divide(out, s.size)
    return _back(out, tensor)


def alltoall(tensor, splits=None, name=None, process_set=None):
    """Send the i-th dim-0 block to member i (reference ``:882``).  With
    ``splits`` (rows per member) returns ``(output, received)``, where
    ``received[i]`` is the rows that came from member i; without, the
    rows split evenly."""
    del name
    s = _set_args(process_set)
    dev = s.wire_device()
    x = tensor.reshape(1) if tensor.dim() == 0 else tensor
    rows = x.shape[0]
    buf = _to_wire(x, dev)
    if splits is None:
        if rows % s.size:
            raise ValueError(f"alltoall first dimension {rows} is not "
                             f"divisible by {s.size} ranks; pass splits=")
        out = torch.empty_like(buf)
        if buf.numel():
            calls.count += 1
            dist.all_to_all_single(out, buf, group=s.group)
        return _back(out, tensor)
    send = [int(v) for v in torch.as_tensor(splits).reshape(-1).tolist()]
    if len(send) != s.size or sum(send) != rows or min(send) < 0:
        raise ValueError(f"alltoall splits {send} do not match first "
                         f"dimension {rows} for size-{s.size} job")
    recv = torch.empty(s.size, dtype=torch.int64, device=dev)
    calls.count += 2
    dist.all_to_all_single(recv, torch.tensor(send, dtype=torch.int64,
                                              device=dev), group=s.group)
    received = recv.tolist()
    out = buf.new_empty((sum(received),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, buf, output_split_sizes=received,
                           input_split_sizes=send, group=s.group)
    return _back(out, tensor), recv.to(tensor.device)


def barrier(name=None, process_set=None) -> None:
    """Block until every member has arrived (reference ``:1021``)."""
    del name
    s = _set_args(process_set)
    calls.count += 1
    if s.nccl:
        dist.barrier(group=s.group, device_ids=[basics.device().index])
    else:
        dist.barrier(group=s.group)
