"""Tensor fusion for the gradient all-reduce and the sharded update.

Counterpart of ``horovod_tpu/ops/fusion.py`` (``parse_size_bytes``
``:93`` and ``max_bucket_bytes`` ``:137``, both in the port's
``config``; ``fusion_threshold_bytes`` ``:106``,
``record_collective_bytes`` ``:158``, ``_bucket_leaves`` ``:191``,
``fused_psum`` ``:280``, ``fused_pytree_mean`` ``:327``; fusion v2:
``ReduceScatterPlan`` ``:343``, ``_chunk_spans`` ``:467``,
``make_reduce_scatter_plan`` ``:487``, ``fused_reduce_scatter`` ``:546``,
``fused_hierarchical_reduce_scatter`` ``:583``, ``fused_all_gather``
``:627``).  Leaves are grouped by dtype into buckets up to the threshold;
each bucket is flattened into one buffer, reduced with ONE
``dist.all_reduce`` and split back.  The bucketing walk is the
reference's, leaf for leaf, so the same leaf list gives the same buckets
in both packages.

Fusion v2 is the sharded-update wire (ZeRO-1): the same walk, each
bucket cut into chunks of at most ``HOROVOD_MAX_BUCKET_BYTES``, padded
to a multiple of the group size and reduce-scattered, so a rank keeps
its 1/N shard of every bucket; :func:`fused_all_gather` puts the buckets
back together.  On NCCL the pair is ``reduce_scatter_tensor`` and
``all_gather_into_tensor``; on gloo the reduce-scatter is an all-reduce
and this rank's block.  Every bucket's collective is issued before the
first is waited on.  The mean is a SUM, then a multiply by ``1/N`` in
the shard's dtype, as the reference computes it.

The counters: ``allreduce_calls``, ``reduce_scatter_calls``,
``all_gather_calls`` and ``all_to_all_calls`` count collectives launched
(the wire codecs' too); ``collective_bytes``
the logical payload bytes a rank puts on the wire, by kind, codec and
level (the reference counts them once per trace, the port once per
call).  The telemetry series (``hvd_fusion_*``,
``hvd_collective_bytes_total``) carry the reference's names, labels and
bounds, and are likewise recorded once per call: in the port every call
is a fusion walk, so per-step traffic is the series itself.  The eager
plane's fused responses count as ``kind="eager"`` walks of one bucket
each, so ``hvd_fusion_buckets_total`` over every kind equals
``allreduce_calls`` for the all-reduce paths.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import config, telemetry
from horovod_tpu_torch.config import (max_bucket_bytes,  # noqa: F401
                                      parse_size_bytes)
from horovod_tpu_torch.ops._build import CallCounter

log = logging.getLogger(__name__)

# Reference defaults: 64 MB threshold, 32 MB reduce-scatter chunk cap.
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
DEFAULT_MAX_BUCKET_BYTES = 32 * 1024 * 1024

# One count per bucket all-reduce (start_bucket), whoever asked for it, so
# a run can show that the gradient mean went through the collective
# library; and one per bucket reduce-scatter and all-gather.
allreduce_calls = CallCounter("fusion.all_reduce")
reduce_scatter_calls = CallCounter("fusion.reduce_scatter")
all_gather_calls = CallCounter("fusion.all_gather")
all_to_all_calls = CallCounter("fusion.all_to_all")


class WireBytes:
    """Logical payload bytes a rank put on the wire, keyed by ``(kind,
    codec, level)``; ``level`` is ``"ici"``/``"dcn"`` for a leg of a
    two-level collective, else None."""

    def __init__(self):
        self.bytes: Dict[Tuple[str, str, Optional[str]], int] = {}
        self._lock = threading.Lock()

    def add(self, kind: str, codec: str, nbytes: int,
            level: Optional[str] = None) -> None:
        key = (kind, codec, level)
        with self._lock:
            self.bytes[key] = self.bytes.get(key, 0) + int(nbytes)

    def total(self, kind=None, codec=None, level=None) -> int:
        """The sum over the keys that match every name given."""
        return sum(v for (k, c, lv), v in self.bytes.items()
                   if kind in (None, k) and codec in (None, c)
                   and level in (None, lv))

    def reset(self) -> None:
        with self._lock:
            self.bytes.clear()


collective_bytes = WireBytes()


def record_collective_bytes(kind: str, codec: str, nbytes: int,
                            level: Optional[str] = None,
                            plane: str = "spmd") -> None:
    """Count ``nbytes`` of logical wire payload for one collective call
    (per rank), labelled by the wire codec that produced them: the
    none/int8 ratio of two runs' counts is the wire compression ratio.
    The eager plane's all-reduces count as ``plane="eager"`` in the
    series only."""
    if not nbytes:
        return
    if plane == "spmd":
        collective_bytes.add(kind, codec, nbytes, level)
    if telemetry.enabled():
        labels = dict(plane=plane, kind=kind, codec=codec)
        if level is not None:
            labels["level"] = level
        telemetry.counter(
            "hvd_collective_bytes_total",
            "Logical wire payload bytes of SPMD collectives (trace-time)",
            **labels).inc(int(nbytes))


def record_buckets(kind: str, tensors, buckets, pad_bytes: int = 0) -> None:
    """One fusion walk's series (reference ``_record_buckets``):
    ``buckets`` are lists of indices into ``tensors``."""
    if not telemetry.enabled():
        return
    telemetry.counter(
        "hvd_fusion_requests_total",
        "Fusion walks (trace-time bucketing decisions)", kind=kind).inc()
    telemetry.counter(
        "hvd_fusion_buckets_total",
        "Fusion buckets produced across all fusion walks", kind=kind).inc(
        len(buckets))
    telemetry.counter(
        "hvd_fusion_tensors_total",
        "Tensors routed through the fusion walks", kind=kind).inc(
        len(tensors))
    hist = telemetry.histogram(
        "hvd_fusion_bucket_bytes",
        "Per-bucket payload size produced by the fusion walk",
        bounds=telemetry.DEFAULT_BYTE_BUCKETS)
    for bucket in buckets:
        hist.observe(float(sum(tensors[i].numel() * tensors[i].element_size()
                               for i in bucket)))
    if pad_bytes:
        telemetry.counter(
            "hvd_fusion_pad_bytes_total",
            "Bytes of axis-size padding added to reduce-scatter buckets "
            "(padding waste)", kind=kind).inc(pad_bytes)


def record_plan(kind: str, plan: "ReduceScatterPlan") -> None:
    """A reduce-scatter plan's series (reference ``_record_plan``)."""
    if not telemetry.enabled():
        return
    telemetry.counter(
        "hvd_fusion_requests_total",
        "Fusion walks (trace-time bucketing decisions)", kind=kind).inc()
    telemetry.counter(
        "hvd_fusion_buckets_total",
        "Fusion buckets produced across all fusion walks", kind=kind).inc(
        len(plan.buckets))
    telemetry.counter(
        "hvd_fusion_tensors_total",
        "Tensors routed through the fusion walks", kind=kind).inc(
        plan.n_leaves)
    hist = telemetry.histogram(
        "hvd_fusion_bucket_bytes",
        "Per-bucket payload size produced by the fusion walk",
        bounds=telemetry.DEFAULT_BYTE_BUCKETS)
    for b in range(len(plan.buckets)):
        hist.observe(float(plan.bucket_size(b)
                           * plan.bucket_dtype(b).itemsize))
    pad = plan.total_pad_bytes()
    if pad:
        telemetry.counter(
            "hvd_fusion_pad_bytes_total",
            "Bytes of axis-size padding added to reduce-scatter buckets "
            "(padding waste)", kind=kind).inc(pad)

_warned_bad_threshold = False

# The live threshold's provider (reference ``ops/fusion.py:65-90``): the
# control plane registers one that returns the threshold the ranks last
# agreed on in ``Runtime.sync_tuned_config()``, a collective, or None
# before any agreement.  It must return the same number on every rank at
# the same point of the program: buckets cut under different thresholds
# would desynchronize the ranks' collectives and hang the job.
_live_threshold_provider = None


def set_live_threshold_provider(provider) -> None:
    """Register (or clear, with None) the live threshold's source; it
    must honour the rank-agreement contract above."""
    global _live_threshold_provider
    _live_threshold_provider = provider


def fusion_threshold_bytes() -> int:
    """The fusion bucket limit: the rank-agreed tuned value once the
    control plane latched one, else ``HOROVOD_FUSION_THRESHOLD``."""
    if _live_threshold_provider is not None:
        try:
            live = _live_threshold_provider()
        except Exception:   # a dying runtime must not break bucketing
            live = None
        if live is not None and live > 0:
            return int(live)
    return env_fusion_threshold_bytes()


def env_fusion_threshold_bytes() -> int:
    """``HOROVOD_FUSION_THRESHOLD`` (bytes, or with a binary suffix); an
    unparseable value falls back to the 64 MB default with one warning."""
    global _warned_bad_threshold
    v = config.env_raw("HOROVOD_FUSION_THRESHOLD")
    if not v:
        return DEFAULT_FUSION_THRESHOLD
    parsed = parse_size_bytes(v)
    if parsed is None:
        if not _warned_bad_threshold:
            _warned_bad_threshold = True
            log.warning(
                "HOROVOD_FUSION_THRESHOLD=%r is not a byte size (expected "
                "e.g. 67108864, 64mb or 32MiB); using the default %d bytes",
                v, DEFAULT_FUSION_THRESHOLD)
        return DEFAULT_FUSION_THRESHOLD
    return parsed


def dtype_name(dtype: torch.dtype) -> str:
    """numpy-style dtype name (``"float32"``), the key the reference sorts
    buckets by, so the two packages order dtypes alike."""
    return str(dtype).removeprefix("torch.")


def _bucket_leaves(leaves, threshold: int) -> List[List[int]]:
    """Group leaf indices into buckets: same dtype, cumulative bytes under
    ``threshold``, leaves sorted by (dtype name, index).  Every leaf here
    is replicated, so the reference's vma key is always empty."""
    keys = [dtype_name(leaf.dtype) for leaf in leaves]
    order = sorted(range(len(leaves)), key=lambda i: (keys[i], i))
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_key = None
    for i in order:
        leaf = leaves[i]
        nbytes = leaf.numel() * leaf.element_size()
        if cur and (keys[i] != cur_key or cur_bytes + nbytes > threshold):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_key = keys[i]
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _times(t: torch.Tensor, factor: float, promote) -> torch.Tensor:
    """``t * factor`` in ``promote(t)``'s dtype, the factor rounded to that
    dtype first, as jnp and numpy multiply by a Python scalar."""
    if factor == 1.0:
        return t
    t = promote(t)
    return t * torch.tensor(factor, dtype=t.dtype, device=t.device)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def start_bucket(tensors: Sequence[torch.Tensor], group, size: int, *,
                 op=dist.ReduceOp.SUM, mean: bool = False,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 device: Optional[torch.device] = None,
                 after_copy=None):
    """Start ONE async all-reduce of a bucket: ``tensors`` flattened into
    one buffer on ``device`` (default: where they lie).

    Returns ``(work, finish)``: ``work`` is None for an empty bucket, and
    ``finish()``, called once the work is complete, gives the reduced
    tensors in order, shaped as the inputs.  The scale factors and the
    ``mean`` divide by ``size`` run in the bucket's dtype, as the
    reference's SPMD plane computes (``fused_psum``); the control plane
    passes neither and scales each result as numpy would, and may pass
    ``after_copy``, called once the tensors are in the buffer (its
    timeline marks the copy).
    """
    # cat copies, so the reduction never writes into a caller's tensor.
    flat = torch.cat([t.reshape(-1).to(device) for t in tensors])
    if after_copy is not None:
        after_copy()
    flat = _times(flat, prescale_factor, _same)
    work = None
    if flat.numel():
        work = dist.all_reduce(flat, op=op, group=group, async_op=True)
        allreduce_calls.add()

    def finish() -> List[torch.Tensor]:
        r = flat / size if mean else flat
        r = _times(r, postscale_factor, _same)
        parts = r.split([t.numel() for t in tensors])
        return [part.view(t.shape) for part, t in zip(parts, tensors)]

    return work, finish


def fused_psum(tensors: Sequence[torch.Tensor], group=None,
               mean: bool = True, threshold: Optional[int] = None,
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """All-reduce a list of tensors over ``group`` with bucketed fusion.

    Returns new tensors in the original order; the inputs are not
    modified.  ``prescale_factor``/``postscale_factor`` multiply the flat
    bucket around the reduction, ``mean`` divides it by the group size,
    all in the bucket's dtype as the reference's ``fused_psum``.
    """
    tensors = list(tensors)
    if not tensors:
        return []
    threshold = fusion_threshold_bytes() if threshold is None else threshold
    n = dist.get_world_size(group)
    buckets = _bucket_leaves(tensors, threshold)
    record_buckets("psum", tensors, buckets)
    record_collective_bytes("psum", "none", sum(
        t.numel() * t.element_size() for t in tensors))
    started = [(bucket, start_bucket(
        [tensors[i] for i in bucket], group, n, mean=mean,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor))
        for bucket in buckets]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for bucket, (work, finish) in started:
        if work is not None:
            work.wait()
        for i, r in zip(bucket, finish()):
            out[i] = r
    return out


def fused_pytree_mean(tree, group=None, threshold: Optional[int] = None):
    """Average gradients across ``group`` with fusion.  ``tree`` is a list
    of tensors, or a dict of them; a dict is walked in sorted key order,
    as a pytree flatten walks it, and comes back as a dict."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        reduced = fused_psum([tree[k] for k in keys], group, mean=True,
                             threshold=threshold)
        return dict(zip(keys, reduced))
    return fused_psum(tree, group, mean=True, threshold=threshold)


# ---------------------------------------------------------------------------
# Fusion v2: the reduce-scatter / all-gather pair (the sharded-update wire).
# ---------------------------------------------------------------------------

def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy-style name (:func:`dtype_name`'s
    inverse)."""
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class ReduceScatterPlan:
    """One fusion walk over a fixed leaf list, frozen, with each bucket's
    padding to a multiple of ``axis_size``.

    A bucket is a tuple of spans ``(leaf, start, stop)``, element ranges
    of the flattened leaf, so one large leaf (or bucket) can be chunked
    across several buckets (``HOROVOD_MAX_BUCKET_BYTES``).  ``lowrank``
    lists the buckets a wire codec claimed as whole-leaf low-rank buckets
    (:mod:`horovod_tpu_torch.ops.compression`); those are never chunked.
    ``dtypes`` holds numpy-style names, so a plan equals the reference's
    field for field.
    """
    buckets: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    axis_size: int
    lowrank: Tuple[int, ...] = ()

    # -- geometry -----------------------------------------------------------
    def leaf_size(self, i: int) -> int:
        n = 1
        for d in self.shapes[i]:
            n *= d
        return n

    def bucket_size(self, b: int) -> int:
        """Unpadded element count of bucket ``b``."""
        return sum(stop - start for _, start, stop in self.buckets[b])

    def padded_size(self, b: int) -> int:
        """Bucket size rounded up to a multiple of ``axis_size``."""
        n, a = self.bucket_size(b), self.axis_size
        return -(-n // a) * a if n else a  # an empty bucket still scatters

    def shard_size(self, b: int) -> int:
        return self.padded_size(b) // self.axis_size

    def pad_elems(self, b: int) -> int:
        return self.padded_size(b) - self.bucket_size(b)

    def bucket_dtype(self, b: int) -> torch.dtype:
        return torch_dtype(self.dtypes[self.buckets[b][0][0]])

    def bucket_leaf_shape(self, b: int) -> Optional[Tuple[int, ...]]:
        """The leaf's shape when bucket ``b`` is exactly one WHOLE leaf
        (the low-rank codec needs the 2-D geometry back), else None."""
        spans = self.buckets[b]
        if len(spans) != 1:
            return None
        i, start, stop = spans[0]
        if start != 0 or stop != self.leaf_size(i):
            return None
        return self.shapes[i]

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    def total_pad_bytes(self) -> int:
        return sum(self.pad_elems(b) * self.bucket_dtype(b).itemsize
                   for b in range(len(self.buckets)))

    def total_padded_bytes(self) -> int:
        """Per-rank logical payload of one reduce-scatter (or all-gather)
        pass over every bucket, on a wire in each bucket's dtype."""
        return sum(self.padded_size(b) * self.bucket_dtype(b).itemsize
                   for b in range(len(self.buckets)))

    # -- flat buffers -------------------------------------------------------
    def concat(self, leaves) -> List[torch.Tensor]:
        """Leaves -> one padded 1-D buffer per bucket."""
        if len(leaves) != self.n_leaves:
            raise ValueError(f"plan describes {self.n_leaves} leaves, got "
                             f"{len(leaves)}")
        flats = []
        for b, spans in enumerate(self.buckets):
            parts = []
            for i, start, stop in spans:
                flat_leaf = leaves[i].reshape(-1)
                parts.append(flat_leaf if stop - start == self.leaf_size(i)
                             else flat_leaf[start:stop])
            pad = self.pad_elems(b)
            if pad or not parts:
                dev = leaves[spans[0][0]].device if spans else None
                parts.append(torch.zeros(
                    pad if parts else self.padded_size(b),
                    dtype=self.bucket_dtype(b), device=dev))
            flats.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        return flats

    def split(self, flats) -> List[torch.Tensor]:
        """Padded per-bucket 1-D buffers -> leaves in ORIGINAL order."""
        if len(flats) != len(self.buckets):
            raise ValueError(f"plan has {len(self.buckets)} buckets, got "
                             f"{len(flats)} buffers")
        pieces: List[List[Tuple[int, torch.Tensor]]] = [
            [] for _ in range(self.n_leaves)]
        for b, spans in enumerate(self.buckets):
            parts = flats[b][:self.bucket_size(b)].split(
                [stop - start for _, start, stop in spans])
            for (i, start, _), part in zip(spans, parts):
                pieces[i].append((start, part))
        out = []
        for i, segs in enumerate(pieces):
            segs = [part for _, part in sorted(segs, key=lambda t: t[0])]
            flat = segs[0] if len(segs) == 1 else torch.cat(segs)
            out.append(flat.view(self.shapes[i]))
        return out

    def shard_slice(self, b: int, flat: torch.Tensor,
                    index: int) -> torch.Tensor:
        """Shard ``index`` of bucket ``b``'s full padded buffer."""
        s = self.shard_size(b)
        return flat[index * s:(index + 1) * s]


def _chunk_spans(spans, itemsize: int, cap: int):
    """Split one bucket's span list into chunks of at most ``cap`` bytes
    (element-granular: a span larger than the cap is cut mid-leaf)."""
    cap_elems = max(1, cap // itemsize)
    chunks, cur, cur_elems = [], [], 0
    for leaf, start, stop in spans:
        pos = start
        while pos < stop:
            take = min(stop - pos, cap_elems - cur_elems)
            cur.append((leaf, pos, pos + take))
            pos += take
            cur_elems += take
            if cur_elems == cap_elems:
                chunks.append(cur)
                cur, cur_elems = [], 0
    if cur:
        chunks.append(cur)
    return chunks or [list(spans)]


def make_reduce_scatter_plan(leaves, axis_size: int,
                             threshold: Optional[int] = None, codec=None,
                             cap: Optional[int] = None) -> ReduceScatterPlan:
    """Run the fusion walk over ``leaves`` (tensors, meta tensors too) and
    freeze it with each bucket's padding for an ``axis_size``-way
    reduce-scatter.  Buckets above ``cap`` bytes (default
    ``HOROVOD_MAX_BUCKET_BYTES``, 32 MiB; 0 disables) are chunked.
    ``codec`` may claim whole leaves as low-rank buckets through its
    ``solo_leaf(shape, dtype)``; they come last, in leaf order, and are
    listed in ``plan.lowrank``."""
    leaves = list(leaves)
    threshold = fusion_threshold_bytes() if threshold is None else threshold
    cap = max_bucket_bytes() if cap is None else cap
    solo = [i for i, leaf in enumerate(leaves)
            if codec is not None
            and codec.solo_leaf(tuple(int(d) for d in leaf.shape),
                                leaf.dtype)]
    rest_idx = [i for i in range(len(leaves)) if i not in solo]
    walk = _bucket_leaves([leaves[i] for i in rest_idx], threshold)
    span_buckets = [[(rest_idx[j], 0, leaves[rest_idx[j]].numel())
                     for j in bucket] for bucket in walk]
    if cap:
        out_buckets, chunked = [], 0
        for spans in span_buckets:
            itemsize = leaves[spans[0][0]].element_size()
            nbytes = sum((stop - start) * itemsize
                         for _, start, stop in spans)
            if nbytes > cap:
                chunked += 1
                out_buckets.extend(_chunk_spans(spans, itemsize, cap))
            else:
                out_buckets.append(spans)
        if chunked and telemetry.enabled():
            telemetry.counter(
                "hvd_fusion_chunked_buckets_total",
                "Fusion buckets split because they exceeded "
                "HOROVOD_MAX_BUCKET_BYTES").inc(chunked)
        span_buckets = out_buckets
    lowrank = tuple(range(len(span_buckets), len(span_buckets) + len(solo)))
    for i in solo:
        span_buckets.append([(i, 0, leaves[i].numel())])
    return ReduceScatterPlan(
        buckets=tuple(tuple(b) for b in span_buckets),
        shapes=tuple(tuple(int(d) for d in leaf.shape) for leaf in leaves),
        dtypes=tuple(dtype_name(leaf.dtype) for leaf in leaves),
        axis_size=int(axis_size), lowrank=lowrank)


def _is_nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def start_reduce_scatter(flat: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """Start the reduce-scatter of one padded bucket: returns ``(work,
    shard)``, the shard valid once ``work`` (None when nothing was sent)
    is waited on.  ``flat`` is never written."""
    n, pos = dist.get_world_size(group), dist.get_rank(group)
    k = flat.numel() // n
    if not flat.numel():
        return None, flat[:0]
    reduce_scatter_calls.add()
    if _is_nccl(group):
        out = flat.new_empty(k)
        return dist.reduce_scatter_tensor(out, flat, op=op, group=group,
                                          async_op=True), out
    # gloo's reduce-scatter is missing from some torch releases: the sum
    # of the whole buffer, then this rank's block.
    buf = flat.clone()
    return (dist.all_reduce(buf, op=op, group=group, async_op=True),
            buf[pos * k:(pos + 1) * k])


def start_all_gather(shard: torch.Tensor, group):
    """Start the all-gather of one shard: returns ``(work, full)``,
    ``full`` the group's shards in rank order."""
    n = dist.get_world_size(group)
    out = shard.new_empty(n * shard.numel())
    if not out.numel():
        return None, out
    all_gather_calls.add()
    if _is_nccl(group):
        return dist.all_gather_into_tensor(out, shard.contiguous(),
                                           group=group, async_op=True), out
    return dist.all_gather(list(out.chunk(n)), shard.contiguous(),
                           group=group, async_op=True), out


def wait_all(started) -> list:
    """Wait on each ``(work, result)`` in order; returns the results."""
    out = []
    for work, result in started:
        if work is not None:
            work.wait()
        out.append(result)
    return out


def scale(t: torch.Tensor, factor: float) -> torch.Tensor:
    """``t * factor`` in ``t``'s dtype, the factor rounded to it first
    (the reference's ``shard * jnp.asarray(factor, shard.dtype)``)."""
    return _times(t, factor, _same)


def fused_reduce_scatter(tensors: Sequence[torch.Tensor], group=None,
                         mean: bool = True, threshold: Optional[int] = None,
                         plan: Optional[ReduceScatterPlan] = None,
                         axis_size: Optional[int] = None):
    """Reduce-scatter a list of tensors over ``group`` with bucketed
    fusion: every bucket is flattened, padded to a multiple of the group
    size and reduce-scattered, so this rank keeps its shard of each.
    Returns ``(shards, plan)``; :func:`fused_all_gather` is the inverse.
    ``mean=True`` multiplies each shard by ``1/N`` after the sum."""
    tensors = list(tensors)
    if plan is None:
        n = dist.get_world_size(group) if axis_size is None else axis_size
        plan = make_reduce_scatter_plan(tensors, n, threshold)
    if not tensors:
        return [], plan
    record_plan("reduce_scatter", plan)
    record_collective_bytes("reduce_scatter", "none",
                            plan.total_padded_bytes())
    shards = wait_all([start_reduce_scatter(flat, group)
                       for flat in plan.concat(tensors)])
    if mean:
        shards = [scale(s, 1.0 / plan.axis_size) for s in shards]
    return shards, plan


def fused_hierarchical_reduce_scatter(
        tensors: Sequence[torch.Tensor], ici_group, dcn_group,
        mean: bool = True, threshold: Optional[int] = None,
        plan: Optional[ReduceScatterPlan] = None,
        axis_size: Optional[int] = None):
    """Two-level reduce-scatter: over ``ici_group`` (the ranks of this
    host), then an all-reduce of each 1/ici shard over ``dcn_group`` (this
    rank's peers on the other hosts), so the inter-host leg carries
    1/ici of every bucket's bytes.  The plan is over the ici size only:
    the shards are ici-sharded and replicated over dcn, and feed
    :func:`fused_all_gather` over ``ici_group``.  ``mean=True`` folds
    both levels into one ``1/(ici*dcn)`` multiply on the shard."""
    tensors = list(tensors)
    ici = dist.get_world_size(ici_group) if axis_size is None else axis_size
    dcn = dist.get_world_size(dcn_group)
    if plan is None:
        plan = make_reduce_scatter_plan(tensors, ici, threshold)
    if not tensors:
        return [], plan
    record_plan("hier_reduce_scatter", plan)
    record_collective_bytes("hier_reduce_scatter", "none",
                            plan.total_padded_bytes(), level="ici")
    record_collective_bytes("hier_reduce_scatter", "none",
                            plan.total_padded_bytes() // max(ici, 1),
                            level="dcn")
    shards = wait_all([start_reduce_scatter(flat, ici_group)
                       for flat in plan.concat(tensors)])
    started = []
    for s in shards:
        work = None
        if s.numel():
            allreduce_calls.add()
            work = dist.all_reduce(s, group=dcn_group, async_op=True)
        started.append((work, s))
    shards = wait_all(started)
    if mean:
        shards = [scale(s, 1.0 / (plan.axis_size * dcn)) for s in shards]
    return shards, plan


def fused_all_gather(shards: Sequence[torch.Tensor],
                     plan: ReduceScatterPlan, group=None):
    """Inverse of :func:`fused_reduce_scatter`: all-gather every bucket's
    shards back to the full padded buffer, strip the padding and split
    into tensors in the ORIGINAL leaf order."""
    shards = list(shards)
    if len(shards) != len(plan.buckets):
        raise ValueError(f"plan has {len(plan.buckets)} buckets, got "
                         f"{len(shards)} shards")
    record_collective_bytes("all_gather", "none", plan.total_padded_bytes())
    return plan.split(wait_all([start_all_gather(s, group)
                                for s in shards]))
