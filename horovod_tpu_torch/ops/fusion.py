"""Tensor fusion for the gradient all-reduce.

Counterpart of ``horovod_tpu/ops/fusion.py`` (``parse_size_bytes``
``:93``, ``fusion_threshold_bytes`` ``:106``, ``max_bucket_bytes`` ``:137``,
``_bucket_leaves`` ``:191``,
``fused_psum`` ``:280``, ``fused_pytree_mean`` ``:327``).  Leaves are
grouped by dtype into buckets up to the threshold; each bucket is
flattened into one buffer, reduced with ONE ``dist.all_reduce`` and split
back.  The bucketing walk is the reference's, leaf for leaf, so the same
leaf list gives the same buckets in both packages.
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import config
from horovod_tpu_torch.ops._build import CallCounter

log = logging.getLogger(__name__)

# Reference default: 64 MB (the JAX package's fusion.py).
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024

_SIZE_SUFFIXES = {
    "": 1, "b": 1,
    "k": 1024, "kb": 1024, "kib": 1024,
    "m": 1024 ** 2, "mb": 1024 ** 2, "mib": 1024 ** 2,
    "g": 1024 ** 3, "gb": 1024 ** 3, "gib": 1024 ** 3,
}

# One count per bucket all-reduce (start_bucket), whoever asked for it, so
# a run can show that the gradient mean went through the collective
# library.
allreduce_calls = CallCounter("fusion.all_reduce")

_warned_bad_threshold = False


def parse_size_bytes(value: str) -> Optional[int]:
    """``"64mb"`` / ``"32MiB"`` / ``"67108864"`` -> bytes, or None when the
    string is not a size.  Multipliers are binary (64 MB == 2**26)."""
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*", str(value))
    if not m:
        return None
    mult = _SIZE_SUFFIXES.get(m.group(2).lower())
    if mult is None:
        return None
    return int(float(m.group(1)) * mult)


def fusion_threshold_bytes() -> int:
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
                 device: Optional[torch.device] = None):
    """Start ONE async all-reduce of a bucket: ``tensors`` flattened into
    one buffer on ``device`` (default: where they lie).

    Returns ``(work, finish)``: ``work`` is None for an empty bucket, and
    ``finish()``, called once the work is complete, gives the reduced
    tensors in order, shaped as the inputs.  The scale factors and the
    ``mean`` divide by ``size`` run in the bucket's dtype, as the
    reference's SPMD plane computes (``fused_psum``); the control plane
    passes neither and scales each result as numpy would.
    """
    # cat copies, so the reduction never writes into a caller's tensor.
    flat = torch.cat([t.reshape(-1).to(device) for t in tensors])
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
    started = [(bucket, start_bucket(
        [tensors[i] for i in bucket], group, n, mean=mean,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor))
        for bucket in _bucket_leaves(tensors, threshold)]
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
