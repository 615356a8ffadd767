"""Gradient wire compression: the per-tensor casts and the bucket codecs.

Counterpart of ``horovod_tpu/ops/compression.py``.  Two layers:

1. The **legacy per-tensor API** (:class:`Compressor`, :class:`Compression`,
   ``:88-160``): ``compress(tensor) -> (tensor, ctx)`` before the wire,
   ``decompress(tensor, ctx)`` after; ``none``, ``fp16`` (clamped to
   ±65504, so one rank's overflow cannot spread an inf through the sum)
   and ``bf16``.  As in the reference torch binding, the casts take f32
   and f64 tensors and leave every other dtype as it is.
2. The **bucket codecs** (:class:`BucketCodec` and its subclasses,
   ``:242-577``) on the flat buckets of a
   :class:`~horovod_tpu_torch.ops.fusion.ReduceScatterPlan`, over both
   phases of the sharded-update wire: the reduce-scatter of gradients
   and the all-gather of updates.  ``int8`` quantizes each bucket to
   affine uint8 with error feedback (the round-off of step t is added to
   step t+1's transmission); ``powersgd`` sends 2-D leaves as a rank-R
   power iteration with a warm-started right factor, and casts the rest
   to bf16.

========== =========== ======= ====================================
codec      wire bytes  state   mechanism
========== =========== ======= ====================================
none       1x          --      pass-through (bit-exact)
bf16       1/2x        --      bfloat16 cast
fp16       1/2x        --      float16 cast, clamped to +-65504
int8       ~1/4x       EF      per-bucket affine uint8 quantization
powersgd   ~R(m+n)/mn  EF + Q  rank-R power iteration (2-D leaves)
========== =========== ======= ====================================

Codec state (:class:`CodecState`) lives on each rank as that rank's own
piece: ``rs[b]`` the reduce-scatter residual over the whole padded
bucket ``(padded_size(b),)``, ``ag[b]`` the all-gather residual of the
shard this rank sends ``(shard_size(b),)``, ``factors[b]`` PowerSGD's
``(n, rank)`` factor, the same on every rank.  The reference's GLOBAL
layout (``rs`` of ``N * padded_size``, ``ag`` of ``padded_size``) is what
:meth:`BucketCodec.init_global_state` builds and
:meth:`BucketCodec.reshard_state` takes; :func:`local_state` cuts a
rank's piece out of it and :func:`gather_state` puts the pieces back
together over a group.

Every rank decodes the same transmitted bytes (the exchanged uint8
shards, the gathered update shards), so the decoded means and the
gathered updates are the same on every rank.  The bucket collectives of
one call are all issued before the first is waited on.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import time
from typing import Callable, ClassVar, List, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import config, telemetry
from horovod_tpu_torch.ops import _threefry, fusion

log = logging.getLogger(__name__)

# Largest finite float16 value: a cast of anything bigger gives inf.
FP16_MAX = 65504.0

_warned_bad_env = False


# ---------------------------------------------------------------------------
# Legacy per-tensor API (reference :88-160).
# ---------------------------------------------------------------------------

class Compressor:
    """Interface: ``compress`` before the wire, ``decompress`` after."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Pass-through."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def _clip(cls, tensor):
        return tensor

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype in (torch.float32, torch.float64):
            return cls._clip(tensor).to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """f32/f64 -> float16 on the wire, clamped to ±65504 first: an
    unclamped cast maps larger values to inf, and one rank's inf poisons
    every rank's sum."""
    wire_dtype = torch.float16

    @classmethod
    def _clip(cls, tensor):
        return tensor.clamp(-FP16_MAX, FP16_MAX)


class BF16Compressor(_CastCompressor):
    """f32/f64 -> bfloat16 on the wire (f32's exponent range: no clamp)."""
    wire_dtype = torch.bfloat16


class Compression:
    """Optional wire compression for the per-leaf paths."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor


# ---------------------------------------------------------------------------
# Codec state.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CodecState:
    """A wire codec's state for one plan, per bucket (None where the codec
    keeps nothing): ``rs``, ``ag`` and ``factors`` (module docstring)."""
    rs: Tuple[Optional[torch.Tensor], ...]
    ag: Tuple[Optional[torch.Tensor], ...]
    factors: Tuple[Optional[torch.Tensor], ...]

    def __post_init__(self):
        self.rs, self.ag = tuple(self.rs), tuple(self.ag)
        self.factors = tuple(self.factors)

    def __repr__(self):
        live = sum(x is not None for x in self.rs + self.ag + self.factors)
        return f"CodecState(buckets={len(self.rs)}, live_leaves={live})"


def zero_residuals(state: Optional[CodecState]) -> Optional[CodecState]:
    """Every error-feedback residual zeroed, the PowerSGD factors kept:
    the state a checkpoint restore starts from."""
    if state is None:
        return None

    def z(group):
        return tuple(None if a is None else torch.zeros_like(a)
                     for a in group)

    return CodecState(z(state.rs), z(state.ag), state.factors)


def local_state(state: Optional[CodecState], plan,
                index: int) -> Optional[CodecState]:
    """Rank ``index``'s piece of a state in the reference's global layout."""
    if state is None:
        return None
    rs = tuple(None if r is None else
               r.reshape(plan.axis_size, -1)[index].clone()
               for r in state.rs)
    ag = tuple(None if a is None else
               plan.shard_slice(b, a, index).clone()
               for b, a in enumerate(state.ag))
    return CodecState(rs, ag, state.factors)


def gather_state(state: Optional[CodecState], plan,
                 group=None) -> Optional[CodecState]:
    """Every rank's piece of ``state`` over ``group`` in the reference's
    global layout (a collective: every rank of the group calls it)."""
    if state is None:
        return None
    rs = [None if r is None else fusion.start_all_gather(r, group)
          for r in state.rs]
    ag = [None if a is None else fusion.start_all_gather(a, group)
          for a in state.ag]
    done = [None if x is None else fusion.wait_all([x])[0]
            for x in rs + ag]
    nb = len(state.rs)
    return CodecState(done[:nb], done[nb:], state.factors)


# ---------------------------------------------------------------------------
# Affine uint8 quantization (per-bucket scale and offset).
# ---------------------------------------------------------------------------

def _affine_qparams(m: torch.Tensor):
    """Scale and offset over [0, 255].  A constant bucket (span 0)
    quantizes exactly: the scale falls back to 1 and every code is 0."""
    lo = m.min().float()
    span = m.max().float() - lo
    scale = torch.where(span > 0, span / 255.0, torch.ones_like(span))
    return scale, lo


def _affine_encode(m: torch.Tensor, scale, lo) -> torch.Tensor:
    q = torch.round((m.float() - lo) / scale)
    return q.clamp(0.0, 255.0).to(torch.uint8)


def _affine_decode(q: torch.Tensor, scale, lo) -> torch.Tensor:
    return q.float() * scale + lo


def _is_float(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point


# ---------------------------------------------------------------------------
# Bucket codecs.
# ---------------------------------------------------------------------------

# A started bucket collective: call it (after every bucket has been
# started) for the bucket's result.
Finish = Callable[[], tuple]


def _started(work_out, then: Callable) -> Finish:
    def finish():
        return then(fusion.wait_all([work_out])[0])
    return finish


@dataclasses.dataclass(frozen=True)
class BucketCodec:
    """Base class: a per-bucket wire codec (hashable).

    Subclasses implement :meth:`start_reduce_scatter_bucket` and
    :meth:`start_all_gather_bucket` for one flat padded bucket over a
    process group, plus the plan and state hooks; the plan-wide functions
    below loop over a plan's buckets and keep the byte counts."""

    name: ClassVar[str] = "none"
    stateful: ClassVar[bool] = False

    # -- plan hooks ---------------------------------------------------------
    def solo_leaf(self, shape: Tuple[int, ...], dtype) -> bool:
        """True to claim a whole leaf as its own (never chunked) bucket."""
        del shape, dtype
        return False

    def _tracks_rs(self, b: int, plan) -> bool:
        del b, plan
        return False

    def _tracks_ag(self, b: int, plan) -> bool:
        del b, plan
        return False

    def _init_factor(self, b: int, plan, device=None):
        del b, plan, device
        return None

    # -- state lifecycle ----------------------------------------------------
    def init_state(self, plan, device=None) -> Optional[CodecState]:
        """This rank's fresh (zero-residual) state."""
        if not self.stateful:
            return None
        nb = len(plan.buckets)
        f32 = dict(dtype=torch.float32, device=device)
        return CodecState(
            tuple(torch.zeros(plan.padded_size(b), **f32)
                  if self._tracks_rs(b, plan) else None for b in range(nb)),
            tuple(torch.zeros(plan.shard_size(b), **f32)
                  if self._tracks_ag(b, plan) else None for b in range(nb)),
            tuple(self._init_factor(b, plan, device) for b in range(nb)))

    def init_global_state(self, plan, device=None) -> Optional[CodecState]:
        """A fresh state in the reference's global layout
        (``init_state`` of ``horovod_tpu/ops/compression.py:276``)."""
        if not self.stateful:
            return None
        nb, n = len(plan.buckets), plan.axis_size
        f32 = dict(dtype=torch.float32, device=device)
        return CodecState(
            tuple(torch.zeros(n * plan.padded_size(b), **f32)
                  if self._tracks_rs(b, plan) else None for b in range(nb)),
            tuple(torch.zeros(plan.padded_size(b), **f32)
                  if self._tracks_ag(b, plan) else None for b in range(nb)),
            tuple(self._init_factor(b, plan, device) for b in range(nb)))

    def reshard_state(self, state: Optional[CodecState], old_plan,
                      new_plan) -> Optional[CodecState]:
        """Re-bucket a state in the GLOBAL layout for another axis size,
        keeping the PENDING error feedback (reference ``:308``).

        In mean units the pending reduce-scatter error is ``sum_r rs[r] /
        N``: the per-rank residuals are summed to one per-leaf vector,
        scaled by ``N_new / N_old`` and given to rank 0 of the new layout.
        The all-gather residual is one global vector already and is only
        re-bucketed.  PowerSGD factors carry over by leaf."""
        if not self.stateful:
            return None
        if state is None:
            return self.init_global_state(new_plan)
        n_old, n_new = old_plan.axis_size, new_plan.axis_size
        nb_old, nb_new = len(old_plan.buckets), len(new_plan.buckets)
        dev = next((x.device for x in state.rs + state.ag if x is not None),
                   None)
        f32 = dict(dtype=torch.float32, device=dev)

        pend = [state.rs[b].reshape(n_old, -1).sum(0).float()
                if state.rs[b] is not None
                else torch.zeros(old_plan.padded_size(b), **f32)
                for b in range(nb_old)]
        pend_leaves = [leaf.float() * (n_new / n_old)
                       for leaf in old_plan.split(pend)]
        new_rs_rows = new_plan.concat(pend_leaves)

        ag = [state.ag[b].float() if state.ag[b] is not None
              else torch.zeros(old_plan.padded_size(b), **f32)
              for b in range(nb_old)]
        new_ag_flats = new_plan.concat(old_plan.split(ag))

        old_factor_by_leaf = {
            old_plan.buckets[b][0][0]: state.factors[b]
            for b in range(nb_old) if state.factors[b] is not None}

        rs, ag_out, factors = [], [], []
        for b in range(nb_new):
            if self._tracks_rs(b, new_plan):
                row0 = new_rs_rows[b].float()
                rest = torch.zeros((n_new - 1) * new_plan.padded_size(b),
                                   **f32)
                rs.append(torch.cat([row0, rest]) if n_new > 1 else row0)
            else:
                rs.append(None)
            ag_out.append(new_ag_flats[b].float()
                          if self._tracks_ag(b, new_plan) else None)
            fresh = self._init_factor(b, new_plan, dev)
            if fresh is not None:
                carried = old_factor_by_leaf.get(new_plan.buckets[b][0][0])
                factors.append(carried if carried is not None
                               and tuple(carried.shape) == tuple(fresh.shape)
                               else fresh)
            else:
                factors.append(None)
        return CodecState(rs, ag_out, factors)

    # -- wire ops -------------------------------------------------------------
    def start_reduce_scatter_bucket(self, b: int, flat, plan, group,
                                    mean: bool, residual,
                                    factor) -> Finish:
        """Start one bucket's compressed reduce-scatter; the returned
        ``finish()`` gives ``(shard, new_residual, new_factor,
        wire_bytes)``."""
        raise NotImplementedError

    def start_all_gather_bucket(self, b: int, shard, plan, group,
                                residual) -> Finish:
        """Start one bucket's compressed all-gather; ``finish()`` gives
        ``(full_flat, new_residual, wire_bytes)``."""
        raise NotImplementedError


def _plain_reduce_scatter(b, flat, plan, group, mean) -> Finish:
    wire = plan.padded_size(b) * flat.element_size()

    def then(shard):
        if mean:
            shard = fusion.scale(shard, 1.0 / plan.axis_size)
        return shard, None, None, wire
    return _started(fusion.start_reduce_scatter(flat, group), then)


def _plain_all_gather(b, shard, plan, group) -> Finish:
    wire = plan.padded_size(b) * shard.element_size()
    return _started(fusion.start_all_gather(shard, group),
                    lambda full: (full, None, wire))


@dataclasses.dataclass(frozen=True)
class NoneCodec(BucketCodec):
    """Bit-exact pass-through: the plan-wide functions hand the plan to
    :func:`fusion.fused_reduce_scatter` / :func:`fusion.fused_all_gather`."""

    name: ClassVar[str] = "none"
    stateful: ClassVar[bool] = False


@dataclasses.dataclass(frozen=True)
class CastCodec(BucketCodec):
    """Stateless cast on the wire (bf16, or fp16 clamped to ±65504): half
    the bytes of an f32 bucket; the sum runs at wire precision."""

    wire: str = "bfloat16"
    stateful: ClassVar[bool] = False

    @property
    def name(self) -> str:  # type: ignore[override]
        return "bf16" if self.wire == "bfloat16" else "fp16"

    @property
    def wire_dtype(self) -> torch.dtype:
        return fusion.torch_dtype(self.wire)

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.wire_dtype or not _is_float(x.dtype):
            return x
        if self.wire_dtype == torch.float16:
            x = x.clamp(-FP16_MAX, FP16_MAX)
        return x.to(self.wire_dtype)

    def start_reduce_scatter_bucket(self, b, flat, plan, group, mean,
                                    residual, factor):
        dtype = flat.dtype
        w = self._to_wire(flat)
        wire = plan.padded_size(b) * w.element_size()

        def then(shard):
            shard = shard.to(dtype)
            if mean:
                shard = fusion.scale(shard, 1.0 / plan.axis_size)
            return shard, None, None, wire
        return _started(fusion.start_reduce_scatter(w, group), then)

    def start_all_gather_bucket(self, b, shard, plan, group, residual):
        dtype = shard.dtype
        w = self._to_wire(shard)
        wire = plan.padded_size(b) * w.element_size()
        return _started(fusion.start_all_gather(w, group),
                        lambda full: (full.to(dtype), None, wire))


def _start_qparams_gather(scale, lo, group):
    return fusion.start_all_gather(torch.stack([scale, lo]), group)


@dataclasses.dataclass(frozen=True)
class Int8Codec(BucketCodec):
    """Per-bucket affine uint8 quantization with error feedback on both
    phases (about 4x fewer bytes than an f32 bucket).

    Reduce-scatter: each rank quantizes its whole (residual-corrected)
    bucket and the ranks exchange uint8 shards with ``all_to_all``, plus
    one ``(scale, lo)`` pair per rank; each rank decodes the N shards it
    received at their senders' qparams and sums in f32, so the error does
    not compound across ranks, and keeps what the round dropped as its
    residual.  All-gather: each rank quantizes its update shard, the
    uint8 shards are gathered and every rank decodes the same bytes; the
    sender keeps the round-off.  Buckets of integers pass through
    uncompressed."""

    name: ClassVar[str] = "int8"
    stateful: ClassVar[bool] = True

    def _tracks_rs(self, b, plan):
        return _is_float(plan.bucket_dtype(b))

    def _tracks_ag(self, b, plan):
        return _is_float(plan.bucket_dtype(b))

    def start_reduce_scatter_bucket(self, b, flat, plan, group, mean,
                                    residual, factor):
        if residual is None:
            return _plain_reduce_scatter(b, flat, plan, group, mean)
        dtype, n = flat.dtype, plan.axis_size
        m = flat.float() + residual
        scale, lo = _affine_qparams(m)
        q = _affine_encode(m, scale, lo)
        new_res = m - _affine_decode(q, scale, lo)
        del m
        s = plan.shard_size(b)
        # Row i of ``ex`` is source rank i's uint8 shard for this rank.
        ex = torch.empty_like(q)
        fusion.all_to_all_calls.add()
        work = dist.all_to_all_single(ex, q, group=group, async_op=True)
        prm = _start_qparams_gather(scale, lo, group)

        def finish():
            got, prms = fusion.wait_all([(work, ex), prm])
            prms = prms.view(n, 2)
            tot = (got.view(n, s).float() * prms[:, 0:1]
                   + prms[:, 1:2]).sum(0)
            if mean:
                tot = tot / n
            return tot.to(dtype), new_res, None, plan.padded_size(b) + 8
        return finish

    def start_all_gather_bucket(self, b, shard, plan, group, residual):
        if residual is None:
            return _plain_all_gather(b, shard, plan, group)
        dtype, n = shard.dtype, plan.axis_size
        m = shard.float() + residual
        scale, lo = _affine_qparams(m)
        q = _affine_encode(m, scale, lo)
        new_res = m - _affine_decode(q, scale, lo)
        qs = fusion.start_all_gather(q, group)
        prm = _start_qparams_gather(scale, lo, group)

        def finish():
            got, prms = fusion.wait_all([qs, prm])
            prms = prms.view(n, 2)
            full = (got.view(n, -1).float() * prms[:, 0:1]
                    + prms[:, 1:2]).reshape(-1)
            return full.to(dtype), new_res, plan.padded_size(b) + 8 * n
        return finish


@dataclasses.dataclass(frozen=True)
class PowerSGDCodec(BucketCodec):
    """PowerSGD low-rank transport (Vogels et al. 2019) for 2-D leaves;
    the bf16 cast everywhere else.

    A leaf that is 2-D, floating and at least ``2 * rank`` in both dims
    gets its own whole-leaf bucket (``plan.lowrank``).  Per step, with
    ``M_r`` the rank's residual-corrected ``(m, n)`` gradient and ``Q``
    the warm-started ``(n, R)`` factor: ``P = mean_r(M_r Q)`` (one small
    all-reduce), ``P̂`` its QR's Q, ``Q' = mean_r(M_r^T P̂)`` (a second),
    and every rank decodes ``P̂ Q'^T ≈ mean_r M_r`` alike; ``M_r -
    decoded`` is the residual and ``Q'`` the next step's factor.  The
    wire carries ``R(m + n)`` floats instead of ``m n``; the all-gather
    phase rides the bf16 cast.

    The first factor is the reference's draw,
    ``jax.random.normal(jax.random.PRNGKey(0x9D + 31 * b), (n, R))``,
    reproduced bit for bit without JAX (:mod:`._threefry`)."""

    rank: int = 4
    name: ClassVar[str] = "powersgd"
    stateful: ClassVar[bool] = True

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"powersgd rank must be >= 1, got {self.rank}")

    @property
    def _cast(self) -> CastCodec:
        return CastCodec("bfloat16")

    def solo_leaf(self, shape, dtype):
        return (len(shape) == 2 and _is_float(dtype)
                and min(shape) >= 2 * self.rank)

    def _tracks_rs(self, b, plan):
        return b in plan.lowrank

    def _init_factor(self, b, plan, device=None):
        if b not in plan.lowrank:
            return None
        _, n_cols = plan.bucket_leaf_shape(b)
        draw = _threefry.normal(0x9D + 31 * b, (n_cols, self.rank))
        return torch.from_numpy(draw).to(device)

    def start_reduce_scatter_bucket(self, b, flat, plan, group, mean,
                                    residual, factor):
        if b not in plan.lowrank:
            return self._cast.start_reduce_scatter_bucket(
                b, flat, plan, group, mean, None, None)
        dtype, n_ranks = flat.dtype, plan.axis_size
        m_rows, n_cols = plan.bucket_leaf_shape(b)
        size = m_rows * n_cols
        mat = (flat[:size].float() + residual[:size]).view(m_rows, n_cols)
        del flat
        p = mat @ factor
        fusion.allreduce_calls.add()
        work = dist.all_reduce(p, group=group, async_op=True)

        def finish():
            work.wait()
            p_hat, _ = torch.linalg.qr(p / n_ranks)
            q_new = mat.T @ p_hat
            fusion.allreduce_calls.add()
            dist.all_reduce(q_new, group=group)
            q_new = q_new / n_ranks
            decoded = (p_hat @ q_new.T).reshape(-1)       # mean_r M_r
            pad = plan.pad_elems(b)
            zeros = torch.zeros(pad, dtype=torch.float32, device=mat.device)
            new_res = mat.reshape(-1) - decoded
            full = decoded if mean else decoded * n_ranks
            if pad:
                new_res = torch.cat([new_res, zeros])
                full = torch.cat([full, zeros])
            shard = plan.shard_slice(b, full.to(dtype),
                                     dist.get_rank(group)).clone()
            wire = (m_rows + n_cols) * self.rank * 4
            return shard, new_res, q_new, wire
        return finish

    def start_all_gather_bucket(self, b, shard, plan, group, residual):
        return self._cast.start_all_gather_bucket(b, shard, plan, group,
                                                  None)


# ---------------------------------------------------------------------------
# Codec resolution: names, legacy Compression classes, HOROVOD_COMPRESSION.
# ---------------------------------------------------------------------------

_CODEC_SPEC = re.compile(r"powersgd:(\d+)")


def parse_codec(spec: str) -> BucketCodec:
    """``"none"|"bf16"|"fp16"|"int8"|"powersgd"|"powersgd:R"`` -> codec."""
    s = str(spec).strip().lower()
    if s in ("", "none"):
        return NoneCodec()
    if s == "bf16":
        return CastCodec("bfloat16")
    if s == "fp16":
        return CastCodec("float16")
    if s == "int8":
        return Int8Codec()
    if s == "powersgd":
        return PowerSGDCodec()
    m = _CODEC_SPEC.fullmatch(s)
    if m:
        return PowerSGDCodec(rank=int(m.group(1)))
    raise ValueError(
        f"unknown compression codec {spec!r}: expected none, bf16, fp16, "
        f"int8, powersgd or powersgd:<rank>")


def resolve_codec(compression=None) -> BucketCodec:
    """Every accepted ``compression=`` form as a :class:`BucketCodec`:
    codecs pass through, strings are parsed, the legacy
    :class:`Compression` classes map to their codec twins, and the
    DEFAULT forms (``None`` and ``Compression.none``) consult
    ``HOROVOD_COMPRESSION``.  An explicit codec (even ``"none"``) wins
    over the environment.  An unparseable environment value warns once
    and falls back to none."""
    global _warned_bad_env
    c = compression
    consult_env = (compression is None
                   or (isinstance(compression, type)
                       and issubclass(compression, NoneCompressor)))
    if isinstance(c, BucketCodec):
        pass
    elif isinstance(c, str):
        c = parse_codec(c)
    elif c is None:
        c = NoneCodec()
    elif isinstance(c, type) and issubclass(c, Compressor):
        if issubclass(c, FP16Compressor):
            c = CastCodec("float16")
        elif issubclass(c, BF16Compressor):
            c = CastCodec("bfloat16")
        elif issubclass(c, NoneCompressor):
            c = NoneCodec()
        else:
            raise TypeError(
                f"custom Compressor subclass {c.__name__} has no bucket-"
                f"codec equivalent; pass a BucketCodec instance instead")
    else:
        raise TypeError(
            f"compression must be a BucketCodec, a codec name string, or "
            f"one of the Compression.* classes; got {c!r}")
    if consult_env and isinstance(c, NoneCodec):
        env = config.compression()
        if env:
            try:
                c = parse_codec(env)
            except ValueError as e:
                if not _warned_bad_env:
                    _warned_bad_env = True
                    log.warning("%s=%r ignored: %s", "HOROVOD_COMPRESSION",
                                env, e)
    return c


_LINK_LEVELS = ("flat", "local", "cross")
_warned_bad_link_env = False


def link_codec(level: str, compression=None) -> BucketCodec:
    """The codec for one link level (``flat``, ``local`` or ``cross``):
    ``HOROVOD_TRANSPORT_CODECS="cross:fp16,local:none"`` overrides per
    level; a level it does not name (and any parse error) takes
    :func:`resolve_codec`'s answer for ``compression``."""
    global _warned_bad_link_env
    base = resolve_codec(compression)
    if level not in _LINK_LEVELS:
        raise ValueError(
            f"unknown link level {level!r}: expected one of {_LINK_LEVELS}")
    spec = config.env_str("HOROVOD_TRANSPORT_CODECS").strip()
    if not spec:
        return base
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        lvl, sep, codec_spec = part.partition(":")
        if not sep or lvl.strip() not in _LINK_LEVELS:
            if not _warned_bad_link_env:
                _warned_bad_link_env = True
                log.warning(
                    "HOROVOD_TRANSPORT_CODECS=%r ignored entry %r: "
                    "expected level:codec with level in %s",
                    spec, part, _LINK_LEVELS)
            continue
        if lvl.strip() == level:
            try:
                return parse_codec(codec_spec)
            except ValueError as e:
                if not _warned_bad_link_env:
                    _warned_bad_link_env = True
                    log.warning("HOROVOD_TRANSPORT_CODECS=%r ignored: %s",
                                spec, e)
                return base
    return base


def as_legacy(codec: BucketCodec):
    """The per-tensor :class:`Compressor` of a stateless codec, or None
    when the codec has no per-tensor form (int8 and powersgd need
    bucket state)."""
    if isinstance(codec, NoneCodec):
        return NoneCompressor
    if isinstance(codec, CastCodec):
        return (FP16Compressor if codec.wire_dtype == torch.float16
                else BF16Compressor)
    return None


# ---------------------------------------------------------------------------
# The plan-wide compressed wire.
# ---------------------------------------------------------------------------

def _record_compression(codec_name: str, bytes_in: int, bytes_out: int,
                        seconds: float) -> None:
    """The codec series (reference ``_record_compression``), once per
    call: bytes in and out, their ratio for the latest application, and
    the host seconds spent issuing the compressed collective."""
    if not telemetry.enabled() or not bytes_in:
        return
    telemetry.counter(
        "hvd_compression_bytes_in_total",
        "Uncompressed payload bytes entering wire codecs (trace-time)",
        codec=codec_name).inc(bytes_in)
    telemetry.counter(
        "hvd_compression_bytes_out_total",
        "Compressed payload bytes leaving wire codecs (trace-time)",
        codec=codec_name).inc(bytes_out)
    telemetry.gauge(
        "hvd_compression_ratio",
        "bytes_in / bytes_out of the most recent codec application",
        codec=codec_name).set(bytes_in / max(bytes_out, 1))
    telemetry.counter(
        "hvd_compression_encode_seconds_total",
        "Host seconds spent building compressed collectives (trace-time)",
        codec=codec_name).inc(max(seconds, 0.0))


def _padded_bytes(plan) -> int:
    return sum(plan.padded_size(b) * plan.bucket_dtype(b).itemsize
               for b in range(len(plan.buckets)))


def compressed_reduce_scatter(leaves, group, codec: BucketCodec, *, plan,
                              state: Optional[CodecState] = None,
                              mean: bool = True):
    """Codec-aware :func:`fusion.fused_reduce_scatter` over a prebuilt
    plan: returns ``(shards, new_state)``.  The none codec is the fused
    path, bit for bit."""
    codec = codec if codec is not None else NoneCodec()
    if isinstance(codec, NoneCodec):
        shards, _ = fusion.fused_reduce_scatter(leaves, group, mean=mean,
                                                plan=plan)
        return shards, state
    t0 = time.perf_counter() if telemetry.enabled() else 0.0
    flats = plan.concat(list(leaves))
    nb = len(plan.buckets)
    rs = list(state.rs) if state is not None else [None] * nb
    factors = list(state.factors) if state is not None else [None] * nb
    ag = tuple(state.ag) if state is not None else (None,) * nb
    pending = []
    for b in range(nb):
        flat, flats[b] = flats[b], None
        pending.append(codec.start_reduce_scatter_bucket(
            b, flat, plan, group, mean, rs[b], factors[b]))
    shards: List[torch.Tensor] = []
    wire_bytes = 0
    for b in range(nb):
        # Drop each finished bucket's closure, and what it holds, at once.
        finish, pending[b] = pending[b], None
        shard, new_r, new_f, wire = finish()
        shards.append(shard)
        if new_r is not None:
            rs[b] = new_r
        if new_f is not None:
            factors[b] = new_f
        wire_bytes += wire
    fusion.record_plan("reduce_scatter", plan)
    fusion.record_collective_bytes("reduce_scatter", codec.name, wire_bytes)
    if telemetry.enabled():
        _record_compression(codec.name, _padded_bytes(plan), wire_bytes,
                            time.perf_counter() - t0)
    return shards, (CodecState(rs, ag, factors) if codec.stateful else None)


def compressed_all_gather(shards, plan, group, codec: BucketCodec,
                          state: Optional[CodecState] = None):
    """Codec-aware :func:`fusion.fused_all_gather`: each update shard
    compressed on the wire, gathered, decoded alike on every rank.
    Returns ``(leaves, new_state)``."""
    codec = codec if codec is not None else NoneCodec()
    if isinstance(codec, NoneCodec):
        return fusion.fused_all_gather(shards, plan, group), state
    shards = list(shards)
    if len(shards) != len(plan.buckets):
        raise ValueError(f"plan has {len(plan.buckets)} buckets, got "
                         f"{len(shards)} shards")
    t0 = time.perf_counter() if telemetry.enabled() else 0.0
    nb = len(plan.buckets)
    ag = list(state.ag) if state is not None else [None] * nb
    pending = [codec.start_all_gather_bucket(b, shard, plan, group, ag[b])
               for b, shard in enumerate(shards)]
    fulls: List[torch.Tensor] = []
    wire_bytes = 0
    for b in range(nb):
        finish, pending[b] = pending[b], None
        full, new_r, wire = finish()
        fulls.append(full)
        if new_r is not None:
            ag[b] = new_r
        wire_bytes += wire
    fusion.record_collective_bytes("all_gather", codec.name, wire_bytes)
    if telemetry.enabled():
        _record_compression(codec.name, _padded_bytes(plan), wire_bytes,
                            time.perf_counter() - t0)
    new_state = None
    if codec.stateful:
        new_state = CodecState(
            state.rs if state is not None else (None,) * nb, ag,
            state.factors if state is not None else (None,) * nb)
    return plan.split(fulls), new_state


def cross_level_psum(x: torch.Tensor, group, codec=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` with an optional stateless wire
    codec: the per-level codec of the two-level plane ("int8 between
    hosts, none within").  ``None``/``"none"``, ``"bf16"``, ``"fp16"`` or
    ``"int8"`` (or their codec instances).

    The int8 form quantizes against a SHARED scale (the max over the
    group of each rank's absmax, one scalar on the wire), so every rank
    decodes alike, sums in int32 (2^23 ranks of ±127 cannot overflow)
    and rescales once.  Stateful codecs (powersgd) raise: their error
    feedback belongs to the plan state (:func:`compressed_reduce_scatter`),
    not one hop.  Returns a new tensor; ``x`` is not written."""
    codec = resolve_codec(codec if codec is not None else "none")
    esize = x.element_size()
    if isinstance(codec, NoneCodec):
        fusion.record_collective_bytes("cross_psum", "none",
                                       x.numel() * esize, level="dcn")
        out = x.clone()
        fusion.allreduce_calls.add()
        dist.all_reduce(out, group=group)
        return out
    if isinstance(codec, CastCodec):
        w = x.to(codec.wire_dtype)
        if w is x:
            w = w.clone()
        fusion.record_collective_bytes("cross_psum", codec.name,
                                       x.numel() * w.element_size(),
                                       level="dcn")
        fusion.allreduce_calls.add()
        dist.all_reduce(w, group=group)
        return w.to(x.dtype)
    if isinstance(codec, Int8Codec):
        scale = x.abs().max().float()
        fusion.allreduce_calls.add()
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        scale = scale / 127.0
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.round(x.float() / safe).clamp(-127, 127).to(torch.int8)
        total = q.to(torch.int32)
        fusion.record_collective_bytes("cross_psum", codec.name, x.numel(),
                                       level="dcn")
        fusion.allreduce_calls.add()
        dist.all_reduce(total, group=group)
        return (total.float() * safe).to(x.dtype)
    raise ValueError(
        f"cross_level_psum supports stateless codecs (none/bf16/fp16/int8); "
        f"got {codec.name!r} — stateful codecs need plan-level error "
        f"feedback, use compressed_reduce_scatter instead")


def compressed_allreduce(leaves, group, codec: BucketCodec, *, plan,
                         state: Optional[CodecState] = None,
                         mean: bool = True):
    """The compressed reduce-scatter and all-gather back to back (the
    replicated-update step with a stateful codec).  Returns ``(leaves,
    new_state)``."""
    shards, state = compressed_reduce_scatter(
        leaves, group, codec, plan=plan, state=state, mean=mean)
    return compressed_all_gather(shards, plan, group, codec, state)
