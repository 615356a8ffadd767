"""Flash attention: exact attention with an online softmax, forward and
backward.

Counterpart of ``horovod_tpu/ops/flash_attention.py``.  On CUDA tensors the
forward, dQ and dK/dV passes are three hand-written Hopper kernels
(``csrc/flash_attention.cu`` for bf16 and f16, ``csrc/flash_attention_f32.cu``
for f32); on CPU tensors they are the plain PyTorch
versions below (``_fwd_parts_plain``, ``_bwd_dq_plain``,
``_bwd_dkv_plain``), the same blockwise math.  The plain versions serve the
CPU and the checks against the kernels; nothing on the card's path falls
back to them.

Contract, as the reference's:

* ``flash_attention(q, k, v, causal=True, scale=None, block_q=None,
  block_k=None, segment_ids=None)`` on ``[B, T, H, D]``; ``scale``
  defaults to ``D ** -0.5`` and multiplies the scores after the product.
* ``T`` must divide by the effective blocks (``_eff_blocks``), with the
  reference's ``ValueError`` otherwise.  The blocks are checked but the
  kernels tile for Hopper (128-row q tiles in the forward and dQ, 128-key
  tiles in dK/dV; 64 of each in the f32 kernels): the reference's 1024
  blocks are a v5e VMEM choice.
* ``_fwd_parts`` returns ``(o, m, l)``: ``m`` the row max of the scaled
  scores and ``l`` the UNnormalized row sum of ``exp(s - m)``, both
  ``[B*H, 1, T]`` f32.  ``_bwd_parts`` takes the global ``(m, l)``.  Both
  take separate q- and k-side segment ids (ring attention passes the
  rotated k side).
* Fully masked rows give ``o = 0`` and zero gradients (``l == 0`` counts
  as a denominator of 1).

The kernels take every float dtype and head dim the reference's kernels
take (``_kernel_plan``): bf16 and f16 run the Hopper kernels, f32 those
of ``csrc/flash_attention_f32.cu`` (products to about f32 accuracy, as
the reference multiplies its f32-upcast operands: three TF32 passes on
the tensor cores up to D 256, f32 FMA above).  Head dims 16, 32, 64, 128
and 256 have instances of their own; any other ``D <= 256`` is padded
with zero columns to the next one, and any ``D > 256`` to the next
multiple of 256, which the wide instances take (zero columns of q and k
leave the scores unchanged, those of v give zero columns of o), with the
caller's scale, and the outputs are sliced back.
``o``, ``dq``, ``dk`` and ``dv`` come back in the operands' dtype, ``m``
and ``l`` in f32.  f64 on the card raises; nothing on a CUDA tensor
falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from horovod_tpu_torch.ops import _build

# One count per kernel launch (the CPU route does not count).
fwd_launches = _build.CallCounter("flash_attention.fwd", kernel=True)
dq_launches = _build.CallCounter("flash_attention.bwd_dq", kernel=True)
dkv_launches = _build.CallCounter("flash_attention.bwd_dkv", kernel=True)
_TOTALS = {"fwd": fwd_launches, "bwd_dq": dq_launches,
           "bwd_dkv": dkv_launches}

NEG_INF = float("-inf")
# Head dims the kernels are built for (multiples of the 16-deep tensor-core
# product); any other head dim up to the last is padded to the next one.
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
# Above the last, the wide instances take any multiple of WIDE_STEP (the
# column block of their outputs): a head dim is padded to the next one.
WIDE_STEP = 256
# The instance of each dtype the kernels take: bf16 and f16 run the Hopper
# kernels of csrc/flash_attention.cu, f32 those of
# csrc/flash_attention_f32.cu (three TF32 passes; f32 FMA above D 256).
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16",
                 torch.float32: "f32"}


class _InstanceCounters(dict):
    """Launches by ``(kernel, instance, kernel head dim)``: those of
    ``KERNEL_HEAD_DIMS`` from the start, a wide head dim's at its first
    launch (any multiple of ``WIDE_STEP`` is one)."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        for kind in _TOTALS:
            for inst in KERNEL_DTYPES.values():
                for d in KERNEL_HEAD_DIMS:
                    self.__missing__((kind, inst, d))

    def __missing__(self, key):
        kind, inst, d = key
        with self._lock:
            return self.setdefault(key, _build.CallCounter(
                f"flash_attention.{kind}.{inst}.d{d}"))


# Launches by (kernel, instance, kernel head dim), beside the totals above:
# which instance a path ran.
instance_launches = _InstanceCounters()
# Key block of the plain versions: bounds their score block to
# [B*H, T, 128] f32.
_PLAIN_BLOCK_K = 128


# ---------------------------------------------------------------------------
# Shape contract (reference :301 and :525-561)
# ---------------------------------------------------------------------------

def _check_shapes(q, k, v, block_q, block_k):
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes must match, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.dim() != 4:
        raise ValueError(f"flash attention takes [B, T, H, D]; got "
                         f"{tuple(q.shape)}")
    b, t, h, d = q.shape
    if t % block_q != 0 or t % block_k != 0:
        raise ValueError(
            f"sequence length {t} must be divisible by block_q={block_q} "
            f"and block_k={block_k} (pad the sequence)")
    return b, t, h, d


def _auto_block(t: int, head_dim: Optional[int] = None) -> int:
    """The reference's auto block: which T the function accepts.  The
    choice of block itself does not reach the kernels."""
    if t < 128:
        for b in (64, 32, 16, 8):
            if t % b == 0:
                return b
        raise ValueError(
            f"sequence length {t} must be divisible by 8 for the flash "
            f"kernel (pad the sequence)")
    prefs = (512, 256, 128) if (head_dim or 0) > 128 else (1024, 512,
                                                           256, 128)
    for b in prefs:
        if t % b == 0:
            return b
    raise ValueError(
        f"sequence length {t} must be divisible by 128 for auto block "
        f"sizing (pad the sequence, or pass explicit block_q/block_k)")


def _eff_blocks(t, block_q, block_k, head_dim=None):
    bq = _auto_block(t, head_dim) if block_q is None else min(block_q, t)
    bk = _auto_block(t, head_dim) if block_k is None else min(block_k, t)
    return bq, bk


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B*H, T, D]."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d)


def _unfold(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3)


def _seg_rows(seg: Optional[torch.Tensor], bh: int, t: int):
    """Segment ids ([B, T] or [B, 1, T]) as [B*H, T] rows, or None."""
    if seg is None:
        return None
    seg = seg.reshape(-1, t)
    if bh % seg.shape[0]:
        raise ValueError(f"{seg.shape[0]} segment-id rows do not divide "
                         f"{bh} batch*head rows")
    return seg.repeat_interleave(bh // seg.shape[0], dim=0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU route, and what the kernels are held to)
# ---------------------------------------------------------------------------

def _mask(s, q_pos, k_pos, causal, qs, ks):
    """-inf where a (query, key) pair may not attend.  ``s``: [BH, Tq,
    Tk]; ``qs``/``ks``: [BH, Tq] / [BH, Tk] segment ids or None."""
    allowed = None
    if causal:
        allowed = (q_pos[:, None] >= k_pos[None, :])[None]
    if qs is not None:
        seg_ok = qs[:, :, None] == ks[:, None, :]
        allowed = seg_ok if allowed is None else allowed & seg_ok
    if allowed is None:
        return s
    return s.masked_fill(~allowed, NEG_INF)


def _fwd_parts_plain(qf, kf, vf, qseg=None, kseg=None, causal=True,
                     scale=None):
    """Folded-layout forward, the reference's ``_fwd_kernel`` math over key
    blocks in f32: returns ``(o, m, l)``, ``o`` in ``qf.dtype`` and ``m``,
    ``l`` as ``[B*H, 1, T]`` f32."""
    bh, t, d = qf.shape
    scale = d ** -0.5 if scale is None else scale
    q, k, v = qf.float(), kf.float(), vf.float()
    qs, ks = _seg_rows(qseg, bh, t), _seg_rows(kseg, bh, t)
    pos = torch.arange(t, device=qf.device)
    m = torch.full((bh, t), NEG_INF, device=qf.device)
    l = torch.zeros((bh, t), device=qf.device)
    acc = torch.zeros((bh, t, d), device=qf.device)
    for k0 in range(0, t, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, t)
        s = torch.matmul(q, k[:, k0:k1].transpose(1, 2)) * scale
        s = _mask(s, pos, pos[k0:k1], causal, qs,
                  None if ks is None else ks[:, k0:k1])
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.where(s == NEG_INF, 0.0, torch.exp(s - safe_m[..., None]))
        corr = torch.where(m == NEG_INF, 0.0, torch.exp(m - safe_m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, v[:, k0:k1])
        m = m_new
    denom = torch.where(l == 0.0, 1.0, l)
    o = (acc / denom[..., None]).to(qf.dtype)
    return o, m[:, None, :], l[:, None, :]


def _bwd_common(qf, of, dof, m, l, qseg, kseg):
    bh, t, _ = qf.shape
    m, l = m.reshape(bh, t), l.reshape(bh, t)
    safe_m = torch.where(m == NEG_INF, 0.0, m)
    denom = torch.where(l == 0.0, 1.0, l)
    # di = rowsum(dO * O) from the stored o in its own dtype (reference
    # :198), in f64: dQ forms dP - di in f64, since it cancels
    # where a row's one visible key is itself (o = v there, dq 0), and the
    # f32 roundings of dP and di were all of such a row's dq.
    di = (dof.double() * of.double()).sum(dim=-1)
    return (safe_m, denom, di, _seg_rows(qseg, bh, t),
            _seg_rows(kseg, bh, t), torch.arange(t, device=qf.device))


def _probs_block(q, k_blk, k0, safe_m, denom, pos, causal, scale, qs, ks):
    s = torch.matmul(q, k_blk.transpose(1, 2)) * scale
    s = _mask(s, pos, pos[k0:k0 + k_blk.shape[1]], causal, qs,
              None if ks is None else ks[:, k0:k0 + k_blk.shape[1]])
    return torch.where(s == NEG_INF, 0.0,
                       torch.exp(s - safe_m[..., None])) / denom[..., None]


def _bwd_dq_plain(qf, kf, vf, of, dof, m, l, qseg=None, kseg=None,
                  causal=True, scale=None):
    """The reference's ``_bwd_dq_kernel`` math over key blocks in f32:
    ``dQ = sum_k dS K * scale`` with ``p`` recomputed from the global
    ``(m, l)``, ``dP - di`` in f64; returns ``dq`` in ``qf.dtype``."""
    bh, t, d = qf.shape
    scale = d ** -0.5 if scale is None else scale
    safe_m, denom, di, qs, ks, pos = _bwd_common(qf, of, dof, m, l, qseg,
                                                 kseg)
    q, k = qf.float(), kf.float()
    do64, v64 = dof.double(), vf.double()
    dq = torch.zeros((bh, t, d), device=qf.device)
    for k0 in range(0, t, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, t)
        p = _probs_block(q, k[:, k0:k1], k0, safe_m, denom, pos, causal,
                         scale, qs, ks)
        # dP and dP - di in f64 (f64 holds the f32 operands' products
        # exactly), then f32.
        dp = torch.matmul(do64, v64[:, k0:k1].transpose(1, 2))
        ds = p * (dp - di[..., None]).float()
        dq += torch.matmul(ds, k[:, k0:k1]) * scale
    return dq.to(qf.dtype)


def _bwd_dkv_plain(qf, kf, vf, of, dof, m, l, qseg=None, kseg=None,
                   causal=True, scale=None):
    """The reference's ``_bwd_dkv_kernel`` math over key blocks in f32:
    ``dV = sum_q p^T dO`` and ``dK = sum_q dS^T Q * scale``; returns
    ``(dk, dv)`` in ``qf.dtype``."""
    bh, t, d = qf.shape
    scale = d ** -0.5 if scale is None else scale
    safe_m, denom, di, qs, ks, pos = _bwd_common(qf, of, dof, m, l, qseg,
                                                 kseg)
    q, k, v, do = qf.float(), kf.float(), vf.float(), dof.float()
    di = di.float()
    dk = torch.empty((bh, t, d), device=qf.device)
    dv = torch.empty((bh, t, d), device=qf.device)
    for k0 in range(0, t, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, t)
        p = _probs_block(q, k[:, k0:k1], k0, safe_m, denom, pos, causal,
                         scale, qs, ks)
        dv[:, k0:k1] = torch.matmul(p.transpose(1, 2), do)
        dp = torch.matmul(do, v[:, k0:k1].transpose(1, 2))
        ds = p * (dp - di[..., None])
        dk[:, k0:k1] = torch.matmul(ds.transpose(1, 2), q) * scale
    return dk.to(qf.dtype), dv.to(qf.dtype)


def _bwd_parts_plain(qf, kf, vf, of, dof, m, l, qseg=None, kseg=None,
                     causal=True, scale=None):
    dq = _bwd_dq_plain(qf, kf, vf, of, dof, m, l, qseg, kseg, causal, scale)
    dk, dv = _bwd_dkv_plain(qf, kf, vf, of, dof, m, l, qseg, kseg, causal,
                            scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

class _Geometry:
    """How the kernels address a tensor: ``[B, T, H, D]`` in place, or the
    folded ``[B*H, T, D]`` as the case ``H = 1``.  Every operand of one
    launch shares the strides of ``x``."""

    def __init__(self, x: torch.Tensor, seg: Optional[torch.Tensor]):
        if x.dim() == 4:
            b, self.t, self.h, self.d = x.shape
            self.bh = b * self.h
            self.strides = (x.stride(0), x.stride(1), x.stride(2))
        else:
            self.bh, self.t, self.d = x.shape
            self.h = 1
            self.strides = (x.stride(0), x.stride(1), 0)
        self.seg_heads = 1
        if seg is not None:
            if self.bh % seg.shape[0]:
                raise ValueError(f"{seg.shape[0]} segment-id rows do not "
                                 f"divide {self.bh} batch*head rows")
            self.seg_heads = self.bh // seg.shape[0]


def _kernel_plan(dtype: torch.dtype, d: int):
    """``(instance, d_kernel)``: the kernels a launch on ``dtype`` operands
    of head dim ``d`` takes (``"bf16"``, ``"f16"`` or ``"f32"``) and the
    head dim its operands are padded to: the smallest of
    ``KERNEL_HEAD_DIMS`` that holds ``d``, above them the next multiple of
    ``WIDE_STEP`` (the wide instances; there is no ceiling).  Raises
    ``TypeError`` for a dtype the kernels do not take and ``ValueError``
    for ``d < 1``."""
    inst = KERNEL_DTYPES.get(dtype)
    if inst is None:
        if dtype == torch.float64:
            raise TypeError(
                "the flash attention kernels take bfloat16, float16 or "
                "float32; got torch.float64: the JAX package has no f64 "
                "kernel on the TPU (without JAX's x64 mode an f64 array is "
                "f32 there), so cast to float32")
        raise TypeError(f"the flash attention kernels take bfloat16, "
                        f"float16 or float32; got {dtype}")
    if d < 1:
        raise ValueError(f"head_dim {d}: the flash attention kernels take "
                         f"head dims of 1 and more")
    if d > KERNEL_HEAD_DIMS[-1]:
        return inst, -(-d // WIDE_STEP) * WIDE_STEP
    return inst, next(x for x in KERNEL_HEAD_DIMS if x >= d)


def _kernel_operands(*tensors):
    """Checks what the kernels take and returns the tensors with one
    layout: one shape, padded with zero columns to the plan's head dim,
    contiguous, 16-byte aligned, on one CUDA device (the kernels address
    every operand with the first one's strides, and the Hopper kernels'
    TMA tensor maps need the aligned base and strides that are multiples
    of 16 bytes, which a contiguous tensor of a kernel head dim has)."""
    ref = tensors[0]
    _, d_kernel = _kernel_plan(ref.dtype, ref.shape[-1])
    out = []
    for t in tensors:
        if t.shape != ref.shape:
            raise ValueError(f"flash attention operands must share one "
                             f"shape; got {tuple(t.shape)} and "
                             f"{tuple(ref.shape)}")
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"flash attention operands must share dtype "
                             f"and device; got {t.dtype} on {t.device} and "
                             f"{ref.dtype} on {ref.device}")
        if t.shape[-1] != d_kernel:
            t = torch.nn.functional.pad(t, (0, d_kernel - t.shape[-1]))
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _unpad(x: torch.Tensor, d: int) -> torch.Tensor:
    """A kernel output cut back to the caller's head dim ``d``."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _kernel_segments(seg, t, device):
    if seg is None:
        return None
    seg = seg.reshape(-1, t).to(device=device, dtype=torch.int32)
    return seg.contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {err}")


_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_N_PTRS = {"fwd": 8, "bwd_dq": 10, "bwd_dkv": 11}


def _fn(inst: str, kind: str):
    lib = "flash_attention_f32" if inst == "f32" else "flash_attention"
    fn = getattr(_build.load(lib), f"hvd_flash_{kind}_{inst}")
    fn.argtypes = [_P] * _N_PTRS[kind] + [_I] * 5 + [_LL] * 3 + [_I, _F, _P]
    fn.restype = ctypes.c_int
    return fn


def _count(kind: str, inst: str, d_kernel: int) -> None:
    _TOTALS[kind].add()
    instance_launches[(kind, inst, d_kernel)].add()


def _run(inst, kind, ptrs, g, causal, scale, device):
    """One launch of ``kind``'s ``inst`` kernel on padded operands."""
    with torch.cuda.device(device):
        err = _fn(inst, kind)(*ptrs, g.bh, g.h, g.seg_heads, g.t, g.d,
                              *g.strides, int(causal), float(scale),
                              _stream(device))
    _check_err(err, kind)


def _run_fwd(inst, q, k, v, qseg, kseg, causal, scale):
    """The forward kernel on operands of a kernel head dim; returns ``(o,
    m, l)`` with ``m``, ``l`` as ``[B*H, T]`` f32."""
    g = _Geometry(q, qseg)
    o = torch.empty_like(q)
    m = torch.empty((g.bh, g.t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _run(inst, "fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), m.data_ptr(), l.data_ptr(), _ptr(qseg),
                       _ptr(kseg)), g, causal, scale, q.device)
    return o, m, l


def _run_dq(inst, q, k, v, o, do, m, l, qseg, kseg, causal, scale):
    g = _Geometry(q, qseg)
    dq = torch.empty_like(q)
    _run(inst, "bwd_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), do.data_ptr(), m.data_ptr(),
                          l.data_ptr(), _ptr(qseg), _ptr(kseg),
                          dq.data_ptr()), g, causal, scale, q.device)
    return dq


def _run_dkv(inst, q, k, v, o, do, m, l, qseg, kseg, causal, scale):
    g = _Geometry(q, qseg)
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    _run(inst, "bwd_dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), do.data_ptr(), m.data_ptr(),
                           l.data_ptr(), _ptr(qseg), _ptr(kseg),
                           dk.data_ptr(), dv.data_ptr()), g, causal, scale,
         q.device)
    return dk, dv


def _stats(m, l, t):
    """``m`` and ``l`` as the kernels read them: ``[B*H, T]`` f32."""
    return (m.reshape(-1, t).float().contiguous(),
            l.reshape(-1, t).float().contiguous())


def _launch_fwd(q, k, v, qseg, kseg, causal, scale):
    """Forward kernel on ``[B, T, H, D]`` or ``[B*H, T, D]`` tensors of a
    dtype the plan takes; returns ``(o, m, l)`` with ``o`` in ``q``'s
    dtype and head dim and ``m``, ``l`` as ``[B*H, T]`` f32.  ``scale``
    is the caller's (that of the true head dim)."""
    inst, d_kernel = _kernel_plan(q.dtype, q.shape[-1])
    d = q.shape[-1]
    q, k, v = _kernel_operands(q, k, v)
    qseg = _kernel_segments(qseg, q.shape[1], q.device)
    kseg = _kernel_segments(kseg, q.shape[1], q.device)
    o, m, l = _run_fwd(inst, q, k, v, qseg, kseg, causal, scale)
    _count("fwd", inst, d_kernel)
    return _unpad(o, d), m, l


def _launch_dq(q, k, v, o, do, m, l, qseg, kseg, causal, scale):
    inst, d_kernel = _kernel_plan(q.dtype, q.shape[-1])
    d = q.shape[-1]
    q, k, v, o, do = _kernel_operands(q, k, v, o, do)
    qseg = _kernel_segments(qseg, q.shape[1], q.device)
    kseg = _kernel_segments(kseg, q.shape[1], q.device)
    m, l = _stats(m, l, q.shape[1])
    dq = _run_dq(inst, q, k, v, o, do, m, l, qseg, kseg, causal, scale)
    _count("bwd_dq", inst, d_kernel)
    return _unpad(dq, d)


def _launch_dkv(q, k, v, o, do, m, l, qseg, kseg, causal, scale):
    inst, d_kernel = _kernel_plan(q.dtype, q.shape[-1])
    d = q.shape[-1]
    q, k, v, o, do = _kernel_operands(q, k, v, o, do)
    qseg = _kernel_segments(qseg, q.shape[1], q.device)
    kseg = _kernel_segments(kseg, q.shape[1], q.device)
    m, l = _stats(m, l, q.shape[1])
    dk, dv = _run_dkv(inst, q, k, v, o, do, m, l, qseg, kseg, causal, scale)
    _count("bwd_dkv", inst, d_kernel)
    return _unpad(dk, d), _unpad(dv, d)


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu; got "
                         f"{x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# The parts, folded or [B, T, H, D] (reference :330, :399)
# ---------------------------------------------------------------------------

def _fwd_parts(qf, kf, vf, qseg=None, kseg=None, causal=True, scale=None):
    """``[B*H, T, D]`` or ``[B, T, H, D]`` forward: ``(o, m, l)``, ``o``
    in the layout of ``qf`` and ``m``/``l`` the ``[B*H, 1, T]``
    online-softmax state either way.  ``qseg``/``kseg`` are ``[B, T]`` or
    ``[B, 1, T]`` (the same tensor for self-attention)."""
    scale = qf.shape[-1] ** -0.5 if scale is None else scale
    if _route(qf) == "cpu":
        if qf.dim() == 4:
            b, _, h, _ = qf.shape
            o, m, l = _fwd_parts_plain(_fold(qf), _fold(kf), _fold(vf),
                                       qseg, kseg, causal, scale)
            return _unfold(o, b, h), m, l
        return _fwd_parts_plain(qf, kf, vf, qseg, kseg, causal, scale)
    o, m, l = _launch_fwd(qf, kf, vf, qseg, kseg, causal, scale)
    return o, m[:, None, :], l[:, None, :]


def _bwd_parts(qf, kf, vf, of, dof, m, l, qseg=None, kseg=None,
               causal=True, scale=None):
    """``[B*H, T, D]`` or ``[B, T, H, D]`` backward from the GLOBAL
    ``(m, l)``: returns ``(dq, dk, dv)`` in the layout of ``qf``."""
    scale = qf.shape[-1] ** -0.5 if scale is None else scale
    if _route(qf) == "cpu":
        if qf.dim() == 4:
            b, _, h, _ = qf.shape
            grads = _bwd_parts_plain(*(_fold(x) for x in (qf, kf, vf, of,
                                                          dof)),
                                     m, l, qseg, kseg, causal, scale)
            return tuple(_unfold(g, b, h) for g in grads)
        return _bwd_parts_plain(qf, kf, vf, of, dof, m, l, qseg, kseg,
                                causal, scale)
    dq = _launch_dq(qf, kf, vf, of, dof, m, l, qseg, kseg, causal, scale)
    dk, dv = _launch_dkv(qf, kf, vf, of, dof, m, l, qseg, kseg, causal,
                         scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The public function
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Forward kernel, then the dQ and dK/dV kernels in the backward (the
    plain versions on the CPU).  On the card the kernels read ``[B, T, H,
    D]`` in place; on the CPU the plain versions run folded."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, scale):
        b, t, h, d = q.shape
        if _route(q) == "cuda":
            o, m, l = _launch_fwd(q, k, v, seg, seg, causal, scale)
        else:
            of, m, l = _fwd_parts_plain(_fold(q), _fold(k), _fold(v), seg,
                                        seg, causal, scale)
            o = _unfold(of, b, h)
        ctx.save_for_backward(q, k, v, o, m, l, seg)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l, seg = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        b, t, h, d = q.shape
        if _route(q) == "cuda":
            do = do.contiguous()
            dq = _launch_dq(q, k, v, o, do, m, l, seg, seg, causal, scale)
            dk, dv = _launch_dkv(q, k, v, o, do, m, l, seg, seg, causal,
                                 scale)
        else:
            dq, dk, dv = _bwd_parts_plain(
                _fold(q), _fold(k), _fold(v), _fold(o), _fold(do), m, l,
                seg, seg, causal, scale)
            dq, dk, dv = (_unfold(x, b, h) for x in (dq, dk, dv))
        # No gradient for the segment ids.
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Exact attention, flash-style (reference ``flash_attention``).

    ``q``/``k``/``v``: ``[B, T, H, D]``; returns ``[B, T, H, D]`` in their
    dtype.  ``segment_ids`` (``[B, T]`` integer) enables sequence packing:
    tokens attend only within their own segment (composes with
    ``causal``).  ``block_q``/``block_k`` follow the reference's contract
    (``T`` must divide by them; default auto); the kernels tile for Hopper.
    """
    d = q.shape[-1]
    bq, bk = _eff_blocks(q.shape[1], block_q, block_k, d)
    b, t, h, d = _check_shapes(q, k, v, bq, bk)
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, t):
            raise ValueError(
                f"segment_ids must be [B, T] = {(b, t)} matching q/k/v, "
                f"got {tuple(segment_ids.shape)} (pad segment ids with the "
                f"sequence)")
        if segment_ids.is_floating_point() or segment_ids.is_complex():
            raise ValueError(
                f"segment_ids must be integer, got {segment_ids.dtype}")
    scale_ = d ** -0.5 if scale is None else float(scale)
    return FlashAttention.apply(q, k, v, segment_ids, bool(causal), scale_)
