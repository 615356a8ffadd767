"""Fused ResNet stem tail: ``maxpool3x3/s2/pad1(relu(x*scale + offset))``.

Counterpart of ``horovod_tpu/ops/fused_stem.py``.  On a CUDA tensor the
forward is one hand-written kernel (``csrc/fused_stem.cu``) that reads the
stem conv's output once and writes the pooled result, so the BN-apply and
relu output never reaches device memory; ``_tiling`` cuts the launch into
strips of output rows whose input a block stages in shared memory.  On a
CPU tensor the forward is the plain PyTorch version, ``_tail``.

Backward follows the reference's ``_bwd``: it recomputes ``_tail`` from the
saved ``x``, ``scale`` and ``offset`` and differentiates it with autograd.
``_tail`` pools with the same contiguous pair/odd identity as the
reference, through ``torch.maximum``/``amax``, whose gradients split ties
evenly as JAX's ``max``/``reduce_max`` do (``F.max_pool2d``'s backward
would route each window's gradient to one element; ties among positive
values are common in bf16).

Pooling identity (window 3, stride 2, pad 1, even H):
``out[i] = max(y[2i-1], y[2i], y[2i+1]) = max(odd[i-1], pair[i])`` with
``pair[i] = max(y[2i], y[2i+1])`` and ``odd[i] = y[2i+1]``, both read from a
contiguous ``[H/2, 2]`` reshape; the same per axis.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from horovod_tpu_torch.ops import _build

# One count per kernel launch (the CPU route does not count).
launches = _build.CallCounter("fused_stem", kernel=True)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory of one kernel block: the staged input of a strip.  72 KB
# lets three blocks share an SM (227 KB), so one block's loads overlap
# another's arithmetic; a pixel wider than a ninth of it takes more, up to
# the most a block can have.
_STRIP_BYTES = 72 * 1024
_BLOCK_SMEM_MAX = 227 * 1024


def _tiling(shape, itemsize: int) -> Tuple[int, int]:
    """The kernel's launch geometry for an NHWC ``shape`` (even H and W):
    each block owns ``rows`` output rows and ``cols`` output columns of
    one image and stages ``(2 rows + 1) (2 cols + 1)`` input pixels, plus
    its 16-byte barrier, in shared memory.  Whole output rows where three
    input rows fit ``_STRIP_BYTES``, else the widest column tile that
    does; then as many rows as fit."""
    _, h, w, c = shape
    pixel = max(c, 1) * itemsize
    if 9 * pixel + 16 > _BLOCK_SMEM_MAX:
        raise ValueError(f"fused stem: {c} channels of {itemsize} bytes do "
                         f"not fit a block's shared memory")
    budget = max(_STRIP_BYTES, 9 * pixel)
    cols = max(1, min(w // 2, (budget // (3 * pixel) - 1) // 2))
    rows = max(1, min(h // 2, (budget // ((2 * cols + 1) * pixel) - 1) // 2))
    return rows, cols


def _pool_axis(y: torch.Tensor, axis: int) -> torch.Tensor:
    """max(window 3, stride 2, pad 1) along ``axis`` (even length) via the
    contiguous pair/odd identity above."""
    h = y.shape[axis]
    yr = y.reshape(y.shape[:axis] + (h // 2, 2) + y.shape[axis + 1:])
    pair = yr.amax(dim=axis + 1)
    odd = yr.select(axis + 1, 1)
    pad = torch.full_like(odd.narrow(axis, 0, 1), float("-inf"))
    shifted = torch.cat([pad, odd.narrow(axis, 0, h // 2 - 1)], dim=axis)
    return torch.maximum(shifted, pair)


def _tail(x: torch.Tensor, scale: torch.Tensor,
          offset: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: relu(x*scale + offset), then the
    3x3/s2/pad1 max-pool over H and W.  ``x``: ``[B, H, W, C]``."""
    y = torch.relu(x * scale + offset)
    y = _pool_axis(y, 1)
    return _pool_axis(y, 2)


def _check(x: torch.Tensor, scale: torch.Tensor,
           offset: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"fused stem takes x of shape [B, H, W, C]; got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused stem pool needs even H, W; got {(h, w)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused stem takes float32 or bfloat16; got "
                        f"{x.dtype}")
    for name, t in (("scale", scale), ("offset", offset)):
        if t.shape != (c,):
            raise ValueError(f"{name} must have shape ({c},); got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch(x: torch.Tensor, scale: torch.Tensor,
            offset: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel; ``scale``/``offset`` already in x.dtype."""
    b, h, w, c = x.shape
    scale, offset = scale.contiguous(), offset.contiguous()
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    lanes = 16 // x.element_size()
    vec = c % lanes == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, scale, offset, out))
    rows, cols = _tiling(x.shape, x.element_size())
    lib = _build.load("fused_stem")
    fn = lib.hvd_fused_stem_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                 out.data_ptr(), b, h, w, c, _DTYPE_CODE[x.dtype],
                 int(vec), rows, cols, stream)
    if err != 0:
        raise RuntimeError(f"fused stem kernel launch failed: CUDA error "
                           f"{err}")
    launches.add()
    return out


class FusedBnReluMaxpool(torch.autograd.Function):
    """Kernel forward on CUDA, plain forward on the CPU; backward
    recomputes ``_tail`` and differentiates it (reference ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale, offset):
        _check(x, scale, offset)
        # Keep the PRE-cast scale/offset so their gradients come back in
        # the caller's dtype (f32 BN coefficients).
        ctx.save_for_backward(x, scale, offset)
        s, o = scale.to(x.dtype), offset.to(x.dtype)
        if x.device.type == "cuda":
            return _launch(x, s, o)
        if x.device.type == "cpu":
            return _tail(x, s, o)
        raise ValueError(f"fused stem runs on cuda or cpu; got {x.device}")

    @staticmethod
    def backward(ctx, g):
        x, scale0, offset0 = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(ctx.needs_input_grad[0])
            sr = scale0.detach().requires_grad_(ctx.needs_input_grad[1])
            orr = offset0.detach().requires_grad_(ctx.needs_input_grad[2])
            y = _tail(xr, sr.to(x.dtype), orr.to(x.dtype))
            wrt = [t for t in (xr, sr, orr) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in (xr, sr, orr))


def fused_bn_relu_maxpool(x: torch.Tensor, scale: torch.Tensor,
                          offset: torch.Tensor) -> torch.Tensor:
    """``maxpool3x3/s2/pad1(relu(x*scale + offset))`` in one fused pass.

    ``x``: ``[B, H, W, C]`` (float32 or bfloat16) with even H, W, made
    contiguous first when it is not (the kernel reads dense NHWC);
    ``scale``/``offset``: ``[C]`` (BN folded in), cast to ``x.dtype``.
    Returns ``[B, H/2, W/2, C]`` in ``x.dtype``.
    """
    return FusedBnReluMaxpool.apply(x.contiguous(), scale, offset)
