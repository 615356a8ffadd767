"""ResNet v1.5 in PyTorch, held against the flax model of the JAX package.

Counterpart of ``horovod_tpu/models/resnet.py``.  The public ``forward``
takes NHWC ``[B, H, W, C]`` as the flax model does; inside, tensors are
NCHW in ``channels_last`` memory format, so the NHWC view
``y.permute(0, 2, 3, 1)`` of a conv output is contiguous and the fused-stem
kernel takes it without a copy.

Numerics follow flax where it rounds: parameters are float32 and are cast
to the compute dtype at each conv and dense layer; BatchNorm computes its
statistics and its normalisation in float32 and casts the result; the head
is computed in the compute dtype and returned as float32.  BatchNorm keeps
per-replica statistics (data-parallel semantics: gradients are averaged,
statistics are not).

Submodules carry flax's names (``conv_init``, ``norm_init``,
``BottleneckBlock_3``, ``Conv_1``, ``BatchNorm_2``, ``conv_proj``,
``norm_proj``, ``head``) and parameters flax's leaf names (``kernel``,
``scale``, ``bias``; buffers ``mean``, ``var``), so a state-dict key is the
flax path joined with dots (see :mod:`horovod_tpu_torch.models.convert`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops.fused_stem import fused_bn_relu_maxpool

Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]

STEMS = ("conv7", "s2d", "s2d_fused")


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Pack ``block x block`` spatial patches into channels (NHWC):
    ``[B, H, W, C] -> [B, H/b, W/b, b*b*C]`` with channel index
    ``(dy*b + dx)*C + c`` (reference ``resnet.py:35``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def conv7_to_s2d_weights(w7: torch.Tensor) -> torch.Tensor:
    """Exact reparameterization of 7x7/s2 stem weights for the s2d stem
    (reference ``resnet.py:52``), in the port's OIHW layout: ``[O, C, 7, 7]
    -> [O, 4*C, 4, 4]`` such that ``conv(s2d(x), w4, stride 1, pad
    [(2,1),(2,1)]) == conv(x, w7, stride 2, pad 3)``.  The 15 packed taps
    with no original tap stay zero."""
    o, c, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 kernel; got {tuple(w7.shape)}")
    w4 = w7.new_zeros((o, 4 * c, 4, 4))
    for ky in range(7):
        for kx in range(7):
            ku, dy = (ky - 3) // 2 + 2, (ky - 3) % 2
            kv, dx = (kx - 3) // 2 + 2, (kx - 3) % 2
            ch = (dy * 2 + dx) * c
            w4[:, ch:ch + c, ku, kv] = w7[:, :, ky, kx]
    return w4


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: variance_scaling(1, fan_in,
    truncated_normal), i.e. N(0, 1/fan_in) truncated at two sigma and
    rescaled so the variance stays 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's 'SAME' padding along one axis: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: kernel ``[O, I, kh, kw]`` in f32,
    cast with the input to ``dtype``.  ``padding`` is ``"SAME"`` (flax's
    default) or explicit ``((top, bottom), (left, right))``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(features, in_features, *kernel_size))
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.kernel.shape
        with torch.no_grad():
            _lecun_normal_(self.kernel, i * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, kh, kw = self.kernel.shape
        if self.padding == "SAME":
            pads = (_same_pads(x.shape[2], kh, self.strides[0]),
                    _same_pads(x.shape[3], kw, self.strides[1]))
        else:
            pads = self.padding
        (top, bottom), (left, right) = pads
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype)
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.strides, padding=(top, left))
        # XLA pads asymmetrically (e.g. (0, 1) for a stride-2 3x3 on an
        # even input); conv2d's padding is symmetric, so pad first.
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, stride=self.strides)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` ``[out, in]`` and ``bias`` in f32,
    computed in ``dtype`` as flax does (product, then bias add)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            _lecun_normal_(self.kernel, self.kernel.shape[1], generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.linear(x.to(self.dtype), self.kernel.to(self.dtype))
                + self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW, per-replica statistics.

    Train mode: mean and the fast variance ``max(E[x^2] - E[x]^2, 0)`` in
    f32; running statistics updated with that (biased) variance as
    ``ra = momentum*ra + (1-momentum)*batch``.  Eval mode: the running
    statistics.  The normalisation runs in f32 and is cast to ``dtype``.
    ``nn.BatchNorm2d`` differs on all three counts.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.epsilon = momentum, epsilon
        self.dtype = dtype
        self.zero_scale = zero_scale

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def statistics(self, x: torch.Tensor):
        """(mean, var) to normalise with; updates the running statistics
        in train mode."""
        if not self.training:
            return self.mean, self.var
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.statistics(x)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = ((x.float() - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(self.dtype)


class FusedStemNorm(BatchNorm):
    """BatchNorm whose apply is folded into the fused stem tail
    (reference ``resnet.py:137``): statistics exactly as :class:`BatchNorm`,
    then ``a = gamma*rsqrt(var+eps)`` and ``b = beta - mean*a`` in f32,
    cast to x's dtype, and BN-apply + relu + 3x3/s2 max-pool as ONE pass.
    Same parameter and statistic names as the unfused stem."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.statistics(x)
        a = self.scale * torch.rsqrt(var + self.epsilon)
        b = self.bias - mean * a
        xh = x.contiguous(memory_format=torch.channels_last)
        y = fused_bn_relu_maxpool(xh.permute(0, 2, 3, 1), a, b)
        return y.permute(0, 3, 1, 2)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with expansion 4 (ResNet-50/101/152);
    v1.5: the stride lives on the 3x3 (reference ``resnet.py:85``)."""
    expansion = 4

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_features, filters, (1, 1), dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype)
        self.Conv_2 = Conv(filters, out, (1, 1), dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out, dtype=dtype, zero_scale=True)
        # flax adds the projection when the residual's shape differs from
        # the block output's: a channel change or a stride.
        self.project = in_features != out or tuple(strides) != (1, 1)
        if self.project:
            self.conv_proj = Conv(in_features, out, (1, 1), strides,
                                  dtype=dtype)
            self.norm_proj = BatchNorm(out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.project:
            residual = self.norm_proj(self.conv_proj(residual))
        return torch.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34, reference
    ``resnet.py:113``)."""
    expansion = 1

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype, zero_scale=True)
        self.project = in_features != filters or tuple(strides) != (1, 1)
        if self.project:
            self.conv_proj = Conv(in_features, filters, (1, 1), strides,
                                  dtype=dtype)
            self.norm_proj = BatchNorm(filters, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.project:
            residual = self.norm_proj(self.conv_proj(residual))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 over NHWC inputs (reference ``resnet.py:187``).

    ``stem``: ``"conv7"`` (7x7/s2 on ``[B, 224, 224, 3]``), ``"s2d"`` (the
    exact 4x4/s1 reparameterization on space-to-depth input
    ``[B, 112, 112, 12]``) or ``"s2d_fused"`` (``"s2d"`` with BN-apply,
    relu and max-pool as one kernel).  Parameters are initialised from
    ``generator`` on the CPU, then moved to ``device`` (default
    ``cuda:<local_rank>``; pass ``"cpu"`` to stay on the CPU).
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv7",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"stem={stem!r}: expected 'conv7', 's2d' or "
                             f"'s2d_fused'")
        from horovod_tpu_torch.basics import resolve_device
        dev = resolve_device(device)
        self.stem, self.dtype = stem, dtype
        if stem in ("s2d", "s2d_fused"):
            # space-to-depth input: 2x2 RGB patches packed into 12 channels
            self.conv_init = Conv(12, num_filters, (4, 4), (1, 1),
                                  ((2, 1), (2, 1)), dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, (7, 7), (2, 2),
                                  ((3, 3), (3, 3)), dtype=dtype)
        norm_cls = FusedStemNorm if stem == "s2d_fused" else BatchNorm
        self.norm_init = norm_cls(num_filters, dtype=dtype)
        features = num_filters
        k = 0
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                self.add_module(f"{block_cls.__name__}_{k}",
                                block_cls(features, filters, strides, dtype))
                features = filters * block_cls.expansion
                k += 1
        self.num_blocks = k
        self.block_name = block_cls.__name__
        self.head = Dense(features, num_classes, dtype=dtype)
        self.reset_parameters(generator)
        self.to(dev)

    def reset_parameters(self, generator=None) -> None:
        """flax's initializer families: lecun-normal conv and dense
        kernels, BN scale ones (zeros on each block's last BN), biases and
        running means zero, running variances one.  The numbers differ
        from the JAX package's: the generators differ."""
        for m in self.modules():
            if isinstance(m, (Conv, Dense, BatchNorm)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC in; the NCHW view of a contiguous NHWC tensor is
        # channels_last, which every layer below keeps.
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.conv_init(x)
        if self.stem == "s2d_fused":
            x = self.norm_init(x)
        else:
            x = torch.relu(self.norm_init(x))
            x = F.max_pool2d(x, 3, 2, 1)
        for k in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{k}")(x)
        x = x.mean(dim=(2, 3))
        return self.head(x).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)
