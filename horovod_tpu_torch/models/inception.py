"""Inception V3 in PyTorch, held against the flax model of the JAX package.

Counterpart of ``horovod_tpu/models/inception.py`` (Szegedy et al. 2015,
without the auxiliary classifier): stem -> 3x InceptionA -> reduction B
-> 4x InceptionC (factorized 7x7) -> reduction D -> 2x InceptionE ->
global average pool -> dense.  Inception-v3 is one of the reference's
three headline scaling models (its docstring cites ``README.rst:75``).

Same conventions as :mod:`.resnet`, whose ``Conv``, ``Dense`` and
``BatchNorm`` it builds on; every convolution is :class:`ConvBN` (conv,
BatchNorm with epsilon **1e-3** and momentum 0.9, ReLU).  Convolutions
pad ``"SAME"`` or ``"VALID"`` as XLA does; the 3x3/s1 ``"SAME"`` average
pool divides by 9 at the borders too (flax's ``count_include_pad``); the
max-pools are VALID 3x3/s2; branches are concatenated on the channel axis
(dim 1 of the NCHW tensors inside).  Submodules carry flax's names, made
in flax's call order (``InceptionA_0.ConvBN_3.Conv_0.kernel``), so
``convert.flax_to_state_dict`` carries the weights across and
``convert.flax_ordered_parameters`` gives JAX's gradient order (a string
sort: ``ConvBN_10`` before ``ConvBN_2``).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.resnet import (BatchNorm, Conv, Dense,
                                             Padding, resolve_axis)


class ConvBN(nn.Module):
    """conv -> BN -> ReLU (reference ``inception.py:39``)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (1, 1),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME",
                 dtype: torch.dtype = torch.bfloat16, axis_name=None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, epsilon=1e-3, dtype=dtype,
                                     axis_name=axis_name)
        self.features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3/s1 ``"SAME"`` average pool dividing by 9 everywhere.

    It pools an NCHW copy and hands back the input's layout: PyTorch's
    channels-last (NHWC) CUDA kernel of this pool's backward shifts the
    windows at a padded border (the gradient of a sum along a 4x4 map's
    first row is not 4/9, 6/9, 6/9, 4/9), in every dtype, so
    Inception-v3's train step on the card got wrong gradients in its pool
    branches (``python3 chip_smoke.py --avg-pool-check``).  The NCHW
    kernel's backward is exact, and every device takes this one route."""
    y = F.avg_pool2d(x.contiguous(), 3, 1, 1, count_include_pad=True)
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """A block whose ConvBNs are named ``ConvBN_<k>`` in creation order,
    which is flax's call order."""

    def __init__(self, conv):
        super().__init__()
        self._conv = conv
        self._made = 0

    def make(self, in_features: int, features: int, *args, **kwargs
             ) -> ConvBN:
        m = self._conv(in_features, features, *args, **kwargs)
        self.add_module(f"ConvBN_{self._made}", m)
        self._made += 1
        return m

    def chain(self, x: torch.Tensor, convs: List[ConvBN]) -> torch.Tensor:
        for c in convs:
            x = c(x)
        return x


class InceptionA(_Block):
    """35x35 block: 1x1 / 5x5 / double-3x3 / pool branches."""

    def __init__(self, in_features: int, pool_features: int, conv):
        super().__init__(conv)
        self.b1 = [self.make(in_features, 64)]
        self.b2 = [self.make(in_features, 48), self.make(48, 64, (5, 5))]
        self.b3 = [self.make(in_features, 64), self.make(64, 96, (3, 3)),
                   self.make(96, 96, (3, 3))]
        self.b4 = [self.make(in_features, pool_features)]
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([self.chain(x, self.b1), self.chain(x, self.b2),
                          self.chain(x, self.b3),
                          self.chain(_avg_pool_same(x), self.b4)], dim=1)


class InceptionB(_Block):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, in_features: int, conv):
        super().__init__(conv)
        self.b1 = [self.make(in_features, 384, (3, 3), (2, 2), "VALID")]
        self.b2 = [self.make(in_features, 64), self.make(64, 96, (3, 3)),
                   self.make(96, 96, (3, 3), (2, 2), "VALID")]
        self.out_features = 384 + 96 + in_features

    def forward(self, x):
        return torch.cat([self.chain(x, self.b1), self.chain(x, self.b2),
                          _max_pool_valid(x)], dim=1)


class InceptionC(_Block):
    """17x17 block with factorized 7x7 (1x7 + 7x1) branches."""

    def __init__(self, in_features: int, channels_7x7: int, conv):
        super().__init__(conv)
        c7 = channels_7x7
        self.b1 = [self.make(in_features, 192)]
        self.b2 = [self.make(in_features, c7), self.make(c7, c7, (1, 7)),
                   self.make(c7, 192, (7, 1))]
        self.b3 = [self.make(in_features, c7), self.make(c7, c7, (7, 1)),
                   self.make(c7, c7, (1, 7)), self.make(c7, c7, (7, 1)),
                   self.make(c7, 192, (1, 7))]
        self.b4 = [self.make(in_features, 192)]
        self.out_features = 4 * 192

    def forward(self, x):
        return torch.cat([self.chain(x, self.b1), self.chain(x, self.b2),
                          self.chain(x, self.b3),
                          self.chain(_avg_pool_same(x), self.b4)], dim=1)


class InceptionD(_Block):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, in_features: int, conv):
        super().__init__(conv)
        self.b1 = [self.make(in_features, 192),
                   self.make(192, 320, (3, 3), (2, 2), "VALID")]
        self.b2 = [self.make(in_features, 192), self.make(192, 192, (1, 7)),
                   self.make(192, 192, (7, 1)),
                   self.make(192, 192, (3, 3), (2, 2), "VALID")]
        self.out_features = 320 + 192 + in_features

    def forward(self, x):
        return torch.cat([self.chain(x, self.b1), self.chain(x, self.b2),
                          _max_pool_valid(x)], dim=1)


class InceptionE(_Block):
    """8x8 block with split 1x3/3x1 branch expansions."""

    def __init__(self, in_features: int, conv):
        super().__init__(conv)
        # Plain lists: the ConvBNs are registered by make() alone.
        self.b1 = [self.make(in_features, 320)]
        self.b2 = [self.make(in_features, 384)]
        self.b2_split = [self.make(384, 384, (1, 3)),
                         self.make(384, 384, (3, 1))]
        self.b3 = [self.make(in_features, 448), self.make(448, 384, (3, 3))]
        self.b3_split = [self.make(384, 384, (1, 3)),
                         self.make(384, 384, (3, 1))]
        self.b4 = [self.make(in_features, 192)]
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x):
        b2 = self.chain(x, self.b2)
        b3 = self.chain(x, self.b3)
        return torch.cat([self.chain(x, self.b1)]
                         + [c(b2) for c in self.b2_split]
                         + [c(b3) for c in self.b3_split]
                         + [self.chain(_avg_pool_same(x), self.b4)], dim=1)


class InceptionV3(nn.Module):
    """Inception V3 over NHWC inputs (reference ``inception.py:163``);
    any image of 75x75 or more survives the stem's reductions.
    ``axis_name`` synchronizes BatchNorm statistics (see
    :func:`.resnet.resolve_axis`).  Parameters are initialised from
    ``generator`` on the CPU, then moved to ``device`` (default
    ``cuda:<local_rank>``)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, axis_name=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        from horovod_tpu_torch.basics import resolve_device
        dev = resolve_device(device)
        conv = functools.partial(ConvBN, dtype=dtype,
                                 axis_name=resolve_axis(axis_name))
        self.dtype = dtype
        self.ConvBN_0 = conv(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = conv(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = conv(32, 64, (3, 3))
        self.ConvBN_3 = conv(64, 80)
        self.ConvBN_4 = conv(80, 192, (3, 3), padding="VALID")
        blocks, c = [], 192
        for pool in (32, 64, 64):
            blocks.append(("InceptionA", InceptionA(c, pool, conv)))
            c = blocks[-1][1].out_features
        blocks.append(("InceptionB", InceptionB(c, conv)))
        c = blocks[-1][1].out_features
        for c7 in (128, 160, 160, 192):
            blocks.append(("InceptionC", InceptionC(c, c7, conv)))
            c = blocks[-1][1].out_features
        blocks.append(("InceptionD", InceptionD(c, conv)))
        c = blocks[-1][1].out_features
        for _ in range(2):
            blocks.append(("InceptionE", InceptionE(c, conv)))
            c = blocks[-1][1].out_features
        seen: dict = {}
        self.block_names = []
        for kind, block in blocks:
            name = f"{kind}_{seen.get(kind, 0)}"
            seen[kind] = seen.get(kind, 0) + 1
            self.add_module(name, block)
            self.block_names.append(name)
        self.head = Dense(c, num_classes, dtype=dtype)
        self.reset_parameters(generator)
        self.to(dev)

    def reset_parameters(self, generator=None) -> None:
        """flax's initializer families (see ``ResNet.reset_parameters``)."""
        for m in self.modules():
            if isinstance(m, (Conv, Dense, BatchNorm)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = _max_pool_valid(x)
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = _max_pool_valid(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.head(x).float()
