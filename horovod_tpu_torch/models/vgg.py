"""VGG-BN in PyTorch, held against the flax model of the JAX package.

Counterpart of ``horovod_tpu/models/vgg.py``: VGG-16 is one of the
reference's three headline scaling models (its docstring cites
``README.rst:75``).  Same conventions as :mod:`.resnet`, whose ``Conv``,
``Dense`` and ``BatchNorm`` it builds on: NHWC in, NCHW in
``channels_last`` memory format inside, f32 parameters cast to the compute
dtype at each layer, f32 BatchNorm statistics (epsilon 1e-5, momentum
0.9), logits returned as f32.

A stage is ``n`` 3x3 convolutions, each followed by BatchNorm and ReLU,
then a 2x2/s2 max-pool.  The head is a global average pool and one dense
layer; ``classic_head=True`` puts the original two ``Dense(4096)`` + ReLU
layers before it, over the last stage's output flattened in NHWC order,
as flax's ``x.reshape((B, -1))`` flattens it (an NCHW flatten would
scramble the first dense layer's rows).  Their input width depends on the
image, so the classic head takes ``image_size``.  Submodule names are
flax's (``Conv_0``…, ``BatchNorm_0``…, ``Dense_0``, ``Dense_1``, ``head``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.resnet import (BatchNorm, Conv, Dense,
                                             resolve_axis)

# Stage configs: (3x3 convolutions, output channels) a stage.
CFGS = {
    "vgg11": ((1, 64), (1, 128), (2, 256), (2, 512), (2, 512)),
    "vgg13": ((2, 64), (2, 128), (2, 256), (2, 512), (2, 512)),
    "vgg16": ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
    "vgg19": ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)),
}


class VGG(nn.Module):
    """VGG-BN over NHWC inputs (reference ``vgg.py:45``).  ``axis_name``
    synchronizes BatchNorm statistics (see :func:`.resnet.resolve_axis`).
    Parameters are initialised from ``generator`` on the CPU, then moved
    to ``device`` (default ``cuda:<local_rank>``)."""

    def __init__(self, stage_sizes: Sequence[Tuple[int, int]],
                 num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, axis_name=None,
                 classic_head: bool = False, image_size: int = 224,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        from horovod_tpu_torch.basics import resolve_device
        dev = resolve_device(device)
        axis_name = resolve_axis(axis_name)
        self.dtype, self.classic_head = dtype, classic_head
        self.stages = [n for n, _ in stage_sizes]
        features, k = 3, 0
        for n, channels in stage_sizes:
            for _ in range(n):
                self.add_module(f"Conv_{k}", Conv(features, channels, (3, 3),
                                                  dtype=dtype))
                self.add_module(f"BatchNorm_{k}", BatchNorm(
                    channels, dtype=dtype, axis_name=axis_name))
                features, k = channels, k + 1
        if classic_head:
            side = image_size
            for _ in stage_sizes:
                side //= 2
            self.Dense_0 = Dense(features * side * side, 4096, dtype=dtype)
            self.Dense_1 = Dense(4096, 4096, dtype=dtype)
            features = 4096
        self.head = Dense(features, num_classes, dtype=dtype)
        self.reset_parameters(generator)
        self.to(dev)

    def reset_parameters(self, generator=None) -> None:
        """flax's initializer families (see ``ResNet.reset_parameters``)."""
        for m in self.modules():
            if isinstance(m, (Conv, Dense, BatchNorm)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        k = 0
        for n in self.stages:
            for _ in range(n):
                x = getattr(self, f"Conv_{k}")(x)
                x = torch.relu(getattr(self, f"BatchNorm_{k}")(x))
                k += 1
            x = F.max_pool2d(x, 2, 2)
        if self.classic_head:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = torch.relu(self.Dense_0(x))
            x = torch.relu(self.Dense_1(x))
        else:
            x = x.mean(dim=(2, 3))
        return self.head(x).float()


VGG11 = functools.partial(VGG, stage_sizes=CFGS["vgg11"])
VGG13 = functools.partial(VGG, stage_sizes=CFGS["vgg13"])
VGG16 = functools.partial(VGG, stage_sizes=CFGS["vgg16"])
VGG19 = functools.partial(VGG, stage_sizes=CFGS["vgg19"])
