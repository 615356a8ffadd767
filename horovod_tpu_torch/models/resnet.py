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
statistics are not) unless ``axis_name`` names a group to synchronize
them over.

Synchronized BatchNorm (``axis_name``, reference ``resnet.py:195``): in
train mode each BatchNorm averages its f32 ``[mean, E[x^2]]`` over the
group in ONE all-reduce of their concatenation, as flax's
``_compute_stats`` does with one ``lax.pmean``, then forms ``var =
max(E[x^2] - mean^2, 0)`` and updates the running statistics once.  The
all-reduce is a ``torch.distributed`` call inside the step
(:class:`_StatsMean`), counted in :data:`stats_allreduce_calls`; eval mode
issues none.  Its backward is what JAX's transpose of that ``pmean`` is
inside the reference's ``shard_map(..., check_vma=False)``: the cotangent
divided by the group size, then summed over the group (a ``pmean`` of
the cotangent), so each rank's statistics receive the mean of every
rank's cotangent.  At group size 1 the result is bitwise the
unsynchronized one.

``remat`` (reference ``resnet.py:205``, ``:242-254``) applies to each
residual block; the stem stays outside.  ``"full"`` checkpoints the block:
it saves only the block's input and recomputes the block in the backward.
A recompute updates no running statistic and issues no statistics
all-reduce: the first pass queues the updates (applied once the block
returns) and keeps the synchronized statistics, which the recompute
reuses.  ``"lean"`` is the reference's "save anything except the tensors
tagged ``act``": the backward keeps everything it keeps without remat
except the post-BN/ReLU activations inside a block, which it recomputes
from the f32 centred input that BatchNorm's backward keeps anyway
(:class:`_LeanActs`, saved-tensor hooks, no checkpoint: the forward runs
once).  So each such activation's bf16 copy is not held between forward
and backward, at the cost of one elementwise pass per activation in the
backward.  The block's output ReLU, also tagged ``act`` in the reference,
stays saved: its recompute would keep the pre-ReLU sum, as many bytes.
Under either the running statistics change once a step, and every value
is bitwise the one without remat.  flax's ``nn.remat`` renames a block
``CheckpointBottleneckBlock_<k>``; the port keeps ``BottleneckBlock_<k>``,
so one state dict serves every ``remat``.

Submodules carry flax's names (``conv_init``, ``norm_init``,
``BottleneckBlock_3``, ``Conv_1``, ``BatchNorm_2``, ``conv_proj``,
``norm_proj``, ``head``) and parameters flax's leaf names (``kernel``,
``scale``, ``bias``; buffers ``mean``, ``var``), so a state-dict key is the
flax path joined with dots (see :mod:`horovod_tpu_torch.models.convert`).
"""

from __future__ import annotations

import contextvars
import functools
import math
import weakref
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops.fused_stem import fused_bn_relu_maxpool

Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]

STEMS = ("conv7", "s2d", "s2d_fused")
REMATS = (None, "lean", "full")

# Forward statistics all-reduces of synchronized BatchNorm: one per layer
# and train-mode forward pass (none in a recompute).
stats_allreduce_calls = _build.CallCounter("bn_stats_allreduce")
# Post-BN/ReLU activations that remat="lean" recomputed in a backward.
act_recomputes = _build.CallCounter("resnet_lean_act_recompute")


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
    default), ``"VALID"`` or explicit ``((top, bottom), (left, right))``."""

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
        elif self.padding == "VALID":
            pads = ((0, 0), (0, 0))
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


def resolve_axis(axis_name):
    """The group a synchronized BatchNorm averages over: None (per-replica
    statistics), a process group, or an axis name that the default mesh
    (``hvd.mesh()``) resolves; the default world group comes back as
    ``dist.group.WORLD``, since None means no synchronization here."""
    if not isinstance(axis_name, str):
        return axis_name
    from horovod_tpu_torch import basics
    group = basics.mesh().axis(axis_name)
    return group if group is not None else dist.group.WORLD


class _StatsMean(torch.autograd.Function):
    """``lax.pmean`` of a BatchNorm's concatenated f32 ``[mean, E[x^2]]``
    over ``group``: one all-reduce (a sum, then a divide by the group
    size).  Backward: JAX's transpose of that ``pmean`` under
    ``check_vma=False``, the cotangent divided by the group size, then
    summed over the group.

    ``cached`` is the result of the same call in a block's first pass,
    handed back by a ``"full"`` recompute, which then issues no
    all-reduce."""

    @staticmethod
    def forward(ctx, local, group, cached):
        ctx.group = group
        if cached is not None:
            return cached.clone()
        out = local.clone()
        dist.all_reduce(out, group=group)
        stats_allreduce_calls.add()
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad / dist.get_world_size(ctx.group)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


class _RematPass:
    """One ``"full"`` checkpointed block call.  Its first pass queues the
    running-statistic updates of the block's BatchNorms (applied once the
    block returns) and keeps their synchronized statistics; the recompute
    in the backward reuses those and updates nothing."""

    def __init__(self):
        self.recompute = False
        self.updates = []      # (BatchNorm, mean, var) of the first pass
        self.synced = {}       # BatchNorm -> its all-reduced statistics


_REMAT_PASS: contextvars.ContextVar = contextvars.ContextVar(
    "resnet_remat_pass", default=None)


def _norm_apply(xc, mul, bias, dtype):
    """BatchNorm's apply on the centred f32 input, cast to ``dtype``."""
    return (xc * mul[:, None, None] + bias[:, None, None]).to(dtype)


class _Recompute:
    """How the backward gets a post-BN/ReLU activation back: ``relu`` of
    the apply on tensors the backward keeps anyway.  Computed at the
    first unpack and dropped after the last one it was packed for."""

    def __init__(self, xc, mul, bias, dtype):
        self.args = (xc, mul, bias, dtype)
        self.packs = 0
        self.value = None

    def get(self) -> torch.Tensor:
        if self.value is None:
            with torch.no_grad():
                self.value = torch.relu(_norm_apply(*self.args))
            act_recomputes.add()
        value = self.value
        self.packs -= 1
        if self.packs <= 0:
            self.value = None
        return value


class _LeanActs:
    """The saved-tensor hooks of ``remat="lean"`` over one forward of the
    blocks: a tensor saved for the backward is kept as it is, unless it
    is a post-BN/ReLU activation made by :meth:`act`; that one is saved
    as its :class:`_Recompute`."""

    def __init__(self):
        self.acts = {}         # id(activation) -> (weakref, _Recompute)

    def act(self, xc, mul, bias, dtype) -> torch.Tensor:
        recipe = _Recompute(xc.detach(), mul.detach(), bias.detach(), dtype)
        return _Act.apply(_norm_apply(xc, mul, bias, dtype), self, recipe)

    def pack(self, t: torch.Tensor):
        hit = self.acts.get(id(t))
        if hit is None or hit[0]() is not t:
            return t
        hit[1].packs += 1
        return hit[1]

    @staticmethod
    def unpack(saved):
        return saved.get() if isinstance(saved, _Recompute) else saved


class _Act(torch.autograd.Function):
    """``relu(z)``, registered with the lean hooks before it is saved, so
    that its own save, and the next convolution's, keep its recipe; the
    backward is autograd's for relu, ``threshold_backward(g, y, 0)``."""

    @staticmethod
    def forward(ctx, z, acts, recipe):
        y = torch.relu(z)
        acts.acts[id(y)] = (weakref.ref(y), recipe)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        y, = ctx.saved_tensors
        return torch.ops.aten.threshold_backward(grad, y, 0), None, None


_LEAN_ACTS: contextvars.ContextVar = contextvars.ContextVar(
    "resnet_lean_acts", default=None)


def _at_least_f32(x: torch.Tensor) -> torch.dtype:
    """flax's statistics dtype: ``promote_types(x.dtype, float32)``."""
    return torch.promote_types(x.dtype, torch.float32)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW.

    Train mode: mean and the fast variance ``max(E[x^2] - E[x]^2, 0)`` in
    f32 (f64 for an f64 model), the two means averaged over ``axis_name``
    when it is set (see the module docstring); running statistics updated
    with that (biased) variance as ``ra = momentum*ra + (1-momentum)*batch``.
    Eval mode: the running statistics.  The normalisation runs in f32 and
    is cast to ``dtype``.  ``nn.BatchNorm2d`` differs on all three counts.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False, axis_name=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.epsilon = momentum, epsilon
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.axis_name = axis_name

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    @torch.no_grad()
    def update_statistics(self, mean: torch.Tensor,
                          var: torch.Tensor) -> None:
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)

    def statistics(self, x: torch.Tensor):
        """(mean, var) to normalise with; updates the running statistics
        in train mode (under remat, once the block returns)."""
        if not self.training:
            return self.mean, self.var
        xf = x.to(_at_least_f32(x))
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        rp = _REMAT_PASS.get()
        if self.axis_name is not None:
            cached = rp.synced[self] if rp is not None and rp.recompute \
                else None
            both = _StatsMean.apply(torch.cat([mean, mean2]),
                                    self.axis_name, cached)
            if rp is not None and not rp.recompute:
                rp.synced[self] = both.detach()
            mean, mean2 = both.chunk(2)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        if rp is None:
            self.update_statistics(mean, var)
        elif not rp.recompute:
            rp.updates.append((self, mean.detach(), var.detach()))
        return mean, var

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """The normalized ``x``; ``relu(...)`` of it with ``relu``, which
        under ``remat="lean"`` the backward recomputes."""
        mean, var = self.statistics(x)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        xc = x.to(_at_least_f32(x)) - mean[:, None, None]
        lean = _LEAN_ACTS.get()
        if relu and lean is not None:
            return lean.act(xc, mul, self.bias, self.dtype)
        y = _norm_apply(xc, mul, self.bias, self.dtype)
        return torch.relu(y) if relu else y


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
                 dtype: torch.dtype = torch.bfloat16, axis_name=None):
        super().__init__()
        out = filters * 4
        norm = functools.partial(BatchNorm, dtype=dtype, axis_name=axis_name)
        self.Conv_0 = Conv(in_features, filters, (1, 1), dtype=dtype)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, dtype=dtype)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = Conv(filters, out, (1, 1), dtype=dtype)
        self.BatchNorm_2 = norm(out, zero_scale=True)
        # flax adds the projection when the residual's shape differs from
        # the block output's: a channel change or a stride.
        self.project = in_features != out or tuple(strides) != (1, 1)
        if self.project:
            self.conv_proj = Conv(in_features, out, (1, 1), strides,
                                  dtype=dtype)
            self.norm_proj = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        y = self.BatchNorm_1(self.Conv_1(y), relu=True)
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
                 dtype: torch.dtype = torch.bfloat16, axis_name=None):
        super().__init__()
        norm = functools.partial(BatchNorm, dtype=dtype, axis_name=axis_name)
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides, dtype=dtype)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), dtype=dtype)
        self.BatchNorm_1 = norm(filters, zero_scale=True)
        self.project = in_features != filters or tuple(strides) != (1, 1)
        if self.project:
            self.conv_proj = Conv(in_features, filters, (1, 1), strides,
                                  dtype=dtype)
            self.norm_proj = norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.BatchNorm_0(self.Conv_0(x), relu=True)
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.project:
            residual = self.norm_proj(self.conv_proj(residual))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 over NHWC inputs (reference ``resnet.py:187``).

    ``stem``: ``"conv7"`` (7x7/s2 on ``[B, 224, 224, 3]``), ``"s2d"`` (the
    exact 4x4/s1 reparameterization on space-to-depth input
    ``[B, 112, 112, 12]``) or ``"s2d_fused"`` (``"s2d"`` with BN-apply,
    relu and max-pool as one kernel).  ``axis_name``: the group to
    synchronize BatchNorm statistics over (:func:`resolve_axis`; None
    keeps them per replica).  ``remat``: None, ``"lean"`` or ``"full"``
    (the module docstring).  Parameters are initialised from
    ``generator`` on the CPU, then moved to ``device`` (default
    ``cuda:<local_rank>``; pass ``"cpu"`` to stay on the CPU).
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv7",
                 axis_name=None, remat: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"stem={stem!r}: expected 'conv7', 's2d' or "
                             f"'s2d_fused'")
        if remat not in REMATS:
            raise ValueError(
                f"remat={remat!r}: expected None, 'lean' or 'full'")
        from horovod_tpu_torch.basics import resolve_device
        dev = resolve_device(device)
        axis_name = resolve_axis(axis_name)
        self.stem, self.dtype, self.remat = stem, dtype, remat
        if stem in ("s2d", "s2d_fused"):
            # space-to-depth input: 2x2 RGB patches packed into 12 channels
            self.conv_init = Conv(12, num_filters, (4, 4), (1, 1),
                                  ((2, 1), (2, 1)), dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, (7, 7), (2, 2),
                                  ((3, 3), (3, 3)), dtype=dtype)
        norm_cls = FusedStemNorm if stem == "s2d_fused" else BatchNorm
        self.norm_init = norm_cls(num_filters, dtype=dtype,
                                  axis_name=axis_name)
        features = num_filters
        k = 0
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                self.add_module(f"{block_cls.__name__}_{k}",
                                block_cls(features, filters, strides, dtype,
                                          axis_name))
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
        if self.remat == "lean" and torch.is_grad_enabled():
            acts = _LeanActs()
            token = _LEAN_ACTS.set(acts)
            try:
                with torch.autograd.graph.saved_tensors_hooks(
                        acts.pack, acts.unpack):
                    x = self._blocks(x)
            finally:
                _LEAN_ACTS.reset(token)
        else:
            x = self._blocks(x)
        x = x.mean(dim=(2, 3))
        return self.head(x).float()

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_blocks):
            block = getattr(self, f"{self.block_name}_{k}")
            x = _full_remat_block(block, x) if self.remat == "full" \
                else block(x)
        return x


def _full_remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under activation checkpointing; the running statistics
    are updated once, here."""
    rp = _RematPass()

    def run(inp):
        token = _REMAT_PASS.set(rp)
        try:
            return block(inp)
        finally:
            _REMAT_PASS.reset(token)
            rp.recompute = True

    y = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    for bn, mean, var in rp.updates:
        bn.update_statistics(mean, var)
    return y


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
