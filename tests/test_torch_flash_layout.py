"""What the flash kernels' TMA tensor maps rely on, checked on the CPU.

The Hopper forward, dQ and dK/dV kernels read q, k, v, o and dO through
TMA tensor maps built over the strides that ``_Geometry`` reports: a 4-D map
(d, t, h, b) over ``[B, T, H, D]`` in place, or over the folded
``[B*H, T, D]`` as H = 1.  TMA needs a 16-byte-aligned base and every
stride but the innermost a multiple of 16 bytes.  ``_kernel_operands``
must hand the kernels such tensors whatever view the caller passes, with
the values unchanged; these tests hold it to that for odd views, every
head dim the kernels take and both layouts.  (The kernels themselves are
held to their plain versions on the card: ``tests/test_torch_cuda_kernels.py``.)
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

B, T, H = 2, 24, 3
VIEWS = ["contiguous", "t_offset_1", "element_offset_1", "transposed",
         "fused_qkv"]


def _base(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _view(kind, layout, d, seed):
    """A bf16 tensor of ``[B, T, H, D]`` (``bthd``) or ``[B*H, T, D]``
    (``folded``) made as the given kind of view."""
    lead = (B, T, H) if layout == "bthd" else (B * H, T)
    shape = lead + (d,)
    if kind == "contiguous":
        return _base(shape, seed)
    if kind == "t_offset_1":       # a slice starting at position 1
        return _base((lead[0], T + 1) + lead[2:] + (d,), seed)[:, 1:]
    if kind == "element_offset_1":  # contiguous, but 2 bytes off alignment
        n = 1
        for s in shape:
            n *= s
        return _base((n + 1,), seed)[1:].view(shape)
    if kind == "transposed":       # time and head (or batch*head) swapped
        if layout == "bthd":
            return _base((B, H, T, d), seed).transpose(1, 2)
        return _base((T, B * H, d), seed).transpose(0, 1)
    # one third of a fused qkv projection
    if layout == "bthd":
        return _base((B, T, 3, H, d), seed)[:, :, 1]
    return _base((B * H, T, 3, d), seed)[:, :, 1]


def _expected_strides(layout, d):
    if layout == "bthd":
        return (T * H * d, H * d, d)
    return (T * d, d, 0)


@pytest.mark.parametrize("layout", ["bthd", "folded"])
@pytest.mark.parametrize("d", tfa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("kind", VIEWS)
def test_kernel_operands_meet_tma_alignment(kind, d, layout):
    """Contiguous, 16-byte-aligned base, every non-innermost stride a
    multiple of 16 bytes, values and shape kept, and the strides the maps
    are built from are those of the dense layout."""
    views = [_view(kind, layout, d, seed) for seed in range(3)]
    out = tfa._kernel_operands(*views)
    for got, want in zip(out, views):
        assert got.is_contiguous()
        assert got.data_ptr() % 16 == 0
        assert got.stride()[-1] == 1
        assert all(s * got.element_size() % 16 == 0
                   for s in got.stride()[:-1])
        assert got.shape == want.shape and torch.equal(got, want)
    g = tfa._Geometry(out[0], None)
    assert g.strides == _expected_strides(layout, d)
    assert all(s * 2 % 16 == 0 for s in g.strides)


@pytest.mark.parametrize("layout", ["bthd", "folded"])
@pytest.mark.parametrize("seg_rows", [None, B])
def test_geometry_of_both_layouts(layout, seg_rows):
    """``_Geometry``: batch*head rows, heads per batch row (1 when
    folded), the element strides of batch, time and head, and the
    batch*head rows per segment-id row."""
    x = _view("contiguous", layout, 32, 0)
    seg = None if seg_rows is None else torch.zeros((seg_rows, T),
                                                    dtype=torch.int32)
    g = tfa._Geometry(x, seg)
    assert (g.bh, g.t, g.d) == (B * H, T, 32)
    assert g.h == (H if layout == "bthd" else 1)
    assert g.strides == _expected_strides(layout, 32)
    assert g.seg_heads == (1 if seg is None else H)


def test_misaligned_operand_is_copied_not_shifted():
    """A contiguous operand whose base is 2 bytes off alignment is cloned
    to an aligned one; an aligned one is passed through untouched."""
    x = _view("element_offset_1", "bthd", 64, 1)
    y = _view("contiguous", "bthd", 64, 2)
    assert x.data_ptr() % 16 != 0
    ox, oy = tfa._kernel_operands(x, y)
    assert ox.data_ptr() % 16 == 0 and torch.equal(ox, x)
    assert oy.data_ptr() == y.data_ptr()
