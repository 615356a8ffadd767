"""Inception-v3's average pool and gradients on the card.

PyTorch's channels-last CUDA kernel of ``F.avg_pool2d``'s backward (3x3,
stride 1, padding 1) shifts its windows at a padded border, in every
dtype; the port's ``models/inception._avg_pool_same`` pools an NCHW copy
on every device.  The card tests hold the pool (f32 and f64) and a
whole Inception-v3's f32 gradients (eval mode) on the card to the CPU's
f64 ones; they carry the ``cuda`` marker and skip without a device.  This file
imports torch and the port only, so it runs on a GPU host without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_inception.py -m cuda

On the CPU the same route is held to its definition (pad with zeros, sum
the 3x3 window, divide by 9) in both layouts.
"""

import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch.models import get_model
from horovod_tpu_torch.models.inception import _avg_pool_same

LAYOUTS = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the repaired path is the card's)")


def _by_definition(x):
    p = F.pad(x, (1, 1, 1, 1))
    h, w = x.shape[2], x.shape[3]
    return sum(p[:, :, i:i + h, j:j + w] for i in range(3)
               for j in range(3)) / 9


def _pool_and_grad(pool, x, gy):
    x = x.detach().requires_grad_(True)
    y = pool(x)
    gx, = torch.autograd.grad(y, x, gy)
    return y.detach(), gx


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (2, 3, 1, 1)])
def test_avg_pool_is_its_definition_on_the_cpu(layout, shape):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    gy = torch.randn(shape, generator=g, dtype=torch.float64)
    x = x.contiguous(memory_format=LAYOUTS[layout])
    got = _pool_and_grad(_avg_pool_same, x, gy)
    want = _pool_and_grad(_by_definition, x, gy)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-14)
    assert got[0].is_contiguous(memory_format=LAYOUTS[layout])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (16, 288, 15, 15),
                                   (16, 2048, 3, 3), (2, 2048, 1, 1)])
def test_avg_pool_on_the_card_equals_the_cpus(cuda_device, layout, dtype,
                                               tol, shape):
    """Tolerance: f32 1e-5, f64 1e-12 absolute on unit-normal values
    (the broken backward was off by 0.9-1.7)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    gy = torch.randn(shape, generator=g, dtype=torch.float64)
    want = _pool_and_grad(_by_definition, x, gy)
    card = x.to(dtype).cuda().contiguous(memory_format=LAYOUTS[layout])
    got = _pool_and_grad(_avg_pool_same, card, gy.to(dtype).cuda())
    for name, a, b in zip(("forward", "backward"), got, want):
        err = (a.double().cpu() - b).abs().max().item()
        assert err <= tol, (name, err)
    assert got[0].is_contiguous(memory_format=LAYOUTS[layout])


@pytest.mark.cuda
def test_inception_gradients_on_the_card_equal_the_cpus(cuda_device):
    """Inception-v3 at 75x75, batch 2, in eval mode (BatchNorm is then an
    affine map, so nothing amplifies rounding), TF32 off: the f32
    parameter gradients of the card's forward and backward within 1e-3
    of the CPU's f64 ones, relative to each parameter's largest entry
    (the pool branches' were wrong before the repair)."""
    g = torch.Generator().manual_seed(3)
    images = torch.randn(2, 75, 75, 3, generator=g)
    labels = torch.randint(0, 5, (2,), generator=g)
    grads = []
    for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
        model = get_model("inception3", num_classes=5, dtype=dtype,
                          device=dev,
                          generator=torch.Generator().manual_seed(0))
        model.eval()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            loss = F.cross_entropy(model(images.to(dev, dtype)).double(),
                                   labels.to(dev))
            names, params = zip(*model.named_parameters())
            got = torch.autograd.grad(loss, params)
        grads.append(dict(zip(names, (p.double().cpu() for p in got))))
    worst = {}
    for name, want in grads[0].items():
        scale = want.abs().max().item() or 1.0
        worst[name] = (grads[1][name] - want).abs().max().item() / scale
    assert max(worst.values()) <= 1e-3, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
