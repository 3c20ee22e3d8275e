"""The port's CUDA kernels on the card. Every test here is marked ``cuda``
and skips without an NVIDIA GPU.

This file imports torch and the port only, so it runs on a machine without
JAX; tests/conftest.py imports JAX, hence ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

Tolerances, relative to max |plain|: fp32 1e-4 (summation order only, TF32
off for the plain conv); bf16 2e-2 (the output is rounded to bf16, and K2's
plain version also rounds its upsampled input, which the kernel keeps in
fp32).
"""

import pytest
import torch

from muvo_tpu_torch.models.stylegan import VoxelDecoder
from muvo_tpu_torch.ops import zconv

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
KERNELS = {"K1": (zconv.zconv3d_leaky, zconv.zconv3d_leaky_plain),
           "K2": (zconv.upzconv3d_leaky, zconv.upzconv3d_leaky_plain)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, shape, cout, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = (torch.randn((cout, c, 3, 3, 3), generator=gen, device=dev)
         / (27 * c) ** 0.5).to(dtype)
    b = torch.randn((cout,), generator=gen, device=dev).to(dtype)
    return x, w, b


@pytest.mark.parametrize("kid", ["K1", "K2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((2, 12, 10, 20, 16), 8),   # several y tiles, ragged last tile
    ((1, 5, 7, 19, 3), 5),      # odd C, Cout not a multiple of 8
    ((1, 1, 1, 20, 4), 12),     # one voxel column: all x/y halo is padding
    ((3, 4, 33, 1, 8), 8),      # z of 1 (K2: 2), clamped interpolation
    ((1, 6, 6, 16, 32), 16),    # the widest stage's channels: 1-row tiles
])
@pytest.mark.parametrize("act", [True, False])
def test_kernel_matches_plain(dev, kid, dtype, shape, cout, act):
    kernel, plain = KERNELS[kid]
    x, w, b = _inputs(dev, shape, cout, dtype)
    slope = 0.2 if act else None
    bias = b if act else None  # no-bias with no activation, as K1 allows
    n = kernel.launches
    got = kernel(x, w, bias, slope)
    want = plain(x, w, bias, slope)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    assert got.dtype == dtype and got.is_contiguous()
    assert got.shape == want.shape
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel.item() <= TOL[dtype]


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x, w, b = _inputs(dev, (1, 4, 4, 20, 4), 4, torch.float32)
    n = zconv.zconv3d_leaky.launches
    with pytest.raises(TypeError):
        zconv.zconv3d_leaky(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        zconv.zconv3d_leaky(x.transpose(1, 2), w, b)
    with pytest.raises(RuntimeError, match="no backward"):
        zconv.zconv3d_leaky(x, w.clone().requires_grad_(), b)
    assert zconv.zconv3d_leaky.launches == n  # nothing launched
    with torch.no_grad():
        zconv.zconv3d_leaky(x, w.clone().requires_grad_(), b)
    assert zconv.zconv3d_leaky.launches == n + 1


def test_voxel_decoder_on_card_matches_host(dev):
    """conv2 and conv3 (z 32, 64) launch K2 then K1 each; the whole decoder
    matches the same weights on the host (plain versions). Norm-relative
    2e-3, as the CPU test against muvo_tpu: the eps-1e-8 instance norms
    amplify summation-order noise."""
    torch.manual_seed(0)
    host = VoxelDecoder(8, 2, 16, (1, 1, 1)).eval()
    card = VoxelDecoder(8, 2, 16, (1, 1, 1)).eval()
    card.load_state_dict(host.state_dict())
    card.to(dev)
    w = torch.randn(2, 8)
    n = (zconv.zconv3d_leaky.launches, zconv.upzconv3d_leaky.launches)
    with torch.inference_mode():
        got = card(w.to(dev))
        want = host(w)
    torch.cuda.synchronize()
    assert (zconv.zconv3d_leaky.launches - n[0],
            zconv.upzconv3d_leaky.launches - n[1]) == (2, 2)
    for key, v in want.items():
        g = got[key].cpu()
        assert g.shape == v.shape
        rel = (g - v).abs().max() / max(1.0, v.abs().max().item())
        assert rel.item() < 2e-3, (key, rel.item())
