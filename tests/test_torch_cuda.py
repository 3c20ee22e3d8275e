"""The port's CUDA kernels on the card. Every test here is marked ``cuda``
and skips without an NVIDIA GPU.

This file imports torch and the port only, so it runs on a machine without
JAX; tests/conftest.py imports JAX, hence ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

Tolerances, relative to max |plain| for the voxel convs and norm-relative
(|kernel - plain| / |plain|, Frobenius norms) for the flash kernels: fp32
1e-4 (summation order only, TF32 off for the plain conv and matmuls; K5's
dq sums by atomics, in an order that varies from run to run); bf16 2e-2
(the output is rounded to bf16, K2's plain version also rounds its
upsampled input, which the kernel keeps in fp32, and the flash kernels
round p relative to a running maximum where the plain version uses the
row's).
"""

import pytest
import torch
import torch.utils.checkpoint

from muvo_tpu_torch.models.stylegan import VoxelDecoder
from muvo_tpu_torch.ops import flash_attention as fa
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
    g = torch.ones_like(x)
    with pytest.raises(ValueError):  # the mask needs the forward output
        zconv.zconv3d_dx(g, None, w, 0.2)
    with pytest.raises(ValueError):  # K2's output z is even
        zconv.upzconv3d_dx(g[:, :, :, :19], g[:, :, :, :19], w, 0.2)
    assert zconv.zconv3d_leaky.launches == n  # nothing launched
    with torch.no_grad():
        zconv.zconv3d_leaky(x, w.clone().requires_grad_(), b)
    assert zconv.zconv3d_leaky.launches == n + 1


BACKWARD = {
    "K1": (zconv.zconv3d_leaky_plain, zconv.zconv3d_dx,
           zconv.zconv3d_dx_plain, zconv.zconv3d_dw,
           zconv.zconv3d_dw_plain),
    "K2": (zconv.upzconv3d_leaky_plain, zconv.upzconv3d_dx,
           zconv.upzconv3d_dx_plain, zconv.upzconv3d_dw,
           zconv.upzconv3d_dw_plain),
}


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("kid", ["K1", "K2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", [
    ((2, 12, 10, 20, 16), 8),   # several y tiles, ragged last tile
    ((1, 5, 7, 19, 3), 5),      # odd C, Cout not a multiple of 8
    ((1, 1, 1, 20, 4), 12),     # one voxel column: all x/y halo is padding
    ((3, 4, 33, 1, 8), 8),      # z of 1 (K2: 2), clamped interpolation
    ((1, 6, 6, 16, 32), 16),    # the widest stage's channels
    ((1, 3, 4, 6, 40), 20),     # more dW units than two per thread
])
@pytest.mark.parametrize("act", [True, False])
def test_backward_kernels_match_plain(dev, kid, dtype, shape, cout, act):
    """K1-dx / K2-dx and K3 / K3-up on the card against their plain
    versions on the same inputs (dW and dbias are fp32 on both sides)."""
    forward, dx_k, dx_p, dw_k, dw_p = BACKWARD[kid]
    x, w, b = _inputs(dev, shape, cout, dtype)
    slope = 0.2 if act else None
    out = forward(x, w, b if act else None, slope)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).to(dtype)
    n = (dx_k.launches, dw_k.launches)
    dx = dx_k(g, out, w, slope)
    dw, db = dw_k(x, g, out, slope, with_bias=act)
    torch.cuda.synchronize()
    assert (dx_k.launches, dw_k.launches) == (n[0] + 1, n[1] + 1)
    dx_want = dx_p(g, out, w, slope)
    dw_want, db_want = dw_p(x.float(), g.float(), out.float(), slope, act)
    assert dx.dtype == dtype and dx.shape == x.shape and dx.is_contiguous()
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    assert _rel(dx, dx_want) <= TOL[dtype]
    assert _rel(dw, dw_want) <= TOL[dtype]
    if act:
        assert db.shape == (cout,) and _rel(db, db_want) <= TOL[dtype]
    else:
        assert db is None


@pytest.mark.parametrize("kid", ["K1", "K2"])
def test_autograd_on_card_matches_host(dev, kid):
    """The autograd Function on the card (forward and backward kernels,
    under torch.utils.checkpoint) against the same Function on the host
    (plain versions), fp32."""
    fn = zconv.zconv3d_leaky if kid == "K1" else zconv.upzconv3d_leaky
    x, w, b = _inputs(dev, (2, 8, 9, 10, 6), 5, torch.float32)
    grads = []
    for d in (dev, torch.device("cpu")):
        xs = [t.detach().to(d).requires_grad_() for t in (x, w, b)]
        out = torch.utils.checkpoint.checkpoint(
            fn, *xs, 0.2, use_reentrant=False)
        (out.square().sum()).backward()
        grads.append([t.grad.cpu() for t in xs])
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-4


def test_autocast_gives_the_kernels_bf16(dev):
    x, w, b = _inputs(dev, (1, 4, 6, 20, 4), 4, torch.float32)
    w.requires_grad_()
    n = zconv.zconv3d_dw.launches
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = zconv.zconv3d_leaky(x, w, b)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert w.grad.dtype == torch.float32
    assert zconv.zconv3d_dw.launches == n + 1


def _norm_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _qkv(dev, bh, n, d, dtype, seed=0, count=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=dev).to(dtype)
            for _ in range(count)]


# (bh, n, seq_len): ragged n; seq_len < n inside a key tile; key tiles of
# masked keys only; a single tile
FLASH_SHAPES = [(3, 300, None), (2, 640, 600), (2, 200, 60), (1, 64, None)]


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,seq_len", FLASH_SHAPES)
def test_flash_kernels_match_plain(dev, d, dtype, bh, n, seq_len):
    """K4, K5 and K6 (dq, dkv) against their plain versions on the same
    inputs, norm-relative (K5's dq sums by atomics in a varying order)."""
    q, k, v, do = _qkv(dev, bh, n, d, dtype, count=4)
    n0 = (fa.flash_fwd.launches, fa.flash_bwd.launches,
          fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, seq_len)
    fused = fa.flash_bwd(q, k, v, o, lse, do, seq_len)
    split = fa.flash_bwd(q, k, v, o, lse, do, seq_len, split=True)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches,
            fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(
                c + 1 for c in n0)
    o_want, lse_want = fa.flash_fwd_plain(q, k, v, seq_len)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _norm_rel(o, o_want) <= TOL[dtype]
    assert _norm_rel(lse, lse_want) <= TOL[dtype]
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)
    for got in (fused, split):
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert _norm_rel(g, w) <= TOL[dtype]


@pytest.mark.parametrize("d", [32, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_matmul_matches_plain(dev, d, dtype):
    q, k, v = _qkv(dev, 2, 300, d, dtype)
    n = fa.flash_matmul.launches
    got = fa.flash_matmul(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_matmul.launches == n + 1
    assert _norm_rel(got, fa.flash_matmul_plain(q, k, v)) <= TOL[dtype]


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_flash_autograd_on_card_matches_host(dev, bwd):
    """flash_attention's Function on the card (K4, then K5 or K6) against
    the same Function on the host (plain versions), fp32."""
    q, k, v, g = _qkv(dev, 2, 200, 48, torch.float32, count=4)
    results = []
    for d in (dev, torch.device("cpu")):
        xs = [t.detach().to(d).reshape(1, 2, 200, 48).requires_grad_()
              for t in (q, k, v)]
        out = fa.flash_attention(*xs, seq_len=150, bwd=bwd)
        out.backward(g.to(d).reshape(out.shape))
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in xs])
    for got, want in zip(*results):
        assert _norm_rel(got, want) <= 1e-4


def test_flash_wrapper_raises_on_what_the_kernels_do_not_take(dev):
    q, k, v = _qkv(dev, 2, 100, 48, torch.float32)
    n = fa.flash_fwd.launches
    with pytest.raises(TypeError):
        fa.flash_fwd(q.double(), k.double(), v.double())
    w = torch.randn((2, 100, 40), device=dev)
    with pytest.raises(ValueError):  # head dim
        fa.flash_fwd(w, w, w)
    with pytest.raises(ValueError):  # not contiguous
        fa.flash_fwd(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1))
    with pytest.raises(ValueError):  # seq_len past n
        fa.flash_fwd(q, k, v, 101)
    assert fa.flash_fwd.launches == n
    fa.flash_fwd(q, k, v)
    assert fa.flash_fwd.launches == n + 1


def test_attention_takes_flash_from_2048_tokens_on_the_card(dev):
    from muvo_tpu_torch.ops.attention import multi_head_attention

    for tokens, launched in ((648, 0), (2048, 1)):
        x = torch.randn((1, tokens, 96), device=dev)
        n = fa.flash_fwd.launches
        got = multi_head_attention(x, x, x, 2)
        torch.cuda.synchronize()
        assert fa.flash_fwd.launches - n == launched
        want = multi_head_attention(x.cpu(), x.cpu(), x.cpu(), 2)
        assert _norm_rel(got, want) <= 1e-4


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
