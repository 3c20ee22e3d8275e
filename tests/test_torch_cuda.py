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

import os
import re
import sys
import time

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
    key = str(dtype).removeprefix("torch.")
    n, typed = kernel.launches, kernel.launches_by_type.get(key, 0)
    got = kernel(x, w, bias, slope)
    want = plain(x, w, bias, slope)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    assert kernel.launches_by_type[key] == typed + 1  # counted by type
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


@pytest.mark.parametrize("kid", ["K1", "K2"])
def test_kernels_without_grad_under_autocast_match_plain(dev, kid):
    """An eval or inference step in bf16 calls K1 and K2 without autograd,
    inside autocast (the wrapper casts): the same result as the plain
    version on the bf16 inputs, at an eval step's batch of 4 frames."""
    up = kid == "K2"
    shape = (4, 24, 20, 16, 32) if up else (4, 24, 20, 32, 16)
    x, w, b = _inputs(dev, shape, 16, torch.float32)
    fn = zconv.upzconv3d_leaky if up else zconv.zconv3d_leaky
    plain = zconv.upzconv3d_leaky_plain if up else zconv.zconv3d_leaky_plain
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        got = fn(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert fn.last_impl.startswith("tc::zconv_tc_kernel")
    want = plain(*(t.to(torch.bfloat16) for t in (x, w, b)), 0.2)
    assert _rel(got.float(), want.float()) <= 2e-2


def _norm_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _qkv(dev, bh, n, d, dtype, seed=0, count=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=dev).to(dtype)
            for _ in range(count)]


def _finished(fn, seconds=120.0):
    """fn's result once the card has run what it launched. bf16 K5's
    consumers wait on each other at named barriers, which have no timeout:
    a lost arrival would hang the card, so this polls an event and ends
    the process (exit code 3) after ``seconds`` rather than leave every
    later test waiting on a kernel that never returns."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            print(f"a kernel did not finish within {seconds} s", flush=True,
                  file=sys.stderr)
            os._exit(3)
        time.sleep(0.001)
    return out


# (bh, n, seq_len): ragged n; seq_len < n inside a key tile; key tiles of
# masked keys only; a single tile; then the bf16 kernels' tile edges (128
# q rows a block, 128 keys a forward tile, 64 q rows a backward tile): n
# just under, on and just past 128, and seq_len on and just past a 128-key
# boundary. For bf16 K5, whose consumer t % 2 owns q tile t's dq: a single
# q tile (n 64, consumer 1 owns none), a block whose second key half lies
# wholly past seq_len (n 200, seq_len 60), odd tile counts (n 129, 257,
# 300) and 17 tiles (n 1025), room for the consumers to drift apart
FLASH_SHAPES = [(3, 300, None), (2, 640, 600), (2, 200, 60), (1, 64, None),
                (2, 127, None), (1, 128, None), (3, 129, None),
                (2, 257, 128), (2, 257, 129), (2, 1025, None)]


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,seq_len", FLASH_SHAPES)
def test_flash_kernels_match_plain(dev, d, dtype, bh, n, seq_len):
    """K4, K5 and K6 (dq, dkv) against their plain versions on the same
    inputs, norm-relative (K5's dq sums by atomics in a varying order); in
    bf16 K6-dkv's dk and dv equal to K5's bit for bit (one kernel: K5's
    dq work changes nothing of them); in fp32 K6-dkv's and K5's dk and dv
    equal to each other and to the plain version's bit for bit (one
    template, fp32::flash_bwd_kv_f32, in the plain version's summation
    order), and so is K6-dq's dq (fp32::flash_bwd_q_f32, the same order)."""
    q, k, v, do = _qkv(dev, bh, n, d, dtype, count=4)
    key = str(dtype).removeprefix("torch.")
    wrappers = (fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    n0 = (fa.flash_fwd.launches, fa.flash_bwd.launches,
          fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    typed = [f.launches_by_type.get(key, 0) for f in wrappers]
    o, lse = fa.flash_fwd(q, k, v, seq_len)
    fused = _finished(lambda: fa.flash_bwd(q, k, v, o, lse, do, seq_len))
    split = _finished(lambda: fa.flash_bwd(q, k, v, o, lse, do, seq_len,
                                           split=True))
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches,
            fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(
                c + 1 for c in n0)
    assert [f.launches_by_type[key] for f in wrappers] == [
        c + 1 for c in typed]  # counted by type
    o_want, lse_want = fa.flash_fwd_plain(q, k, v, seq_len)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _norm_rel(o, o_want) <= TOL[dtype]
    assert _norm_rel(lse, lse_want) <= TOL[dtype]
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)
    for got in (fused, split):
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert _norm_rel(g, w) <= TOL[dtype]
    assert torch.equal(split[1], fused[1]) and torch.equal(split[2],
                                                           fused[2])
    if dtype == torch.float32:
        ref = want
        if bh == 1:
            # cuBLAS sums a single batch's products in another order than a
            # batch of two or more, which the kernels keep, so at bh 1 the
            # plain version runs on the batch doubled
            ref = [w[:1] for w in fa.flash_bwd_plain(
                *(torch.cat([t, t]) for t in (q, k, v, o, lse, do)), seq_len)]
        assert all(torch.equal(g, w) for g, w in zip(fused[1:], ref[1:]))
        assert torch.equal(split[0], ref[0])


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


# bf16 K6 on the Hopper kernels: K6-dq is hopper::flash_bwd_dq_wgmma (128 q
# rows a block, 128-key tiles taken in halves of 64 keys), K6-dkv
# hopper::flash_bwd_wgmma<D, false> (K5's kernel without dq: 128 keys a
# block, 64-row q tiles). (bh, n, seq_len): tools/torch_flash_probe.py's
# edges, n just under, on and past 128, seq_len on and past a 128-key tile
K6_EDGES = [(1, 128, None), (2, 127, None), (3, 129, None), (2, 257, 128),
            (2, 257, 129), (2, 300, 200), (2, 200, 60), (1, 64, None)]


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("bh,n,seq_len", K6_EDGES)
def test_bf16_k6_runs_the_hopper_kernels(dev, d, bh, n, seq_len):
    """bf16 K6-dq and K6-dkv against the plain version, each launch counted
    once and named in ``last_impl``, a second launch giving the same bits,
    K6-dkv's dk and dv equal to K5's (the same kernel, products and order),
    and K6-dq's dq within one bf16 rounding of K5's, norm-relative (both
    sum the same bf16 products in fp32, in other orders, then round)."""
    q, k, v, do = _qkv(dev, bh, n, d, torch.bfloat16, count=4)
    o, lse = fa.flash_fwd(q, k, v, seq_len)
    n0 = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq = fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len)
    dk, dv = fa.flash_bwd_dkv(q, k, v, o, lse, do, seq_len)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches - n0[0],
            fa.flash_bwd_dkv.launches - n0[1]) == (1, 1)
    assert fa.flash_bwd_dq.last_impl == f"hopper::flash_bwd_dq_wgmma<{d}>"
    assert fa.flash_bwd_dkv.last_impl == f"hopper::flash_bwd_wgmma<{d}, false>"
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)
    for g, w in zip((dq, dk, dv), want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _norm_rel(g, w) <= TOL[torch.bfloat16]
    again = (fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len),
             *fa.flash_bwd_dkv(q, k, v, o, lse, do, seq_len))
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    fused = fa.flash_bwd(q, k, v, o, lse, do, seq_len)
    assert fa.flash_bwd.last_impl == f"hopper::flash_bwd_wgmma<{d}, true>"
    assert torch.equal(dk, fused[1]) and torch.equal(dv, fused[2])
    assert _norm_rel(dq, fused[0]) <= 2.0 ** -8


def test_bf16_k5_repeats_without_a_race(dev):
    """Five launches of bf16 K5 at 81 q tiles (the LARGE step's n): dk and
    dv the same bits every time; dq, summed by atomics in a varying order,
    within one bf16 rounding of the first launch's and within the bf16
    tolerance of the plain version. A buffer overwritten before its
    owner's product read it would show as an error far past both."""
    q, k, v, do = _qkv(dev, 4, 5184, 48, torch.bfloat16, count=4)
    o, lse = fa.flash_fwd(q, k, v)
    runs = [_finished(lambda: fa.flash_bwd(q, k, v, o, lse, do))
            for _ in range(5)]
    want = fa.flash_bwd_plain(q, k, v, o, lse, do)
    for dq, dk, dv in runs:
        assert torch.equal(dk, runs[0][1]) and torch.equal(dv, runs[0][2])
        assert _norm_rel(dq, runs[0][0]) <= 2.0 ** -8
        assert _norm_rel(dq, want[0]) <= TOL[torch.bfloat16]


# (bh, n, seq_len) of the fp32 K6 cases: a ragged q tail; seq_len just
# past a 64-key tile; seq_len on a key-tile edge; n a multiple of every
# block's q rows (64 and 128)
FP32_K6_CASES = [(3, 300, None), (2, 257, 129), (2, 257, 128), (2, 256, None)]


@pytest.mark.parametrize("d", [32, 48, 64])
@pytest.mark.parametrize("bh,n,seq_len", FP32_K6_CASES)
def test_fp32_k6_runs_the_register_tiled_kernels(dev, d, bh, n, seq_len):
    """fp32 K6-dq runs the q-major register-tiled fp32::flash_bwd_q_f32,
    fp32 K5 and K6-dkv the key-major fp32::flash_bwd_kv_f32. All equal the
    plain version bit for bit (K5's dq, summed by atomics, aside)."""
    q, k, v, do = _qkv(dev, bh, n, d, torch.float32, count=4)
    o, lse = fa.flash_fwd(q, k, v, seq_len)
    got = (fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len),
           *fa.flash_bwd_dkv(q, k, v, o, lse, do, seq_len))
    fused = fa.flash_bwd(q, k, v, o, lse, do, seq_len)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.last_impl == f"fp32::flash_bwd_q_f32<{d}>"
    assert fa.flash_bwd_dkv.last_impl == f"fp32::flash_bwd_kv_f32<{d}, false>"
    assert fa.flash_bwd.last_impl == f"fp32::flash_bwd_kv_f32<{d}, true>"
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(fused[1:], want[1:]))


@pytest.mark.parametrize("d", [32, 48, 64])
def test_fp32_k6_dq_repeats_bit_for_bit(dev, d):
    """Three launches of fp32 K6-dq at the LARGE step's n (81 blocks of 64
    q rows or 41 of 128 a head, 79 key tiles at seq_len 5000) give the same
    bits, each counted once, and equal the plain version's dq."""
    q, k, v, do = _qkv(dev, 4, 5184, d, torch.float32, count=4)
    o, lse = fa.flash_fwd(q, k, v, 5000)
    n0 = fa.flash_bwd_dq.launches
    runs = [fa.flash_bwd_dq(q, k, v, o, lse, do, 5000) for _ in range(3)]
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches - n0 == 3
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, 5000)[0]
    assert torch.equal(runs[0], want)


def test_k6_profile_names_the_kernels(dev):
    """The profiler sees flash_bwd_dq_wgmma and flash_bwd_wgmma<48, false>
    for bf16 K6 (and no CUDA-core kernel), flash_bwd_q_f32<48> and
    flash_bwd_kv_f32<48, false> for fp32 (and no wgmma kernel)."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = _qkv(dev, 2, 300, 48, dtype, count=4)
        o, lse = fa.flash_fwd(q, k, v)
        names = _kernel_names(lambda: fa.flash_bwd(q, k, v, o, lse, do,
                                                   split=True))
        cores = [k for k in names
                 if "flash_bwd_q_f32" in k or "flash_bwd_kv_f32" in k]
        if dtype == torch.bfloat16:
            assert any("flash_bwd_dq_wgmma<48>" in k for k in names), names
            assert any("flash_bwd_wgmma<48, false>" in k for k in names), names
            assert not cores, names
        else:
            assert any("flash_bwd_q_f32<48>" in k for k in names), names
            assert any("flash_bwd_kv_f32<48, false>" in k
                       for k in names), names
            assert not any("wgmma" in k for k in names), names


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


# bf16 K2 and K2-dx run zconv_tc_kernel on the small-z grid: a block covers
# ceil(128 / Zs) y rows (at most Y) and 8 x rows, 64-row tiles of (y, z)
@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 6, 1, 16), 8),       # Zs 1: both z edges on one slice
    ((1, 4, 9, 2, 32), 16),      # Zs 2: both z edges in one tile
    ((1, 11, 13, 16, 16), 8),    # X ends mid block (8 rows), Y mid block (8)
    ((2, 9, 7, 32, 16), 8),      # Zs 32: Y ends mid block (4 rows)
    ((1, 96, 96, 16, 32), 16),   # conv2.conv1 at full width, batch 1
    ((1, 192, 192, 32, 16), 8),  # conv3.conv1 at full width, batch 1
])
def test_bf16_up_kernels_on_the_small_z_grid(dev, shape, cout):
    x, w, b = _inputs(dev, shape, cout, torch.bfloat16)
    n = (zconv.upzconv3d_leaky.launches, zconv.upzconv3d_dx.launches)
    out = zconv.upzconv3d_leaky(x, w, b, 0.2)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).to(torch.bfloat16)
    dx = zconv.upzconv3d_dx(g, out, w, 0.2)
    torch.cuda.synchronize()
    assert (zconv.upzconv3d_leaky.launches - n[0],
            zconv.upzconv3d_dx.launches - n[1]) == (1, 1)
    assert _rel(out, zconv.upzconv3d_leaky_plain(x, w, b, 0.2)) <= 2e-2
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert _rel(dx, zconv.upzconv3d_dx_plain(g, out, w, 0.2)) <= 2e-2


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()]


def test_bf16_up_launches_the_tensor_core_kernel(dev):
    """The profile names zconv_tc_kernel<..., false> for bf16 K2 and
    zconv_tc_kernel<..., true> for bf16 K2-dx, and neither CUDA-core
    kernel; fp32 K2 runs zconv_up_f32_kernel (and not zconv_kernel<float,
    true>), fp32 K2-dx zconv_dxup_f32_kernel."""
    x, w, b = _inputs(dev, (1, 6, 7, 16, 32), 16, torch.bfloat16)
    out = zconv.upzconv3d_leaky(x, w, b, 0.2)
    fwd = _kernel_names(lambda: zconv.upzconv3d_leaky(x, w, b, 0.2))
    dx = _kernel_names(lambda: zconv.upzconv3d_dx(out, out, w, 0.2))
    assert any("zconv_tc_kernel" in k and "false>" in k for k in fwd), fwd
    assert any("zconv_tc_kernel" in k and "true>" in k for k in dx), dx
    assert not any("zconv_kernel<" in k or "zconv_dxup_kernel" in k
                   for k in fwd + dx)
    x32, w32, b32 = (t.float() for t in (x, w, b))
    out32 = zconv.upzconv3d_leaky(x32, w32, b32, 0.2)
    fwd = _kernel_names(lambda: zconv.upzconv3d_leaky(x32, w32, b32, 0.2))
    dx = _kernel_names(lambda: zconv.upzconv3d_dx(out32, out32, w32, 0.2))
    assert any("zconv_up_f32_kernel" in k for k in fwd), fwd
    assert not any("zconv_kernel<float, true>" in k for k in fwd), fwd
    assert any("zconv_dxup_f32_kernel" in k for k in dx), dx
    assert not any("zconv_kernel<" in k for k in dx), dx


# fp32 K2 runs f32conv::zconv_up_f32_kernel (csrc/zconv_f32.cu): 4 output z
# x 4 or 8 channels a thread, blocks walking runs of x rows over a ring of
# three planes, the plan from zconv.f32_plan
@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 6, 1, 16), 8),        # Zs 1: both z edges on one slice
    ((1, 4, 9, 2, 8), 8),         # Zs 2
    ((1, 3, 5, 3, 3), 5),         # Zs 3, C 3, Cout 5
    ((1, 7, 37, 16, 4), 16),      # Y ends mid tile (19 + 18), a run mid X
    ((2, 40, 6, 5, 6), 12),       # Zs 5, runs across (b, y tile) ends
    ((1, 96, 96, 16, 32), 16),    # conv2.conv1 at full width, batch 1
    ((1, 192, 192, 32, 16), 8),   # conv3.conv1 at full width, batch 1
])
def test_fp32_up_kernel_matches_plain_and_repeats(dev, shape, cout):
    """fp32 K2 against its plain version (1e-4 of max |plain|), the
    launch counted and named, a second launch giving the same bits."""
    x, w, b = _inputs(dev, shape, cout, torch.float32)
    n = zconv.upzconv3d_leaky.launches
    out = zconv.upzconv3d_leaky(x, w, b, 0.2)
    assert zconv.upzconv3d_leaky.last_impl == zconv.K2_F32_IMPL
    again = zconv.upzconv3d_leaky(x, w, b, 0.2)
    torch.cuda.synchronize()
    assert zconv.upzconv3d_leaky.launches == n + 2
    assert out.shape == (*shape[:3], 2 * shape[3], cout)
    assert torch.equal(out, again)
    assert _rel(out, zconv.upzconv3d_leaky_plain(x, w, b, 0.2)) <= 1e-4


# fp32 K1 runs f32conv::zconv_f32_kernel (csrc/zconv_f32.cu): fp32 K2's
# register tile, plane ring and walk, with plain z planes staged from x's y
# rows (float4 where Z x C allows), the plan from zconv.f32_plan
@pytest.mark.parametrize("shape,cout,act", [
    ((2, 5, 6, 1, 16), 8, True),       # Z 1
    ((1, 4, 9, 2, 8), 8, True),        # Z 2
    ((1, 3, 5, 3, 3), 5, True),        # Z 3, C 3, Cout 5: scalar loads
    ((1, 3, 37, 64, 4), 16, True),     # Y ends mid tile (13 + 13 + 11)
    ((2, 40, 6, 5, 6), 12, True),      # Z 5, runs across (b, y tile) ends
    ((1, 4, 5, 16, 32), 16, False),    # no activation, no bias
    ((1, 96, 96, 32, 16), 16, True),   # conv2.conv2 at full width, batch 1
    ((1, 192, 192, 64, 8), 8, True),   # conv3.conv2 at full width, batch 1
])
def test_fp32_k1_kernel_matches_plain_and_repeats(dev, shape, cout, act):
    """fp32 K1 against its plain version (1e-4 of max |plain|), the launch
    counted and named, a second launch giving the same bits."""
    x, w, b = _inputs(dev, shape, cout, torch.float32)
    slope = 0.2 if act else None
    bias = b if act else None
    n = zconv.zconv3d_leaky.launches
    out = zconv.zconv3d_leaky(x, w, bias, slope)
    assert zconv.zconv3d_leaky.last_impl == zconv.K1_F32_IMPL
    again = zconv.zconv3d_leaky(x, w, bias, slope)
    torch.cuda.synchronize()
    assert zconv.zconv3d_leaky.launches == n + 2
    assert out.shape == (*shape[:4], cout)
    assert torch.equal(out, again)
    assert _rel(out, zconv.zconv3d_leaky_plain(x, w, bias, slope)) <= 1e-4


# fp32 K1-dx and K2-dx run f32conv::zconv_dx_f32_kernel and
# zconv_dxup_f32_kernel (csrc/zconv_f32.cu): fp32 K1's walk on the masked
# cotangent, K2-dx on the small-z view with the adjoint fold's edge terms,
# the plan from zconv.f32_dx_plan
@pytest.mark.parametrize("kid", ["K1-dx", "K2-dx"])
@pytest.mark.parametrize("shape,cout,act", [
    ((3, 4, 33, 1, 8), 8, True),       # Z 1; K2: Zs 1, both edge terms
    ((1, 4, 9, 2, 8), 8, True),        # Z / Zs 2
    ((1, 3, 5, 3, 3), 5, True),        # odd channels: scalar loads
    ((1, 3, 37, 33, 8), 4, True),      # Y ends mid tile, z not 4k
    ((2, 40, 6, 7, 6), 12, True),      # z 7, runs across (b, y tile) ends
    ((1, 4, 5, 16, 32), 16, False),    # no activation: no mask
    ((1, 3, 4, 6, 40), 20, True),      # K2-dx: the fold's widest test
    ((1, 96, 96, 32, 16), 16, True),   # conv2.conv2 at full width
    ((1, 96, 96, 16, 32), 16, True),   # conv2.conv1
    ((1, 192, 192, 64, 8), 8, True),   # conv3.conv2
    ((1, 192, 192, 32, 16), 8, True),  # conv3.conv1
])
def test_fp32_dx_kernels_match_plain_and_repeat(dev, kid, shape, cout, act):
    """fp32 K1-dx and K2-dx against their plain versions (1e-4 of max
    |plain|), the launch counted and named, a second launch giving the same
    bits."""
    up = kid == "K2-dx"
    forward, dx_k, dx_p, _, _ = BACKWARD["K2" if up else "K1"]
    x, w, b = _inputs(dev, shape, cout, torch.float32)
    slope = 0.2 if act else None
    out = forward(x, w, b if act else None, slope)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    n = dx_k.launches
    dx = dx_k(g, out, w, slope)
    assert dx_k.last_impl == (zconv.K2_DX_F32_IMPL if up
                              else zconv.K1_DX_F32_IMPL)
    again = dx_k(g, out, w, slope)
    torch.cuda.synchronize()
    assert dx_k.launches == n + 2
    assert dx.shape == x.shape and dx.is_contiguous()
    assert torch.equal(dx, again)
    assert _rel(dx, dx_p(g, out, w, slope)) <= 1e-4


def test_fp32_dx_refuses_what_its_plan_does_not_take(dev):
    """A shape the plan refuses raises, with nothing launched and no other
    kernel or plain version run in its place: a 112-channel cotangent,
    whose block cannot hold the weights of even a slice of 4 dx channels
    (zconv.channel_slices)."""
    x, w, _ = _inputs(dev, (1, 2, 2, 16, 8), 112, torch.float32)
    g = torch.randn((1, 2, 2, 32, 112), device=dev)
    n = zconv.upzconv3d_dx.launches
    with pytest.raises(ValueError, match="fp32 K2-dx kernel"):
        zconv.upzconv3d_dx(g, g, w, 0.2)
    assert zconv.upzconv3d_dx.launches == n


# bf16 K1 and K1-dx run zconv_tc_kernel with no edge terms on the view
# zconv.k1_route picks: the pair view (z pairs folded into channels) where
# z is even and C or Cout is below 16, else the plain view; a block covers
# ceil(128 / Zs) y rows (at most Y) and 16 x rows with two warpgroups
@pytest.mark.parametrize("shape,cout,act,view", [
    ((2, 5, 6, 1, 16), 8, True, "plain"),      # Z 1
    ((1, 4, 9, 2, 8), 8, True, "pair"),        # Z 2: one pair slice
    ((1, 3, 5, 3, 3), 5, True, "plain"),       # Z 3 (odd), C 3, Cout 5
    ((1, 20, 13, 16, 16), 16, True, "plain"),  # X and Y end mid block
    ((1, 19, 11, 32, 8), 8, True, "pair"),     # the same on the pair view
    ((1, 3, 4, 6, 40), 12, True, "plain"),     # C 40 (2 C past 64), Cout 12
    ((1, 4, 5, 16, 32), 16, False, "plain"),   # no activation, no bias
    ((1, 96, 96, 32, 16), 16, True, "plain"),  # conv2.conv2 at full width
    ((1, 192, 192, 64, 8), 8, True, "pair"),   # conv3.conv2 at full width
])
def test_bf16_k1_kernels_on_the_tensor_cores(dev, shape, cout, act, view):
    """bf16 K1 and K1-dx against their plain versions, each launch counted
    once, ``last_impl`` naming the tensor-core kernel and the view, and a
    second launch giving the same bits."""
    x, w, b = _inputs(dev, shape, cout, torch.bfloat16)
    slope = 0.2 if act else None
    bias = b if act else None
    n = (zconv.zconv3d_leaky.launches, zconv.zconv3d_dx.launches)
    out = zconv.zconv3d_leaky(x, w, bias, slope)
    impl = zconv.zconv3d_leaky.last_impl
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).to(torch.bfloat16)
    dx = zconv.zconv3d_dx(g, out, w, slope)
    torch.cuda.synchronize()
    assert (zconv.zconv3d_leaky.launches - n[0],
            zconv.zconv3d_dx.launches - n[1]) == (1, 1)
    for name in (impl, zconv.zconv3d_dx.last_impl):
        assert name.startswith(f"tc::zconv_tc_kernel, {view} view"), name
    assert torch.equal(out, zconv.zconv3d_leaky(x, w, bias, slope))
    assert torch.equal(dx, zconv.zconv3d_dx(g, out, w, slope))
    assert out.shape == (*shape[:4], cout) and out.dtype == torch.bfloat16
    assert _rel(out, zconv.zconv3d_leaky_plain(x, w, bias, slope)) <= 2e-2
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert _rel(dx, zconv.zconv3d_dx_plain(g, out, w, slope)) <= 2e-2


def test_k1_last_impl_names_the_route(dev):
    """Past 64 channels bf16 K1 and K1-dx take the CUDA-core kernel, as
    k1_route says; fp32 K1 runs zconv_f32_kernel and fp32 K1-dx
    zconv_dx_f32_kernel at every width. All stay right."""
    x, w, b = _inputs(dev, (1, 3, 4, 6, 72), 8, torch.bfloat16)
    for t in (torch.bfloat16, torch.float32):
        x, w, b = x.to(t), w.to(t), b.to(t)
        out = zconv.zconv3d_leaky(x, w, b, 0.2)
        dx = zconv.zconv3d_dx(out, out, w, 0.2)
        name = "bf16" if t == torch.bfloat16 else "float"
        assert zconv.zconv3d_leaky.last_impl == (
            f"zconv_kernel<{name}>" if t == torch.bfloat16
            else zconv.K1_F32_IMPL)
        assert zconv.zconv3d_dx.last_impl == (
            f"zconv_kernel<{name}>" if t == torch.bfloat16
            else zconv.K1_DX_F32_IMPL)
        assert _rel(out, zconv.zconv3d_leaky_plain(x, w, b, 0.2)) <= TOL[t]
        assert _rel(dx, zconv.zconv3d_dx_plain(out, out, w, 0.2)) <= TOL[t]


def test_bf16_k1_launches_the_tensor_core_kernel(dev):
    """The profile names zconv_tc_kernel<NP, KS, false, false> for bf16 K1
    and zconv_tc_kernel<NP, KS, false, true> for bf16 K1-dx (no edge
    terms) on both views, and no CUDA-core kernel; fp32 K1 runs
    zconv_f32_kernel, fp32 K1-dx zconv_dx_f32_kernel."""
    for shape, cout in (((1, 6, 7, 32, 16), 16), ((1, 6, 7, 64, 8), 8)):
        x, w, b = _inputs(dev, shape, cout, torch.bfloat16)
        out = zconv.zconv3d_leaky(x, w, b, 0.2)
        fwd = _kernel_names(lambda: zconv.zconv3d_leaky(x, w, b, 0.2))
        dx = _kernel_names(lambda: zconv.zconv3d_dx(out, out, w, 0.2))
        assert any(re.search(r"zconv_tc_kernel<\d+, \d+, false, false>", k)
                   for k in fwd), fwd
        assert any(re.search(r"zconv_tc_kernel<\d+, \d+, false, true>", k)
                   for k in dx), dx
        assert not any("zconv_kernel<" in k for k in fwd + dx)
        x32, w32, b32, out32 = (t.float() for t in (x, w, b, out))
        fwd = _kernel_names(lambda: zconv.zconv3d_leaky(x32, w32, b32, 0.2))
        dx = _kernel_names(lambda: zconv.zconv3d_dx(out32, out32, w32, 0.2))
        assert any("zconv_f32_kernel<" in k for k in fwd), fwd
        assert not any("zconv_kernel<" in k or "zconv_up_f32_kernel" in k
                       for k in fwd), fwd
        assert any("zconv_dx_f32_kernel" in k for k in dx), dx
        assert not any("zconv_kernel<" in k or "zconv_tc_kernel" in k
                       for k in dx), dx
        assert not any("zconv_tc_kernel" in k for k in fwd + dx)


# bf16 K3 and K3-up run tc::dw_tc_kernel (csrc/zconv_dw_tc.cu), the split-K
# GEMM over the big-z positions; fp32 ones f32dw::dw_f32_kernel
# (csrc/zconv_dw.cu), the register-tiled CUDA-core kernel
DW_SHAPES = [
    ((2, 96, 96, 16, 32), 16, True),   # conv2.conv1 (K3-up) at batch 2
    ((2, 96, 96, 32, 16), 16, True),   # conv2.conv2 (K3)
    ((2, 192, 192, 32, 16), 8, True),  # conv3.conv1 (K3-up)
    ((2, 192, 192, 64, 8), 8, True),   # conv3.conv2 (K3)
    ((1, 5, 7, 3, 3), 5, True),        # C 3, Zs 3, X and Y mid tile
    ((1, 3, 4, 6, 40), 12, True),      # C 40 (row passes), Cout 12
    ((1, 4, 5, 16, 32), 16, False),    # no activation, no bias
    ((1, 11, 13, 1, 16), 8, True),     # Zs 1
    ((1, 9, 6, 2, 16), 8, True),       # Zs 2, Y ends mid tile
    ((1, 5, 21, 4, 4), 8, True),       # Y 21: fp32 y tiles of 16 and 5
]


@pytest.mark.parametrize("kid", ["K1", "K2"])
@pytest.mark.parametrize("shape,cout,act", DW_SHAPES)
def test_bf16_dw_kernel_matches_plain(dev, kid, shape, cout, act):
    """bf16 K3 / K3-up against the plain version on the same bf16 inputs
    (fp32 out on both sides; the plain one rounds dW to bf16), the launch
    counted once, the tensor-core kernel named, and a second launch giving
    the same bits (no atomics)."""
    forward, _, _, dw_k, dw_p = BACKWARD[kid]
    x, w, b = _inputs(dev, shape, cout, torch.bfloat16)
    slope = 0.2 if act else None
    out = forward(x, w, b if act else None, slope)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).to(torch.bfloat16)
    n = dw_k.launches
    dw, db = dw_k(x, g, out, slope, with_bias=act)
    torch.cuda.synchronize()
    assert dw_k.launches == n + 1
    assert dw_k.last_impl == zconv.DW_IMPL[torch.bfloat16]
    dw2, db2 = dw_k(x, g, out, slope, with_bias=act)
    assert torch.equal(dw, dw2)
    dw_want, db_want = dw_p(x, g, out, slope, act)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    assert _rel(dw, dw_want) <= TOL[torch.bfloat16]
    if act:
        assert torch.equal(db, db2)
        assert db.shape == (cout,) and _rel(db, db_want) <= TOL[torch.bfloat16]
    else:
        assert db is None


@pytest.mark.parametrize("kid", ["K1", "K2"])
@pytest.mark.parametrize("shape,cout,act", DW_SHAPES)
def test_fp32_dw_kernel_matches_plain(dev, kid, shape, cout, act):
    """fp32 K3 / K3-up against the plain version on the same inputs (TF32
    off), the launch counted once, the register-tiled kernel named, and a
    second launch giving the same bits (no atomics)."""
    forward, _, _, dw_k, dw_p = BACKWARD[kid]
    x, w, b = _inputs(dev, shape, cout, torch.float32)
    slope = 0.2 if act else None
    out = forward(x, w, b if act else None, slope)
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    n = dw_k.launches
    dw, db = dw_k(x, g, out, slope, with_bias=act)
    torch.cuda.synchronize()
    assert dw_k.launches == n + 1
    assert dw_k.last_impl == zconv.DW_IMPL[torch.float32]
    dw2, db2 = dw_k(x, g, out, slope, with_bias=act)
    assert torch.equal(dw, dw2)
    dw_want, db_want = dw_p(x, g, out, slope, act)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    assert _rel(dw, dw_want) <= TOL[torch.float32]
    if act:
        assert torch.equal(db, db2)
        assert db.shape == (cout,)
        assert _rel(db, db_want) <= TOL[torch.float32]
    else:
        assert db is None


def test_dw_launches_the_tensor_core_kernel_in_bf16_only(dev):
    """The profile names dw_tc_kernel for bf16 K3-up and K3,
    dw_f32_kernel for fp32; a bf16 shape the kernel's plan refuses raises
    and launches nothing."""
    x, w, b = _inputs(dev, (1, 6, 7, 16, 16), 8, torch.bfloat16)
    out = zconv.upzconv3d_leaky_plain(x, w, b, 0.2)
    names = _kernel_names(lambda: zconv.upzconv3d_dw(x, out, out, 0.2))
    assert any("dw_tc_kernel" in k for k in names), names
    assert not any("dw_f32_kernel<" in k for k in names), names
    x32, out32 = x.float(), out.float()
    names = _kernel_names(lambda: zconv.upzconv3d_dw(x32, out32, out32, 0.2))
    assert any("dw_f32_kernel<true>" in k for k in names), names
    assert not any("dw_tc_kernel" in k for k in names), names
    assert zconv.upzconv3d_dw.last_impl == zconv.DW_IMPL[torch.float32]
    big = torch.zeros((1, 2, 2, 2000, 64), dtype=torch.bfloat16, device=dev)
    gb = torch.zeros((1, 2, 2, 4000, 8), dtype=torch.bfloat16, device=dev)
    n = zconv.upzconv3d_dw.launches
    with pytest.raises(ValueError):
        zconv.upzconv3d_dw(big, gb, gb, 0.2)
    assert zconv.upzconv3d_dw.launches == n


def _suite_inputs(seed, b=1, s=2):
    """Seeded labels and outputs at muvo.yml's output shapes (rgb at its
    IMAGE.CROP, the range view, the voxels of 2 classes with 10% of the
    labels 255), on the host."""
    from muvo_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..",
                                     "muvo_tpu_torch", "configs", "muvo.yml"))
    gen = torch.Generator().manual_seed(seed)
    ih = cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1]
    iw = cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0]
    h, w = cfg.POINTS.CHANNELS, cfg.POINTS.HORIZON_RESOLUTION
    rgb = torch.rand((b, s, ih, iw, 3), generator=gen)
    rv = torch.rand((b, s, h, w, 4), generator=gen) * 2 - 1
    voxel = torch.randint(0, 2, (b, s, *cfg.VOXEL.SIZE), generator=gen,
                          dtype=torch.uint8)
    voxel[torch.rand(voxel.shape, generator=gen) < 0.1] = 255
    labels = {"rgb_label_1": rgb, "range_view_label_1": rv,
              "voxel_label_1": voxel}
    output = {
        "rgb_1": (rgb + 0.1 * torch.randn(rgb.shape, generator=gen)).clamp(
            0, 1),
        "lidar_reconstruction_1": rv + 0.05 * torch.randn(rv.shape,
                                                          generator=gen),
        "voxel_1": torch.randn((b, s, *cfg.VOXEL.SIZE, 2), generator=gen)}
    return cfg, labels, output


def test_metric_suite_on_the_card_matches_the_host(dev):
    """muvo.yml's metric suite (SSIM, PSNR, Chamfer at 10,000 columns, the
    SSC counts) on the card against the host, two updates, the same
    outputs, labels and columns: the counts equal, the running totals
    within 1e-4 relative (fp32, TF32 off)."""
    from muvo_tpu_torch.training.evaluator import MetricSuite

    card, host = None, None
    for seed in (0, 1):
        cfg, labels, output = _suite_inputs(seed)
        if card is None:
            card, host = MetricSuite(cfg, dev), MetricSuite(cfg, "cpu")
        card.update({k: v.to(dev) for k, v in labels.items()},
                    {k: v.to(dev) for k, v in output.items()},
                    torch.Generator().manual_seed(seed))
        host.update(labels, output, torch.Generator().manual_seed(seed))
    for key, v in host.state["ssc"].items():
        assert torch.equal(card.state["ssc"][key].cpu(), v), key
    for key in ("ssim", "psnr", "cd"):
        got, want = (card.state[key]["total"].item(),
                     host.state[key]["total"].item())
        assert abs(got - want) <= 1e-4 * abs(want), (key, got, want)
    assert card.state["cd"]["total"].device.type == "cuda"


def test_chamfer_at_10000_columns_matches_the_host(dev):
    """chamfer_batch's Gram form at the evaluator's 10,000 columns: the
    card against the host within 1e-4 relative, with TF32 off inside
    chamfer_batch even where the caller turned it on."""
    from muvo_tpu_torch import metrics

    gen = torch.Generator().manual_seed(3)
    pred = 50 * (torch.rand((2, 10000, 3), generator=gen) * 2 - 1)
    target = pred + torch.randn(pred.shape, generator=gen)
    want = metrics.chamfer_batch(pred, target).item()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = metrics.chamfer_batch(pred.to(dev), target.to(dev)).item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.backends.cuda.matmul.allow_tf32 == saved
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("train", [False, True])
def test_point_pillars_on_card_matches_host(dev, train):
    """PointPillarNet at its full grid (480 x 480 pillars) on 60,000
    points a frame, some padding, some past the grid: the card's canvas
    (index_add_ and scatter_reduce amax on the device) against the host's,
    1e-5 norm-relative (fp32: the cluster sums' and BatchNorm sums' order
    only, TF32 off); in training also the running statistics and the
    gradients of the points and parameters (the Linear biases', zero but
    for rounding, held below 1e-6 of their weights')."""
    from muvo_tpu_torch.models.pointpillars import PointPillarNet

    torch.manual_seed(0)
    host = PointPillarNet().train(train)
    card = PointPillarNet().train(train)
    card.load_state_dict(host.state_dict())
    card.to(dev)
    gen = torch.Generator().manual_seed(1)
    pts = (torch.rand((2, 60000, 3), generator=gen) * 2 - 1) * 55
    num = torch.tensor([60000, 41000])
    cot = torch.randn((2, 480, 480, 32), generator=gen)
    x_host = pts.clone().requires_grad_(train)
    x_card = pts.to(dev).requires_grad_(train)
    want = host(x_host, num)
    got = card(x_card, num.to(dev))
    assert _norm_rel(got.detach().cpu(), want.detach()) <= 1e-5
    if not train:
        return
    (want * cot).sum().backward()
    (got * cot.to(dev)).sum().backward()
    for (name, a), b in zip(host.state_dict().items(),
                            card.state_dict().values()):
        if a.is_floating_point():
            assert _norm_rel(b.cpu(), a) <= 1e-5, name
    assert _norm_rel(x_card.grad.cpu(), x_host.grad) <= 1e-5
    for (name, a), b in zip(host.named_parameters(), card.parameters()):
        if name in ("point_net.net.0.bias", "point_net.net.3.bias"):
            # a Linear's bias before a training-mode BatchNorm cancels in
            # the batch mean: its gradient is 0 but for rounding, on both
            # sides, next to its weight's
            scale = host.get_parameter(name[:-4] + "weight").grad.norm()
            assert max(a.grad.norm(), b.grad.norm()) <= 1e-6 * scale, name
            continue
        assert _norm_rel(b.grad.cpu(), a.grad) <= 1e-5, name


def test_mobilevit_trunk_on_card_matches_host(dev):
    """MobileViTV2Features (test_mobilevit_2d.yml's camera trunk) at the
    320 x 832 crop, fp32 with TF32 off, eval mode: every feature map within
    1e-4 norm-relative of the host's."""
    from muvo_tpu_torch.models.backbones.mobilevit import MobileViTV2Features

    torch.manual_seed(0)
    host = MobileViTV2Features().eval()
    card = MobileViTV2Features().eval()
    card.load_state_dict(host.state_dict())
    card.to(dev)
    x = torch.randn((1, 320, 832, 3), generator=torch.Generator()
                    .manual_seed(2))
    with torch.inference_mode():
        want = host(x)
        got = card(x.to(dev))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _norm_rel(g.cpu(), w) <= 1e-4


def test_fp32_up_kernels_slice_where_the_weights_do_not_fit(dev):
    """fp32 K2 and K2-dx at the default config's conv3.conv1 (C 64 -> 32
    at z 64, 256 voxel feature channels): K2 launches on four slices of 8
    output channels, K2-dx on four of 16 dx channels, each launch counted,
    together within 1e-4 of the plain versions and bit-equal on a second
    call."""
    shape, cout = (1, 192, 192, 32, 64), 32
    x, w, b = _inputs(dev, shape, cout, torch.float32)
    n = (zconv.upzconv3d_leaky.launches, zconv.upzconv3d_dx.launches)
    out = zconv.upzconv3d_leaky(x, w, b, 0.2)
    again = zconv.upzconv3d_leaky(x, w, b, 0.2)
    g = torch.randn(out.shape, generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev)
    dx = zconv.upzconv3d_dx(g, out, w, 0.2)
    dx_again = zconv.upzconv3d_dx(g, out, w, 0.2)
    torch.cuda.synchronize()
    assert (zconv.upzconv3d_leaky.launches - n[0],
            zconv.upzconv3d_dx.launches - n[1]) == (8, 8)
    assert zconv.upzconv3d_leaky.last_impl == zconv.K2_F32_IMPL
    assert zconv.upzconv3d_dx.last_impl == zconv.K2_DX_F32_IMPL
    assert torch.equal(out, again) and torch.equal(dx, dx_again)
    assert _rel(out, zconv.upzconv3d_leaky_plain(x, w, b, 0.2)) <= 1e-4
    assert _rel(dx, zconv.upzconv3d_dx_plain(g, out, w, 0.2)) <= 1e-4


def test_bf16_up_kernels_slice_where_the_fold_does_not_fit(dev):
    """bf16 K2 and K2-dx at the default config's conv3.conv1 (C 64 -> 32 at
    small z 32, batch 2): the folded weights of all channels do not fit a
    block, so K2 launches on four slices of 8 output channels and K2-dx on
    four of 16 input channels, together within 2e-2 of the plain versions
    and bit-equal on a second call."""
    shape, cout = (2, 192, 192, 32, 64), 32
    x, w, b = _inputs(dev, shape, cout, torch.bfloat16)
    n = (zconv.upzconv3d_leaky.launches, zconv.upzconv3d_dx.launches)
    out = zconv.upzconv3d_leaky(x, w, b, 0.2)
    again = zconv.upzconv3d_leaky(x, w, b, 0.2)
    g = torch.randn(out.shape, generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev).to(torch.bfloat16)
    dx = zconv.upzconv3d_dx(g, out, w, 0.2)
    dx_again = zconv.upzconv3d_dx(g, out, w, 0.2)
    torch.cuda.synchronize()
    assert (zconv.upzconv3d_leaky.launches - n[0],
            zconv.upzconv3d_dx.launches - n[1]) == (8, 8)
    assert "N 16" in zconv.upzconv3d_leaky.last_impl
    assert torch.equal(out, again) and torch.equal(dx, dx_again)
    assert _rel(out, zconv.upzconv3d_leaky_plain(x, w, b, 0.2)) <= 2e-2
    assert _rel(dx, zconv.upzconv3d_dx_plain(g, out, w, 0.2)) <= 2e-2


def _lifting_inputs(b, c, seed):
    """muvo.yml's lifting inputs: (b, 40, 104, c) features, a softmax over
    37 depth bins, the cropped camera's intrinsics and a camera -> ego pose
    turned a little from the rig's."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 40, 104, c), generator=gen)
    depth = torch.softmax(2 * torch.randn((b, 40, 104, 37), generator=gen),
                          -1)
    k = torch.tensor([[402.8, 0.0, 416.0], [0.0, 402.8, 162.0],
                      [0.0, 0.0, 1.0]]).repeat(b, 1, 1)
    k[:, :2, 2] += 10 * torch.randn((b, 2), generator=gen)
    pose = torch.eye(4).repeat(b, 1, 1)
    pose[:, :3, :3] = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0],
                                    [0.0, -1.0, 0.0]])
    pose[:, :3, 3] = torch.tensor([1.0, 0.0, 2.0]) + torch.randn(
        (b, 3), generator=gen)
    return x, depth, k, pose


def test_frustum_pooling_on_card_matches_host(dev):
    """FrustumPooling at muvo.yml's lifting (37 x 40 x 104 points onto the
    48 x 48 grid), fp32: every point's cell the same on the card as on the
    host, the pooled BEV and the gradients of x and depth within 1e-5
    norm-relative (only the order of the atomic adds differs)."""
    from muvo_tpu_torch.models.frustum import FrustumPooling

    pool = FrustumPooling((48, 48), 0.8, -16.0, [1.0, 38.0, 1.0], 8)
    x, depth, k, pose = _lifting_inputs(2, 64, 3)
    cot = torch.randn((2, 48, 48, 64), generator=torch.Generator()
                      .manual_seed(4))
    for a, b in zip(pool.cells(40, 104, k, pose),
                    pool.to(dev).cells(40, 104, k.to(dev), pose.to(dev))):
        assert torch.equal(a, b.cpu())
    results = []
    for where in ("cpu", dev):
        xs = x.detach().to(where).requires_grad_()
        ds = depth.detach().to(where).requires_grad_()
        out = pool.to(where)(xs, ds, k.to(where), pose.to(where))
        (out * cot.to(where)).sum().backward()
        results.append([t.detach().cpu() for t in (out, xs.grad, ds.grad)])
    for want, got in zip(*results):
        assert want.abs().max() > 0
        assert _norm_rel(got, want) <= 1e-5


def test_mile_encode_on_card_matches_host(dev):
    """One encode of the default config (the MILE branch: lifting, the
    route and speed broadcast over the BEV, backbone_bev, the LiDAR range
    view) at full width, fp32 with TF32 off, eval mode: the embedding
    within 1e-3 norm-relative of the host's."""
    from muvo_tpu_torch.config import get_cfg
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.models.preprocess import PreProcess
    from muvo_tpu_torch.models.world_model import MuvoWorldModel

    cfg = get_cfg()
    cfg.merge_from_dict({"VOXEL_SEG": {"ENABLED": False},
                         "SEMANTIC_SEG": {"ENABLED": False},
                         "LIDAR_RE": {"ENABLED": False},
                         "LIDAR_SEG": {"ENABLED": False}})
    torch.manual_seed(0)
    host = MuvoWorldModel(cfg).eval()
    card = MuvoWorldModel(cfg).eval()
    card.load_state_dict(host.state_dict())
    card.to(dev)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 1, 1, seed=5).items()}
    pb = PreProcess(cfg)(batch, training=False, labels=False)
    with torch.inference_mode():
        want = host.encode(pb)
        got = card.encode({k: v.to(dev) for k, v in pb.items()})
    assert got.shape == want.shape == (1, 1, cfg.MODEL.EMBEDDING_DIM)
    assert _norm_rel(got.cpu(), want) <= 1e-3


def _edge_distance(points, h, w, fov=(-30.0, 10.0), lidar=(1.0, 0.0, 2.0)):
    """Each point's distance in rad (float64) to the nearest yaw or pitch
    bin edge of an h x w range view."""
    import numpy as np

    c = points.double().numpy() * np.array([1.0, -1.0, 1.0]) - lidar
    depth = np.linalg.norm(c, axis=-1)
    yaw = np.arctan2(-c[..., 1], c[..., 0])
    pitch = np.arcsin(np.clip(c[..., 2] / np.maximum(depth, 1e-12), -1, 1))
    fov_down, span = np.deg2rad(fov[0]), np.deg2rad(fov[1] - fov[0])
    tw = 0.5 * (1.0 - yaw / np.pi) * w
    th = (1.0 - (pitch + abs(fov_down)) / span) * h
    return np.minimum(np.abs(tw - np.round(tw)) * 2 * np.pi / w,
                      np.abs(th - np.round(th)) * span / h)


def test_range_projection_on_card_matches_host(dev):
    """project_torch at muvo.yml's 64 x 1024 on 6 frames of 60,000 points
    (two padded): the card's pixels are the host's except where the
    card's atan2 and asin round a point within 1e-6 rad of a bin edge to
    the other side, or its norm turns a depth tie within 2 ulp the other
    way, at most 0.1% of the pixels; where the winner is the same, xyz
    are the same bits (the winner's own point) and depth is within 2 ulp
    (the card's norm rounds its sum of squares otherwise)."""
    import numpy as np

    from muvo_tpu_torch.geometry.range_view import RangeProjector

    proj = RangeProjector(64, 1024)
    gen = torch.Generator().manual_seed(0)
    pts = torch.rand((6, 60000, 3), generator=gen) * 80 - 40
    pts[..., 2] = torch.rand((6, 60000), generator=gen) * 9 - 3
    ids = torch.arange(60000, dtype=torch.int32).expand(6, -1).contiguous()
    valid = torch.ones((6, 60000), dtype=torch.bool)
    valid[1, 50000:] = valid[4, 1000:] = False
    host = proj.project_torch(pts, ids, valid)
    card = [t.cpu() for t in proj.project_torch(pts.to(dev), ids.to(dev),
                                                valid.to(dev))]
    hit = host[0] >= 0
    bad = (card[2] != host[2]) | ((card[0] >= 0) != hit)
    assert bad.float().mean() <= 1e-3
    near = _edge_distance(pts, 64, 1024) < 1e-6
    for f, i, j in bad.nonzero().tolist():
        sides = [(int(s[f, i, j]), np.float32(d[f, i, j]))
                 for s, d in ((host[2], host[0]), (card[2], card[0]))
                 if d[f, i, j] >= 0]
        depths = [d for _, d in sides]
        tie = len(depths) == 2 and (abs(depths[0] - depths[1])
                                    <= 2 * np.spacing(max(depths)))
        assert tie or near[f, [w for w, _ in sides]].any(), (f, i, j)
    same = ~bad
    assert torch.equal(card[1][same], host[1][same])
    depth = host[0][same].numpy()
    assert (np.abs(card[0][same].numpy() - depth)
            <= 2 * np.spacing(np.abs(depth))).all()
    assert hit.sum() > 100000


def test_triplane_decoder_on_card_matches_host(dev):
    """TriPlaneVoxelDecoder at three scales (planes 24 x 24 x 8 and
    halves, 16 channels, 32 feature channels), fp32 with TF32 off: each
    scale within 1e-5 norm-relative of the host's."""
    from muvo_tpu_torch.models.stylegan import TriPlaneVoxelDecoder

    torch.manual_seed(0)
    host = TriPlaneVoxelDecoder(16, 2, 32).eval()
    gen = torch.Generator().manual_seed(1)
    planes = [{}, {}, {}]
    for s in (1, 2, 4):
        x, y, z = 24 // s, 24 // s, 8 // s
        for plane, shape in zip(planes, ((x, y), (x, z), (y, z))):
            plane[f"rgb_{s}"] = torch.randn((2, *shape, 16), generator=gen)
    with torch.no_grad():
        want = host(*planes)
        got = host.to(dev)(*({k: v.to(dev) for k, v in p.items()}
                             for p in planes))
    for key, w in want.items():
        assert _norm_rel(got[key].cpu(), w) <= 1e-5, key


def test_agent_tick_on_card_matches_host(dev):
    """The closed-loop agent (agents/muvo_agent.py) at tiny_test_cfg in
    fp32 with one transformer layer: the same weights on the card and on
    the host, both fed the host's observations (the kinematic env stepped
    with the host agent's controls) for 4 ticks, observed then dreaming.
    Each tick decodes once: conv2 and conv3 of the 64^3 voxel decoder
    launch fp32 K2 and K1 once each on the card. The controls, and the
    last tick's decode of the card's latent on both sides, within 1e-3 of
    max(1, max |host|), chip_smoke.py's DECODE_TOL."""
    import copy

    from muvo_tpu_torch.agents.muvo_agent import MuvoAgent
    from muvo_tpu_torch.data.synthetic import tiny_test_cfg
    from muvo_tpu_torch.inference import LatentCarry
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv

    cfg = tiny_test_cfg()
    cfg.PRECISION = "32"
    cfg.MODEL.TRANSFORMER.N_LAYERS = 1
    torch.manual_seed(0)
    model = MuvoWorldModel(cfg)
    host = MuvoAgent(cfg, copy.deepcopy(model), device="cpu")
    card = MuvoAgent(cfg, model, device=dev)
    for dreaming in (False, True):
        env = KinematicDrivingEnv(seed=4, episode_steps=10, image_hw=(96, 160))
        obs = env.reset()
        host.reset()
        card.reset()
        host.is_dreaming = card.is_dreaming = dreaming
        for tick in range(4):
            n = (zconv.zconv3d_leaky.launches, zconv.upzconv3d_leaky.launches)
            got = card.run_step(obs["hero"])
            torch.cuda.synchronize()
            assert (zconv.zconv3d_leaky.launches - n[0],
                    zconv.upzconv3d_leaky.launches - n[1]) == (2, 2)
            want = host.run_step(obs["hero"])
            for key, w in want.items():
                assert abs(got[key] - w) <= 1e-3 * max(1.0, abs(w)), (
                    dreaming, tick, key, got[key], w)
            obs = env.step({"hero": want})[0]
    carry = card.session.carry
    with torch.inference_mode():
        got = card.session.decode(carry)
        want = host.session.decode(LatentCarry(*(t.cpu() for t in carry)))
    for key, w in want.items():
        g = got[key].cpu()
        assert g.shape == w.shape, key
        rel = (g - w).abs().max() / max(1.0, w.abs().max().item())
        assert rel.item() <= 1e-3, (key, rel.item())
