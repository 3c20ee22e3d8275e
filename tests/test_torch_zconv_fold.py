"""K2 and K2-dx on the small-z grid: ``up_fold_weights`` (the folded
weights and their two centre-tap edge terms that the bf16 kernels of
muvo_tpu_torch/csrc/zconv.cu compute with) against the plain versions, and
the fold's coefficients against muvo_tpu's ``_z_coeff_np``.

The fold is applied here with F.conv3d / F.conv2d on the CPU, the same
function the kernel computes with wgmma, in fp32: tolerance 1e-5 relative
to max |plain| (summation order only).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from muvo_tpu.ops.pallas_zconv import _z_coeff_np
from muvo_tpu_torch.models.layers import to_nchw, to_nhwc
from muvo_tpu_torch.ops import zconv

TOL = 1e-5


def _conv_small_z(x, main, edges):
    """The folded conv: x (B, X, Y, Zs, K) with main (3, 3, 3, K, N) over
    the small-z grid, plus edges[0] (3, 3, K, N) on slice 0 and edges[1] on
    slice Zs - 1, both as 3x3 SAME convs over (X, Y); (B, X, Y, Zs, N)."""
    y = to_nhwc(F.conv3d(to_nchw(x), main.permute(4, 3, 0, 1, 2),
                         padding=1))
    b, X, Y, zs, k = x.shape
    for q, s in ((0, 0), (1, zs - 1)):
        sl = x[:, :, :, s].permute(0, 3, 1, 2)  # (B, K, X, Y)
        corr = F.conv2d(sl, edges[q].permute(3, 2, 0, 1), padding=1)
        y[:, :, :, s] += corr.permute(0, 2, 3, 1)
    return y


def _folded_forward(x, w, bias, slope, main=None, edges=None):
    if main is None:
        main, edges = zconv.up_fold_weights(w)
    y = _conv_small_z(x, main, edges)
    b, X, Y, zs, n = y.shape
    y = y.reshape(b, X, Y, 2 * zs, n // 2) + bias
    return F.leaky_relu(y, slope)


def _folded_dx(g, out, w, slope):
    main, edges = zconv.up_fold_weights(w, adjoint=True)
    gm = zconv.leaky_mask(g, out, slope)
    b, X, Y, z, cg = gm.shape
    return _conv_small_z(gm.reshape(b, X, Y, z // 2, 2 * cg), main, edges)


def _data(shape, cout, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((cout, c, 3, 3, 3),
                                             dtype=np.float32))
    w = w / (27 * c) ** 0.5
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32))
    return x, w, bias


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


SHAPES = [((2, 3, 4, 1, 3), 5),    # Zs 1: both edge terms on one slice
          ((1, 4, 3, 2, 5), 3),    # Zs 2: the two edges side by side
          ((1, 3, 5, 3, 7), 5),    # Zs 3: one interior slice
          ((1, 4, 4, 16, 5), 7)]   # Zs 16, conv2.conv1's z


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_folded_forward_matches_plain(shape, cout):
    x, w, bias = _data(shape, cout, 0)
    want = zconv.upzconv3d_leaky_plain(x, w, bias, 0.2)
    assert _rel(_folded_forward(x, w, bias, 0.2), want) <= TOL


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_folded_adjoint_matches_plain(shape, cout):
    x, w, bias = _data(shape, cout, 1)
    out = zconv.upzconv3d_leaky_plain(x, w, bias, 0.2)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal(out.shape, dtype=np.float32))
    want = zconv.upzconv3d_dx_plain(g, out, w, 0.2)
    got = _folded_dx(g, out, w, 0.2)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("zs", [1, 2, 3, 5, 16])
def test_fold_coefficients_equal_the_tpu_kernels(zs):
    """B[z, s, dz] (big z, small s, conv tap dz) rebuilt from E and the
    edge terms equals muvo_tpu's _z_coeff_np(Zs) exactly."""
    e = np.asarray(zconv.UP_FOLD_E, np.float32)
    edge = np.asarray(zconv.UP_FOLD_EDGE, np.float32)
    coeff = np.zeros((2 * zs, zs, 3), np.float32)
    for k in range(zs):
        for p in range(2):
            for t in range(3):
                s = k - 1 + t
                if 0 <= s < zs:
                    coeff[2 * k + p, s] += e[p, t]
            if k == 0:
                coeff[p, 0] += edge[0, p]
            if k == zs - 1:
                coeff[2 * k + p, k] += edge[1, p]
    np.testing.assert_array_equal(coeff, _z_coeff_np(zs))


def test_adjoint_fold_is_the_transpose():
    """The adjoint fold is the forward fold flipped in space and z and
    transposed in channels, edge terms included."""
    _, w, _ = _data((1, 1, 1, 1, 4), 3, 3)
    main, edges = zconv.up_fold_weights(w)
    main_a, edges_a = zconv.up_fold_weights(w, adjoint=True)
    assert main_a.shape == (3, 3, 3, 6, 4)
    assert edges_a.shape == (2, 3, 3, 6, 4)
    assert torch.equal(main_a, main.flip(0, 1, 2).transpose(-1, -2))
    assert torch.equal(edges_a, edges.flip(1, 2).transpose(-1, -2))


@pytest.mark.parametrize("fault", ["no_first_edge", "no_last_edge",
                                   "phases_swapped"])
@pytest.mark.parametrize("zs", [1, 2, 16])
def test_the_checks_catch_a_broken_fold(fault, zs):
    """A fold that drops an edge term or swaps the two phases fails the
    forward check above at every Zs."""
    x, w, bias = _data((1, 3, 4, zs, 3), 4, 4)
    want = zconv.upzconv3d_leaky_plain(x, w, bias, 0.2)
    main, edges = zconv.up_fold_weights(w)
    edges = edges.clone()
    if fault == "no_first_edge":
        edges[0] = 0
    elif fault == "no_last_edge":
        edges[1] = 0
    else:
        cout = w.shape[0]
        main = torch.cat([main[..., cout:], main[..., :cout]], -1)
        edges = torch.cat([edges[..., cout:], edges[..., :cout]], -1)
    assert _rel(_folded_forward(x, w, bias, 0.2), want) <= TOL
    assert _rel(_folded_forward(x, w, bias, 0.2, main, edges), want) > 1e-2


@pytest.mark.parametrize("adjoint", [False, True])
def test_fold_stays_fp32_under_autocast(adjoint):
    """An eval or inference step in bf16 calls K2 without autograd, inside
    autocast, where einsum's products come out bf16: the fold (which the
    tensor-core kernels read as fp32) must be the same fp32 bits there."""
    _, w, _ = _data((1, 4, 4, 16, 5), 7, 3)
    w = w.to(torch.bfloat16)
    want = zconv.up_fold_weights(w, adjoint)
    view = zconv.TcView("small-z", 16, 5, 14)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = zconv.up_fold_weights(w, adjoint)
        flat = zconv._tc_weights(w, view, adjoint)
    for g, v in zip(got, want):
        assert g.dtype == v.dtype == torch.float32
        assert torch.equal(g, v)
    assert flat.dtype == torch.float32
    assert torch.equal(flat, torch.cat([v.reshape(-1) for v in want]))


def test_tc_launch_refuses_a_fold_that_is_not_fp32():
    """The tensor-core kernels read their weights as fp32: a fold of any
    other type is refused before the launch, wherever it came from."""
    x = torch.zeros((1, 4, 4, 16, 5), dtype=torch.bfloat16)
    w = torch.zeros(9 * 3 * 5 * 14, dtype=torch.bfloat16)
    view = zconv.TcView("small-z", 16, 5, 14)
    with pytest.raises(TypeError, match="not fp32"):
        zconv._launch_tc(x, None, None, w, None, x, view, 7, False, 0.2, "K2")


def test_sliced_folds_assemble_the_plain_output():
    """bf16 K2 and K2-dx launch once for each slice of channel_slices where
    the folded weights of all channels do not fit a block: the fold of
    each slice's weights (K2: its output channels; K2-dx: its input
    channels), applied on the small-z grid and written side by side, gives
    the plain version's output. At the default config's conv3.conv1 (C 64
    -> 32 at small z 32) K2 takes four slices of 8, K2-dx four of 16; at
    muvo.yml's stages one slice each; the other kernels one launch."""
    h100, bf16 = 232448, torch.bfloat16
    assert zconv.channel_slices("K2", bf16, 32, 64, 32, h100) == [
        (0, 8), (8, 16), (16, 24), (24, 32)]
    assert zconv.channel_slices("K2-dx", bf16, 32, 64, 32, h100) == [
        (0, 16), (16, 32), (32, 48), (48, 64)]
    for zs, c, cout in ((16, 32, 16), (32, 16, 8)):
        for kid in ("K2", "K2-dx"):
            assert zconv.channel_slices(kid, bf16, zs, c, cout, h100) == [
                (0, c if kid == "K2-dx" else cout)]
    for kid in ("K1", "K1-dx"):
        assert zconv.channel_slices(kid, bf16, 64, 64, 32, h100) == [
            (0, 64 if kid == "K1-dx" else 32)]
    with pytest.raises(ValueError, match="for 8 output channels"):
        zconv.channel_slices("K2", bf16, 32, 64, 32, 10 ** 5)
    x, w, b = _data((1, 4, 5, 3, 12), 10, seed=3)
    slices = [(0, 4), (4, 8), (8, 10)]
    got = torch.cat([_folded_forward(x, w[lo:hi], b[lo:hi], 0.2)
                     for lo, hi in slices], -1)
    assert _rel(got, zconv.upzconv3d_leaky_plain(x, w, b, 0.2)) <= TOL
    out = zconv.upzconv3d_leaky_plain(x, w, b, 0.2)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    got = torch.cat([_folded_dx(g, out, w[:, lo:hi], 0.2)
                     for lo, hi in ((0, 8), (8, 12))], -1)
    assert _rel(got, zconv.upzconv3d_dx_plain(g, out, w, 0.2)) <= TOL
