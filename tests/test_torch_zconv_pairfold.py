"""K1 and K1-dx on the pair grid: ``pair_fold_weights`` (the weights the
bf16 tensor-core kernel of muvo_tpu_torch/csrc/zconv.cu computes with where
z pairs are folded into channels) against the plain versions, its blocks
against muvo_tpu's ``banded_weight(kernel, f=2)``, and ``k1_route``'s
choice of view.

The fold is applied here with F.conv3d on the CPU, the same function the
kernel computes with wgmma, in fp32: tolerance 1e-5 relative to max
|plain| (summation order only). The plain versions are held to muvo_tpu's
Pallas K1 and its vjp in interpret mode by tests/test_torch_zconv.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from muvo_tpu.ops.pallas_zconv import banded_weight
from muvo_tpu_torch.models.layers import to_nchw, to_nhwc
from muvo_tpu_torch.ops import zconv

TOL = 1e-5


def _pair_conv(x, fold):
    """x (B, X, Y, Z, K) viewed as (B, X, Y, Z / 2, 2 K), the SAME conv
    with ``fold`` (3, 3, 3, 2 K, 2 N), viewed back as (B, X, Y, Z, N)."""
    b, X, Y, z, k = x.shape
    y = F.conv3d(to_nchw(x.reshape(b, X, Y, z // 2, 2 * k)),
                 fold.permute(4, 3, 0, 1, 2), padding=1)
    return to_nhwc(y).reshape(b, X, Y, z, -1)


def _kernel(w):
    """(Cout, C, kx, ky, kz) -> (kx, ky, kz, C, Cout)."""
    return w.permute(2, 3, 4, 1, 0)


def _adjoint(w):
    """The flipped, transposed kernel, (kx, ky, kz, Cout, C)."""
    return w.flip(2, 3, 4).permute(2, 3, 4, 0, 1)


def _folded_forward(x, w, bias, slope, fold=None):
    if fold is None:
        fold = zconv.pair_fold_weights(_kernel(w))
    y = _pair_conv(x, fold)
    if bias is not None:
        y = y + bias
    return y if slope is None else F.leaky_relu(y, slope)


def _data(b, z, c, cout, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 3, 4, z, c),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((cout, c, 3, 3, 3),
                                             dtype=np.float32))
    w = w / (27 * c) ** 0.5
    bias = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32))
    return x, w, bias


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


CHANNELS = [(8, 8), (3, 16), (16, 3), (8, 3)]


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("c,cout", CHANNELS)
@pytest.mark.parametrize("z", [2, 4, 64])
def test_pair_fold_forward_matches_plain(z, c, cout, act):
    """K1 on the pair grid equals K1's plain version, with bias and
    activation or with neither."""
    x, w, bias = _data(2, z, c, cout, 0)
    bias, slope = (bias, 0.2) if act else (None, None)
    want = zconv.zconv3d_leaky_plain(x, w, bias, slope)
    got = _folded_forward(x, w, bias, slope)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("c,cout", CHANNELS)
@pytest.mark.parametrize("z", [2, 4, 64])
def test_pair_fold_adjoint_matches_plain(z, c, cout, act):
    """K1-dx on the pair grid (the masked cotangent with the fold of the
    flipped, transposed kernel) equals K1-dx's plain version."""
    x, w, bias = _data(1, z, c, cout, 1)
    slope = 0.2 if act else None
    out = zconv.zconv3d_leaky_plain(x, w, bias if act else None, slope)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal(out.shape, dtype=np.float32))
    want = zconv.zconv3d_dx_plain(g, out, w, slope)
    gm = zconv.leaky_mask(g, out, slope)
    got = _pair_conv(gm, zconv.pair_fold_weights(_adjoint(w)))
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) <= TOL


def _banded(kernel):
    """muvo_tpu's banded_weight(kernel, 2), as (kx, ky, 4, C, 2 Cout)."""
    c, cout = kernel.shape[3], kernel.shape[4]
    band = banded_weight(jnp.asarray(kernel.numpy()), 2, jnp.float32)
    return np.asarray(band).reshape(3, 3, 4, c, 2 * cout)


@pytest.mark.parametrize("c,cout", [(8, 8), (3, 5)])
def test_pair_fold_blocks_are_the_tpu_kernels_band(c, cout):
    """With the fold's (t, q) rows numbered 2t + q, rows 1-4 (big z
    2k - 1 .. 2k + 2) are muvo_tpu's banded_weight(kernel, 2, float32)
    exactly, and rows 0 and 5 (big z 2k - 2 and 2k + 3) are zero."""
    _, w, _ = _data(1, 2, c, cout, 3)
    kernel = _kernel(w)
    fold = zconv.pair_fold_weights(kernel).reshape(3, 3, 6, c, 2 * cout)
    np.testing.assert_array_equal(fold[:, :, 1:5].numpy(), _banded(kernel))
    assert not fold[:, :, 0].any() and not fold[:, :, 5].any()


@pytest.mark.parametrize("adjoint", [False, True])
def test_the_wrapper_passes_the_pair_fold(adjoint):
    """The weights the K1 / K1-dx wrappers hand the kernel for the pair view
    are pair_fold_weights of the kernel (K1) or of the flipped, transposed
    kernel (K1-dx); for the plain view, that kernel itself."""
    _, w, _ = _data(1, 2, 8, 3, 4)
    kernel = _adjoint(w) if adjoint else _kernel(w)
    pair = zconv.k1_route(64, *kernel.shape[3:])
    plain = zconv.k1_route(63, *kernel.shape[3:])
    assert pair.name == "pair" and plain.name == "plain"
    assert torch.equal(zconv._tc_weights(w, pair, adjoint),
                       zconv.pair_fold_weights(kernel))
    assert torch.equal(zconv._tc_weights(w, plain, adjoint), kernel)


@pytest.mark.parametrize("z,c,cout,want", [
    (32, 16, 16, ("plain", 32, 16, 16)),  # conv2.conv2 (K1 and K1-dx)
    (64, 8, 8, ("pair", 32, 16, 16)),     # conv3.conv2 (K1 and K1-dx)
    (63, 8, 8, ("plain", 63, 8, 8)),      # odd z: no pairs
    (1, 3, 5, ("plain", 1, 3, 5)),
    (64, 40, 8, ("plain", 64, 40, 8)),    # 2 C past 64: no pairs
    (20, 4, 12, ("pair", 10, 8, 24)),
    (64, 72, 8, None),                    # C past 64: the CUDA cores
    (32, 16, 80, None),                   # Cout past 64
])
def test_k1_route(z, c, cout, want):
    assert zconv.k1_route(z, c, cout) == (
        None if want is None else zconv.TcView(*want))


def _broken_fold(kernel, fault):
    """The fold with one fault at tap t = 1 (read at every Zs):
    ``dz_shifted``: block (q 0, p 0) takes dz 2 instead of 1;
    ``transposed``: blocks (q 0, p 1) and (q 1, p 0) swapped."""
    c, cout = kernel.shape[3], kernel.shape[4]
    fold = zconv.pair_fold_weights(kernel).reshape(3, 3, 3, 2, c, 2, cout)
    fold = fold.clone()
    if fault == "dz_shifted":
        fold[:, :, 1, 0, :, 0] = kernel[:, :, 2]
    else:
        a = fold[:, :, 1, 0, :, 1].clone()
        fold[:, :, 1, 0, :, 1] = fold[:, :, 1, 1, :, 0]
        fold[:, :, 1, 1, :, 0] = a
    return fold.reshape(3, 3, 3, 2 * c, 2 * cout)


@pytest.mark.parametrize("fault", ["dz_shifted", "transposed"])
@pytest.mark.parametrize("z", [2, 4, 64])
def test_the_checks_catch_a_broken_fold(fault, z):
    """A fold with one dz shifted or one block transposed fails the
    forward check and the band check above."""
    x, w, bias = _data(1, z, 8, 8, 5)
    want = zconv.zconv3d_leaky_plain(x, w, bias, 0.2)
    kernel = _kernel(w)
    broken = _broken_fold(kernel, fault)
    assert _rel(_folded_forward(x, w, bias, 0.2), want) <= TOL
    assert _rel(_folded_forward(x, w, bias, 0.2, broken), want) > 1e-2
    band = broken.reshape(3, 3, 6, 8, 16)[:, :, 1:5].numpy()
    assert not np.array_equal(band, _banded(kernel))
