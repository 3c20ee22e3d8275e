"""K1 / K2 of the PyTorch port (muvo_tpu_torch/ops/zconv.py): the plain
versions against muvo_tpu's Pallas z-fold kernels run in interpret mode, on
tests/test_pallas_zconv.py's shapes, and the wrapper contract on the CPU.
The CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py;
chip_smoke.py holds them against the plain versions at the serving shapes).

Tolerance 1e-4 (abs and rel): both sides are fp32 and differ only in
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.ops.pallas_zconv import (
    _pick_f_up,
    upzconv3d_leaky_folded,
    zconv3d_leaky as pallas_zconv3d_leaky,
)
from muvo_tpu_torch.ops import zconv
from torch_port_common import assert_same


def _torch_weight(kernel):
    """(kx, ky, kz, C, Cout) -> upstream Conv3d (Cout, C, kx, ky, kz)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(kernel, (4, 3, 0, 1, 2))))


@pytest.mark.parametrize("shape,cout,f", [
    ((2, 8, 6, 32, 4), 4, 32),   # zb=1 (full fold)
    ((1, 8, 10, 32, 4), 8, 16),  # zb=2 (blocked, halo crosses blocks)
    ((1, 16, 6, 24, 3), 5, 8),   # odd channels, zb=3
])
def test_k1_plain_matches_pallas(shape, cout, f):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    kernel = rs.randn(3, 3, 3, shape[-1], cout).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32)
    want = pallas_zconv3d_leaky(jnp.asarray(x), jnp.asarray(kernel),
                                jnp.asarray(bias), f, 0.2, True)
    got = zconv.zconv3d_leaky(torch.from_numpy(x), _torch_weight(kernel),
                              torch.from_numpy(bias), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_k1_plain_no_bias_no_activation():
    rs = np.random.RandomState(2)
    x = rs.randn(1, 8, 4, 16, 2).astype(np.float32)
    kernel = rs.randn(3, 3, 3, 2, 8).astype(np.float32)
    want = pallas_zconv3d_leaky(jnp.asarray(x), jnp.asarray(kernel), None,
                                16, None, True)
    got = zconv.zconv3d_leaky(torch.from_numpy(x), _torch_weight(kernel),
                              None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,Xs,Ys,Zs,C,Cout", [
    (1, 4, 6, 16, 8, 4),
    (1, 4, 3, 16, 8, 4),
])
def test_k2_plain_matches_pallas(B, Xs, Ys, Zs, C, Cout):
    rs = np.random.RandomState(4)
    x5 = rs.randn(B, Xs, Ys, Zs, C).astype(np.float32)
    kernel = rs.randn(3, 3, 3, C, Cout).astype(np.float32)
    bias = rs.randn(Cout).astype(np.float32)
    # x/y upsampled outside both kernels, on the folded small-z tensor
    xy = np.array(jax.image.resize(
        jnp.asarray(x5).reshape(B, Xs, Ys, Zs * C),
        (B, 2 * Xs, 2 * Ys, Zs * C), method="linear"))
    f = _pick_f_up(Zs, C, Cout) or 2 * Zs
    want = upzconv3d_leaky_folded(jnp.asarray(xy), jnp.asarray(kernel),
                                  jnp.asarray(bias), C, f, 0.2, True)
    want = np.asarray(want).reshape(B, 2 * Xs, 2 * Ys, 2 * Zs, Cout)
    got = zconv.upzconv3d_leaky(
        torch.from_numpy(xy.reshape(B, 2 * Xs, 2 * Ys, Zs, C)),
        _torch_weight(kernel), torch.from_numpy(bias), 0.2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(1, 4, 4, 24, 2).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 2, 3, 3, 3).astype(np.float32))
    before = (zconv.zconv3d_leaky.launches, zconv.upzconv3d_leaky.launches)
    got = zconv.zconv3d_leaky(x, w)
    up = zconv.upzconv3d_leaky(x, w)
    assert (zconv.zconv3d_leaky.launches,
            zconv.upzconv3d_leaky.launches) == before  # no kernel launched
    assert_same(got, zconv.zconv3d_leaky_plain(x, w))
    assert_same(up, zconv.upzconv3d_leaky_plain(x, w))
    assert up.shape == (1, 4, 4, 48, 3)


@pytest.mark.parametrize("bad", ["weight_shape", "bias_shape", "dtype", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 4, 4, 24, 2)
    w = torch.zeros(3, 2, 3, 3, 3)
    b = torch.zeros(3)
    if bad == "weight_shape":
        w = torch.zeros(3, 4, 3, 3, 3)
    elif bad == "bias_shape":
        b = torch.zeros(4)
    elif bad == "dtype":
        w = w.double()
    else:
        x = x[0]
    with pytest.raises(ValueError):
        zconv.zconv3d_leaky(x, w, b)

