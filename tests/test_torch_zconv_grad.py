"""Gradients of the port's K1 / K2 autograd Functions (on the CPU: the
plain versions of K1-dx, K2-dx and K3) against jax.grad through muvo_tpu's
zconv3d_leaky_folded / upzconv3d_leaky_folded in interpret mode, on
tests/test_pallas_zconv.py's shapes, with and without bias and activation,
and once under torch.utils.checkpoint.

Tolerance: rtol 1e-3, atol 1e-4 (1e-3 for K2), as muvo_tpu's own grad
tests in tests/test_pallas_zconv.py: both sides fp32, summation order only,
through a sin() loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from muvo_tpu.ops.pallas_zconv import (
    _pick_f,
    _pick_f_up,
    upzconv3d_leaky_folded,
    zconv3d_leaky_folded,
)
from muvo_tpu_torch.ops import zconv
from torch_port_common import import_torch_dynamo

import_torch_dynamo()  # torch.utils.checkpoint's first call imports it


def _torch_weight(kernel):
    """(kx, ky, kz, C, Cout) -> upstream Conv3d (Cout, C, kx, ky, kz)."""
    return np.ascontiguousarray(np.transpose(kernel, (4, 3, 0, 1, 2)))


def _jax_grads(x5, kernel, bias, slope, up):
    B, X, Y, Z, C = x5.shape
    cout = kernel.shape[-1]
    if up:
        f = _pick_f_up(Z, C, cout) or 2 * Z
        fn = lambda x4, k, b: upzconv3d_leaky_folded(  # noqa: E731
            x4, k, b, C, f, slope, True)
    else:
        f = _pick_f(Z, C, cout) or Z
        fn = lambda x4, k, b: zconv3d_leaky_folded(  # noqa: E731
            x4, k, b, C, f, slope, True)

    def loss(x4, k, b):
        return jnp.sum(jnp.sin(fn(x4, k, b)))

    args = (jnp.asarray(x5.reshape(B, X, Y, Z * C)), jnp.asarray(kernel),
            None if bias is None else jnp.asarray(bias))
    argnums = (0, 1) if bias is None else (0, 1, 2)
    grads = jax.grad(loss, argnums=argnums)(*args)
    dx = np.asarray(grads[0]).reshape(x5.shape)
    dw = _torch_weight(np.asarray(grads[1]))
    db = None if bias is None else np.asarray(grads[2])
    return dx, dw, db


def _port_grads(x5, kernel, bias, slope, up, checkpoint=False):
    fn = zconv.upzconv3d_leaky if up else zconv.zconv3d_leaky
    x = torch.from_numpy(x5).requires_grad_()
    w = torch.from_numpy(_torch_weight(kernel)).requires_grad_()
    b = None if bias is None else torch.from_numpy(bias).requires_grad_()
    if checkpoint:
        out = torch.utils.checkpoint.checkpoint(fn, x, w, b, slope,
                                                use_reentrant=False)
    else:
        out = fn(x, w, b, slope)
    torch.sin(out).sum().backward()
    return (x.grad.numpy(), w.grad.numpy(),
            None if b is None else b.grad.numpy())


def _compare(got, want, atol):
    for g, w, name in zip(got, want, ("dx", "dW", "dbias")):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=name)


@pytest.mark.parametrize("shape,cout", [
    ((1, 8, 6, 32, 4), 8),     # test_grads_match_lax's shape
    ((1, 16, 6, 24, 3), 5),    # odd channels
])
@pytest.mark.parametrize("bias_act", [True, False])
def test_k1_grads_match_pallas(shape, cout, bias_act):
    rs = np.random.RandomState(1)
    x5 = rs.randn(*shape).astype(np.float32)
    kernel = rs.randn(3, 3, 3, shape[-1], cout).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32) if bias_act else None
    slope = 0.2 if bias_act else None
    _compare(_port_grads(x5, kernel, bias, slope, up=False),
             _jax_grads(x5, kernel, bias, slope, up=False), atol=1e-4)


@pytest.mark.parametrize("bias_act", [True, False])
def test_k2_grads_match_pallas(bias_act):
    """test_fused_upsample_conv_grads's shape: the input is already
    upsampled in x and y; grads flow through the z-upsample."""
    rs = np.random.RandomState(5)
    x5 = rs.randn(1, 8, 8, 16, 8).astype(np.float32)
    kernel = rs.randn(3, 3, 3, 8, 4).astype(np.float32)
    bias = rs.randn(4).astype(np.float32) if bias_act else None
    slope = 0.2 if bias_act else None
    _compare(_port_grads(x5, kernel, bias, slope, up=True),
             _jax_grads(x5, kernel, bias, slope, up=True), atol=1e-3)


@pytest.mark.parametrize("up", [False, True])
def test_grads_under_checkpoint(up):
    """The Function saves what its backward needs, so a checkpointed call
    (forward recomputed in the backward pass) gives the same gradients."""
    rs = np.random.RandomState(7)
    x5 = rs.randn(1, 4, 4, 16, 4).astype(np.float32)
    kernel = rs.randn(3, 3, 3, 4, 4).astype(np.float32)
    bias = rs.randn(4).astype(np.float32)
    n = (zconv.zconv3d_dx.launches, zconv.zconv3d_dw.launches)
    got = _port_grads(x5, kernel, bias, 0.2, up, checkpoint=True)
    assert (zconv.zconv3d_dx.launches, zconv.zconv3d_dw.launches) == n
    _compare(got, _jax_grads(x5, kernel, bias, 0.2, up), atol=1e-3)


def test_backward_wrappers_take_the_plain_version_on_the_cpu():
    """The dx and dW wrappers on CPU tensors: their plain versions, no
    launch counted; dW and dbias in fp32 and upstream's layout."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(1, 4, 5, 6, 3).astype(np.float32))
    w = torch.from_numpy(rs.randn(5, 3, 3, 3, 3).astype(np.float32))
    out = zconv.zconv3d_leaky(x, w)
    g = torch.randn_like(out)
    counters = [zconv.zconv3d_dx, zconv.upzconv3d_dx, zconv.zconv3d_dw,
                zconv.upzconv3d_dw]
    before = [f.launches for f in counters]
    dx = zconv.zconv3d_dx(g, out, w)
    dw, db = zconv.zconv3d_dw(x, g, out)
    up = zconv.upzconv3d_leaky(x, w)
    gu = torch.randn_like(up)
    dxu = zconv.upzconv3d_dx(gu, up, w)
    dwu, dbu = zconv.upzconv3d_dw(x, gu, up, with_bias=False)
    assert [f.launches for f in counters] == before
    assert dx.shape == dxu.shape == x.shape
    assert dw.shape == dwu.shape == w.shape and dw.dtype == torch.float32
    assert db.shape == (5,) and dbu is None
    gm = torch.where(out >= 0, g, 0.2 * g)
    np.testing.assert_allclose(db.numpy(), gm.sum((0, 1, 2, 3)).numpy(),
                               rtol=1e-5, atol=1e-5)
