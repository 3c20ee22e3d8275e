"""bf16 weight gradients of the voxel convs (K3, K3-up) on the CPU.

1. The plain versions zconv3d_dw_plain / upzconv3d_dw_plain on bf16 inputs
   against muvo_tpu's dW and dbias from jax.vjp of zconv3d_leaky_folded /
   upzconv3d_leaky_folded, the Pallas kernels in interpret mode on bf16
   inputs (as tests/test_pallas_zconv.py runs them), with the same forward
   output as the leaky mask on both sides. Inputs from a numpy seed, two
   shapes per kernel, one with X and Y that end mid tile.

   Tolerance: max |port - muvo_tpu| <= 1e-2 * max |muvo_tpu| (dW and dbias
   each). The inputs are bf16 and both sides sum in fp32, but muvo_tpu
   returns dW and dbias in the kernel's type (_vjp_bwd and _up_vjp_bwd end
   in .astype(kernel.dtype)), so its gradients are rounded to bf16 (a
   relative 2^-9 of each value) where the port's are fp32, and the port's
   plain K3-up rounds the z-upsampled input to bf16 (upsample2x_z) where
   muvo_tpu folds the upsample into its banded weights.

2. The host-side pieces of the card's kernel (csrc/zconv_dw_tc.cu): its plan
   (dw_tc_plan) covers every (b, x, y) exactly once and fits the card's
   shared memory, its DwTcShape has dw_tc_plan's fields in order, and the
   GEMM it computes, written out here in plain PyTorch tile by tile as the
   plan deals the tiles to blocks (A: taps x channels of the staged input
   plus a row of ones; B: the masked cotangent), gives through
   dw_tc_unpack the plain version's dW and dbias, computed in fp32 on the
   same bf16 operands (summation order only: 1e-5 relative to max
   |plain|).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from muvo_tpu.ops.pallas_zconv import (
    _pick_f,
    _pick_f_up,
    upzconv3d_leaky_folded,
    zconv3d_leaky_folded,
)
from muvo_tpu_torch.ops import zconv

JAX_TOL = 1e-2
GEMM_TOL = 1e-5
# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block may opt in to
H100 = dict(sms=132, smem_optin=232448)
# muvo.yml's four weight-gradient shapes at batch 24: (B, X, Y, Zin, C,
# Cout, up) and the y rows a tile the plan picks
FLAGSHIP = (((24, 96, 96, 16, 32, 16, True), 16),
            ((24, 96, 96, 32, 16, 16, False), 8),
            ((24, 192, 192, 32, 16, 8, True), 4),
            ((24, 192, 192, 64, 8, 8, False), 16))


def _bf16(rs, *shape, scale=1.0):
    """Seeded normal values rounded to bf16, as a torch bf16 tensor."""
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)
                            ).to(torch.bfloat16)


def _jax_dw(x, w, b, g, slope, up):
    """muvo_tpu's forward output, dW (Cout, C, 3, 3, 3) and dbias through
    jax.vjp in interpret mode, all bf16 in, returned as fp32 numpy."""
    B, X, Y, Z, C = x.shape
    cout = w.shape[0]
    if up:
        f = _pick_f_up(Z, C, cout) or 2 * Z
        fn = lambda x4, k, bb: upzconv3d_leaky_folded(  # noqa: E731
            x4, k, bb, C, f, slope, True)
    else:
        f = _pick_f(Z, C, cout) or Z
        fn = lambda x4, k, bb: zconv3d_leaky_folded(  # noqa: E731
            x4, k, bb, C, f, slope, True)

    def j(t):
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)

    kernel = j(w.permute(2, 3, 4, 1, 0))  # (kx, ky, kz, C, Cout)
    out, vjp = jax.vjp(fn, j(x.reshape(B, X, Y, Z * C)), kernel, j(b))
    _, dk, db = vjp(j(g).reshape(out.shape))
    assert dk.dtype == jnp.bfloat16 and db.dtype == jnp.bfloat16
    out = torch.from_numpy(np.array(out.astype(jnp.float32))).to(
        torch.bfloat16).reshape(g.shape)
    dw = np.transpose(np.asarray(dk.astype(jnp.float32)), (4, 3, 0, 1, 2))
    return out, dw, np.asarray(db.astype(jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("up", [False, True], ids=["K3", "K3-up"])
@pytest.mark.parametrize("shape,cout", [
    ((1, 5, 6, 10, 8), 8),     # one tile a row
    ((2, 7, 11, 4, 4), 12),    # X and Y end mid tile, Cout not a power of 2
])
def test_plain_dw_matches_muvo_tpu_in_bf16(shape, cout, up):
    rs = np.random.RandomState(3)
    c = shape[-1]
    x = _bf16(rs, *shape)
    w = _bf16(rs, cout, c, 3, 3, 3, scale=(27 * c) ** -0.5)
    b = _bf16(rs, cout)
    zout = 2 * shape[3] if up else shape[3]
    g = _bf16(rs, *shape[:3], zout, cout)
    out, dw_want, db_want = _jax_dw(x, w, b, g, 0.2, up)
    plain = zconv.upzconv3d_dw_plain if up else zconv.zconv3d_dw_plain
    dw, db = plain(x, g, out, 0.2)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    assert _rel(dw.numpy(), dw_want) <= JAX_TOL
    assert _rel(db.numpy(), db_want) <= JAX_TOL


def _covered(plan):
    """How often each (b, x, y) falls in a tile of some block."""
    hits = np.zeros((plan["B"], plan["X"], plan["Y"]), np.int32)
    for block in range(plan["grid"]):
        for b, xi, y0, y1 in zconv.dw_tc_tiles(plan, block):
            hits[b, xi, y0:y1] += 1
    return hits


@pytest.mark.parametrize("args,ty", FLAGSHIP)
def test_plan_covers_every_position_once_at_the_flagship(args, ty):
    plan = zconv.dw_tc_plan(*args, **H100)
    assert plan["ty"] == ty
    assert plan["smem_bytes"] <= H100["smem_optin"]
    if plan["nwg"] <= 2:  # two blocks an SM, each with 1 KB reserved
        assert 2 * (plan["smem_bytes"] + 1024) <= 233472
    assert (plan["m_passes"], plan["n_passes"]) == (1, 1)
    assert (_covered(plan) == 1).all()


@pytest.mark.parametrize("args", [
    (1, 1, 1, 1, 3, 5, True),        # one voxel, Zs 1
    (3, 5, 7, 3, 40, 12, False),     # ragged X and Y, C 40, Cout 12
    (2, 9, 33, 2, 8, 100, True),     # Cout > 64: two channel passes
    (1, 4, 17, 20, 64, 64, False),   # 27 * 64 + 8 rows: two row passes
])
def test_plan_covers_every_position_once_at_the_edges(args):
    for sms in (1, 3, 132):
        plan = zconv.dw_tc_plan(*args, sms=sms, smem_optin=232448)
        assert (_covered(plan) == 1).all()
        assert plan["mt"] <= (4 if plan["np"] <= 16 else 2)
        assert plan["m_passes"] * plan["nwg"] * plan["mt"] >= plan["mtiles"]
        assert plan["n_passes"] * plan["np"] >= plan["Cout"]
        assert plan["mtiles"] * 64 >= 27 * plan["cp8"] + 8


def test_plan_refuses_a_block_past_the_cards_shared_memory():
    with pytest.raises(ValueError):
        zconv.dw_tc_plan(1, 2, 2, 2000, 64, 8, True, **H100)


def test_shape_struct_matches_the_kernel_source():
    src = (Path(zconv.__file__).resolve().parent.parent / "csrc"
           / "zconv_dw_tc.cu").read_text()
    body = re.search(r"struct DwTcShape \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"\b(\w+)\s*[,;]", body.replace("int ", " "))
    assert tuple(names) == zconv.DW_TC_FIELDS


def _gemm_like_the_kernel(x, g, out, slope, up, plan):
    """The kernel's D, block by block and tile by tile in the plan's order,
    each block's partial summed in fp32 and the partials added in block
    order."""
    u = zconv.upsample2x_z(x) if up else x  # bf16, as the kernel stages it
    cp8, npad = plan["cp8"], plan["n_passes"] * plan["np"]
    u = F.pad(u.float(), (0, cp8 - plan["C"], 1, 1, 1, 1, 1, 1))
    gm = zconv.leaky_mask(g, out, slope).float()
    gm = F.pad(gm, (0, npad - plan["Cout"]))
    rows = plan["mtiles"] * 64
    total = torch.zeros(rows, npad)
    for block in range(plan["grid"]):
        d = torch.zeros(rows, npad)
        for b, xi, y0, y1 in zconv.dw_tc_tiles(plan, block):
            bmat = gm[b, xi, y0:y1].reshape(-1, npad)       # (P, N)
            taps = [u[b, xi + kx, y0 + ky:y1 + ky, kz:kz + plan["Z"]]
                    .reshape(-1, cp8)
                    for kx in range(3) for ky in range(3) for kz in range(3)]
            amat = torch.cat(taps, 1).T                      # (27 cp8, P)
            d[:27 * cp8] += amat @ bmat
            d[27 * cp8] += bmat.sum(0)                       # the ones row
        total += d
    return total.reshape(rows, plan["n_passes"], plan["np"]).permute(1, 0, 2)


@pytest.mark.parametrize("up", [False, True], ids=["K3", "K3-up"])
@pytest.mark.parametrize("shape,cout,slope", [
    ((2, 5, 11, 6, 8), 8, 0.2),    # ragged Y, several tiles a block
    ((1, 3, 4, 3, 3), 12, None),   # C 3, Cout 12, no activation
    ((1, 2, 9, 2, 16), 70, 0.2),   # Cout > 64: two channel passes
])
def test_kernel_gemm_unpacks_to_the_plain_dw(shape, cout, slope, up):
    rs = np.random.RandomState(5)
    x = _bf16(rs, *shape)
    zout = 2 * shape[3] if up else shape[3]
    g = _bf16(rs, *shape[:3], zout, cout)
    out = _bf16(rs, *shape[:3], zout, cout)
    plan = zconv.dw_tc_plan(*shape, cout, up, sms=2, smem_optin=232448)
    d = _gemm_like_the_kernel(x, g, out, slope, up, plan)
    dw, db = zconv.dw_tc_unpack(d, shape[-1], cout, with_bias=True)
    # the plain version in fp32 on the same bf16 operands (on bf16 tensors
    # it rounds dW to bf16)
    u = zconv.upsample2x_z(x) if up else x
    gm = zconv.leaky_mask(g, out, slope)
    dw_want, db_want = zconv.zconv3d_dw_plain(u.float(), gm.float(), None,
                                              None)
    assert dw.shape == dw_want.shape and db.shape == (cout,)
    assert _rel(dw.numpy(), dw_want.numpy()) <= GEMM_TOL
    assert _rel(db.numpy(), db_want.numpy()) <= GEMM_TOL
    assert zconv.dw_tc_unpack(d, shape[-1], cout, with_bias=False)[1] is None


def test_bf16_on_the_host_takes_the_plain_version():
    rs = np.random.RandomState(7)
    x, g = _bf16(rs, 1, 3, 4, 5, 4), _bf16(rs, 1, 3, 4, 10, 8)
    n = zconv.upzconv3d_dw.launches
    dw, db = zconv.upzconv3d_dw(x, g, g, 0.2)
    want = zconv.upzconv3d_dw_plain(x, g, g, 0.2)
    assert zconv.upzconv3d_dw.launches == n
    assert torch.equal(dw, want[0]) and torch.equal(db, want[1])
