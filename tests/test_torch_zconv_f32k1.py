"""fp32 K1 (csrc/zconv_f32.cu's zconv_f32_kernel) on the CPU: the host side
of the card's kernel.

fp32 K1 runs fp32 K2's kernel with plain z planes: the same plan
(ops/zconv.py::f32_plan without ``up``), register tile, plane ring and walk;
only the staging differs. An item is 4 consecutive floats of one y row of
x (Z x C floats, z-major), stored transposed into the plane's [c][z]. The
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); here, with tests/test_torch_zconv_f32up.py's copy of the
walk, at muvo.yml's two K1 stages (conv2.conv2 96x96x32x16 -> 16 and
conv3.conv2 192x192x64x8 -> 8, batch 1 and 5), tiny_test_cfg's and the card
tests' shapes:

1. the plan fits an H100 (232,448 bytes of shared memory a block, 512
   threads); at the two stages every thread of a block has work, no y tile
   is ragged, x rows load as float4 and the next plane fits the registers
   the kernel prefetches it into (kPrefetch items a thread, as K2);
2. the rows the blocks walk, times the threads' register tiles, cover each
   output voxel and channel once, and each row's three taps find their
   planes in the ring;
3. a plane's staging items write each z of each (y, c) row once and leave
   the zeroed z halo alone;
4. a numpy run of the kernel's steps (K1's staging, then the walk and each
   thread's 4 x CO tile summed over dx, dy, c, dz) gives the plain version's
   output (zconv3d_leaky_plain) within 1e-5 of max |plain| at Z 1-3, C 3
   with Cout 5, a ragged y tile, runs that end mid segment, with and without
   bias and activation, on CO 4 and CO 8; and once muvo_tpu's
   zconv3d_leaky (Pallas in interpret mode) within 1e-4;
5. the kernel's K1 constants match ops/zconv.py, and on a CPU tensor fp32
   K1 runs the plain version and counts no launch.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.ops.pallas_zconv import zconv3d_leaky as pallas_zconv3d_leaky
from muvo_tpu_torch.ops import zconv
from test_torch_zconv_f32up import (H100, MAX_THREADS, PREFETCH, _coverage,
                                    _emulate, _walk)

# muvo.yml's fp32 K1 stages: (X, Y, Z, C, Cout) and the plan's co, y rows,
# threads
STAGES = {"conv2.conv2": ((96, 96, 32, 16, 16), 4, 16, 512),
          "conv3.conv2": ((192, 192, 64, 8, 8), 4, 16, 512)}
# tiny_test_cfg's K1 shapes (voxel 64^3, feature channels 16; batch 6 in
# chip_smoke.py's fp32 card-vs-host step) and tests/test_torch_cuda.py's
# fp32 K1 shapes, (B, X, Y, Z, C), Cout
TINY_SHAPES = (((6, 32, 32, 32, 4), 4), ((6, 64, 64, 64, 2), 2))
CARD_SHAPES = (((1, 3, 4, 6, 72), 8), ((1, 6, 7, 32, 16), 16),
               ((1, 6, 7, 64, 8), 8), ((2, 5, 6, 1, 16), 8),
               ((1, 4, 9, 2, 8), 8), ((1, 3, 5, 3, 3), 5),
               ((1, 3, 37, 64, 4), 16), ((2, 7, 3, 5, 6), 12),
               ((1, 4, 5, 16, 32), 16))
# small shapes that take every path: Z 1-3, C 3 with Cout 5 (Z x C not a
# multiple of 4: scalar loads, items that wrap z), a ragged y tile (37 = 4 x
# 8 + 5; 13 + 13 + 11 at CO 8), runs across segments
EDGE_SHAPES = (((2, 5, 6, 1, 16), 8), ((1, 4, 9, 2, 8), 8),
               ((1, 3, 5, 3, 3), 5), ((1, 3, 37, 64, 4), 16),
               ((2, 7, 3, 5, 6), 12))


def _plan(shape, cout, sms=132, **kw):
    return zconv.f32_plan(*shape, cout, False, sms=sms,
                          smem_optin=H100["smem_optin"], **kw)


def _floats(plan: dict, i: int):
    """The kernel's decode of K1 staging item ``i`` of a plane: (y row yy,
    [(z, c)] of its floats inside the row's Z x C)."""
    yy, q = divmod(i, plan["runs"])
    f0 = q * zconv.F32_QUAD
    return yy, [divmod(f, plan["C"]) for f in range(f0, f0 + zconv.F32_QUAD)
                if f < plan["Z"] * plan["C"]]


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_plan_at_the_decoder_stages(stage, batch):
    shape, co, ty, threads = STAGES[stage]
    plan = _plan((batch, *shape[:4]), shape[4])
    assert (plan["co"], plan["ty"], plan["threads"]) == (co, ty, threads)
    assert plan["up"] == 0 and plan["xvec"] == 1
    assert plan["Z"] == plan["Zin"] == shape[2]
    assert plan["smem_bytes"] <= H100["smem_optin"]
    # every thread has work: one (y, z group, chunk) each, no ragged tile
    assert plan["ty"] * plan["ngz"] * plan["nchunks"] == plan["threads"]
    assert plan["Y"] % plan["ty"] == 0 and plan["Z"] % 4 == 0
    assert plan["Cout"] % plan["co"] == 0
    # the next plane arrives in registers whole
    assert plan["items"] <= PREFETCH * plan["threads"]
    # one block an SM, as many as the rows allow
    assert 2 * (plan["smem_bytes"] + 1024) > zconv.SMEM_PER_SM
    assert plan["grid"] == min(H100["sms"],
                               plan["rows"] // zconv.F32_MIN_ROWS)


@pytest.mark.parametrize("shape,cout", TINY_SHAPES + CARD_SHAPES)
def test_plan_fits_the_other_k1_shapes(shape, cout):
    plan = _plan(shape, cout)
    assert plan["smem_bytes"] <= H100["smem_optin"]
    assert plan["threads"] <= MAX_THREADS and plan["threads"] % 32 == 0
    assert plan["threads"] >= plan["ty"] * plan["ngz"] * plan["nchunks"]
    assert plan["ngz"] * 4 >= plan["Z"] and plan["coutp"] >= plan["Cout"]
    assert 1 <= plan["grid"] <= plan["rows"]
    assert plan["xs"] * plan["grid"] >= plan["rows"]
    assert plan["xvec"] == int(shape[3] * shape[4] % 4 == 0)


def test_plan_refuses_what_does_not_fit():
    assert _plan((1, 4, 4, 64, 70), 8)["smem_bytes"] <= H100["smem_optin"]
    assert _plan((1, 4, 4, 4, 44), 44)["smem_bytes"] <= H100["smem_optin"]
    for shape, cout in (((1, 4, 4, 64, 71), 8), ((1, 4, 4, 4, 45), 45)):
        with pytest.raises(ValueError, match="fp32 K1 kernel"):
            _plan(shape, cout)
    assert _plan((1, 4, 4, 8, 8), 8, xvec=False)["xvec"] == 0  # misaligned


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_walk_covers_every_output_once_at_the_stages(stage, batch):
    shape = STAGES[stage][0]
    plan = _plan((batch, *shape[:4]), shape[4])
    assert (_coverage(plan) == 1).all()


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("shape,cout", TINY_SHAPES[:1] + CARD_SHAPES)
def test_walk_covers_every_output_once_at_the_edges(shape, cout, sms):
    plan = _plan(shape, cout, sms=sms)
    assert (_coverage(plan) == 1).all()
    for block in range(plan["grid"]):
        for b, y0, xo, j, slots in _walk(plan, block):
            taps = [slots[(j + dx) % zconv.F32_PLANES] for dx in range(3)]
            assert taps == [xo - 1, xo, xo + 1]


@pytest.mark.parametrize("shape,cout", EDGE_SHAPES + TINY_SHAPES + (
    ((1, 96, 96, 32, 16), 16), ((1, 192, 192, 64, 8), 8)))
def test_staging_items_write_each_z_once(shape, cout):
    plan = _plan(shape, cout)
    written = np.zeros((plan["ty"] + 2, plan["C"], plan["zs"]), np.int32)
    for i in range(plan["items"]):
        yy, zc = _floats(plan, i)
        for z, c in zc:
            written[yy, c, z + 1] += 1
    assert (written[..., 1:plan["Z"] + 1] == 1).all()
    assert (written[..., 0] == 0).all()            # z -1: the halo
    assert (written[..., plan["Z"] + 1:] == 0).all()


def _stage_k1(plane, x, plan, b, xi, y0):
    """Every K1 staging item of plane xi: load_item (zero outside the
    volume), then store_item's transpose into [y][c][padded z]."""
    row_floats = plan["Z"] * plan["C"]
    for i in range(plan["items"]):
        yy, zc = _floats(plan, i)
        gy = y0 + yy - 1
        inside = 0 <= xi < plan["X"] and 0 <= gy < plan["Y"]
        row = (x[b, xi, gy].reshape(row_floats) if inside
               else np.zeros(row_floats, np.float32))
        for z, c in zc:
            plane[yy, c, z + 1] = row[z * plan["C"] + c]


@pytest.mark.parametrize("co", [4, 8])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("sms", [3, 132])
@pytest.mark.parametrize("shape,cout", EDGE_SHAPES)
def test_kernel_steps_match_the_plain_version(shape, cout, sms, act, co):
    rs = np.random.RandomState(11)
    c = shape[-1]
    x = rs.standard_normal(shape).astype(np.float32)
    w = (rs.standard_normal((cout, c, 3, 3, 3)) / np.sqrt(27 * c)).astype(
        np.float32)
    b = rs.standard_normal(cout).astype(np.float32) if act else None
    slope = 0.2 if act else None
    plan = zconv._f32_plan(*shape, cout, False, co=co, sms=sms,
                           smem_optin=H100["smem_optin"])
    got = _emulate(x, w, b, slope, plan, _stage_k1)
    want = zconv.zconv3d_leaky_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), slope).numpy()
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_kernel_steps_match_muvo_tpu_pallas():
    """The numpy run of the kernel's steps against muvo_tpu's K1 (the Pallas
    z-fold kernel in interpret mode, z blocks of 16), fp32 both."""
    rs = np.random.RandomState(5)
    shape, cout = (1, 8, 10, 32, 4), 8
    x = rs.standard_normal(shape).astype(np.float32)
    kernel = rs.standard_normal((3, 3, 3, shape[-1], cout)).astype(np.float32)
    bias = rs.standard_normal(cout).astype(np.float32)
    want = np.asarray(pallas_zconv3d_leaky(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), 16, 0.2,
        True))
    w = np.ascontiguousarray(np.transpose(kernel, (4, 3, 0, 1, 2)))
    got = _emulate(x, w, bias, 0.2, _plan(shape, cout, sms=3), _stage_k1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_k1_constants_match_the_kernel_source():
    csrc = Path(zconv.__file__).resolve().parent.parent / "csrc"
    # the staging items' constants are zconv_stage.cuh's, which it includes
    src = ((csrc / "zconv_f32.cu").read_text()
           + (csrc / "zconv_stage.cuh").read_text())
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kQuad"]) == zconv.F32_QUAD
    assert int(consts["kPrefetch"]) == PREFETCH
    assert "kItemFloats = UP ? kRun + 2 : kQuad;" in src
    assert "conv_walk<CO, false>" in src  # zconv_f32_kernel is K1


def test_fp32_k1_on_the_host_takes_the_plain_version():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.standard_normal((1, 3, 4, 5, 3)).astype(
        np.float32))
    w = torch.from_numpy(rs.standard_normal((5, 3, 3, 3, 3)).astype(
        np.float32))
    n, impl = zconv.zconv3d_leaky.launches, zconv.zconv3d_leaky.last_impl
    got = zconv.zconv3d_leaky(x, w, None, 0.2)
    assert torch.equal(got, zconv.zconv3d_leaky_plain(x, w, None, 0.2))
    assert zconv.zconv3d_leaky.launches == n
    assert zconv.zconv3d_leaky.last_impl == impl
