"""fp32 K3 and K3-up (csrc/zconv_dw.cu's dw_f32_kernel) on the CPU: the
host side of the card's kernel.

The kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py);
here its plan (ops/zconv.py::dw_f32_plan) and a numpy run of its steps,
this file's copy of how zconv_dw.cu decodes threads, staging items and rows
(``_threads``, ``_stage_x``, ``_stage_g``, ``_walk``), are checked at
muvo.yml's four weight-gradient stages (batch 24 and 2), tiny_test_cfg's
(batch 6) and the card tests' shapes:

1. the plan fits an H100 (232,448 bytes of shared memory a block, 288
   threads); at the four stages every thread has a unit, no y tile is
   ragged, the tile is the largest power of two that fits, the (y row, z
   segment) pairs
   split evenly over the slices, and a quarter warp's shared loads meet at
   most once on a bank; it refuses what does not fit;
2. the rows the blocks walk, times the threads' units and slices, cover
   each (position, tap, c, co) of the gradient exactly once;
3. a numpy run of the kernel's steps (the staging, with K3-up's z
   interpolation and the mask; the ring of planes; each thread's sliding z
   window and its fp32 sums; the block's dbias pass; the workspace rows
   summed in sum_rows_kernel's fixed order) gives the plain version's dW and
   dbias (zconv3d_dw_plain, upzconv3d_dw_plain) within 1e-5 of max |plain|
   at C 3 with Cout 5, C 40 with Cout 12 and 20 (two launches), Zs 1 and
   2, a ragged y tile, with and without the activation; and
   once muvo_tpu's dW and dbias from jax.vjp of zconv3d_leaky_folded and
   upzconv3d_leaky_folded (Pallas in interpret mode) within 1e-4;
4. the kernel source's constants and DwF32Shape fields match ops/zconv.py,
   and on a CPU tensor fp32 K3 and K3-up take the plain version and count
   no launch.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.ops.pallas_zconv import (
    _pick_f,
    _pick_f_up,
    upzconv3d_leaky_folded,
    zconv3d_leaky_folded,
)
from muvo_tpu_torch.ops import zconv

# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block may opt in to
H100 = dict(sms=132, smem_optin=232448)
TOL = 1e-5      # numpy run of the kernel's steps against the plain version
JAX_TOL = 1e-4  # against muvo_tpu's Pallas gradients (interpret mode)
# muvo.yml's fp32 weight-gradient stages: (X, Y, Zin, C, Cout, up), and the
# plan's ty, slices, threads and the most loads of a quarter warp on one
# bank (x, cotangent)
STAGES = {
    "conv2.conv1": ((96, 96, 16, 32, 16, True), (8, 1, 288), (1, 1)),
    "conv2.conv2": ((96, 96, 32, 16, 16, False), (16, 2, 288), (1, 1)),
    "conv3.conv1": ((192, 192, 32, 16, 8, True), (8, 4, 288), (1, 1)),
    "conv3.conv2": ((192, 192, 64, 8, 8, False), (16, 8, 288), (1, 1)),
}
# tiny_test_cfg's four (voxel 64^3; batch 6 in chip_smoke.py's fp32
# card-vs-host step) and tests/test_torch_cuda.py's shapes: (B, X, Y, Zin,
# C), Cout, up
TINY_SHAPES = (((6, 64, 64, 64, 2), 2, False), ((6, 64, 64, 32, 4), 2, True),
               ((6, 32, 32, 32, 4), 4, False), ((6, 32, 32, 16, 8), 4, True))
CARD_SHAPES = tuple((shape, cout, up) for shape, cout in (
    ((2, 12, 10, 20, 16), 8), ((1, 5, 7, 19, 3), 5), ((1, 1, 1, 20, 4), 12),
    ((3, 4, 33, 1, 8), 8), ((1, 6, 6, 16, 32), 16), ((1, 3, 4, 6, 40), 20),
    ((1, 5, 7, 3, 3), 5), ((1, 3, 4, 6, 40), 12), ((1, 4, 5, 16, 32), 16),
    ((1, 11, 13, 1, 16), 8), ((1, 9, 6, 2, 16), 8), ((1, 5, 21, 4, 4), 8))
    for up in (False, True))
# small shapes that take every path: C 3 with Cout 5 (scalar loads and
# stores, padded channels), C 40 with Cout 12 (270 units, one launch) and
# 20 (450 units: two launches), Zs 1 and 2, ragged y tiles (13 = 8 + 5,
# 21 = 16 + 5), runs that end mid segment
EDGE_SHAPES = (((1, 5, 7, 3, 3), 5), ((1, 3, 4, 6, 40), 12),
               ((1, 3, 4, 6, 40), 20), ((1, 11, 13, 1, 16), 8),
               ((1, 9, 6, 2, 16), 8), ((2, 7, 21, 4, 4), 8))


def _plan(shape, cout, up, sms=132, **kw):
    return zconv.dw_f32_plan(*shape, cout, up, sms=sms,
                             smem_optin=H100["smem_optin"], **kw)


def _threads(plan: dict, unit0: int = 0):
    """The kernel's decode of every thread of a launch from ``unit0``:
    arrays (worker, unit, slice, coc, cic, dx, dy)."""
    tid = np.arange(plan["threads"])
    slc, ul = tid % plan["slices"], tid // plan["slices"]
    u = unit0 + ul
    worker = (ul < plan["nl"]) & (u < plan["nunits"])
    coc, cic = u % plan["ncoc"], (u // plan["ncoc"]) % plan["ncic"]
    tap = u // (plan["ncoc"] * plan["ncic"])
    return worker, u, slc, coc, cic, tap // 3, tap % 3


def _walk(plan: dict, block: int):
    """The output rows block ``block`` computes, in order: (b, y0, xo, j,
    more), ``j`` the row's index in its run (tap dx reads slot (j + dx) %
    3) and ``more`` whether the run goes on (the kernel then stages plane
    xo + 2 into slot j % 3)."""
    rows, grid, X = plan["rows"], plan["grid"], plan["X"]
    r, rend = block * rows // grid, (block + 1) * rows // grid
    walk = []
    while r < rend:
        seg, xa = divmod(r, X)
        xb = min(X, xa + rend - r)
        b, yt = divmod(seg, plan["nyt"])
        for xo in range(xa, xb):
            walk.append((b, yt * plan["ty"], xo, xo - xa, xo + 1 < xb))
        r += xb - xa
    return walk


def _stage_x(plan, x, b, xi, y0):
    """Plane xi of tile (b, y0): every staging item of zconv_stage.cuh
    (load_item, then store_item in the [y][z + 1][cp] layout), flat."""
    C, Zin, runs, ys, cp = (plan[k] for k in ("C", "Zin", "runs", "ys",
                                              "cp"))
    plane = np.zeros((plan["ty"] + 2) * ys, np.float32)
    for i in range(plan["items"]):
        if plan["up"]:
            c, q = i % C, i // C
            k0, yy = (q % runs) * 4, q // runs
        else:
            yy, k0 = i // runs, (i % runs) * 4
        gy = y0 + yy - 1
        inside = 0 <= xi < plan["X"] and 0 <= gy < plan["Y"]
        row = (x[b, xi, gy].reshape(-1) if inside
               else np.zeros(Zin * C, np.float32))
        base = yy * ys
        if plan["up"]:
            v = [row[min(max(k0 - 1 + j, 0), Zin - 1) * C + c]
                 for j in range(6)]
            for m in range(4):
                k = k0 + m
                if k >= Zin:
                    break
                xk = v[m + 1]
                lo = xk if k == 0 else np.float32(0.75) * xk + np.float32(
                    0.25) * v[m]
                hi = xk if k == Zin - 1 else np.float32(
                    0.75) * xk + np.float32(0.25) * v[m + 2]
                plane[base + (2 * k + 1) * cp + c] = lo
                plane[base + (2 * k + 2) * cp + c] = hi
        elif C % 4 == 0:  # one float4: the y row as it is in x
            plane[base + cp + k0:base + cp + k0 + 4] = row[k0:k0 + 4]
        else:
            for f in range(k0, min(k0 + 4, Zin * C)):
                z, c = divmod(f, C)
                plane[base + (z + 1) * cp + c] = row[f]
    return plane


def _stage_g(plan, g, mask, slope, b, xo, y0):
    """The cotangent rows of output row (b, xo) of tile y0, masked: every
    item of load_g / store_g in the [y][z][coutp] layout, flat."""
    Z, cout, gs, coutp = (plan[k] for k in ("Z", "Cout", "gs", "coutp"))
    gt = np.zeros(plan["ty"] * gs, np.float32)
    for i in range(plan["gitems"]):
        yl, f0 = i // plan["gruns"], (i % plan["gruns"]) * 4
        gy = y0 + yl
        if gy >= plan["Y"]:
            continue
        for f in range(f0, min(f0 + 4, Z * cout)):
            z, co = divmod(f, cout)
            v = g[b, xo, gy, z, co]
            if mask is not None and mask[b, xo, gy, z, co] < 0:
                v = v * np.float32(slope)
            gt[yl * gs + z * coutp + co] = v
    return gt


def _sum_rows(part):
    """sum_rows_kernel: 8 warps each add every 8th row in order, then the 8
    warp sums are added in order; fp32."""
    warp = np.zeros((8, part.shape[1]), np.float32)
    for r in range(part.shape[0]):
        warp[r % 8] += part[r]
    out = np.zeros(part.shape[1], np.float32)
    for w in range(8):
        out += warp[w]
    return out


def _emulate(x, g, mask, slope, plan):
    """The kernel's steps on ``plan``: (dW (27, cp, coutp), dbias (coutp))
    as the C entry returns them, every sum in fp32."""
    ty, Z, Y, ys, gs = (plan[k] for k in ("ty", "Z", "Y", "ys", "gs"))
    cp, coutp, slices = (plan[k] for k in ("cp", "coutp", "slices"))
    co = zconv.DW_F32_CO
    T, grid, zrun = plan["threads"], plan["grid"], plan["zrun"]
    part = np.zeros((grid * slices, 27 * cp * coutp), np.float32)
    part_bias = np.zeros((grid, coutp), np.float32)
    # dbias: thread t adds channels 4 bq .. of positions bp, bp + bstride..
    nq = coutp // 4
    bstride = T // nq
    bq, bp = np.arange(T) % nq, np.arange(T) // nq
    pairs = ty * plan["nzs"]
    four, cos = np.arange(4), np.arange(co)
    for p in range(plan["passes"]):
        worker, u, slc, coc, cic, dx, dy = _threads(plan, p * plan["nl"])
        for block in range(grid):
            acc = np.zeros((T, 3, 4, co), np.float32)
            bacc = np.zeros((T, 4), np.float32)
            for b, y0, xo, j, more in _walk(plan, block):
                if j == 0:  # a run stages its first three planes
                    slots = [_stage_x(plan, x, b, xo - 1 + s, y0)
                             for s in range(3)]
                gt = _stage_g(plan, g, mask, slope, b, xo, y0)
                if p == 0:  # only the first launch sums dbias
                    for k in range(-(-ty * Z // bstride)):
                        pos = bp + k * bstride
                        ok = (bp < bstride) & (pos < ty * Z)
                        idx = (pos // Z) * gs + pos % Z * coutp + 4 * bq
                        bacc[ok] += gt[idx[ok, None] + four]
                planes = np.stack(slots)
                slot = (j + dx) % 3  # tap dx's plane in the ring
                for k in range(-(-pairs // slices)):
                    q = slc + k * slices
                    yi, z0 = q % ty, q // ty * zrun
                    n = np.minimum(zrun, Z - z0)
                    live = worker & (q < pairs) & (y0 + yi < Y) & (n > 0)
                    xbase = (dy + yi) * ys + cic * 4

                    def x_at(zz):  # float4 of x at padded z zz
                        idx = xbase[:, None] + zz[:, None] * cp + four
                        return planes[slot[:, None],
                                      np.where(live[:, None], idx, 0)]

                    # the sliding window: x at z - 1 and z, then z + 1
                    xa, xb = x_at(z0), x_at(z0 + 1)
                    for t in range(zrun):
                        step = live & (t < n)
                        if not step.any():
                            break
                        xc = x_at(np.where(step, z0 + t + 2, 0))
                        gi = (yi * gs + coc * co + (z0 + t) * coutp)[:, None]
                        gv = gt[np.where(step[:, None], gi + cos, 0)]
                        win = np.stack([xa, xb, xc], 1)  # (T, dz, 4)
                        acc[step] += (win[:, :, :, None]
                                      * gv[:, None, None, :])[step]
                        xa, xb = xb, xc
                if more:  # plane xo + 2 into the slot of plane xo - 1
                    slots[j % 3] = _stage_x(plan, x, b, xo + 2, y0)
            # this (block, slice)'s workspace row: entry ((tap, dz), c, co)
            for t in np.nonzero(worker)[0]:
                row = block * slices + slc[t]
                for dz in range(3):
                    for i in range(4):
                        e = ((((dx[t] * 3 + dy[t]) * 3 + dz) * cp
                              + cic[t] * 4 + i) * coutp + coc[t] * co)
                        part[row, e:e + co] = acc[t, dz, i]
            if p == 0:  # the block's sum of the threads' dbias, in order
                red = np.where((bp < bstride)[:, None], bacc, 0)
                for c in range(coutp):
                    v = np.float32(0)
                    for q in range(bstride):
                        v += red[q * nq + c // 4, c % 4]
                    part_bias[block, c] = v
    return _sum_rows(part).reshape(27, cp, coutp), _sum_rows(part_bias)


def _unpack(dw, db, c, cout):
    """As ops/zconv.py::_dw_f32: dW (Cout, C, 3, 3, 3), dbias (Cout,)."""
    dw = dw.reshape(3, 3, 3, dw.shape[1], dw.shape[2])[..., :c, :cout]
    return np.transpose(dw, (4, 3, 0, 1, 2)), db[:cout]


def _inputs(rs, shape, cout, up, act):
    """x, g and the forward output (the mask), seeded, fp32."""
    b, X, Y, zin, c = shape
    z = 2 * zin if up else zin
    x = rs.standard_normal(shape).astype(np.float32)
    g = rs.standard_normal((b, X, Y, z, cout)).astype(np.float32)
    out = rs.standard_normal((b, X, Y, z, cout)).astype(np.float32)
    return x, g, (out if act else None)


@pytest.mark.parametrize("batch", [24, 2])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_plan_at_the_decoder_stages(stage, batch):
    (X, Y, zin, c, cout, up), (ty, slices, threads), ways = STAGES[stage]
    plan = _plan((batch, X, Y, zin, c), cout, up)
    assert (plan["ty"], plan["slices"], plan["threads"]) == (
        ty, slices, threads)
    assert plan["smem_bytes"] <= H100["smem_optin"]
    # every thread has a unit, one launch, no ragged tile, the pairs split
    # evenly over the slices
    assert plan["nl"] * plan["slices"] == plan["threads"] == (
        zconv.DW_F32_THREADS)
    assert plan["passes"] == 1 and plan["nl"] == plan["nunits"]
    assert Y % plan["ty"] == 0 and plan["nzs"] * plan["zrun"] == plan["Z"]
    assert plan["ty"] * plan["nzs"] % plan["slices"] == 0
    assert plan["cp"] == c and plan["coutp"] == cout  # no padded channel
    # the most y rows, a power of two: twice as many do not fit the card
    t = 2 * ty
    block = 4 * (zconv.DW_F32_PLANES * (t + 2) * plan["ys"] + t * plan["gs"])
    assert ty & (ty - 1) == 0
    assert t > zconv.DW_F32_MAX_TY or block > H100["smem_optin"]
    assert plan["xvec"] == int(not up) and plan["gvec"] == 1
    # one block an SM, every SM a block
    assert plan["grid"] == H100["sms"]
    assert _lane_ways(plan) == ways


@pytest.mark.parametrize("shape,cout,up", TINY_SHAPES + CARD_SHAPES)
def test_plan_fits_the_other_shapes(shape, cout, up):
    plan = _plan(shape, cout, up)
    assert plan["smem_bytes"] <= H100["smem_optin"]
    assert plan["threads"] <= zconv.DW_F32_THREADS
    assert plan["threads"] % 32 == 0
    assert plan["nl"] * plan["slices"] <= plan["threads"]
    assert plan["nl"] * plan["passes"] >= plan["nunits"]
    assert plan["ys"] >= (plan["Z"] + 2) * plan["cp"]
    assert plan["gs"] >= plan["Z"] * plan["coutp"]
    assert 1 <= plan["grid"] <= plan["rows"]
    assert plan["nzs"] * plan["zrun"] >= plan["Z"]
    assert (plan["nzs"] - 1) * plan["zrun"] < plan["Z"]


def test_plan_refuses_what_does_not_fit():
    assert _plan((1, 4, 4, 300, 16), 16, False)["smem_bytes"] <= H100[
        "smem_optin"]
    with pytest.raises(ValueError, match="fp32 K3 kernel"):
        _plan((1, 4, 4, 400, 16), 16, False)  # 3 planes of 3 y rows: 257 KB
    with pytest.raises(ValueError, match="fp32 K3-up kernel"):
        _plan((1, 4, 4, 200, 16), 16, True)
    with pytest.raises(ValueError, match="empty"):
        _plan((1, 4, 0, 8, 8), 8, False)
    misaligned = _plan((1, 4, 4, 8, 8), 8, False, xvec=False, gvec=False)
    assert misaligned["xvec"] == misaligned["gvec"] == 0


@pytest.mark.parametrize("up", [False, True])
def test_edge_shapes_take_every_path(up):
    """EDGE_SHAPES hold, in each direction, two launches, a ragged y tile,
    several z segments, scalar loads and padded channels."""
    plans = [_plan(shape, cout, up, sms=3) for shape, cout in EDGE_SHAPES]
    assert any(p["passes"] == 2 for p in plans)
    assert any(p["nyt"] * p["ty"] > p["Y"] and p["nyt"] > 1 for p in plans)
    assert any(p["nzs"] > 1 for p in plans)
    assert any(not p["gvec"] and p["cp"] > p["C"] for p in plans)
    assert any(p["Zin"] == 1 for p in plans)


def _row_coverage(plan):
    """How often each (b, y tile, x) row is walked, over all blocks."""
    hits = np.zeros((plan["B"], plan["nyt"], plan["X"]), np.int64)
    for block in range(plan["grid"]):
        for b, y0, xo, _, _ in _walk(plan, block):
            hits[b, y0 // plan["ty"], xo] += 1
    return hits


def _tile_coverage(plan):
    """How often each (y row of a tile, z, unit) is summed by the threads
    of all launches: the slices' (y row, z segment) pairs and z runs."""
    hits = np.zeros((plan["ty"], plan["Z"], plan["nunits"]), np.int64)
    pairs = plan["ty"] * plan["nzs"]
    for p in range(plan["passes"]):
        worker, u, slc, *_ = _threads(plan, p * plan["nl"])
        for t in np.nonzero(worker)[0]:
            for q in range(slc[t], pairs, plan["slices"]):
                yi, z0 = q % plan["ty"], q // plan["ty"] * plan["zrun"]
                hits[yi, z0:z0 + plan["zrun"], u[t]] += 1
    return hits


@pytest.mark.parametrize("batch", [24, 2])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_walk_covers_every_term_once_at_the_stages(stage, batch):
    (X, Y, zin, c, cout, up), _, _ = STAGES[stage]
    plan = _plan((batch, X, Y, zin, c), cout, up)
    assert (_row_coverage(plan) == 1).all()
    assert (_tile_coverage(plan) == 1).all()


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("shape,cout,up", TINY_SHAPES[2:] + CARD_SHAPES)
def test_walk_covers_every_term_once_at_the_edges(shape, cout, up, sms):
    """Every (b, x, y, z) position and every (tap, c, co) of a unit (each
    unit's 3 dz x 4 x DW_F32_CO terms) once: the rows, times the tiles,
    times the units, which the threads of the launches decode one to
    one."""
    plan = _plan(shape, cout, up, sms=sms)
    co = zconv.DW_F32_CO
    assert (_row_coverage(plan) == 1).all()
    assert (_tile_coverage(plan) == 1).all()
    units = []
    for p in range(plan["passes"]):  # slice 0's thread of each unit
        worker, u, slc, *_ = _threads(plan, p * plan["nl"])
        units += list(u[worker & (slc == 0)])
    assert sorted(units) == list(range(plan["nunits"]))
    terms = set()
    for u in units:
        coc, cic = u % plan["ncoc"], u // plan["ncoc"] % plan["ncic"]
        tap = u // (plan["ncoc"] * plan["ncic"])
        for dz in range(3):
            for i in range(4):
                for k in range(co):
                    terms.add((tap * 3 + dz, cic * 4 + i, coc * co + k))
    assert len(terms) == 27 * plan["cp"] * plan["coutp"]


@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("shape,cout", EDGE_SHAPES + (
    ((1, 2, 10, 32, 16), 8), ((1, 2, 10, 64, 8), 8)))
def test_staging_writes_each_value_once(shape, cout, up):
    """A plane's items write each (y, z, c < C) once and leave the z halo,
    the padded channels and the row pad zero; the cotangent's items each
    (y, z, co < Cout) once."""
    plan = _plan(shape, cout, up)
    b, X, Y, zin, c = shape
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    plane = _stage_x(plan, x, 0, 0, 1).reshape(plan["ty"] + 2, plan["ys"])
    Z, cp = plan["Z"], plan["cp"]
    body = plane[:, :(Z + 2) * cp].reshape(plan["ty"] + 2, Z + 2, cp)
    rows = min(plan["ty"] + 2, Y)  # y rows inside the volume
    assert (body[:rows, 1:Z + 1, :c] != 0).all()
    assert (body[:, [0, Z + 1]] == 0).all() and (body[..., c:] == 0).all()
    assert (plane[:, (Z + 2) * cp:] == 0).all()
    if not up:
        want = x[0, 0, :rows]
        assert np.array_equal(body[:rows, 1:Z + 1, :c], want)
    g = np.arange(b * X * Y * Z * cout, dtype=np.float32).reshape(
        b, X, Y, Z, cout) + 1
    gt = _stage_g(plan, g, None, None, 0, 0, 0).reshape(plan["ty"],
                                                         plan["gs"])
    coutp = plan["coutp"]
    gb = gt[:, :Z * coutp].reshape(plan["ty"], Z, coutp)
    rows = min(plan["ty"], Y)
    assert np.array_equal(gb[:rows, :, :cout], g[0, 0, :rows])
    assert (gb[..., cout:] == 0).all() and (gt[:, Z * coutp:] == 0).all()
    assert (gb[rows:] == 0).all()


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("shape,cout", EDGE_SHAPES)
def test_kernel_steps_match_the_plain_version(shape, cout, up, act):
    rs = np.random.RandomState(17)
    x, g, out = _inputs(rs, shape, cout, up, act)
    slope = 0.2 if act else None
    plan = _plan(shape, cout, up, sms=3)
    dw, db = _unpack(*_emulate(x, g, out, slope, plan), shape[-1], cout)
    plain = zconv.upzconv3d_dw_plain if up else zconv.zconv3d_dw_plain
    dw_want, db_want = plain(
        torch.from_numpy(x), torch.from_numpy(g),
        None if out is None else torch.from_numpy(out), slope)
    dw_want, db_want = dw_want.numpy(), db_want.numpy()
    assert np.abs(dw - dw_want).max() <= TOL * np.abs(dw_want).max()
    assert np.abs(db - db_want).max() <= TOL * np.abs(db_want).max()


def _jax_dw(x, kernel, bias, g, slope, up):
    """muvo_tpu's dW (upstream layout) and dbias: jax.vjp of the folded
    Pallas conv (interpret mode) at the cotangent g, and its output."""
    B, X, Y, Z, C = x.shape
    cout = kernel.shape[-1]
    if up:
        f = _pick_f_up(Z, C, cout) or 2 * Z
        fn = lambda k, b: upzconv3d_leaky_folded(  # noqa: E731
            jnp.asarray(x.reshape(B, X, Y, Z * C)), k, b, C, f, slope, True)
    else:
        f = _pick_f(Z, C, cout) or Z
        fn = lambda k, b: zconv3d_leaky_folded(  # noqa: E731
            jnp.asarray(x.reshape(B, X, Y, Z * C)), k, b, C, f, slope, True)
    out, vjp = jax.vjp(fn, jnp.asarray(kernel), jnp.asarray(bias))
    dk, db = vjp(jnp.asarray(g.reshape(out.shape)))
    out = np.asarray(out).reshape(g.shape)
    dw = np.transpose(np.asarray(dk), (4, 3, 0, 1, 2))
    return dw, np.asarray(db), out


@pytest.mark.parametrize("up", [False, True])
def test_kernel_steps_match_muvo_tpu_pallas(up):
    """The numpy run of the kernel's steps against muvo_tpu's dW and dbias
    (jax.vjp through the Pallas z-fold kernel in interpret mode), with
    muvo_tpu's forward output as the leaky mask, fp32 both."""
    rs = np.random.RandomState(5)
    shape, cout = ((1, 8, 6, 16, 8), 4) if up else ((1, 8, 6, 32, 4), 8)
    x = rs.standard_normal(shape).astype(np.float32)
    kernel = rs.standard_normal((3, 3, 3, shape[-1], cout)).astype(
        np.float32)
    bias = rs.standard_normal(cout).astype(np.float32)
    z = 2 * shape[3] if up else shape[3]
    g = rs.standard_normal((*shape[:3], z, cout)).astype(np.float32)
    dw_want, db_want, out = _jax_dw(x, kernel, bias, g, 0.2, up)
    dw, db = _unpack(*_emulate(x, g, out, 0.2, _plan(shape, cout, up,
                                                      sms=3)),
                     shape[-1], cout)
    assert np.abs(dw - dw_want).max() <= JAX_TOL * np.abs(dw_want).max()
    assert np.abs(db - db_want).max() <= JAX_TOL * np.abs(db_want).max()


def _lane_ways(plan):
    """The most loads of one quarter warp on one group of 4 banks, (x, g),
    over the kernel's threads at the first z of their first pair and each
    ring position: lanes reading one address count once (a broadcast)."""
    worker, u, slc, coc, cic, dx, dy = _threads(plan)
    yi = slc % plan["ty"]
    z0 = slc // plan["ty"] * plan["zrun"]
    worst = [0, 0]
    for j in range(3):
        xaddr = (((j + dx) % 3) * plan["plane"] + (dy + yi) * plan["ys"]
                 + (z0 + 2) * plan["cp"] + cic * 4)
        loads = [xaddr]
        loads.append(yi * plan["gs"] + z0 * plan["coutp"]
                     + coc * zconv.DW_F32_CO)
        for which, arrays in ((0, loads[:1]), (1, loads[1:])):
            for a in arrays:
                for q in range(0, plan["threads"], 8):
                    lanes = [a[t] for t in range(q, q + 8) if worker[t]]
                    slots = {}
                    for addr in set(lanes):
                        s = addr // 4 % 8
                        slots[s] = slots.get(s, 0) + 1
                    worst[which] = max(worst[which], max(slots.values(),
                                                         default=0))
    return tuple(worst)


def test_row_strides_follow_the_lanes_rule():
    """The plan's strides are dw_f32_lanes' rule: at the four stages the
    rule's count equals the lanes' own (``_lane_ways``)."""
    for (X, Y, zin, c, cout, up), _, ways in STAGES.values():
        plan = _plan((24, X, Y, zin, c), cout, up)
        rows, x_off, g_off = zconv.dw_f32_lanes(plan)
        assert (zconv.bank_ways(plan["ys"], rows, x_off),
                zconv.bank_ways(plan["gs"], rows, g_off)) == ways
        assert plan["ys"] % 4 == 0 and plan["gs"] % 4 == 0


def test_dw_f32_constants_match_the_kernel_source():
    csrc = Path(zconv.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "zconv_dw.cu").read_text()
    body = re.search(r"struct DwF32Shape \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"\b(\w+)\s*[,;]", body.replace("int ", " "))
    assert tuple(names) == zconv.DW_F32_FIELDS
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kCo"]) == zconv.DW_F32_CO
    assert int(consts["kThreads"]) == zconv.DW_F32_THREADS
    assert "__launch_bounds__(kThreads, 1)" in src
    assert int(consts["kPrefetchX"]) == zconv.DW_F32_PREFETCH_X
    assert int(consts["kPrefetchG"]) == zconv.DW_F32_PREFETCH_G
    assert int(consts["kPlanes"]) == zconv.DW_F32_PLANES
    stage = dict(re.findall(r"constexpr int (\w+) = (\d+);",
                            (csrc / "zconv_stage.cuh").read_text()))
    assert int(stage["kRun"]) == zconv.F32_RUN
    assert int(stage["kQuad"]) == zconv.F32_QUAD
    assert '#include "zconv_stage.cuh"' in src
    assert "dw_f32_kernel" in zconv.DW_IMPL[torch.float32]
    assert "zconv_dw.cu" in zconv.DW_IMPL[torch.float32]


@pytest.mark.parametrize("up", [False, True])
def test_fp32_dw_on_the_host_takes_the_plain_version(up):
    rs = np.random.RandomState(3)
    shape, cout = (1, 3, 4, 5, 3), 5
    x, g, out = (torch.from_numpy(a) for a in _inputs(rs, shape, cout, up,
                                                      True))
    wrapper = zconv.upzconv3d_dw if up else zconv.zconv3d_dw
    plain = zconv.upzconv3d_dw_plain if up else zconv.zconv3d_dw_plain
    n, impl = wrapper.launches, wrapper.last_impl
    typed = dict(wrapper.launches_by_type)
    dw, db = wrapper(x, g, out, 0.2)
    dw_want, db_want = plain(x, g, out, 0.2)
    assert torch.equal(dw, dw_want) and torch.equal(db, db_want)
    assert wrapper.launches == n and wrapper.last_impl == impl
    assert wrapper.launches_by_type == typed
