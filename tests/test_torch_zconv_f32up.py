"""fp32 K2 (csrc/zconv_f32.cu) on the CPU: the host side of the card's kernel.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); here its plan (ops/zconv.py::f32_plan with ``up``) and the
walk it makes over that plan are checked in pure Python. The walk is this
file's copy of how zconv_f32.cu decodes threads, staging items and rows
(``_thread``, ``_item``, ``_walk``): it shows that the plan admits a walk
that covers every output once, while only the card tests, against the
plain version, prove the kernel's own walk. At muvo.yml's two stages
(conv2.conv1 96x96x16x32 -> 16 and conv3.conv1 192x192x32x16 -> 8, batch 1
and 5) and at the card tests' shapes:

1. the plan fits an H100 (232,448 bytes of shared memory a block, 512
   threads), and at the two stages every thread of a block has work (no
   spare thread, no ragged y tile), the next plane fits the registers the
   kernel prefetches it into, and batch 1 gives every SM a block;
2. the rows the blocks walk, times the threads' register tiles, cover each
   output voxel and channel exactly once; each row's three taps find their
   x planes in the ring's slots, and each thread's haloed window lies in a
   staged plane and its weights in the staged weights;
3. a plane's staging items write each big z of each (y, c) row once and
   leave the zeroed z halo alone;
4. a numpy run of the kernel's steps (weights staged chunk-major, planes
   interpolated item by item into the ring, each thread's 4 x CO tile summed
   over dx, dy, c, dz) on the plan gives the plain version's output
   (upzconv3d_leaky_plain) within 1e-5 of max |plain| (fp32, summation
   order only), at Zs 1-3, C 3, Cout 5, a ragged y tile and runs that end
   mid segment, on CO 4 and CO 8;
5. ``last_impl``'s names: zconv_f32.cu's kernels for fp32 K1, K2, K1-dx
   and K2-dx;
6. the F32Shape struct and the kernel's constants match ops/zconv.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from muvo_tpu_torch.ops import zconv

# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block may opt in to
H100 = dict(sms=132, smem_optin=232448)
MAX_THREADS = 512
PREFETCH = 5  # staging items a thread holds in registers (kPrefetch)
# muvo.yml's fp32 K2 stages: (X, Y, Zin, C, Cout) and the plan's y rows,
# threads
STAGES = {"conv2.conv1": ((96, 96, 16, 32, 16), 8, 256),
          "conv3.conv1": ((192, 192, 32, 16, 8), 12, 384)}
# tests/test_torch_cuda.py's kernel shapes (B, X, Y, Zin, C), Cout
CARD_SHAPES = (((2, 12, 10, 20, 16), 8), ((1, 5, 7, 19, 3), 5),
               ((1, 1, 1, 20, 4), 12), ((3, 4, 33, 1, 8), 8),
               ((1, 6, 6, 16, 32), 16))
# small shapes that take every path of the walk: Zs 1-3, C 3, Cout 5, a
# ragged y tile (37 = 13 + 13 + 11), runs across segments
EDGE_SHAPES = (((2, 5, 6, 1, 16), 8), ((1, 4, 9, 2, 8), 8),
               ((1, 3, 5, 3, 3), 5), ((1, 7, 37, 16, 4), 16),
               ((2, 7, 3, 5, 6), 12))


def _plan(shape, cout, sms=132):
    return zconv.f32_plan(*shape, cout, True, sms=sms,
                          smem_optin=H100["smem_optin"])


def _thread(plan: dict, tid: int):
    """The kernel's decode of thread ``tid``: (y row yi, z group g, channel
    chunk cc), or None for a thread past the last chunk (no work)."""
    g = tid % plan["ngz"]
    yi = (tid // plan["ngz"]) % plan["ty"]
    cc = tid // (plan["ngz"] * plan["ty"])
    return (yi, g, cc) if cc < plan["nchunks"] else None


def _item(plan: dict, i: int):
    """The kernel's decode of staging item ``i`` of a plane: (y row yy,
    channel c, first small z k0); it writes big z 2k0 .. 2k0 + 2 F32_RUN
    - 1 (below Z) of that (yy, c) row."""
    q, c = divmod(i, plan["C"])
    yy, run = divmod(q, plan["runs"])
    return yy, c, run * zconv.F32_RUN


def _walk(plan: dict, block: int):
    """The rows block ``block`` computes, in the kernel's order: (b, y0, xo,
    j, slots), ``j`` the row's index in its run and ``slots`` the x index
    of the plane each of the F32_PLANES slots holds while it computes
    (tap dx reads slot (j + dx) % F32_PLANES)."""
    rows, grid, X = plan["rows"], plan["grid"], plan["X"]
    r, rend = block * rows // grid, (block + 1) * rows // grid
    walk = []
    while r < rend:
        seg, xa = divmod(r, X)
        xb = min(X, xa + rend - r)
        b, yt = divmod(seg, plan["nyt"])
        slots = [xa - 1 + p for p in range(zconv.F32_PLANES)]
        for xo in range(xa, xb):
            j = xo - xa
            walk.append((b, yt * plan["ty"], xo, j, tuple(slots)))
            if xo + 1 < xb:  # plane xo + 2 into the slot of plane xo - 1
                slots[j % zconv.F32_PLANES] = xo + 2
        r += xb - xa
    return walk


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_plan_at_the_decoder_stages(stage, batch):
    shape, ty, threads = STAGES[stage]
    plan = _plan((batch, *shape[:4]), shape[4])
    assert (plan["co"], plan["ty"], plan["threads"]) == (4, ty, threads)
    assert plan["smem_bytes"] <= H100["smem_optin"]
    # every thread has work: one (y, z group, chunk) each, no ragged tile
    assert plan["ty"] * plan["ngz"] * plan["nchunks"] == plan["threads"]
    assert plan["Y"] % plan["ty"] == 0 and plan["Z"] % 4 == 0
    assert plan["Cout"] % plan["co"] == 0
    # the next plane arrives in registers whole
    assert plan["items"] <= PREFETCH * plan["threads"]
    # one block an SM, every SM a block
    assert 2 * (plan["smem_bytes"] + 1024) > zconv.SMEM_PER_SM
    assert plan["grid"] == H100["sms"]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("shape,cout", CARD_SHAPES + EDGE_SHAPES)
def test_plan_at_the_card_test_shapes(shape, cout, batch):
    plan = _plan((batch, *shape[1:]), cout)
    assert plan["smem_bytes"] <= H100["smem_optin"]
    assert plan["threads"] <= MAX_THREADS and plan["threads"] % 32 == 0
    assert plan["threads"] >= plan["ty"] * plan["ngz"] * plan["nchunks"]
    assert plan["ngz"] * 4 >= plan["Z"] and plan["coutp"] >= plan["Cout"]
    assert 1 <= plan["grid"] <= plan["rows"]
    assert plan["xs"] * plan["grid"] >= plan["rows"]


def test_plan_refuses_a_block_past_the_cards_shared_memory():
    with pytest.raises(ValueError):  # 27 * 64 * 64 fp32 weights: 442 KB
        _plan((1, 4, 4, 8, 64), 64)
    with pytest.raises(ValueError):
        zconv._f32_plan(1, 4, 4, 8, 8, 8, True, ty=5,  # more y rows than Y
                        **H100)


def _walk_all(plan):
    return [row for block in range(plan["grid"])
            for row in _walk(plan, block)]


def _coverage(plan):
    """How often each output (b, x, y, z, co) is written: the walked rows
    times the threads' tiles."""
    tile = np.zeros((plan["ty"], 4 * plan["ngz"], plan["coutp"]), np.int32)
    for tid in range(plan["threads"]):
        t = _thread(plan, tid)
        if t is not None:
            yi, g, cc = t
            co = plan["co"]
            tile[yi, 4 * g:4 * g + 4, cc * co:(cc + 1) * co] += 1
    B, X, Y = plan["B"], plan["X"], plan["Y"]
    hits = np.zeros((B, X, plan["nyt"] * plan["ty"], 4 * plan["ngz"],
                     plan["coutp"]), np.int32)
    for b, y0, xo, _, _ in _walk_all(plan):
        hits[b, xo, y0:y0 + plan["ty"]] += tile
    return hits[:, :, :Y, :plan["Z"], :plan["Cout"]]


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_walk_covers_every_output_once_at_the_stages(stage, batch):
    shape = STAGES[stage][0]
    plan = _plan((batch, *shape[:4]), shape[4])
    assert (_coverage(plan) == 1).all()


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("shape,cout", CARD_SHAPES + EDGE_SHAPES)
def test_walk_covers_every_output_once_at_the_edges(shape, cout, sms):
    plan = _plan(shape, cout, sms=sms)
    assert (_coverage(plan) == 1).all()


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("shape,cout", EDGE_SHAPES + (
    ((1, 96, 96, 16, 32), 16), ((1, 192, 192, 32, 16), 8)))
def test_walk_reads_only_staged_planes(shape, cout, sms):
    """Tap dx of row xo reads the slot holding plane xo - 1 + dx of the
    same (b, y tile); every thread's window (y rows yi .. yi + 2, padded z
    4g .. 4g + 7, weights of its chunk) lies inside what is staged."""
    plan = _plan(shape, cout, sms=sms)
    for block in range(plan["grid"]):
        for b, y0, xo, j, slots in _walk(plan, block):
            taps = [slots[(j + dx) % zconv.F32_PLANES] for dx in range(3)]
            assert taps == [xo - 1, xo, xo + 1]
    for tid in range(plan["threads"]):
        t = _thread(plan, tid)
        if t is None:
            continue
        yi, g, cc = t
        assert 0 <= yi and yi + 2 <= plan["ty"] + 1
        assert 4 * g + 7 <= plan["zs"] - 1
        assert (cc + 1) * 27 * plan["C"] * plan["co"] <= plan["wfloats"]


@pytest.mark.parametrize("shape,cout", CARD_SHAPES + EDGE_SHAPES + (
    ((1, 96, 96, 16, 32), 16), ((1, 192, 192, 32, 16), 8)))
def test_staging_items_write_each_big_z_once(shape, cout):
    plan = _plan(shape, cout)
    written = np.zeros((plan["ty"] + 2, plan["C"], plan["zs"]), np.int32)
    for i in range(plan["items"]):
        yy, c, k0 = _item(plan, i)
        for k in range(k0, min(k0 + zconv.F32_RUN, plan["Zin"])):
            written[yy, c, 2 * k + 1:2 * k + 3] += 1
    assert (written[..., 1:plan["Z"] + 1] == 1).all()
    assert (written[..., 0] == 0).all()            # big z -1: the halo
    assert (written[..., plan["Z"] + 1:] == 0).all()


# ---------------------------------------------------------------------------
# the kernel's steps in numpy
# ---------------------------------------------------------------------------
def _stage(plane, x, plan, b, xi, y0):
    """Every staging item of plane xi: load_item, then store_item."""
    Zin = plan["Zin"]
    for i in range(plan["items"]):
        yy, c, k0 = _item(plan, i)
        gy = y0 + yy - 1
        inside = 0 <= xi < plan["X"] and 0 <= gy < plan["Y"]
        v = [x[b, xi, gy, min(max(k0 - 1 + j, 0), Zin - 1), c] if inside
             else np.float32(0) for j in range(zconv.F32_RUN + 2)]
        row = plane[yy, c]
        for m in range(zconv.F32_RUN):
            k = k0 + m
            if k >= Zin:
                break
            xk = v[m + 1]
            row[2 * k + 1] = xk if k == 0 else (np.float32(0.75) * xk
                                               + np.float32(0.25) * v[m])
            row[2 * k + 2] = xk if k == Zin - 1 else (
                np.float32(0.75) * xk + np.float32(0.25) * v[m + 2])


def _emulate(x, weight, bias, slope, plan, stage=_stage):
    """The kernel's steps on ``plan``; ``stage`` fills a plane (K2's
    ``_stage``, or fp32 K1's)."""
    B, X, Y, Z, C, Cout = (plan[k] for k in ("B", "X", "Y", "Z", "C",
                                              "Cout"))
    co, ty, ngz, nyt = plan["co"], plan["ty"], plan["ngz"], plan["nyt"]
    wk = weight.transpose(2, 3, 4, 1, 0)  # kx ky kz C Cout
    wsm = np.zeros((plan["nchunks"], 3, 3, C, 3, co), np.float32)
    for cc in range(plan["nchunks"]):
        n = min(co, Cout - cc * co)
        wsm[cc, ..., :n] = wk[..., cc * co:cc * co + n].transpose(0, 1, 3, 2,
                                                                   4)
    out = np.full((B, X, Y, Z, Cout), np.nan, np.float32)
    threads = [t for t in map(lambda i: _thread(plan, i),
                              range(plan["threads"])) if t is not None]
    rows = plan["rows"]
    for block in range(plan["grid"]):
        planes = np.zeros((zconv.F32_PLANES, ty + 2, C, plan["zs"]),
                          np.float32)
        r, rend = block * rows // plan["grid"], (block + 1) * rows // plan[
            "grid"]
        while r < rend:
            seg, xa = divmod(r, X)
            xb = min(X, xa + rend - r)
            b, y0 = seg // nyt, (seg % nyt) * ty
            for p in range(zconv.F32_PLANES):
                stage(planes[p], x, plan, b, xa - 1 + p, y0)
            for xo in range(xa, xb):
                j = xo - xa
                taps = np.stack([planes[(j + dx) % 3] for dx in range(3)])
                for yi, g, cc in threads:
                    gy = y0 + yi
                    if gy >= Y:
                        continue
                    win = taps[:, yi:yi + 3, :, 4 * g:4 * g + 6]
                    win = np.stack([win[..., dz:dz + 4] for dz in range(3)],
                                   3)  # (dx, dy, c, dz, r)
                    acc = np.einsum("xycdr,xycdk->rk", win, wsm[cc])
                    for rz in range(4):
                        z = 4 * g + rz
                        if z >= Z:
                            break
                        for k in range(co):
                            c_out = cc * co + k
                            if c_out >= Cout:
                                continue
                            v = acc[rz, k] + (0 if bias is None
                                              else bias[c_out])
                            if slope is not None and v < 0:
                                v *= slope
                            assert np.isnan(out[b, xo, gy, z, c_out])
                            out[b, xo, gy, z, c_out] = v
                if xo + 1 < xb:
                    stage(planes[j % 3], x, plan, b, xo + 2, y0)
            r += xb - xa
    return out


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("shape,cout", EDGE_SHAPES)
def test_kernel_steps_match_the_plain_version(shape, cout, sms, act):
    rs = np.random.RandomState(7)
    c = shape[-1]
    x = rs.standard_normal(shape).astype(np.float32)
    w = (rs.standard_normal((cout, c, 3, 3, 3)) / np.sqrt(27 * c)).astype(
        np.float32)
    b = rs.standard_normal(cout).astype(np.float32) if act else None
    slope = 0.2 if act else None
    plan = _plan(shape, cout, sms=sms)
    got = _emulate(x, w, b, slope, plan)
    want = zconv.upzconv3d_leaky_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), slope).numpy()
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape,cout", EDGE_SHAPES)
def test_kernel_steps_match_the_plain_version_at_co_8(shape, cout):
    """The same on the plans' other register tile, 4 z x 8 channels."""
    rs = np.random.RandomState(8)
    c = shape[-1]
    x = rs.standard_normal(shape).astype(np.float32)
    w = (rs.standard_normal((cout, c, 3, 3, 3)) / np.sqrt(27 * c)).astype(
        np.float32)
    b = rs.standard_normal(cout).astype(np.float32)
    plan = zconv._f32_plan(*shape, cout, True, co=8, sms=3,
                           smem_optin=H100["smem_optin"])
    got = _emulate(x, w, b, 0.2, plan)
    want = zconv.upzconv3d_leaky_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        0.2).numpy()
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_impl_names_the_new_kernel_for_fp32_k2_only():
    f32, bf16 = torch.float32, torch.bfloat16
    assert zconv._impl(None, f32, True, False) == zconv.K2_F32_IMPL
    assert "zconv_f32.cu" in zconv.K2_F32_IMPL
    assert zconv._impl(None, f32, False, False) == zconv.K1_F32_IMPL
    assert zconv._impl(None, bf16, False, False) == "zconv_kernel<bf16>"
    assert zconv._impl(None, f32, False, True) == zconv.K1_DX_F32_IMPL
    assert zconv._impl(None, f32, True, True) == zconv.K2_DX_F32_IMPL
    view = zconv.TcView("small-z", 16, 32, 32)
    for dx in (False, True):
        assert zconv._impl(view, bf16, True, dx).startswith(
            "tc::zconv_tc_kernel, small-z view")


def test_fp32_k2_on_the_host_takes_the_plain_version():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.standard_normal((1, 3, 4, 2, 3)).astype(
        np.float32))
    w = torch.from_numpy(rs.standard_normal((5, 3, 3, 3, 3)).astype(
        np.float32))
    n, impl = zconv.upzconv3d_leaky.launches, zconv.upzconv3d_leaky.last_impl
    got = zconv.upzconv3d_leaky(x, w, None, 0.2)
    assert torch.equal(got, zconv.upzconv3d_leaky_plain(x, w, None, 0.2))
    assert zconv.upzconv3d_leaky.launches == n
    assert zconv.upzconv3d_leaky.last_impl == impl


def test_shape_struct_and_constants_match_the_kernel_source():
    csrc = Path(zconv.__file__).resolve().parent.parent / "csrc"
    # the staging items' constants are zconv_stage.cuh's, which it includes
    src = ((csrc / "zconv_f32.cu").read_text()
           + (csrc / "zconv_stage.cuh").read_text())
    body = re.search(r"struct F32Shape \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"\b(\w+)\s*[,;]", body.replace("int ", " "))
    assert tuple(names) == zconv.F32_FIELDS
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kRZ"]) == zconv.F32_RZ
    assert int(consts["kRun"]) == zconv.F32_RUN
    assert int(consts["kPlanes"]) == zconv.F32_PLANES
    assert int(consts["kMaxThreads"]) == MAX_THREADS
    assert int(consts["kPrefetch"]) == PREFETCH


def test_chunks_slice_cout_only_where_the_weights_do_not_fit():
    """channel_slices: one fp32 launch at muvo.yml's stages and at the
    default config's fp32 K1 (conv3.conv2, 32 -> 32 at z 64); at its fp32
    K2 (conv3.conv1, C 64 -> 32 at z 64, 377,856 bytes for all 32
    channels) four slices of 8 channels, each on a plan that fits."""
    optin = H100["smem_optin"]
    f32 = torch.float32
    for (shape, _, _) in STAGES.values():
        _, _, _, zin, c, cout = (1, *shape)
        assert zconv.channel_slices("K2", f32, zin, c, cout, optin) == [
            (0, cout)]
    assert zconv.channel_slices("K1", f32, 64, 32, 32, optin) == [(0, 32)]
    with pytest.raises(ValueError):
        zconv.f32_plan(1, 192, 192, 32, 64, 32, True, **H100)
    chunks = zconv.channel_slices("K2", f32, 32, 64, 32, optin)
    assert chunks == [(0, 8), (8, 16), (16, 24), (24, 32)]
    for lo, hi in chunks:
        plan = zconv.f32_plan(1, 192, 192, 32, 64, hi - lo, True, **H100)
        assert plan["smem_bytes"] == zconv.f32_smem_bytes(64, 64, 8)
        assert plan["smem_bytes"] <= optin


def test_sliced_launches_match_the_plain_version():
    """The kernel's steps on each slice's plan, with the weights and bias
    of its channels, written side by side, give the plain version's
    output; a block that fits 4 of 10 channels' weights takes three
    slices (4, 4 and 2)."""
    rs = np.random.RandomState(9)
    shape, cout = (1, 4, 5, 3, 6), 10
    x = rs.standard_normal(shape).astype(np.float32)
    w = (rs.standard_normal((cout, 6, 3, 3, 3)) / np.sqrt(162)).astype(
        np.float32)
    b = rs.standard_normal(cout).astype(np.float32)
    optin = zconv._f32_plan(*shape, 4, True, sms=3, smem_optin=10 ** 6,
                            ty=1)["smem_bytes"]
    chunks = zconv.channel_slices("K2", torch.float32, 3, 6, cout, optin)
    assert chunks == [(0, 4), (4, 8), (8, 10)]
    got = np.concatenate([_emulate(x, w[lo:hi], b[lo:hi], 0.2, zconv.f32_plan(
        *shape, hi - lo, True, sms=3, smem_optin=optin))
        for lo, hi in chunks], -1)
    want = zconv.upzconv3d_leaky_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        0.2).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
