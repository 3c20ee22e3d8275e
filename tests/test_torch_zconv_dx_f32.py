"""fp32 K1-dx and K2-dx (csrc/zconv_f32.cu's zconv_dx_f32_kernel and
zconv_dxup_f32_kernel) on the CPU: the host side of the card's kernels.

Both run fp32 K1's walk (``f32conv::conv_walk``: a register tile of 4
output z x 4 channels a thread, a ring of three staged x planes, persistent
blocks over runs of x rows) in its DX flavour: a staging item is 4 floats
of one y row of the cotangent g, loaded with the same floats of the forward
output and stored as m(g), the LeakyReLU derivative applied to g; no bias,
no activation. K1-dx walks the plain view with the flipped, transposed
kernel; K2-dx walks the small-z view, g's (2 Zs, Cout) as (Zs, 2 Cout),
with ``up_fold_weights(w, adjoint=True)``, and then each block adds the
fold's centre-tap edge terms at small slices 0 and Zs - 1 to the rows it
walked. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py); here, at muvo.yml's four
stages, the card tests' and tiny_test_cfg's shapes and small edge shapes:

1. ``f32_dx_plan`` fits an H100 at the four stages (batch 24: the flagship
   step's 4 x 6 frames) with every thread busy, no ragged y tile and the
   next plane in the prefetch registers, fits every shape the first fp32
   dx kernels ran in the card tests, and refuses what does not fit;
2. the walk (tests/test_torch_zconv_f32up.py's copy) covers every dx
   voxel and channel once;
3. the masked staging items write each z of each (y, c) row once, from the
   same floats of g and of the forward output;
4. the DX walk written out in PyTorch (the masked staging item by item,
   the ring, each thread's tile, each block's edge pass over its rows,
   every (row, chunk, y) item once) gives
   ``zconv3d_dx_plain`` / ``upzconv3d_dx_plain`` within 1e-5 of max |plain|
   (fp32, summation order only) at Z and Zs 1-7, odd channels, a ragged y
   tile, runs across segments, with and without the mask;
5. the same walk gives muvo_tpu's dx, jax.vjp of zconv3d_leaky_folded /
   upzconv3d_leaky_folded (Pallas in interpret mode), within 1e-4, with
   odd channels, Zs 1 and no activation; and fp32 K2's walk
   (tests/test_torch_zconv_f32up.py's numpy run) gives muvo_tpu's K2;
6. the kernels' constants and flavours match ops/zconv.py, ``last_impl``
   names them, and on CPU tensors the wrappers run the plain versions and
   count no launch.
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
from test_torch_zconv_f32k1 import _floats
from test_torch_zconv_f32up import (H100, MAX_THREADS, PREFETCH, _coverage,
                                    _emulate, _thread)

TOL = 1e-5      # the walk in PyTorch against the plain version
JAX_TOL = 1e-4  # against muvo_tpu's jax.vjp in interpret mode
# muvo.yml's fp32 dx stages: (kernel, forward input (X, Y, Z, C), Cout) and
# the plan's y rows and threads
STAGES = {"K2-dx conv2.conv1": ("K2-dx", (96, 96, 16, 32), 16, 12, 384),
          "K1-dx conv2.conv2": ("K1-dx", (96, 96, 32, 16), 16, 16, 512),
          "K2-dx conv3.conv1": ("K2-dx", (192, 192, 32, 16), 8, 16, 512),
          "K1-dx conv3.conv2": ("K1-dx", (192, 192, 64, 8), 8, 16, 512)}
# the forward shapes (B, X, Y, Z, C), Cout whose dx the first fp32 dx
# kernels ran in tests/test_torch_cuda.py (backward, autograd, K1's route
# past 64 channels) and tiny_test_cfg's (batch 6 in chip_smoke.py's fp32
# card-vs-host step); K2's z is the small z
CARD_SHAPES = (((2, 12, 10, 20, 16), 8), ((1, 5, 7, 19, 3), 5),
               ((1, 1, 1, 20, 4), 12), ((3, 4, 33, 1, 8), 8),
               ((1, 6, 6, 16, 32), 16), ((1, 3, 4, 6, 40), 20),
               ((2, 8, 9, 10, 6), 5), ((1, 3, 4, 6, 72), 8))
TINY_SHAPES = {"K1-dx": (((6, 32, 32, 32, 4), 4), ((6, 64, 64, 64, 2), 2)),
               "K2-dx": (((6, 32, 32, 16, 4), 4), ((6, 64, 64, 32, 4), 2))}
# small forward shapes that take every path: Z / Zs 1-7 (not multiples of
# 4, both edge terms on one slice at Zs 1), odd channels (scalar loads,
# items that wrap z), a ragged y tile (37 = 19 + 18), runs across segments
EDGE_SHAPES = {"K1-dx": (((2, 5, 6, 1, 16), 8), ((1, 4, 9, 2, 8), 8),
                         ((1, 3, 5, 3, 3), 5), ((1, 3, 37, 33, 8), 4),
                         ((2, 7, 3, 5, 6), 12)),
               "K2-dx": (((2, 5, 6, 1, 16), 8), ((1, 4, 9, 2, 8), 8),
                         ((1, 3, 5, 3, 3), 5), ((1, 3, 37, 16, 16), 4),
                         ((2, 7, 3, 7, 6), 12))}


def _plan(kid, shape, cout, sms=132, **kw):
    """f32_dx_plan of the cotangent of the forward ``shape`` -> ``cout``."""
    b, X, Y, z, c = shape
    up = kid == "K2-dx"
    return zconv.f32_dx_plan(b, X, Y, 2 * z if up else z, cout, c, up,
                             sms=sms, smem_optin=H100["smem_optin"], **kw)


@pytest.mark.parametrize("batch", [24, 1])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_plan_at_the_decoder_stages(stage, batch):
    kid, shape, cout, ty, threads = STAGES[stage]
    plan = _plan(kid, (batch, *shape), cout)
    assert (plan["co"], plan["ty"], plan["threads"]) == (4, ty, threads)
    assert plan["dx"] == 1 and plan["up"] == 0 and plan["xvec"] == 1
    assert plan["edges"] == int(kid == "K2-dx")
    # the view: K2-dx's cotangent (2 Zs, Cout) as (Zs, 2 Cout) -> C
    z, c = shape[2], shape[3]
    assert (plan["Z"], plan["C"], plan["Cout"]) == (
        (z, 2 * cout, c) if kid == "K2-dx" else (z, cout, c))
    assert plan["smem_bytes"] <= H100["smem_optin"]
    assert plan["smem_bytes"] == 4 * (plan["wfloats"] + 3 * plan["plane"])
    # every thread has work, no ragged tile, the next plane in registers
    assert plan["ty"] * plan["ngz"] * plan["nchunks"] == plan["threads"]
    assert plan["Y"] % plan["ty"] == 0 and plan["Z"] % 4 == 0
    assert plan["items"] <= PREFETCH * plan["threads"]
    assert plan["grid"] == min(H100["sms"],
                               plan["rows"] // zconv.F32_MIN_ROWS)
    assert _edge_pass_bytes(plan) <= plan["smem_bytes"]


def _edge_pass_bytes(plan):
    """Shared memory K2-dx's edge pass takes once the walk is done: the
    edge weights [2][9][C][coutp], R rows' masked slices [R][3][ty +
    2][2 C + 1] and their (b, x, y) [R][3]."""
    rows = max(1, min(plan["threads"] // (plan["nchunks"] * plan["ty"]),
                      plan["ngz"]))
    return 4 * (18 * plan["C"] * plan["coutp"]
                + rows * 3 * (plan["ty"] + 2) * (2 * plan["C"] + 1)
                + 3 * rows)


@pytest.mark.parametrize("kid", ["K1-dx", "K2-dx"])
@pytest.mark.parametrize("shape,cout", CARD_SHAPES)
def test_plan_fits_what_the_first_dx_kernels_ran(kid, shape, cout):
    plan = _plan(kid, shape, cout)
    assert plan["smem_bytes"] <= H100["smem_optin"]
    assert _edge_pass_bytes(plan) <= plan["smem_bytes"]
    assert plan["threads"] <= MAX_THREADS and plan["threads"] % 32 == 0
    assert plan["threads"] >= plan["ty"] * plan["ngz"] * plan["nchunks"]
    assert 1 <= plan["grid"] <= plan["rows"]
    assert plan["xs"] * plan["grid"] >= plan["rows"]
    assert plan["xvec"] == int(plan["Z"] * plan["C"] % 4 == 0)


@pytest.mark.parametrize("kid", ["K1-dx", "K2-dx"])
def test_plan_fits_tiny_test_cfg(kid):
    for shape, cout in TINY_SHAPES[kid]:
        assert _plan(kid, shape, cout)["smem_bytes"] <= H100["smem_optin"]


def test_plan_refuses_what_does_not_fit():
    # the widest the source note gives: K1-dx at z 64, Cout 8 takes C 128
    # (16 z groups x 32 chunks of 4 fill 512 threads), K2-dx at small z 16
    # and C 32 the forward's Cout 27 (the fold's weights and one y row)
    assert _plan("K1-dx", (1, 4, 4, 64, 128), 8)["threads"] == 512
    assert _plan("K2-dx", (1, 4, 4, 16, 32), 27)["ty"] == 1
    for kid, shape, cout in (("K1-dx", (1, 4, 4, 64, 129), 8),
                             ("K2-dx", (1, 4, 4, 16, 32), 28)):
        with pytest.raises(ValueError, match=f"fp32 {kid} kernel"):
            _plan(kid, shape, cout)
    with pytest.raises(ValueError, match="co 8"):  # CO 4 only
        zconv._f32_plan(1, 4, 4, 8, 8, 8, False, co=8, dx=True, **H100)
    # g or the forward output misaligned: scalar loads
    assert _plan("K1-dx", (1, 4, 4, 8, 8), 8, xvec=False)["xvec"] == 0


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_walk_covers_every_output_once_at_the_stages(stage, batch):
    kid, shape, cout, _, _ = STAGES[stage]
    assert (_coverage(_plan(kid, (batch, *shape), cout)) == 1).all()


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("kid", ["K1-dx", "K2-dx"])
def test_walk_covers_every_output_once_at_the_edges(kid, sms):
    for shape, cout in EDGE_SHAPES[kid] + CARD_SHAPES[:6]:
        assert (_coverage(_plan(kid, shape, cout, sms=sms)) == 1).all()


# ---------------------------------------------------------------------------
# the DX walk in PyTorch
# ---------------------------------------------------------------------------
def _item_map(plan):
    """The kernel's decode of every staging item of a plane, each float of
    it: (item, y row yy, z, c) as index tensors (_floats' decode)."""
    rows = [(i, yy, z, c) for i in range(plan["items"])
            for yy, zc in [_floats(plan, i)] for z, c in zc]
    return torch.tensor(rows, dtype=torch.long).T


def _stage_dx(plane, g, out, slope, plan, imap, b, xi, y0):
    """Every masked staging item of plane xi: the same floats of g and of
    the forward output out (zero outside the volume), m(g) stored into
    [y][c][padded z]."""
    _, yy, z, c = imap
    gy = y0 + yy - 1
    inside = (0 <= xi < plan["X"]) & (gy >= 0) & (gy < plan["Y"])
    gyc = gy.clamp(0, plan["Y"] - 1)
    xic = min(max(xi, 0), plan["X"] - 1)
    v = torch.where(inside, g[b, xic, gyc, z, c], 0.0)
    if slope is not None:
        o = torch.where(inside, out[b, xic, gyc, z, c], 0.0)
        v = torch.where(o >= 0, v, v * slope)
    plane[yy, c, z + 1] = v


def _edge_pass(dx, g, out, slope, edges, plan, r0, r1, counts):
    """K2-dx's edge pass of the block that walked rows r0 .. r1 - 1, in the
    kernel's steps of R rows (R = threads // (chunks x ty), at most the z
    groups), thread t of a step taking item (row t // (chunks x ty), chunk,
    y t % ty): the 3x3 conv of the masked cotangent at small slices 0 and
    Z - 1 (zero outside the volume) with edges[q], added to dx at those
    slices (both at slice 0 where Z = 1); ``counts`` tallies the items by
    (b, x, y, chunk)."""
    X, Y, Z, N = plan["X"], plan["Y"], plan["Z"], plan["Cout"]
    ty, co, nchunks = plan["ty"], plan["co"], plan["nchunks"]
    gm = g if slope is None else torch.where(out >= 0, g, g * slope)
    per_row = nchunks * ty
    R = max(1, min(plan["threads"] // per_row, plan["ngz"]))
    for rb in range(r0, r1, R):
        for t in range(min(R, r1 - rb) * per_row):
            yi, cc, r = t % ty, t // ty % nchunks, rb + t // per_row
            seg, xo = divmod(r, X)
            b, gy = seg // plan["nyt"], (seg % plan["nyt"]) * ty + yi
            if gy >= Y:
                continue
            n0, n1 = cc * co, min(N, (cc + 1) * co)
            e = torch.zeros((2, n1 - n0))
            for tap in range(9):
                gx, gyy = xo + tap // 3 - 1, gy + tap % 3 - 1
                if 0 <= gx < X and 0 <= gyy < Y:
                    for q, k in ((0, 0), (1, Z - 1)):
                        e[q] += gm[b, gx, gyy, k] @ edges[
                            q, tap // 3, tap % 3, :, n0:n1]
            dx[b, xo, gy, 0, n0:n1] += e[0]
            dx[b, xo, gy, Z - 1, n0:n1] += e[1]
            counts[b, xo, gy, cc] += 1


def _dx_walk(g, out, weight, slope, plan, with_edges=True):
    """The kernels' steps on ``plan``, in PyTorch: g and out (the forward
    output) viewed as the plan's (B, X, Y, Z, C), the view's weights as the
    threads read them, the ring of three masked planes, each thread's 4 z x
    co tile summed over dx, dy, c, dz; then (K2-dx, unless ``with_edges``
    is False) each block's edge pass over the rows it walked."""
    B, X, Y, Z, C, N = (plan[k] for k in ("B", "X", "Y", "Z", "C", "Cout"))
    co, ty, nyt, zs = plan["co"], plan["ty"], plan["nyt"], plan["zs"]
    g = g.reshape(B, X, Y, Z, C)
    out = None if slope is None else out.reshape(B, X, Y, Z, C)
    if plan["edges"]:
        main, edges = zconv.up_fold_weights(weight, adjoint=True)
        edges = edges if with_edges else None
    else:
        main, edges = zconv._kkkcn(weight, adjoint=True), None
    w = torch.zeros((3, 3, 3, C, plan["coutp"]))
    w[..., :N] = main
    imap = _item_map(plan)
    threads = [t for t in (_thread(plan, i) for i in range(plan["threads"]))
               if t is not None]
    dx = torch.full((B, X, Y, Z, N), float("nan"))
    hits = torch.zeros((B, X, Y, Z, N), dtype=torch.int32)
    counts = torch.zeros((B, X, Y, plan["nchunks"]), dtype=torch.int32)
    for block in range(plan["grid"]):
        planes = torch.zeros((3, ty + 2, C, zs))
        r0 = block * plan["rows"] // plan["grid"]
        r, rend = r0, (block + 1) * plan["rows"] // plan["grid"]
        while r < rend:
            seg, xa = divmod(r, X)
            xb = min(X, xa + rend - r)
            b, y0 = seg // nyt, (seg % nyt) * ty
            for p in range(3):
                _stage_dx(planes[p], g, out, slope, plan, imap, b, xa - 1 + p,
                          y0)
            for xo in range(xa, xb):
                j = xo - xa
                taps = torch.stack([planes[(j + d) % 3] for d in range(3)])
                # every tile of the row at once: (dx, yi, c, z, dy, dz)
                win = taps.unfold(1, 3, 1).unfold(3, 3, 1)
                row = torch.einsum("xycZud,xudcn->yZn", win, w)
                for yi, gz, cc in threads:
                    gy = y0 + yi
                    if gy >= Y:
                        continue
                    n = min(N, (cc + 1) * co) - cc * co
                    z1 = min(Z, 4 * gz + 4)
                    dx[b, xo, gy, 4 * gz:z1, cc * co:cc * co + n] = row[
                        yi, 4 * gz:z1, cc * co:cc * co + n]
                    hits[b, xo, gy, 4 * gz:z1, cc * co:cc * co + n] += 1
                if xo + 1 < xb:
                    _stage_dx(planes[j % 3], g, out, slope, plan, imap, b,
                              xo + 2, y0)
            r += xb - xa
        if edges is not None:
            _edge_pass(dx, g, out, slope, edges, plan, r0, rend, counts)
    assert (hits == 1).all()
    if edges is not None:
        assert (counts == 1).all()  # each (b, x, y, chunk) once
    return dx


def _torch_inputs(rs, shape, cout, up, act):
    """Forward input x, weight (Cout, C, 3, 3, 3), the forward output (the
    mask) and a cotangent, from a numpy seed."""
    c = shape[-1]
    x = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy((rs.standard_normal((cout, c, 3, 3, 3))
                          / np.sqrt(27 * c)).astype(np.float32))
    fwd = zconv.upzconv3d_leaky_plain if up else zconv.zconv3d_leaky_plain
    out = fwd(x, w, None, 0.2 if act else None)
    g = torch.from_numpy(rs.standard_normal(tuple(out.shape)).astype(
        np.float32))
    return w, out, g


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("kid", ["K1-dx", "K2-dx"])
def test_dx_walk_matches_the_plain_version(kid, act):
    rs = np.random.RandomState(12)
    up = kid == "K2-dx"
    slope = 0.2 if act else None
    plain = zconv.upzconv3d_dx_plain if up else zconv.zconv3d_dx_plain
    for n, (shape, cout) in enumerate(EDGE_SHAPES[kid]):
        w, out, g = _torch_inputs(rs, shape, cout, up, act)
        plan = _plan(kid, shape, cout, sms=3 if n % 2 else 132)
        got = _dx_walk(g, out, w, slope, plan)
        want = plain(g, out, w, slope)
        assert got.shape == want.shape == shape
        assert (got - want).abs().max() <= TOL * want.abs().max(), shape


def test_dx_walk_catches_a_lost_edge_term_or_mask():
    """The comparison above sees a K2-dx without its edge terms and a DX
    staging without the mask."""
    rs = np.random.RandomState(13)
    shape, cout = (1, 3, 5, 3, 3), 5
    w, out, g = _torch_inputs(rs, shape, cout, True, True)
    plan = _plan("K2-dx", shape, cout)
    want = zconv.upzconv3d_dx_plain(g, out, w, 0.2)
    for got in (_dx_walk(g, out, w, 0.2, plan, with_edges=False),
                _dx_walk(g, out, w, None, plan)):
        assert (got - want).abs().max() > 1e-2 * want.abs().max()


def _jax_dx(x, kernel, bias, g, slope, up):
    """muvo_tpu's dx: jax.vjp of the folded Pallas conv (interpret mode) at
    the cotangent g, and the forward output."""
    B, X, Y, Z, C = x.shape
    cout = kernel.shape[-1]
    folded, pick = ((upzconv3d_leaky_folded, _pick_f_up) if up
                    else (zconv3d_leaky_folded, _pick_f))
    f = pick(Z, C, cout) or (2 * Z if up else Z)
    k, b = jnp.asarray(kernel), jnp.asarray(bias)
    out, vjp = jax.vjp(lambda x4: folded(x4, k, b, C, f, slope, True),
                       jnp.asarray(x.reshape(B, X, Y, Z * C)))
    (dx,) = vjp(jnp.asarray(g.reshape(out.shape)))
    return np.array(dx).reshape(x.shape), np.array(out).reshape(g.shape)


@pytest.mark.parametrize("kid,shape,cout,act", [
    ("K1-dx", (1, 6, 5, 32, 4), 8, True),     # z blocks of 16
    ("K1-dx", (1, 4, 5, 6, 3), 5, True),      # odd channels
    ("K1-dx", (1, 4, 5, 7, 4), 6, False),     # no activation, Z 7
    ("K2-dx", (1, 6, 5, 16, 8), 4, True),     # the fold's z blocks
    ("K2-dx", (1, 4, 5, 3, 3), 5, True),      # odd channels, Zs 3
    ("K2-dx", (1, 5, 4, 1, 3), 2, True),      # Zs 1: both edge terms
    ("K2-dx", (1, 4, 5, 2, 4), 6, False),     # no activation
])
def test_dx_walk_matches_muvo_tpu_pallas(kid, shape, cout, act):
    """The walk against muvo_tpu's dx, with muvo_tpu's forward output as the
    leaky mask, fp32 both."""
    rs = np.random.RandomState(14)
    up = kid == "K2-dx"
    slope = 0.2 if act else None
    x = rs.standard_normal(shape).astype(np.float32)
    kernel = rs.standard_normal((3, 3, 3, shape[-1], cout)).astype(
        np.float32)
    bias = rs.standard_normal(cout).astype(np.float32)
    z = 2 * shape[3] if up else shape[3]
    g = rs.standard_normal((*shape[:3], z, cout)).astype(np.float32)
    want, out = _jax_dx(x, kernel, bias, g, slope, up)
    w = torch.from_numpy(np.ascontiguousarray(
        np.transpose(kernel, (4, 3, 0, 1, 2))))
    got = _dx_walk(torch.from_numpy(g), torch.from_numpy(out), w, slope,
                   _plan(kid, shape, cout, sms=3)).numpy()
    assert np.abs(got - want).max() <= JAX_TOL * np.abs(want).max()


def test_fp32_k2_walk_matches_muvo_tpu_pallas():
    """fp32 K2's walk (the numpy run of its kernel's steps) against
    muvo_tpu's K2, upzconv3d_leaky_folded in interpret mode, fp32 both."""
    rs = np.random.RandomState(15)
    shape, cout = (1, 6, 5, 16, 8), 4
    x = rs.standard_normal(shape).astype(np.float32)
    kernel = rs.standard_normal((3, 3, 3, shape[-1], cout)).astype(
        np.float32)
    bias = rs.standard_normal(cout).astype(np.float32)
    B, X, Y, Z, C = shape
    want = np.asarray(upzconv3d_leaky_folded(
        jnp.asarray(x.reshape(B, X, Y, Z * C)), jnp.asarray(kernel),
        jnp.asarray(bias), C, _pick_f_up(Z, C, cout) or 2 * Z, 0.2,
        True)).reshape(B, X, Y, 2 * Z, cout)
    w = np.ascontiguousarray(np.transpose(kernel, (4, 3, 0, 1, 2)))
    plan = zconv.f32_plan(*shape, cout, True, sms=3,
                          smem_optin=H100["smem_optin"])
    got = _emulate(x, w, bias, 0.2, plan)
    assert np.abs(got - want).max() <= JAX_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# the staging items, the source, the wrappers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_masked_items_write_each_z_once(stage):
    kid, shape, cout, _, _ = STAGES[stage]
    for plan in (_plan(kid, (1, *shape), cout),
                 *(_plan(kid, s, c) for s, c in EDGE_SHAPES[kid])):
        _, yy, z, c = _item_map(plan)
        written = torch.zeros((plan["ty"] + 2, plan["C"], plan["zs"]),
                              dtype=torch.int32)
        written.index_put_((yy, c, z + 1), torch.ones_like(yy,
                                                           dtype=torch.int32),
                           accumulate=True)
        assert (written[..., 1:plan["Z"] + 1] == 1).all()
        assert (written[..., 0] == 0).all()  # z -1: the halo
        assert (written[..., plan["Z"] + 1:] == 0).all()


def test_dx_constants_and_flavours_match_the_kernel_source():
    csrc = Path(zconv.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "zconv_f32.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kDxCo"]) == zconv.F32_DX_CO
    for kernel, walk, impl in (
            ("zconv_dx_f32_kernel", "conv_walk<kDxCo, false, true>(",
             zconv.K1_DX_F32_IMPL),
            ("zconv_dxup_f32_kernel", "conv_walk<kDxCo, false, true, true>(",
             zconv.K2_DX_F32_IMPL)):
        body = src[src.index(f"    {kernel}("):]
        assert walk in body[:body.index("\n}\n")], kernel
        assert f"f32conv::{kernel} (csrc/zconv_f32.cu)" == impl
    stage = (csrc / "zconv_stage.cuh").read_text()
    assert "if (!(o[j] >= 0.f)) v[j] *= slope;" in stage  # leaky_mask's
    # the first fp32 K2-dx kernel is gone
    assert "zconv_dxup_kernel" not in (csrc / "zconv.cu").read_text()


def test_impl_names_the_fp32_dx_kernels():
    f32, bf16 = torch.float32, torch.bfloat16
    assert zconv._impl(None, f32, False, True) == zconv.K1_DX_F32_IMPL
    assert zconv._impl(None, f32, True, True) == zconv.K2_DX_F32_IMPL
    assert zconv._impl(None, bf16, False, True) == "zconv_kernel<bf16>"


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("up", [False, True])
def test_fp32_dx_on_the_host_takes_the_plain_version(up, act):
    rs = np.random.RandomState(16)
    w, out, g = _torch_inputs(rs, (1, 3, 4, 2, 3), 5, up, act)
    slope = 0.2 if act else None
    kernel = zconv.upzconv3d_dx if up else zconv.zconv3d_dx
    plain = zconv.upzconv3d_dx_plain if up else zconv.zconv3d_dx_plain
    n, impl = kernel.launches, kernel.last_impl
    assert torch.equal(kernel(g, out, w, slope), plain(g, out, w, slope))
    assert kernel.launches == n and kernel.last_impl == impl


@pytest.mark.parametrize("kid", ["K1-dx", "K2-dx"])
def test_sliced_dx_walks_match_the_plain_version(kid):
    """Where a block cannot hold the weights of all dx channels (fp32
    K2-dx at the default config's conv3.conv1: 64 dx channels from a 32-
    channel cotangent at small z 32, four slices of 16), the walk on each
    slice of dx channels, with those channels' weights, written side by
    side gives the plain version's dx; at a small shape whose block holds
    4 of 10 dx channels, three slices (4, 4 and 2)."""
    optin = H100["smem_optin"]
    assert zconv.channel_slices("K2-dx", torch.float32, 32, 64, 32,
                                optin) == [(0, 16), (16, 32), (32, 48),
                                           (48, 64)]
    assert zconv.channel_slices("K1-dx", torch.float32, 64, 32, 32,
                                optin) == [(0, 32)]
    up = kid == "K2-dx"
    shape, cout = (1, 3, 4, 3, 10), 6
    zin = shape[3]  # K1-dx: the cotangent's z; K2-dx: the small z
    small = zconv.f32_smem_bytes(zin, 2 * cout if up else cout, 4)
    slices = zconv.channel_slices(kid, torch.float32, zin, 10, cout, small)
    assert slices == [(0, 4), (4, 8), (8, 10)]
    rs = np.random.RandomState(13)
    w, out, g = _torch_inputs(rs, shape, cout, up, True)
    b, X, Y = shape[:3]
    z = out.shape[3]
    got = torch.cat([_dx_walk(g, out, w[:, lo:hi], 0.2, zconv.f32_dx_plan(
        b, X, Y, z, cout, hi - lo, up, sms=3, smem_optin=small))
        for lo, hi in slices], -1)
    plain = zconv.upzconv3d_dx_plain if up else zconv.zconv3d_dx_plain
    want = plain(g, out, w, 0.2)
    assert (got - want).abs().max() <= TOL * want.abs().max()
