#!/usr/bin/env python3
"""bf16 K2 and K2-dx (the tensor-core kernel on the small-z grid), bf16 K3
and K3-up (the split-K weight-gradient GEMM), bf16 K1 and K1-dx (the
tensor-core kernel on the plain or the pair view), fp32 K2 and fp32 K1
(the register-tiled CUDA-core kernel) and fp32 K3 and K3-up (the
register-tiled weight gradients) and fp32 K1-dx and K2-dx (fp32 K1's
register-tiled walk on the masked cotangent) on one GPU: right at the
edges, then timed launch by launch at the voxel decoder's stages beside
cuDNN.

    python3 tools/torch_zconv_probe.py [--iters 12]
        [--parts k2,dw,k1,k2f32,k1f32,dw32,dx32] [--out PATH]

1. edges: K2 (upzconv3d_leaky) and K2-dx (upzconv3d_dx) in bf16 against
   their plain versions, relative to max |plain| (2e-2, as chip_smoke.py),
   at Zs 1 and 2 (both z edges in one tile), Zs 3, X and Y that end mid
   block, odd and wide channel counts, no activation, and both full-width
   stage shapes at batch 1; a second launch must give the same bits. A
   case that fails prints where the error sits (by small z slice and by
   output channel) before the script stops.
2. timing: each kernel --iters times in a row, one CUDA event between
   launches: K2 at batch 5 (the imagination's decode), K2-dx at batch 24
   (the flagship step's 4 x 6 frames), conv2 and conv3, each beside one
   cuDNN call on the same inputs (F.conv3d of the z-upsampled input;
   aten.convolution_backward's input gradient over big z), with the bound
   (each input read and each output written once, over 3.35 TB/s, or the
   flops over 989 TFLOP/s).
3. dw edges: K3 (zconv3d_dw) and K3-up (upzconv3d_dw) in bf16 against their
   plain versions on the same bf16 inputs (dW and dbias, relative to max
   |plain|, 2e-2), at C 3 and 40, Cout 12, no activation, X and Y that end
   mid tile, Zs 1-3 and batch 1, each with a second launch that must give
   the same bits, and the kernel the wrapper names.
4. dw timing: each at batch 24 at its two stages (K3-up: conv2.conv1,
   conv3.conv1; K3: conv2.conv2, conv3.conv2), --iters launches one event
   apart, beside aten.convolution_backward's weight and bias gradient on
   the same inputs and the bound (x, g and the forward output read once,
   dW and dbias written once, over 3.35 TB/s), and the rate of the
   kernel's m64 x k16 tensor-core products an SM (from its plan).
5. k1 edges: K1 (zconv3d_leaky) and K1-dx (zconv3d_dx) in bf16 against
   their plain versions (2e-2) at Z 1-3, X and Y that end mid block on
   both views, C 3, C 40 with Cout 12, no activation and both full-width
   stage shapes at batch 1, each with a second launch that must give the
   same bits and the kernel and view the wrapper names.
6. k1 timing: K1 at batch 5 (the imagination's decode) and 24 (the
   flagship step), K1-dx at batch 24, at conv2.conv2 and conv3.conv2, on
   the view k1_route picks and, at conv3.conv2, also on the plain view
   (the route's other choice there), each beside one cuDNN call (F.conv3d
   with bias; aten.convolution_backward's input gradient of the masked
   cotangent) and the bound (as parts 2 and 4), with the rate of the
   view's m64 x k16 tensor-core products an SM.

7. k2f32 edges: fp32 K2 (upzconv3d_leaky on fp32 tensors) against its
   plain version, relative to max |plain| (1e-4, TF32 off), at Zs 1-3, C
   3 with Cout 5, a y tile and a run that end mid volume, no activation and
   both full-width stages at batch 1; a second launch must give the same
   bits and ``last_impl`` must name f32conv::zconv_up_f32_kernel.
8. k2f32 timing: fp32 K2 at conv2.conv1 and conv3.conv1, batch 1 and 5,
   --iters launches one event apart, on zconv.f32_plan's plan and on
   the other channel tile (co 4 <-> 8) and on fewer y rows, beside one
   cuDNN call (F.interpolate over z, then F.conv3d with bias, TF32 off)
   and the bound (2 * 27 * C * Cout flops an output voxel over 67 TFLOP/s,
   or x, the weights and the output over 3.35 TB/s, the larger), with
   zconv_f32.cu's ptxas lines (registers and spills).
9. k1f32 edges: fp32 K1 (zconv3d_leaky on fp32 tensors) as part 7, at Z
   1-3, C 3 with Cout 5 (scalar loads), a y tile and a run that end mid
   volume, no activation and both full-width stages (conv2.conv2,
   conv3.conv2) at batch 1; ``last_impl`` must name
   f32conv::zconv_f32_kernel.
10. k1f32 timing: fp32 K1 at conv2.conv2 and conv3.conv2 as part 8, and
   the first CUDA-core zconv_kernel<float> (csrc/zconv.cu, through
   muvo_zconv3d_leaky with dtype 0) on the same inputs, beside F.conv3d
   with bias.
11. dw32 edges: fp32 K3 and K3-up (zconv3d_dw, upzconv3d_dw on fp32
   tensors) against their plain versions (dW and dbias, 1e-4 of max
   |plain|, TF32 off) at part 3's cases, each with a second launch that
   must give the same bits and ``last_impl`` naming f32dw::dw_f32_kernel.
12. dw32 timing: fp32 K3 and K3-up at batch 24 at their four stages,
   --iters launches one event apart, on zconv.dw_f32_plan's plan and on
   the fewer y rows a tile (ty) it takes under smaller shared-memory
   limits (10/12 .. 4/12 of the card's), beside
   aten.convolution_backward's weight and bias gradient (TF32 off) and
   the bound (2 * 27 * C * Cout flops an output voxel over 67 TFLOP/s, or
   x, g, the forward output, dW and dbias over 3.35 TB/s, the larger),
   with zconv_dw.cu's ptxas lines (registers and spills).
13. dx32 edges: fp32 K1-dx and K2-dx (zconv3d_dx, upzconv3d_dx on fp32
   tensors) against their plain versions (1e-4 of max |plain|, TF32 off)
   at Z and Zs 1, 2, 3 and 7, odd channels, a y tile that ends mid volume,
   runs across (b, y tile) ends, no activation and K2-dx's widest test
   shape, each with a second launch that must give the same bits and
   ``last_impl`` naming f32conv::zconv_dx_f32_kernel or
   zconv_dxup_f32_kernel.
14. dx32 timing: fp32 K1-dx and K2-dx at batch 24 at their four stages,
   --iters launches one event apart, through the wrapper (zconv.f32_dx_plan's
   plan, the host's weight fold included) and on every other ty the plan
   could take (CO 4 is the dx kernels' only tile), K2-dx's walk without
   its edge terms (timing only: not a right result), the weight fold alone
   (K2-dx: up_fold_weights(adjoint=True); K1-dx: the flipped, transposed
   kernel), beside aten.convolution_backward's input gradient (TF32 off)
   and the bound (2 * 27 * C * Cout flops an output voxel, K2-dx's
   transpose 8 a dx value, over 67 TFLOP/s, or g, the forward output, the
   weights and dx over 3.35 TB/s, the larger), with zconv_f32.cu's ptxas
   lines (registers and spills).

Prints one JSON object and writes it to --out. Needs CUDA; it has no CPU
mode.
"""

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOL = 2e-2
FP32_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# (label, input shape (B, X, Y, Zs, C), Cout, activation)
EDGES = (("Zs1", (2, 5, 6, 1, 16), 8, True),
         ("Zs2", (1, 4, 9, 2, 32), 16, True),
         ("Zs3_odd_c", (1, 3, 5, 3, 3), 5, True),
         ("xy_mid_block", (1, 11, 13, 16, 16), 8, True),
         ("y_mid_block_zs32", (2, 9, 7, 32, 16), 8, True),
         ("wide_c", (1, 3, 4, 6, 40), 20, True),
         ("cout12", (1, 2, 3, 10, 4), 12, True),
         ("no_act", (1, 4, 5, 16, 32), 16, False),
         ("conv2.conv1", (1, 96, 96, 16, 32), 16, True),
         ("conv3.conv1", (1, 192, 192, 32, 16), 8, True))
# (stage, input shape without batch, Cout)
STAGES = (("conv2.conv1", (96, 96, 16, 32), 16),
          ("conv3.conv1", (192, 192, 32, 16), 8))
FWD_BATCH, BWD_BATCH = 5, 24
# (label, kernel, input shape (B, X, Y, Z, C), Cout, activation); K3-up's z
# is the small z
DW_EDGES = (("c3_zs3", "K3-up", (1, 5, 7, 3, 3), 5, True),
            ("c3", "K3", (1, 5, 7, 6, 3), 5, True),
            ("c40_cout12", "K3-up", (1, 3, 4, 6, 40), 12, True),
            ("c40_cout12", "K3", (1, 3, 4, 6, 40), 12, True),
            ("no_act", "K3-up", (1, 4, 5, 16, 32), 16, False),
            ("no_act", "K3", (1, 4, 5, 16, 32), 16, False),
            ("zs1", "K3-up", (1, 11, 13, 1, 16), 8, True),
            ("zs2_y_mid_tile", "K3-up", (1, 9, 6, 2, 16), 8, True),
            ("xy_mid_tile", "K3", (1, 11, 13, 16, 16), 8, True),
            ("z1", "K3", (2, 9, 7, 1, 8), 8, True))
# (label, kernel, forward input shape (B, X, Y, Z, C), Cout, activation);
# K2-dx's z is the small z
DX32_EDGES = (("z1", "K1-dx", (3, 4, 33, 1, 8), 8, True),
              ("zs1", "K2-dx", (3, 4, 33, 1, 8), 8, True),
              ("z2", "K1-dx", (1, 4, 9, 2, 8), 8, True),
              ("zs2", "K2-dx", (1, 4, 9, 2, 8), 8, True),
              ("z3_odd_c", "K1-dx", (1, 3, 5, 3, 3), 5, True),
              ("zs3_odd_c", "K2-dx", (1, 3, 5, 3, 3), 5, True),
              ("y_mid_tile_z33", "K1-dx", (1, 3, 37, 33, 8), 4, True),
              ("y_mid_tile_zs16", "K2-dx", (1, 3, 37, 16, 16), 4, True),
              ("z7_runs", "K1-dx", (2, 40, 6, 7, 6), 12, True),
              ("zs7_runs", "K2-dx", (2, 40, 6, 7, 6), 12, True),
              ("no_act", "K1-dx", (1, 4, 5, 16, 32), 16, False),
              ("no_act", "K2-dx", (1, 4, 5, 16, 32), 16, False),
              ("wide_c", "K2-dx", (1, 3, 4, 6, 40), 20, True))
# (kernel, stage, input shape without batch, Cout)
DX32_STAGES = (("K2-dx", "conv2.conv1", (96, 96, 16, 32), 16),
               ("K1-dx", "conv2.conv2", (96, 96, 32, 16), 16),
               ("K2-dx", "conv3.conv1", (192, 192, 32, 16), 8),
               ("K1-dx", "conv3.conv2", (192, 192, 64, 8), 8))
# (kernel, stage, input shape without batch, Cout)
DW_STAGES = (("K3-up", "conv2.conv1", (96, 96, 16, 32), 16),
             ("K3", "conv2.conv2", (96, 96, 32, 16), 16),
             ("K3-up", "conv3.conv1", (192, 192, 32, 16), 8),
             ("K3", "conv3.conv2", (192, 192, 64, 8), 8))


def per_launch(fn, iters):
    """ms of each of ``iters`` launches after one warm-up."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    fn()
    torch.cuda.synchronize()
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return [events[i].elapsed_time(events[i + 1]) for i in range(iters)]


def inputs(dev, shape, cout, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((cout, c, 3, 3, 3), generator=gen, device=dev)
         / (27 * c) ** 0.5).to(torch.bfloat16)
    b = torch.randn((cout,), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((*shape[:3], 2 * shape[3], cout), generator=gen,
                    device=dev).to(torch.bfloat16)
    return x, w, b, g


def rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def where(got, want, zs):
    """Max |error| by small z slice and by channel, relative to max |want|."""
    d = (got.float() - want.float()).abs() / want.float().abs().max()
    d = d.reshape(*d.shape[:3], zs, -1)
    return {"by_z": d.amax((0, 1, 2, 4)).tolist(),
            "by_channel": d.amax((0, 1, 2, 3)).tolist()}


def ms_median(ms):
    return sorted(ms)[len(ms) // 2]


CONV = dict(stride=[1, 1, 1], padding=[1, 1, 1], dilation=[1, 1, 1],
            transposed=False, output_padding=[0, 0, 0], groups=1)


def dw_fns(kid):
    from muvo_tpu_torch.ops import zconv

    if kid == "K3-up":
        return (zconv.upzconv3d_leaky, zconv.upzconv3d_dw,
                zconv.upzconv3d_dw_plain)
    return zconv.zconv3d_leaky, zconv.zconv3d_dw, zconv.zconv3d_dw_plain


def dw_edges(dev):
    """Part 3: bf16 K3 / K3-up against their plain versions at the edges."""
    edges, failed = [], []
    for label, kid, shape, cout, act in DW_EDGES:
        fwd, kern, plain = dw_fns(kid)
        x, w, b, _ = inputs(dev, shape, cout)
        slope = 0.2 if act else None
        out = fwd(x, w, b if act else None, slope)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1)).to(torch.bfloat16)
        dw, db = kern(x, g, out, slope, with_bias=act)
        impl = kern.last_impl
        dw2, db2 = kern(x, g, out, slope, with_bias=act)
        want, db_want = plain(x, g, out, slope, act)
        torch.cuda.synchronize()
        same = torch.equal(dw, dw2) and (not act or torch.equal(db, db2))
        row = {"case": label, "kernel": kid, "shape": list(shape),
               "cout": cout, "act": act, "impl": impl, "dW": rel(dw, want),
               "dbias": rel(db, db_want) if act else None,
               "repeat_equal": same}
        if not same:
            failed.append(f"{kid} {label}: a second launch differs")
        if not (row["dW"] <= TOL and (not act or row["dbias"] <= TOL)):
            failed.append(f"{kid} {label}: {row['dW']} {row['dbias']}")
        edges.append(row)
        print(json.dumps(row), flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return edges


def dw_timed(dev, iters):
    """Part 4: bf16 K3 / K3-up per launch at batch 24 beside cuDNN."""
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import zconv

    timed = []
    for kid, stage, shape, cout in DW_STAGES:
        fwd, kern, _ = dw_fns(kid)
        x, w, b, _ = inputs(dev, (BWD_BATCH, *shape), cout, seed=2)
        out = fwd(x, w, b, 0.2)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(3)).to(torch.bfloat16)
        gm = zconv.leaky_mask(g, out, 0.2)
        xin = zconv.upsample2x_z(x) if kid == "K3-up" else x
        runs = {kid: lambda: kern(x, g, out, 0.2),
                "cudnn_" + kid: lambda: torch.ops.aten.convolution_backward(
                    to_nchw(gm), to_nchw(xin), w, [cout], **CONV,
                    output_mask=[False, True, True])}
        nbytes = 2 * (x.numel() + g.numel() + out.numel()) + 4 * (
            w.numel() + cout)
        for name, fn in runs.items():
            ms = per_launch(fn, iters)
            row = {"run": name, "stage": stage, "batch": BWD_BATCH,
                   "input": [BWD_BATCH, *shape], "cout": cout, "ms": ms,
                   "ms_median": ms_median(ms)}
            if name == kid:
                row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                row["impl"] = kern.last_impl
                # the kernel's m64 x k16 wgmma products an SM a microsecond
                sms, optin = zconv._dw_tc_limits(dev.index or 0)
                plan = zconv.dw_tc_plan(*x.shape, cout, kid == "K3-up",
                                        sms, optin)
                products = (plan["nwg"] * plan["mt"] * plan["m_passes"]
                            * plan["n_passes"] * plan["B"] * plan["X"]
                            * plan["Y"] * plan["zp"] // 16)
                row["products_per_sm_per_us"] = products / sms / (
                    row["ms_median"] * 1e3)
            timed.append(row)
            print(json.dumps(row), flush=True)
        del x, w, b, out, g, gm, xin, runs
        torch.cuda.empty_cache()
    return timed


# (label, input shape (B, X, Y, Z, C), Cout, activation)
K1_EDGES = (("z1", (2, 5, 6, 1, 16), 8, True),
            ("z2_pair", (1, 4, 9, 2, 8), 8, True),
            ("z3_c3", (1, 3, 5, 3, 3), 5, True),
            ("xy_mid_block", (1, 20, 13, 16, 16), 16, True),
            ("xy_mid_block_pair", (1, 19, 11, 32, 8), 8, True),
            ("c40_cout12", (1, 3, 4, 6, 40), 12, True),
            ("no_act", (1, 4, 5, 16, 32), 16, False),
            ("conv2.conv2", (1, 96, 96, 32, 16), 16, True),
            ("conv3.conv2", (1, 192, 192, 64, 8), 8, True))
# (stage, input shape without batch, Cout)
K1_STAGES = (("conv2.conv2", (96, 96, 32, 16), 16),
             ("conv3.conv2", (192, 192, 64, 8), 8))


@contextlib.contextmanager
def k1_view(name):
    """K1 and K1-dx on the route's view (None) or forced to ``name``."""
    from muvo_tpu_torch.ops import zconv

    route = zconv.k1_route
    if name == "plain":
        zconv.k1_route = lambda z, c, cout: zconv.TcView("plain", z, c, cout)
    try:
        yield
    finally:
        zconv.k1_route = route


def k1_edges(dev):
    """Part 5: bf16 K1 / K1-dx against their plain versions at the edges."""
    from muvo_tpu_torch.ops import zconv

    edges, failed = [], []
    for label, shape, cout, act in K1_EDGES:
        x, w, b, _ = inputs(dev, shape, cout)
        slope = 0.2 if act else None
        bias = b if act else None
        out = zconv.zconv3d_leaky(x, w, bias, slope)
        impl = zconv.zconv3d_leaky.last_impl
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1)).to(torch.bfloat16)
        dx = zconv.zconv3d_dx(g, out, w, slope)
        same = (torch.equal(out, zconv.zconv3d_leaky(x, w, bias, slope))
                and torch.equal(dx, zconv.zconv3d_dx(g, out, w, slope)))
        want = zconv.zconv3d_leaky_plain(x, w, bias, slope)
        dx_want = zconv.zconv3d_dx_plain(g, out, w, slope)
        torch.cuda.synchronize()
        row = {"case": label, "shape": list(shape), "cout": cout, "act": act,
               "impl": impl, "dx_impl": zconv.zconv3d_dx.last_impl,
               "K1": rel(out, want), "K1-dx": rel(dx, dx_want),
               "repeat_equal": same}
        if not same:
            failed.append(f"{label}: a second launch differs")
        if not all(n.startswith("tc::zconv_tc_kernel")
                   for n in (row["impl"], row["dx_impl"])):
            failed.append(f"{label}: ran {row['impl']}, {row['dx_impl']}")
        for kid in ("K1", "K1-dx"):
            if not row[kid] <= TOL:
                failed.append(f"{kid} {label}: {row[kid]}")
        edges.append(row)
        print(json.dumps(row), flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return edges


def k1_timed(dev, iters):
    """Part 6: bf16 K1 and K1-dx per launch beside cuDNN, on the route's
    view and, at conv3.conv2, on the plain view."""
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import zconv

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timed = []
    for stage, shape, cout in K1_STAGES:
        c = shape[-1]
        views = [None] + (["plain"] if stage == "conv3.conv2" else [])
        for batch in (FWD_BATCH, BWD_BATCH):
            x, w, b, _ = inputs(dev, (batch, *shape), cout, seed=4)
            out = zconv.zconv3d_leaky(x, w, b, 0.2)
            g = torch.randn(out.shape, device=dev, generator=torch.Generator(
                device=dev).manual_seed(5)).to(torch.bfloat16)
            gm = zconv.leaky_mask(g, out, 0.2)
            flops = 2 * 27 * c * out.numel()
            runs = {"K1": (lambda: zconv.zconv3d_leaky(x, w, b, 0.2),
                           2 * (x.numel() + w.numel() + out.numel() + cout),
                           (shape[2], c, cout)),
                    "cudnn_K1": (lambda: F.conv3d(to_nchw(x), w, b,
                                                  padding=1), 0, None)}
            if batch == BWD_BATCH:
                runs["K1-dx"] = (lambda: zconv.zconv3d_dx(g, out, w, 0.2),
                                 2 * (g.numel() + out.numel() + w.numel()
                                      + x.numel()), (shape[2], cout, c))
                runs["cudnn_K1-dx"] = (
                    lambda: torch.ops.aten.convolution_backward(
                        to_nchw(gm), to_nchw(x), w, None, **CONV,
                        output_mask=[True, False, False]), 0, None)
            for view in views:
                for name, (fn, nbytes, zcc) in runs.items():
                    if view is not None and zcc is None:
                        continue  # cuDNN once a batch
                    with k1_view(view):
                        ms = per_launch(fn, iters)
                        kern = (zconv.zconv3d_dx if name == "K1-dx"
                                else zconv.zconv3d_leaky)
                        route = (zconv.k1_route(*zcc) if zcc is not None
                                 else None)
                    row = {"run": name, "stage": stage, "batch": batch,
                           "input": [batch, *shape], "cout": cout, "ms": ms,
                           "ms_median": ms_median(ms)}
                    if route is not None:
                        row["impl"] = kern.last_impl
                        row["view"] = route.name
                        row["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                              flops / BF16_FLOPS) * 1e3
                        # the view's m64 x k16 wgmma products an SM a us
                        rows = batch * shape[0] * shape[1] * route.zs
                        products = -(-rows // 64) * 27 * (-(-route.kc // 16))
                        row["products_per_sm_per_us"] = products / sms / (
                            row["ms_median"] * 1e3)
                    timed.append(row)
                    print(json.dumps(row), flush=True)
            del x, w, b, out, g, gm, runs
            torch.cuda.empty_cache()
    return timed


# (label, input shape (B, X, Y, Zs, C), Cout, activation)
K2F32_EDGES = (("Zs1", (2, 5, 6, 1, 16), 8, True),
               ("Zs2", (1, 4, 9, 2, 8), 8, True),
               ("Zs3_c3_cout5", (1, 3, 5, 3, 3), 5, True),
               ("y_mid_tile_run_mid_x", (1, 7, 37, 16, 4), 16, True),
               ("runs_across_tiles", (2, 40, 6, 5, 6), 12, True),
               ("no_act", (1, 4, 5, 16, 32), 16, False),
               ("conv2.conv1", (1, 96, 96, 16, 32), 16, True),
               ("conv3.conv1", (1, 192, 192, 32, 16), 8, True))
# (label, input shape (B, X, Y, Z, C), Cout, activation)
K1F32_EDGES = (("Z1", (2, 5, 6, 1, 16), 8, True),
               ("Z2", (1, 4, 9, 2, 8), 8, True),
               ("Z3_c3_cout5", (1, 3, 5, 3, 3), 5, True),
               ("y_mid_tile_run_mid_x", (1, 3, 37, 64, 4), 16, True),
               ("runs_across_tiles", (2, 40, 6, 5, 6), 12, True),
               ("no_act", (1, 4, 5, 16, 32), 16, False),
               ("conv2.conv2", (1, 96, 96, 32, 16), 16, True),
               ("conv3.conv2", (1, 192, 192, 64, 8), 8, True))


def fp32_inputs(dev, shape, cout, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev)
    w = torch.randn((cout, c, 3, 3, 3), generator=gen, device=dev) / (
        27 * c) ** 0.5
    b = torch.randn((cout,), generator=gen, device=dev)
    return x, w, b


def f32_fns(up):
    """(kernel id, wrapper, plain version, the wrapper's kernel name)."""
    from muvo_tpu_torch.ops import zconv

    if up:
        return ("K2", zconv.upzconv3d_leaky, zconv.upzconv3d_leaky_plain,
                zconv.K2_F32_IMPL)
    return ("K1", zconv.zconv3d_leaky, zconv.zconv3d_leaky_plain,
            zconv.K1_F32_IMPL)


def f32_edges(dev, up):
    """Parts 7 and 9: fp32 K2 (``up``) or K1 against its plain version at
    the edges."""
    from muvo_tpu_torch.ops import zconv

    kid, kern, plain, impl_want = f32_fns(up)
    edges, failed = [], []
    for label, shape, cout, act in (K2F32_EDGES if up else K1F32_EDGES):
        x, w, b = fp32_inputs(dev, shape, cout)
        slope = 0.2 if act else None
        bias = b if act else None
        out = kern(x, w, bias, slope)
        impl = kern.last_impl
        same = torch.equal(out, kern(x, w, bias, slope))
        want = plain(x, w, bias, slope)
        torch.cuda.synchronize()
        plan = zconv.f32_plan(*shape, cout, up,
                              *zconv._f32_limits(dev.index or 0))
        row = {"case": label, "shape": list(shape), "cout": cout, "act": act,
               "impl": impl, kid: rel(out, want), "repeat_equal": same,
               "plan": {k: plan[k] for k in ("co", "ty", "threads", "grid",
                                             "xs", "xvec", "smem_bytes")}}
        if not same:
            failed.append(f"{kid} {label}: a second launch differs")
        if impl != impl_want:
            failed.append(f"{kid} {label}: ran {impl}")
        if not row[kid] <= FP32_TOL:
            row[kid + "_where"] = where(out, want, out.shape[3])
            failed.append(f"{kid} {label}: {row[kid]}")
        edges.append(row)
        print(json.dumps(row), flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return edges


def old_k1_f32(x, wk, b, out):
    """The first fp32 K1, zconv_kernel<float> (csrc/zconv.cu, which bf16 K1
    keeps past 64 channels), on the same inputs."""
    from muvo_tpu_torch.ops import zconv

    with torch.cuda.device(x.device):
        rc = zconv._library("zconv").muvo_zconv3d_leaky(
            x.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(),
            *x.shape, out.shape[-1], 1, 0.2, 0, zconv._stream(x))
    zconv._raise_if(rc, "zconv", "K1")


def f32_timed(dev, iters, up):
    """Parts 8 and 10: fp32 K2 (``up``) or K1 per launch on the plan and
    its alternatives (K1 also on the first kernel), beside cuDNN and the
    bound."""
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import _build, zconv

    kid, kern, _, _ = f32_fns(up)
    sms, optin = zconv._f32_limits(dev.index or 0)
    timed = []
    for stage, shape, cout in (STAGES if up else K1_STAGES):
        c = shape[-1]
        big = (shape[0], shape[1], (2 if up else 1) * shape[2])
        for batch in (1, FWD_BATCH):
            x, w, b = fp32_inputs(dev, (batch, *shape), cout, seed=6)
            out = torch.empty((batch, *big, cout), device=dev)
            wk = zconv._kkkcn(w)
            plan = zconv.f32_plan(batch, *shape, cout, up, sms, optin)
            other = zconv._f32_plan(batch, *shape, cout, up, sms, optin,
                                    co=12 - plan["co"])
            fewer = zconv._f32_plan(batch, *shape, cout, up, sms, optin,
                                    ty=max(1, plan["ty"] // 2))
            flops = 2 * 27 * c * cout * batch * big[0] * big[1] * big[2]
            nbytes = 4 * (x.numel() + w.numel() + out.numel() + cout)
            bound_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            runs = {kid: (lambda: kern(x, w, b, 0.2), plan)}
            for name, p in ((f"{kid}_other_co", other),
                            (f"{kid}_half_ty", fewer)):
                runs[name] = (lambda p=p: zconv._launch_f32(
                    x, wk, b, out, 0.2, p), p)
            if up:
                runs["cudnn_K2"] = (lambda: F.conv3d(F.interpolate(
                    to_nchw(x), size=big, mode="trilinear",
                    align_corners=False), w, b, padding=1), None)
            else:
                runs["K1_zconv_kernel_float"] = (
                    lambda: old_k1_f32(x, wk, b, out), {})
                runs["cudnn_K1"] = (
                    lambda: F.conv3d(to_nchw(x), w, b, padding=1), None)
            for name, (fn, p) in runs.items():
                ms = per_launch(fn, iters)
                row = {"run": name, "stage": stage, "batch": batch,
                       "input": [batch, *shape], "cout": cout, "ms": ms,
                       "ms_median": ms_median(ms)}
                if p is not None:
                    row["bound_ms"] = bound_ms
                    row["x_bound"] = row["ms_median"] / bound_ms
                if p:
                    row["plan"] = {k: p[k] for k in ("co", "ty", "threads",
                                                     "grid", "xs",
                                                     "smem_bytes")}
                timed.append(row)
                print(json.dumps(row), flush=True)
            del x, w, b, out, wk, runs
            torch.cuda.empty_cache()
    ptxas = [ln.strip() for ln in _build.build_log("zconv_f32").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    timed.append({"ptxas": ptxas})
    print(json.dumps({"ptxas": ptxas}), flush=True)
    return timed


def dw32_edges(dev):
    """Part 11: fp32 K3 / K3-up against their plain versions at part 3's
    cases."""
    from muvo_tpu_torch.ops import zconv

    edges, failed = [], []
    for label, kid, shape, cout, act in DW_EDGES:
        fwd, kern, plain = dw_fns(kid)
        x, w, b = fp32_inputs(dev, shape, cout)
        slope = 0.2 if act else None
        out = fwd(x, w, b if act else None, slope)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1))
        dw, db = kern(x, g, out, slope, with_bias=act)
        impl = kern.last_impl
        dw2, db2 = kern(x, g, out, slope, with_bias=act)
        want, db_want = plain(x, g, out, slope, act)
        torch.cuda.synchronize()
        same = torch.equal(dw, dw2) and (not act or torch.equal(db, db2))
        row = {"case": label, "kernel": kid, "shape": list(shape),
               "cout": cout, "act": act, "impl": impl, "dW": rel(dw, want),
               "dbias": rel(db, db_want) if act else None,
               "repeat_equal": same}
        if not same:
            failed.append(f"{kid} {label}: a second launch differs")
        if impl != zconv.DW_IMPL[torch.float32]:
            failed.append(f"{kid} {label}: ran {impl}")
        if not (row["dW"] <= FP32_TOL
                and (not act or row["dbias"] <= FP32_TOL)):
            failed.append(f"{kid} {label}: {row['dW']} {row['dbias']}")
        edges.append(row)
        print(json.dumps(row), flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return edges


def dw32_timed(dev, iters):
    """Part 12: fp32 K3 / K3-up per launch at batch 24 on the plan and its
    alternatives, beside cuDNN and the bound."""
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import _build, zconv

    sms, optin = zconv._f32_limits(dev.index or 0)
    timed = []
    for kid, stage, shape, cout in DW_STAGES:
        up = kid == "K3-up"
        fwd, kern, _ = dw_fns(kid)
        x, w, b = fp32_inputs(dev, (BWD_BATCH, *shape), cout, seed=2)
        out = fwd(x, w, b, 0.2)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(3))
        gm = zconv.leaky_mask(g, out, 0.2)
        xin = zconv.upsample2x_z(x) if up else x
        c, vox = shape[-1], out.numel() // cout
        flops = (2 * 27 * c * cout + cout) * vox
        nbytes = 4 * (x.numel() + g.numel() + out.numel() + w.numel() + cout)
        bound_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        plan = zconv.dw_f32_plan(BWD_BATCH, *shape, cout, up, sms, optin)
        runs = {kid: (lambda: kern(x, g, out, 0.2), plan)}
        for twelfths in (10, 8, 6, 5, 4):
            try:
                p = zconv.dw_f32_plan(BWD_BATCH, *shape, cout, up, sms,
                                      optin * twelfths // 12)
            except ValueError:  # its planes do not fit
                continue
            name = f"{kid}_ty{p['ty']}"
            if p["ty"] != plan["ty"] and name not in runs:
                runs[name] = (lambda p=p: zconv._launch_dw_f32(
                    x, g, out, 0.2, p, True), p)
        runs["cudnn_" + kid] = (
            lambda: torch.ops.aten.convolution_backward(
                to_nchw(gm), to_nchw(xin), w, [cout], **CONV,
                output_mask=[False, True, True]), None)
        for name, (fn, p) in runs.items():
            ms = per_launch(fn, iters)
            row = {"run": name, "stage": stage, "batch": BWD_BATCH,
                   "input": [BWD_BATCH, *shape], "cout": cout, "ms": ms,
                   "ms_median": ms_median(ms)}
            if p is not None:
                row["bound_ms"] = bound_ms
                row["x_bound"] = row["ms_median"] / bound_ms
                row["plan"] = {k: p[k] for k in (
                    "ty", "slices", "threads", "nzs", "grid", "passes",
                    "smem_bytes")}
            timed.append(row)
            print(json.dumps(row), flush=True)
        del x, w, b, out, g, gm, xin, runs
        torch.cuda.empty_cache()
    ptxas = [ln.strip() for ln in _build.build_log("zconv_dw").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    timed.append({"ptxas": ptxas})
    print(json.dumps({"ptxas": ptxas}), flush=True)
    return timed


def dx32_fns(kid):
    """(forward, dx kernel, dx plain version, the kernel's name)."""
    from muvo_tpu_torch.ops import zconv

    if kid == "K2-dx":
        return (zconv.upzconv3d_leaky, zconv.upzconv3d_dx,
                zconv.upzconv3d_dx_plain, zconv.K2_DX_F32_IMPL)
    return (zconv.zconv3d_leaky, zconv.zconv3d_dx, zconv.zconv3d_dx_plain,
            zconv.K1_DX_F32_IMPL)


def dx32_edges(dev):
    """Part 13: fp32 K1-dx / K2-dx against their plain versions at the
    edges."""
    from muvo_tpu_torch.ops import zconv

    edges, failed = [], []
    for label, kid, shape, cout, act in DX32_EDGES:
        fwd, kern, plain, impl_want = dx32_fns(kid)
        x, w, b = fp32_inputs(dev, shape, cout)
        slope = 0.2 if act else None
        out = fwd(x, w, b if act else None, slope)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1))
        dx = kern(g, out, w, slope)
        impl = kern.last_impl
        same = torch.equal(dx, kern(g, out, w, slope))
        want = plain(g, out, w, slope)
        torch.cuda.synchronize()
        plan = zconv.f32_dx_plan(*out.shape, shape[-1], kid == "K2-dx",
                                 *zconv._f32_limits(dev.index or 0))
        row = {"case": label, "kernel": kid, "shape": list(shape),
               "cout": cout, "act": act, "impl": impl, "rel": rel(dx, want),
               "repeat_equal": same,
               "plan": {k: plan[k] for k in ("ty", "threads", "grid", "xs",
                                             "xvec", "smem_bytes")}}
        if not same:
            failed.append(f"{kid} {label}: a second launch differs")
        if impl != impl_want:
            failed.append(f"{kid} {label}: ran {impl}")
        if not row["rel"] <= FP32_TOL:
            row["where"] = where(dx, want, dx.shape[3])
            failed.append(f"{kid} {label}: {row['rel']}")
        edges.append(row)
        print(json.dumps(row), flush=True)
    if failed:
        raise AssertionError("; ".join(failed))
    return edges


def dx_walk_only(g, out, w, dx, plan):
    """K2-dx's walk on the small-z view with the adjoint fold's main weights
    and no edge terms: not K2-dx (its first and last small slices lack the
    edge terms), timed for their share."""
    from muvo_tpu_torch.ops import zconv

    main, _ = zconv.up_fold_weights(w, adjoint=True)
    with torch.cuda.device(g.device):
        rc = zconv._library("zconv_f32").muvo_zconv3d_dx_f32(
            g.data_ptr(), out.data_ptr(), 0.2, main.data_ptr(), None,
            dx.data_ptr(), zconv.ctypes.byref(zconv._F32Shape(**plan)),
            zconv._stream(g))
    zconv._raise_if(rc, "zconv_f32", "K2-dx")


def dx32_timed(dev, iters):
    """Part 14: fp32 K1-dx / K2-dx per launch at batch 24 on the plan and
    every other ty it could take, the weight fold alone, beside cuDNN and
    the bound."""
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import _build, zconv

    sms, optin = zconv._f32_limits(dev.index or 0)
    timed = []
    for kid, stage, shape, cout in DX32_STAGES:
        up = kid == "K2-dx"
        fwd, kern, _, _ = dx32_fns(kid)
        x, w, b = fp32_inputs(dev, (BWD_BATCH, *shape), cout, seed=4)
        out = fwd(x, w, b, 0.2)
        g = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(5))
        gm = zconv.leaky_mask(g, out, 0.2)
        xin = zconv.upsample2x_z(x) if up else x
        dx = torch.empty_like(x)
        c = shape[-1]
        flops = 2 * 27 * c * cout * out.numel() // cout + (
            8 * dx.numel() if up else 0)
        nbytes = 4 * (g.numel() + out.numel() + w.numel() + dx.numel())
        bound_ms = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        view = zconv.f32_dx_view(out.shape[3], cout, c, up)
        plan = zconv.f32_dx_plan(*out.shape, c, up, sms, optin)
        runs = {kid: (lambda: kern(g, out, w, 0.2), plan)}
        for ty in range(1, 33):
            try:
                p = zconv._f32_plan(BWD_BATCH, *shape[:2], *view, False, sms,
                                    optin, ty=ty, dx=True, edges=up)
            except ValueError:  # past the most y rows a block takes
                break
            if ty != plan["ty"]:
                runs[f"{kid}_ty{ty}"] = (lambda p=p: zconv._launch_dx_f32(
                    g, out, 0.2, w, dx, p), p)
        if up:  # the share of the edge terms: the walk without them
            runs["K2-dx_no_edge_terms"] = (
                lambda: dx_walk_only(g, out, w, dx, dict(plan, edges=0)),
                plan)
        runs[kid + "_weight_fold"] = (
            (lambda: zconv.up_fold_weights(w, adjoint=True)) if up
            else (lambda: zconv._kkkcn(w, adjoint=True)), None)
        runs["cudnn_" + kid] = (
            lambda: torch.ops.aten.convolution_backward(
                to_nchw(gm), to_nchw(xin), w, None, **CONV,
                output_mask=[True, False, False]), None)
        for name, (fn, p) in runs.items():
            ms = per_launch(fn, iters)
            row = {"run": name, "stage": stage, "batch": BWD_BATCH,
                   "input": [BWD_BATCH, *shape], "cout": cout, "ms": ms,
                   "ms_median": ms_median(ms)}
            if p is not None:
                row["bound_ms"] = bound_ms
                row["x_bound"] = row["ms_median"] / bound_ms
                row["plan"] = {k: p[k] for k in ("ty", "threads", "grid",
                                                 "xs", "smem_bytes")}
            timed.append(row)
            print(json.dumps(row), flush=True)
        del x, w, b, out, g, gm, xin, dx, runs
        torch.cuda.empty_cache()
    ptxas = [ln.strip() for ln in _build.build_log("zconv_f32").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    timed.append({"ptxas": ptxas})
    print(json.dumps({"ptxas": ptxas}), flush=True)
    return timed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--parts", default="k2,dw,k1,k2f32,k1f32,dw32,dx32",
                    help="comma-separated: k2 (parts 1-2), dw (3-4), "
                         "k1 (5-6), k2f32 (7-8), k1f32 (9-10), "
                         "dw32 (11-12), dx32 (13-14)")
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "torch_zconv_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    parts = args.parts.split(",")
    result = {"device": torch.cuda.get_device_name(0)}
    if "k2" in parts:
        result["edges"], result["timed"] = k2_parts(dev, args.iters)
    if "dw" in parts:
        result["dw_edges"] = dw_edges(dev)
        result["dw_timed"] = dw_timed(dev, args.iters)
    if "k1" in parts:
        result["k1_edges"] = k1_edges(dev)
        result["k1_timed"] = k1_timed(dev, args.iters)
    for part, up in (("k2f32", True), ("k1f32", False)):
        if part in parts:
            result[part + "_edges"] = f32_edges(dev, up)
            result[part + "_timed"] = f32_timed(dev, args.iters, up)
    if "dw32" in parts:
        result["dw32_edges"] = dw32_edges(dev)
        result["dw32_timed"] = dw32_timed(dev, args.iters)
    if "dx32" in parts:
        result["dx32_edges"] = dx32_edges(dev)
        result["dx32_timed"] = dx32_timed(dev, args.iters)
    result["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in ("device", "nvidia_smi")}))
    return 0


def k2_parts(dev, iters):
    """Parts 1 and 2: bf16 K2 and K2-dx at the edges, then timed."""
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import zconv

    edges, failed = [], []
    for label, shape, cout, act in EDGES:
        x, w, b, g = inputs(dev, shape, cout)
        slope = 0.2 if act else None
        bias = b if act else None
        out = zconv.upzconv3d_leaky(x, w, bias, slope)
        want = zconv.upzconv3d_leaky_plain(x, w, bias, slope)
        dx = zconv.upzconv3d_dx(g, out, w, slope)
        dx_want = zconv.upzconv3d_dx_plain(g, out, w, slope)
        # no atomics: a second launch gives the same bits
        same = (torch.equal(out, zconv.upzconv3d_leaky(x, w, bias, slope))
                and torch.equal(dx, zconv.upzconv3d_dx(g, out, w, slope)))
        torch.cuda.synchronize()
        row = {"case": label, "shape": list(shape), "cout": cout, "act": act,
               "K2": rel(out, want), "K2-dx": rel(dx, dx_want),
               "repeat_equal": same}
        if not same:
            failed.append(f"{label}: a second launch differs")
        for kid, got, ref in (("K2", out, want), ("K2-dx", dx, dx_want)):
            if not row[kid] <= TOL:
                row[kid + "_where"] = where(got, ref, shape[3])
                failed.append(f"{kid} {label}: {row[kid]}")
        edges.append(row)
        print(json.dumps(row), flush=True)
    if failed:
        raise AssertionError("; ".join(failed))

    timed = []
    for stage, shape, cout in STAGES:
        c = shape[-1]
        x, w, b, _ = inputs(dev, (FWD_BATCH, *shape), cout)
        out = zconv.upzconv3d_leaky(x, w, b, 0.2)
        big = (shape[0], shape[1], 2 * shape[2])
        vox = FWD_BATCH * big[0] * big[1] * big[2]
        flops = 2 * 27 * c * cout * vox
        nbytes = 2 * (x.numel() + w.numel() + out.numel() + cout)
        runs = {"K2": (lambda: zconv.upzconv3d_leaky(x, w, b, 0.2)),
                "cudnn_K2": (lambda: F.conv3d(F.interpolate(
                    to_nchw(x), size=big, mode="trilinear",
                    align_corners=False), w, b, padding=1))}
        bounds = {"K2": max(nbytes / HBM_BYTES_PER_S,
                            flops / BF16_FLOPS) * 1e3}
        xb, wb, bb, gb = inputs(dev, (BWD_BATCH, *shape), cout, seed=1)
        outb = zconv.upzconv3d_leaky(xb, wb, bb, 0.2)
        gm = zconv.leaky_mask(gb, outb, 0.2)
        xin = zconv.upsample2x_z(xb)
        runs["K2-dx"] = lambda: zconv.upzconv3d_dx(gb, outb, wb, 0.2)
        runs["cudnn_K2-dx"] = lambda: torch.ops.aten.convolution_backward(
            to_nchw(gm), to_nchw(xin), wb, None, **CONV,
            output_mask=[True, False, False])
        nbytes = 2 * (gb.numel() + outb.numel() + wb.numel() + xb.numel())
        bounds["K2-dx"] = max(nbytes / HBM_BYTES_PER_S,
                              flops / FWD_BATCH * BWD_BATCH / BF16_FLOPS) * 1e3
        for name, fn in runs.items():
            ms = per_launch(fn, iters)
            kid = name.replace("cudnn_", "")
            batch = FWD_BATCH if kid == "K2" else BWD_BATCH
            row = {"run": name, "stage": stage, "batch": batch,
                   "input": [batch, *shape], "cout": cout, "ms": ms,
                   "ms_median": ms_median(ms)}
            if name in bounds:
                row["bound_ms"] = bounds[name]
            timed.append(row)
            print(json.dumps(row), flush=True)
        del x, w, b, out, xb, wb, bb, gb, outb, gm, xin, runs
        torch.cuda.empty_cache()
    return edges, timed


if __name__ == "__main__":
    sys.exit(main())
