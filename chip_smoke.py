#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; a failed phase raises and the script
exits nonzero (there is no CPU fallback):

1. device: the card's name and nvidia-smi's name and power limit.
2. build: compiles muvo_tpu_torch/csrc/*.cu (one nvcc each, in parallel).
3. kernels: K1 (zconv3d_leaky) and K2 (upzconv3d_leaky) at the voxel
   decoder's four serving shapes, batch 1 and 5, fp32 and bf16: each is held
   against its plain PyTorch version on the card (TF32 off), and timed beside
   the plain version, one library call and the bound. In bf16 both are the
   tensor-core kernel (zconv_tc_kernel): K2 on the small-z grid, K1 on the
   view zconv.k1_route picks (z pairs folded into channels at conv3.conv2);
   fp32 K1 is the CUDA-core zconv_kernel, fp32 K2 the register-tiled
   f32up::zconv_up_f32_kernel (zconv_f32.cu). Each row names the kernel
   that ran in ``impl``; a bf16 row must name the tensor-core kernel, an
   fp32 K2 row zconv_up_f32_kernel, and for both a second launch must give
   the same bits.
4. backward_kernels: K1-dx, K2-dx, K3 and K3-up at the four training shapes
   (batch 24 = 4 sequences of 6 frames), bf16 and fp32, held against their
   plain versions and timed beside them, one library call
   (aten.convolution_backward) and the bound. bf16 K1-dx is
   zconv_tc_kernel on K1's view, bf16 K2-dx zconv_tc_kernel with the
   adjoint fold; bf16 K3 and K3-up are tc::dw_tc_kernel (zconv_dw_tc.cu),
   fp32 ones dw_kernel (zconv_dw.cu); each row names its kernel in
   ``impl``. A bf16 dx row must name the tensor-core kernel; a second
   launch of a bf16 dx kernel and of every dW kernel must give the same
   bits.
5. flash_kernels: K4 (flash forward), K5 (fused backward), K6-dq and K6-dkv
   (split backward) at the LARGE training shape (bh 48 = 8 heads x 6
   frames, n 5184, d 48), at d 32, at a ragged n, with seq_len < n and at
   n and seq_len just past a 128-row tile, fp32
   (TF32 off) and bf16, each held against its plain version and timed
   beside it (FLASH_ITERS launches), one library call
   (scaled_dot_product_attention, or its backward alone) and the bound;
   K4-mb (the microbenchmark's kernel) once. K6 in every case: each kernel
   named in ``last_impl`` as the dispatch picks it (bf16: the hopper
   kernels, flash_bwd_dq_wgmma and flash_bwd_wgmma<D, false>), the same
   bits on a second launch; in bf16 K6-dkv's dk and dv equal to K5's (one
   kernel, the same products in the same order) and K6-dq's dq reported
   against K5's; in fp32 K6's outputs and K5's dk, dv equal to the plain
   version's.
6. serving: muvo.yml at full width with seeded random weights, driven
   through DeploymentSession (deployment_forward, then sim_forward with a
   5-step imagination); K1 and K2 must be launched (K2 on
   zconv_up_f32_kernel) and K4 not (648 tokens a frame), outputs must be
   finite with muvo_tpu's shapes, and one decode on the card must match the
   same decode run by the port on the host CPU.
7. training: build_flagship_step (muvo.yml at full width, 4 x 6 frames, bf16
   autocast, decoder remat, AdamW + OneCycle), 3 warm-up steps, then timed
   steps; every kernel's launches must rise by what the model predicts and
   every loss must be finite. Then one fp32 train step at tiny_test_cfg
   (voxel 64^3: conv2 and conv3 take the kernels) on the card against the
   same step on the host CPU, same weights and batch, no sampling noise or
   dropout.
8. serving_large: muvo.yml with MODEL.TRANSFORMER.LARGE (stride-8 features,
   5,184 fusion tokens a frame) through DeploymentSession, fp32: K4 must be
   launched once a layer for each encode, outputs must be finite with
   muvo_tpu's shapes, and one frame's embedding on the card must match the
   port's host run (the math attention path).
9. training_large: build_flagship_step(large=True) (1 x 6 frames, bf16),
   3 warm-up steps, then timed steps with K4 and K5 launched once a layer a
   step; then gradients with the split backward (K6, not K5) against the
   fused backward's, each leaf within 2e-2 plus 8x the fused gradient's
   own noise (its change on a rerun, or from a scaled loss, the larger).
   tools/torch_large_grad_check.py repeats this phase alone.
10. microbench: tools/torch_flash_microbench.py, K4-mb and K4 at bh 16.

Each main path's launch counts are set to 0 just before it runs and read
just after; each wrapper counts its launches by the tensors' type. The
kernels line has one entry for each kernel and type that a main path
launched, with that type's counts by path, and every kernel must have been
launched on some main path.
The last three lines are the kernels summary, nvidia-smi's name and power
limit, and {"ok": true, "device": {...}}.
"""

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# the card's published rates (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # fp32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores, dense
# the SFUs: 16 exponentials a clock on each of the 132 SMs at the 1.98 GHz
# boost clock (CUDA programming guide's throughput table, compute 9.0)
EXP_PER_S = 132 * 16 * 1.98e9
FP32_TOL = 1e-4   # max |kernel - plain| / max |plain|: summation order only
BF16_TOL = 2e-2   # output rounded to bf16 (and K2's plain upsample rounds)
DECODE_TOL = 1e-3  # card vs host decode, norm-relative, fp32 with TF32 off
LOSS_TOL = 1e-4   # card vs host train step: each loss, relative
# ... every gradient leaf: |card - host| / |host| (Frobenius norms, the
# leaf's own) <= GRAD_TOL + NOISE_FACTOR * the host's own fp32 noise, the
# norm-relative change of its gradient when every parameter moves by a
# relative ULP (about one fp32 ulp), the larger of NOISE_DRAWS draws: this
# model's fp32 gradients turn rounding into up to a few 1e-2 at this size
# (tests/test_torch_train_step.py)
GRAD_TOL = 2e-3
NOISE_FACTOR = 8.0
ULP = 1e-7
NOISE_DRAWS = 2
# LARGE split against fused: the fused backward re-run from these multiples
# of the loss (not powers of two, so that every bf16 rounding is drawn anew)
SEED_SCALES = (1.0 + 2.0 ** -9, 1.0 - 2.0 ** -9)

# (kernel, stage, input shape without batch, Cout) on muvo.yml's voxel decoder
SHAPES = (
    ("K2", "conv2.conv1", (96, 96, 16, 32), 16),
    ("K1", "conv2.conv2", (96, 96, 32, 16), 16),
    ("K2", "conv3.conv1", (192, 192, 32, 16), 8),
    ("K1", "conv3.conv2", (192, 192, 64, 8), 8),
)
# the stage each voxel kernel's kernels-line entry reports (fp32 K2 at
# conv2.conv1, where its kernel has the least room)
MAIN_SHAPE = {"K1": "conv3.conv2", "K2": "conv3.conv1", "K1-dx": "conv3.conv2",
              "K2-dx": "conv3.conv1", "K3": "conv3.conv2",
              "K3-up": "conv3.conv1"}
MAIN_BATCH = 5  # the imagination rollout decodes 5 states at once
TRAIN_BATCH = 24  # the flagship train step decodes 4 x 6 frames
TRAIN_STEPS = 5   # timed flagship steps
# the backward kernels by the forward kernel they differentiate
BACKWARD = {"K1": ("K1-dx", "K3"), "K2": ("K2-dx", "K3-up")}
ZCONV_KERNELS = ("K1", "K2", "K1-dx", "K2-dx", "K3", "K3-up")
KERNEL_NAMES = {"K1": "zconv3d_leaky", "K2": "upzconv3d_leaky",
                "K1-dx": "zconv3d_dx", "K2-dx": "upzconv3d_dx",
                "K3": "zconv3d_dw", "K3-up": "upzconv3d_dw",
                "K4": "flash_fwd", "K5": "flash_bwd", "K6-dq": "flash_bwd_dq",
                "K6-dkv": "flash_bwd_dkv", "K4-mb": "flash_matmul"}
# each kernel's source; where fp32 has its own, in F32_SOURCES
SOURCES = {"K1": "zconv.cu", "K2": "zconv.cu", "K1-dx": "zconv.cu",
           "K2-dx": "zconv.cu", "K3": "zconv_dw_tc.cu",
           "K3-up": "zconv_dw_tc.cu",
           "K4": "flash_attention.cu", "K5": "flash_attention.cu",
           "K6-dq": "flash_attention.cu", "K6-dkv": "flash_attention.cu",
           "K4-mb": "flash_attention.cu"}
F32_SOURCES = {"K2": "zconv_f32.cu", "K3": "zconv_dw.cu",
               "K3-up": "zconv_dw.cu"}
REPLACES = {"K1": "muvo_tpu/ops/pallas_zconv.py:171",
            "K2": "muvo_tpu/ops/pallas_zconv.py:171",
            "K1-dx": "muvo_tpu/ops/pallas_zconv.py:171",
            "K2-dx": "muvo_tpu/ops/pallas_zconv.py:171",
            "K3": "muvo_tpu/ops/pallas_zconv.py:388",
            "K3-up": "muvo_tpu/ops/pallas_zconv.py:388",
            "K4": "muvo_tpu/ops/flash_attention.py:79",
            "K5": "muvo_tpu/ops/flash_attention.py:305",
            "K6-dq": "muvo_tpu/ops/flash_attention.py:222",
            "K6-dkv": "muvo_tpu/ops/flash_attention.py:261",
            "K4-mb": "tools/pallas_smalld_microbench.py:42"}
FLASH_TOL = {torch.float32: 1e-4,   # norm-relative: summation order (K5's
                                    # dq by atomics, in a varying order)
             torch.bfloat16: 2e-2}  # p, ds and the outputs rounded to bf16
# (label, bh, n, d, seq_len): the LARGE training step's attention (8 heads x
# 6 frames of 5,184 tokens, d 384 / 8), d 32, a ragged n, masked keys, and
# n and seq_len just past the bf16 kernels' 128-row tiles
FLASH_CASES = (("training", 48, 5184, 48, None), ("d32", 48, 5184, 32, None),
               ("ragged", 4, 300, 48, None), ("seq_len<n", 8, 5184, 48, 5000),
               ("tile_edge", 4, 257, 48, 129))
FLASH_ITERS = 20  # timed launches of a flash kernel: steady below 1 ms
# model FLOPs per (query, unmasked key) pair over d: 2 per product
FLASH_FLOPS = {"K4": 4, "K4-mb": 4, "K5": 10, "K6-dq": 6, "K6-dkv": 8}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def least_time(nbytes: int, flops: int, dtype, exps: int = 0):
    """The larger of bytes over HBM bandwidth and operations over their
    peak, in ms, and which of the two it is. Operations: ``flops`` at the
    type's peak, or ``exps`` exponentials on the SFUs, whichever takes
    longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FLOPS[dtype], exps / EXP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(x, w, out, z_out: int, up: bool):
    """Least time for the forward: each input read once, the output written
    once; 2 * 27 * C * Cout flops per output voxel (and K2's z
    interpolation)."""
    b, X, Y, _, c = x.shape
    cout = out.shape[-1]
    flops = 2 * 27 * c * cout * b * X * Y * z_out
    if up:
        flops += 3 * b * X * Y * z_out * c  # the z interpolation
    return least_time(nbytes(x, w, out) + cout * x.element_size(), flops,
                      x.dtype)


TC_IMPL = "tc::zconv_tc_kernel"  # bf16 K1, K2, K1-dx and K2-dx


def require_kernel(what, impl, want, got, again):
    """A launch must have run the kernel whose name ``impl`` starts with
    ``want``, and a second launch on the same inputs must give the same
    bits."""
    if not impl.startswith(want):
        raise AssertionError(f"{what}: ran {impl}, not {want}")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: a second launch gave other bits")


def kernel_phase(dev):
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import zconv

    fns = {
        "K1": (zconv.zconv3d_leaky, zconv.zconv3d_leaky_plain),
        "K2": (zconv.upzconv3d_leaky, zconv.upzconv3d_leaky_plain),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for kid, stage, shape, cout in SHAPES:
        kernel, plain = fns[kid]
        up = kid == "K2"
        c = shape[-1]
        for b in (1, MAIN_BATCH):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((b, *shape), generator=gen, device=dev).to(dtype)
                w = (torch.randn((cout, c, 3, 3, 3), generator=gen, device=dev)
                     / (27 * c) ** 0.5).to(dtype)
                bias = torch.randn((cout,), generator=gen, device=dev).to(dtype)
                with torch.no_grad():
                    out = kernel(x, w, bias, 0.2)
                    impl = kernel.last_impl
                    want = (TC_IMPL if dtype == torch.bfloat16
                            else zconv.K2_F32_IMPL if up else None)
                    if want is not None:
                        require_kernel(f"{kid} {stage} B={b} {dtype}", impl,
                                       want, out, kernel(x, w, bias, 0.2))
                    ref = plain(x, w, bias, 0.2)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    rel = err / ref.float().abs().max().item()
                    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
                    z_out = out.shape[3]
                    if up:
                        def library():
                            xs = F.interpolate(to_nchw(x), size=out.shape[1:4],
                                               mode="trilinear",
                                               align_corners=False)
                            return F.conv3d(xs, w, bias, padding=1)
                    else:
                        def library():
                            return F.conv3d(to_nchw(x), w, bias, padding=1)
                    ms = time_ms(lambda: kernel(x, w, bias, 0.2))
                    plain_ms = time_ms(lambda: plain(x, w, bias, 0.2))
                    library_ms = time_ms(library)
                bound_ms, bound_by = bound(x, w, out, z_out, up)
                row = {
                    "phase": "kernel", "kernel": kid, "stage": stage,
                    "shape": [b, *shape], "cout": cout,
                    "dtype": str(dtype).replace("torch.", ""),
                    "impl": impl, "repeat_equal": want is not None,
                    "max_abs_err": err, "rel_err": rel, "tol": tol,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                emit(row)
                if not (rel <= tol):
                    raise AssertionError(f"{kid} {stage} B={b} {dtype}: "
                                         f"relative error {rel} > {tol}")
                results[(kid, stage, b, dtype)] = row
                del x, w, bias, out, ref
    return results


def backward_kernel_phase(dev):
    """K1-dx, K2-dx, K3 and K3-up at the training shapes, against their
    plain versions on the same inputs."""
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import zconv

    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for fwd, stage, shape, cout in SHAPES:
        up = fwd == "K2"
        dx_id, dw_id = BACKWARD[fwd]
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((TRAIN_BATCH, *shape), generator=gen,
                            device=dev).to(dtype)
            w = (torch.randn((cout, c, 3, 3, 3), generator=gen, device=dev)
                 / (27 * c) ** 0.5).to(dtype)
            bias = torch.randn((cout,), generator=gen, device=dev).to(dtype)
            plain_fwd = (zconv.upzconv3d_leaky_plain if up
                         else zconv.zconv3d_leaky_plain)
            with torch.no_grad():
                out = plain_fwd(x, w, bias, 0.2)
                g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
                gm = zconv.leaky_mask(g, out, 0.2)
                xin = zconv.upsample2x_z(x) if up else x
                b, X, Y, z_out = out.shape[:4]
                tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
                conv = dict(stride=[1, 1, 1], padding=[1, 1, 1],
                            dilation=[1, 1, 1], transposed=False,
                            output_padding=[0, 0, 0], groups=1)
                rows = []
                # dx: the library call is the conv's input gradient over
                # the (big-z) input, given the masked cotangent
                dx_k = zconv.upzconv3d_dx if up else zconv.zconv3d_dx
                dx_p = zconv.upzconv3d_dx_plain if up else zconv.zconv3d_dx_plain
                got, want = dx_k(g, out, w, 0.2), dx_p(g, out, w, 0.2)
                dx_impl = dx_k.last_impl
                if dtype == torch.bfloat16:
                    require_kernel(f"{dx_id} {stage}", dx_impl, TC_IMPL,
                                   got, dx_k(g, out, w, 0.2))
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
                flops = 2 * 27 * c * cout * b * X * Y * z_out
                if up:
                    flops += 8 * got.numel()  # the z-upsample's transpose
                rows.append((dx_id, err, rel, dx_impl,
                             lambda: dx_k(g, out, w, 0.2),
                             lambda: dx_p(g, out, w, 0.2),
                             lambda: torch.ops.aten.convolution_backward(
                                 to_nchw(gm), to_nchw(xin), w, None, **conv,
                                 output_mask=[True, False, False]),
                             least_time(nbytes(g, out, w, got), flops, dtype)))
                del got, want
                # dW and dbias (fp32 out of the kernel)
                dw_k = zconv.upzconv3d_dw if up else zconv.zconv3d_dw
                dw_p = zconv.upzconv3d_dw_plain if up else zconv.zconv3d_dw_plain
                (dw, db), (dw_w, db_w) = (dw_k(x, g, out, 0.2),
                                          dw_p(x, g, out, 0.2))
                impl = dw_k.last_impl
                dw2, db2 = dw_k(x, g, out, 0.2)
                torch.cuda.synchronize()
                if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
                    raise AssertionError(f"{dw_id} {stage} {dtype}: a second "
                                         f"launch gave other bits")
                del dw2, db2
                err = max((dw - dw_w).abs().max().item(),
                          (db - db_w).abs().max().item())
                rel = max(((dw - dw_w).abs().max()
                           / dw_w.abs().max()).item(),
                          ((db - db_w).abs().max()
                           / db_w.abs().max()).item())
                flops = (2 * 27 * c * cout + cout) * b * X * Y * z_out
                if up:
                    flops += 3 * b * X * Y * z_out * c
                rows.append((dw_id, err, rel, impl,
                             lambda: dw_k(x, g, out, 0.2),
                             lambda: dw_p(x, g, out, 0.2),
                             lambda: torch.ops.aten.convolution_backward(
                                 to_nchw(gm), to_nchw(xin), w, [cout], **conv,
                                 output_mask=[False, True, True]),
                             least_time(nbytes(x, g, out, dw, db), flops,
                                        dtype)))
                del dw, db, dw_w, db_w
                for (kid, err, rel, impl, kern, plain, library,
                     (bms, by)) in rows:
                    row = {
                        "phase": "backward_kernel", "kernel": kid,
                        "stage": stage, "input": [TRAIN_BATCH, *shape],
                        "cotangent": list(out.shape),
                        "dtype": str(dtype).replace("torch.", ""),
                        "impl": impl,  # the kernel (and view) that ran
                        # checked above: bf16 dx rows, and every dW row
                        "repeat_equal": (dtype == torch.bfloat16
                                         or kid in ("K3", "K3-up")),
                        "max_abs_err": err, "rel_err": rel, "tol": tol,
                        "ms": time_ms(kern, iters=5, warmup=1),
                        "plain_ms": time_ms(plain, iters=3, warmup=1),
                        "library_ms": time_ms(library, iters=3, warmup=1),
                        "bound_ms": bms, "bound_by": by,
                    }
                    emit(row)
                    if not rel <= tol:
                        raise AssertionError(f"{kid} {stage} {dtype}: "
                                             f"relative error {rel} > {tol}")
                    results[(kid, stage, dtype)] = row
            del x, w, bias, out, g, gm, xin, rows
            torch.cuda.empty_cache()
    return results


def _wrapper(kid):
    from muvo_tpu_torch.ops import flash_attention, zconv

    module = zconv if kid in ZCONV_KERNELS else flash_attention
    return getattr(module, KERNEL_NAMES[kid])


def reset_launches():
    for kid in KERNEL_NAMES:
        _wrapper(kid).launches = 0
        _wrapper(kid).launches_by_type = {}


def read_launches():
    return {kid: _wrapper(kid).launches for kid in KERNEL_NAMES}


def read_typed_launches():
    """{kernel: {type: launches}} for every kernel launched since the
    counts were set to 0, as its wrapper counted them by type."""
    return {kid: dict(_wrapper(kid).launches_by_type) for kid in KERNEL_NAMES
            if _wrapper(kid).launches}


def predicted_launches(cfg):
    """Kernel launches per train step the model's code predicts: each
    kernel-path DecoderBlock (output z > 18) runs K2 then K1, twice with
    the voxel decoder rematerialised, and each backward kernel once; on the
    LARGE path (5,184 tokens, flash from 2048) each transformer layer runs
    K4 once and K5 once (the transformer is outside every checkpoint)."""
    z = max(1, cfg.VOXEL.SIZE[2] // 64)  # the learned constant's z
    blocks = 0
    for _ in range(6):  # three middle blocks, conv1, conv2, conv3
        z *= 2
        blocks += z >= 19
    fwd = 2 if cfg.MODEL.REMAT else 1
    layers = cfg.MODEL.TRANSFORMER.N_LAYERS if cfg.MODEL.TRANSFORMER.LARGE \
        else 0
    return {"K1": fwd * blocks, "K2": fwd * blocks, "K1-dx": blocks,
            "K2-dx": blocks, "K3": blocks, "K3-up": blocks,
            "K4": layers, "K5": layers, "K6-dq": 0, "K6-dkv": 0, "K4-mb": 0}


def norm_rel(got, want):
    """|got - want| / |want| in float64 (inf where only want is zero)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    num, den = (got - want).norm().item(), want.norm().item()
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


def host_noise(trainer, batch, grads):
    """Per leaf, the largest norm-relative change of the host's gradient
    over NOISE_DRAWS relative ULP changes of every parameter."""
    model = trainer.state.model
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(7)
    noise = {k: 0.0 for k in grads}
    try:
        for _ in range(NOISE_DRAWS):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(saved[n] * (1.0 + ULP * torch.randn(
                        p.shape, generator=gen)))
            _, moved = trainer.grads(batch, stochastic=False)
            for k, g in grads.items():
                noise[k] = max(noise[k], norm_rel(moved[k], g))
    finally:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved[n])
    return noise


def seed_noise(trainer, batch, grads):
    """Per leaf, the largest norm-relative change of ``trainer``'s gradient
    (``grads``) when the backward starts from SEED_SCALES x the loss instead
    of the loss, divided back: the forward bit for bit the same, the same
    function, every rounding of the backward drawn anew."""
    from muvo_tpu_torch.training import trainer as trainer_mod

    reduce = trainer_mod.reduce_loss
    noise = {k: 0.0 for k in grads}
    try:
        for scale in SEED_SCALES:
            trainer_mod.reduce_loss = (
                lambda losses, scale=scale: reduce(losses) * scale)
            _, moved = trainer.grads(batch, stochastic=False)
            for k, g in grads.items():
                noise[k] = max(noise[k], norm_rel(moved[k] / scale, g))
    finally:
        trainer_mod.reduce_loss = reduce
    return noise


def run_train_steps(fs, dev, phase: str, config: str):
    """3 warm-up steps, then TRAIN_STEPS timed ones with the launch counts
    set to 0 just before and read just after; checks the counts against
    the prediction and every loss for finiteness."""
    cfg = fs.cfg
    frames = cfg.BATCHSIZE * (cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    warm_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        fs.trainer.train_step(fs.batch, fs.generator)
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms, steps = [], []
    reset_launches()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = fs.trainer.train_step(fs.batch, fs.generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append({k: v.item() for k, v in metrics.items()})
    launches, typed = read_launches(), read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    per_step = predicted_launches(cfg)
    median = statistics.median(step_ms)
    emit({"phase": phase, "config": config, "batch": cfg.BATCHSIZE,
          "frames_per_step": frames, "precision": str(cfg.PRECISION),
          "remat": bool(cfg.MODEL.REMAT), "warmup_step_ms": warm_ms,
          "step_ms": step_ms, "step_ms_median": median,
          "frames_per_s": frames / (median / 1e3), "peak_mib": peak_mib,
          "launches": launches, "launches_by_type": typed,
          "launches_per_step": {k: n // TRAIN_STEPS
                                for k, n in launches.items()},
          "launches_per_step_predicted": per_step,
          "losses_last_step": steps[-1]})
    for kid, n in per_step.items():
        if launches[kid] != n * TRAIN_STEPS:
            raise AssertionError(f"{kid}: {launches[kid]} launches in "
                                 f"{TRAIN_STEPS} steps, predicted "
                                 f"{n * TRAIN_STEPS}")
    for i, losses in enumerate(steps):
        bad = [k for k, v in losses.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i}: non-finite losses {bad}")
    return typed


def training_phase(dev):
    from muvo_tpu_torch.training.flagship import build_flagship_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fs = build_flagship_step(device=dev)
    launches = run_train_steps(fs, dev, "training", "muvo.yml")
    del fs
    torch.cuda.empty_cache()
    card_vs_host(dev)
    return launches


def card_vs_host(dev):
    """One fp32 step on the card against the same step on the host CPU:
    the same weights and batch, no sampling noise or dropout."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch, tiny_test_cfg
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    tiny = tiny_test_cfg()
    tiny.PRECISION = "32"
    batch = synthetic_batch(tiny, 2, 3, seed=0)
    host = WorldModelTrainer(tiny, device="cpu")
    host.init_state(seed=0)
    card = WorldModelTrainer(tiny, device=dev)
    card.init_state(model=copy.deepcopy(host.state.model))
    before = read_launches()
    got_m, got_g = card.grads(batch, stochastic=False)
    torch.cuda.synchronize()
    tiny_launches = {k: v - before[k] for k, v in read_launches().items()
                     if k in ZCONV_KERNELS}
    t0 = time.perf_counter()
    want_m, want_g = host.grads(batch, stochastic=False)
    host_s = time.perf_counter() - t0
    if set(got_g) != set(want_g) or any(
            v is None for v in (*got_g.values(), *want_g.values())):
        raise AssertionError("card and host gradients do not cover the same "
                             "parameters")
    want_g = {k: g.detach().clone() for k, g in want_g.items()}
    noise = host_noise(host, batch, want_g)
    loss_rel = {k: abs(got_m[k].item() - v.item()) / max(abs(v.item()), 1e-6)
                for k, v in want_m.items()}
    grad_rel = {k: norm_rel(got_g[k], v) for k, v in want_g.items()}
    over = {k: (grad_rel[k] - GRAD_TOL) / max(noise[k], 1e-30)
            for k in grad_rel}
    bad = {k: (grad_rel[k], noise[k]) for k in grad_rel
           if not grad_rel[k] <= GRAD_TOL + NOISE_FACTOR * noise[k]}
    emit({"phase": "training_vs_host", "config": "tiny_test_cfg voxel 64^3",
          "precision": "32 (TF32 off)", "launches": tiny_launches,
          "loss": got_m["loss"].item(), "loss_host": want_m["loss"].item(),
          "max_loss_rel": max(loss_rel.values()), "loss_tol": LOSS_TOL,
          "max_grad_norm_rel": max(grad_rel.values()),
          "median_grad_norm_rel": statistics.median(grad_rel.values()),
          "worst_grad": max(grad_rel, key=grad_rel.get),
          "host_noise_median": statistics.median(noise.values()),
          "host_noise_max": max(noise.values()),
          "worst_over_noise": max(over.values()),
          "grad_leaves": len(grad_rel), "grad_tol": GRAD_TOL,
          "noise_factor": NOISE_FACTOR, "host_step_s": host_s})
    if not all(tiny_launches.values()):
        raise AssertionError(f"a kernel did not run in the tiny step: "
                             f"{tiny_launches}")
    if not max(loss_rel.values()) <= LOSS_TOL:
        raise AssertionError(f"card loss differs from host: {loss_rel}")
    if bad:
        raise AssertionError(f"card gradients differ from host: {bad}")


def muvo_cfg():
    from muvo_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent / "muvo_tpu_torch"
                            / "configs" / "muvo.yml"))
    return cfg


def serving_phase(dev, cfg):
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.inference import DeploymentSession, LatentCarry
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.ops import zconv

    torch.manual_seed(0)
    model = MuvoWorldModel(cfg)
    host_model = copy.deepcopy(model)
    session = DeploymentSession(
        model, cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    batch = synthetic_batch(cfg, batch_size=1, sequence_length=seq, seed=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    deploy_ms, sim_ms, sim_launches = [], [], None
    for _ in range(3):
        t0 = time.perf_counter()
        out = session.deployment_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        deploy_ms.append((time.perf_counter() - t0) * 1e3)
    session.reset()
    for _ in range(3):
        before = (zconv.zconv3d_leaky.launches,
                  zconv.upzconv3d_leaky.launches)
        t0 = time.perf_counter()
        sim_out, imagined = session.sim_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        sim_ms.append((time.perf_counter() - t0) * 1e3)
        sim_launches = {"K1": zconv.zconv3d_leaky.launches - before[0],
                        "K2": zconv.upzconv3d_leaky.launches - before[1]}
    launches, typed = read_launches(), read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20

    if not (launches["K1"] and launches["K2"]):
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    if zconv.upzconv3d_leaky.last_impl != zconv.K2_F32_IMPL:
        raise AssertionError(f"serving's K2 ran "
                             f"{zconv.upzconv3d_leaky.last_impl}")
    if launches["K4"]:  # 648 tokens a frame take the math path
        raise AssertionError(f"flash attention ran on muvo.yml's 648 tokens: "
                             f"{launches}")
    check_serving_outputs(cfg, out, sim_out, imagined)

    # the card's decode (K1/K2 inside) against the port's host decode
    # (plain versions) on the same carry and weights
    carry = session.carry
    card = session.decode(carry)
    host = DeploymentSession(host_model, cfg, device="cpu")
    t0 = time.perf_counter()
    on_host = host.decode(LatentCarry(*(t.cpu() for t in carry)))
    host_s = time.perf_counter() - t0
    decode_err = {}
    for key, want in on_host.items():
        got = card[key].float().cpu()
        decode_err[key] = ((got - want).abs().max()
                           / want.abs().max().clamp_min(1e-12)).item()
    worst = max(decode_err.values())
    emit({"phase": "serving", "batch": 1,
          "sequence": seq, "deployment_tick_ms": deploy_ms,
          "sim_tick_ms": sim_ms,
          "sim_tick_ms_median": statistics.median(sim_ms),
          "deployment_tick_ms_median": statistics.median(deploy_ms),
          "peak_mib": peak_mib, "launches": launches,
          "launches_by_type": typed, "launches_per_sim_tick": sim_launches,
          "K2_impl": zconv.upzconv3d_leaky.last_impl,
          "decode_vs_host_norm_rel": decode_err,
          "decode_tol": DECODE_TOL, "host_decode_s": host_s})
    if not worst <= DECODE_TOL:
        raise AssertionError(f"card decode differs from host decode: {worst}")
    return typed


def check_serving_outputs(cfg, out, sim_out, imagined):
    """muvo_tpu's shapes and finite values for a deployment_forward output,
    a sim_forward output and its imagination."""
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    fh = seq - 1
    s_h, s_w = (cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1],
                cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0])
    expect = {
        "throttle_brake": (1,), "steering": (1,),
        "rgb_1": (s_h, s_w, 3), "rgb_4": (s_h // 4, s_w // 4, 3),
        "lidar_reconstruction_1": (cfg.POINTS.CHANNELS,
                                   cfg.POINTS.HORIZON_RESOLUTION, 4),
        "voxel_1": (*cfg.VOXEL.SIZE, cfg.VOXEL_SEG.N_CLASSES),
        "voxel_2": (*(v // 2 for v in cfg.VOXEL.SIZE),
                    cfg.VOXEL_SEG.N_CLASSES),
    }
    state_dim = (cfg.MODEL.TRANSITION.HIDDEN_STATE_DIM
                 + cfg.MODEL.TRANSITION.STATE_DIM)
    for name, result, steps in (("deployment_forward", out, 1),
                                ("sim_forward", sim_out, 1),
                                ("imagine", imagined, fh)):
        for key, tail in expect.items():
            got = tuple(result[key].shape)
            if got != (1, steps, *tail):
                raise AssertionError(f"{name} {key}: shape {got}")
        for key, v in result.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{name} {key}: non-finite values")
    if tuple(imagined["state"].shape) != (1, fh, state_dim):
        raise AssertionError(f"imagine state shape {imagined['state'].shape}")


def flash_bound(kid, q, seq_len, inputs, outputs):
    """Least time of a flash kernel on (bh, n, d) inputs: FLASH_FLOPS per
    (query, unmasked key) pair and d, one exponential per pair (K4-mb
    none), each input read and each output written once."""
    bh, n, d = q.shape
    pairs = bh * n * seq_len
    flops = FLASH_FLOPS[kid] * pairs * d
    exps = 0 if kid == "K4-mb" else pairs
    ms, by = least_time(nbytes(*inputs, *outputs), flops, q.dtype, exps)
    return ms, by, {"flops": flops, "exps": exps,
                    "ops_ms": flops / PEAK_FLOPS[q.dtype] * 1e3,
                    "exp_ms": exps / EXP_PER_S * 1e3}


def check_k6(fa, label, dtype, d, got, want, again):
    """The K6 checks of one flash case (see the module docstring); emits
    one row and raises on a failed check. ``again``: (dq, dk, dv) from a
    second launch of K6-dq and K6-dkv."""
    impl = {kid: _wrapper(kid).last_impl for kid in ("K6-dq", "K6-dkv")}
    k6 = (*got["K6-dq"], *got["K6-dkv"])
    row = {"phase": "flash_k6", "case": label,
           "dtype": str(dtype).replace("torch.", ""), "impl": impl,
           "repeat_equal": all(torch.equal(a, b) for a, b in zip(k6, again))}
    bad = [f"{kid} ran {name}" for kid, name in impl.items()
           if name != fa.kernel_name(kid, dtype, d)]
    if not row["repeat_equal"]:
        bad.append("a second launch gave other bits")
    if dtype == torch.bfloat16:
        row["dkv_equals_k5"] = all(
            torch.equal(a, b) for a, b in zip(got["K6-dkv"], got["K5"][1:]))
        row["dq_vs_k5_norm_rel"] = norm_rel(got["K6-dq"][0], got["K5"][0])
        if not row["dkv_equals_k5"]:
            bad.append("K6-dkv's dk, dv differ from K5's")
    else:
        row["k6_equals_plain"] = all(
            torch.equal(a, b) for a, b in zip(k6, want["K5"]))
        row["k5_dkv_equals_plain"] = all(
            torch.equal(a, b) for a, b in zip(got["K5"][1:], want["K5"][1:]))
        if not (row["k6_equals_plain"] and row["k5_dkv_equals_plain"]):
            bad.append("fp32 K6 or K5's dk, dv differ from the plain version")
    emit(row)
    if bad:
        raise AssertionError(f"K6 {label} {dtype}: {bad}")


def flash_kernel_phase(dev):
    """K4, K5, K6-dq and K6-dkv against their plain versions on the same
    inputs (the backward ones on K4's o and lse), norm-relative per output;
    then K4-mb once."""
    from muvo_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(2)
    results = {}
    for label, bh, n, d, seq_len in FLASH_CASES:
        keys = n if seq_len is None else seq_len
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn((bh, n, d), generator=gen, device=dev)
                           .to(dtype) for _ in range(4))
            o, lse = fa.flash_fwd(q, k, v, seq_len)
            got = {"K4": (o, lse),
                   "K5": fa.flash_bwd(q, k, v, o, lse, do, seq_len),
                   "K6-dq": (fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len),),
                   "K6-dkv": fa.flash_bwd_dkv(q, k, v, o, lse, do, seq_len)}
            again = (fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len),
                     *fa.flash_bwd_dkv(q, k, v, o, lse, do, seq_len))
            torch.cuda.synchronize()
            want_bwd = fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)
            want = {"K4": fa.flash_fwd_plain(q, k, v, seq_len),
                    "K5": want_bwd, "K6-dq": want_bwd[:1],
                    "K6-dkv": want_bwd[1:]}
            check_k6(fa, label, dtype, d, got, want, again)
            # the yardstick: one library call on (1, bh, n, d), and its
            # backward alone
            q4, k4, v4 = (t[None].detach().requires_grad_()
                          for t in (q, k, v))
            mask = None
            if seq_len is not None:
                mask = (torch.arange(n, device=dev) < seq_len)[None, None,
                                                                None]
            lib_out = F.scaled_dot_product_attention(q4, k4, v4,
                                                     attn_mask=mask)
            runs = {
                "K4": (lambda: fa.flash_fwd(q, k, v, seq_len),
                       lambda: fa.flash_fwd_plain(q, k, v, seq_len),
                       lambda: F.scaled_dot_product_attention(
                           q4, k4, v4, attn_mask=mask),
                       (q, k, v)),
                "K5": (lambda: fa.flash_bwd(q, k, v, o, lse, do, seq_len),
                       lambda: fa.flash_bwd_plain(q, k, v, o, lse, do,
                                                  seq_len),
                       lambda: torch.autograd.grad(
                           lib_out, (q4, k4, v4), do[None],
                           retain_graph=True),
                       (q, k, v, o, lse, do)),
            }
            runs["K6-dq"] = (
                lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len),
                runs["K5"][1], runs["K5"][2], runs["K5"][3])
            runs["K6-dkv"] = (
                lambda: fa.flash_bwd_dkv(q, k, v, o, lse, do, seq_len),
                runs["K5"][1], runs["K5"][2], runs["K5"][3])
            tol = FLASH_TOL[dtype]
            for kid, (kern, plain, library, inputs) in runs.items():
                rel = max(norm_rel(g, w) for g, w in zip(got[kid], want[kid]))
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got[kid], want[kid]))
                bms, by, work = flash_bound(kid, q, keys, inputs, got[kid])
                row = {"phase": "flash_kernel", "kernel": kid, "case": label,
                       "bh": bh, "n": n, "d": d, "seq_len": seq_len,
                       "dtype": str(dtype).replace("torch.", ""),
                       "max_abs_err": err, "norm_rel_err": rel, "tol": tol,
                       "ms": time_ms(kern, iters=FLASH_ITERS, warmup=2),
                       "plain_ms": time_ms(plain, iters=3, warmup=1),
                       "library_ms": time_ms(library, iters=3, warmup=1),
                       "bound_ms": bms, "bound_by": by, **work}
                emit(row)
                if not rel <= tol:
                    raise AssertionError(f"{kid} {label} {dtype}: "
                                         f"norm-relative error {rel} > {tol}")
                results[(kid, label, dtype)] = row
            del q, k, v, do, o, lse, got, want, want_bwd, runs, lib_out, again
            del q4, k4, v4
            torch.cuda.empty_cache()
    # K4-mb: the microbenchmark's shape, bf16
    q, k, v = (torch.randn((16, 5184, 48), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    got, want = fa.flash_matmul(q, k, v), fa.flash_matmul_plain(q, k, v)
    torch.cuda.synchronize()
    rel = norm_rel(got, want)
    bms, by, work = flash_bound("K4-mb", q, q.shape[1], (q, k, v), (got,))
    row = {"phase": "flash_kernel", "kernel": "K4-mb", "case": "microbench",
           "bh": 16, "n": 5184, "d": 48, "seq_len": None, "dtype": "bfloat16",
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "norm_rel_err": rel, "tol": FLASH_TOL[torch.bfloat16],
           "ms": time_ms(lambda: fa.flash_matmul(q, k, v), iters=FLASH_ITERS,
                         warmup=2),
           "plain_ms": time_ms(lambda: fa.flash_matmul_plain(q, k, v),
                               iters=3, warmup=1),
           "library_ms": None, "bound_ms": bms, "bound_by": by, **work}
    emit(row)
    if not rel <= FLASH_TOL[torch.bfloat16]:
        raise AssertionError(f"K4-mb: norm-relative error {rel}")
    results[("K4-mb", "microbench", torch.bfloat16)] = row
    return results


def microbench_phase():
    """tools/torch_flash_microbench.py in this process (its path: K4-mb and
    K4 at bh 16), the launch counts set to 0 just before and read after."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import torch_flash_microbench

    reset_launches()
    out = Path(__file__).resolve().parent / "build" / "flash_microbench.json"
    rc = torch_flash_microbench.main(["--iters", "5", "--out", str(out)])
    launches, typed = read_launches(), read_typed_launches()
    emit({"phase": "microbench", "rc": rc, "launches": launches,
          "launches_by_type": typed})
    if rc != 0 or not launches["K4-mb"]:
        raise AssertionError(f"the flash microbenchmark failed: rc {rc}, "
                             f"{launches}")
    return typed


def serving_large_phase(dev):
    """muvo.yml with MODEL.TRANSFORMER.LARGE through DeploymentSession in
    fp32: 3 deployment_forward and 3 sim_forward ticks, K4 once a layer for
    each encode, then one frame's embedding on the card against the host."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.inference import DeploymentSession
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.utils.network import remove_past

    cfg = muvo_cfg()
    cfg.MODEL.TRANSFORMER.LARGE = True
    torch.manual_seed(1)
    model = MuvoWorldModel(cfg)
    host_model = copy.deepcopy(model).eval().requires_grad_(False)
    session = DeploymentSession(
        model, cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    batch = synthetic_batch(cfg, batch_size=1, sequence_length=seq, seed=0)

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    deploy_ms, sim_ms, encodes = [], [], 0
    for _ in range(3):
        encodes += session.count == 0  # the tick encodes a frame
        t0 = time.perf_counter()
        out = session.deployment_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        deploy_ms.append((time.perf_counter() - t0) * 1e3)
    session.reset()
    for _ in range(3):
        encodes += session.count == 0
        t0 = time.perf_counter()
        sim_out, imagined = session.sim_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        sim_ms.append((time.perf_counter() - t0) * 1e3)
    launches, typed = read_launches(), read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    predicted_k4 = cfg.MODEL.TRANSFORMER.N_LAYERS * encodes
    check_serving_outputs(cfg, out, sim_out, imagined)

    # one frame: the card's embedding (K4 in every layer) against the
    # port's host run (the math path), same weights and preprocessed input
    one = session._tensors(remove_past(batch, cfg.RECEPTIVE_FIELD))
    with torch.inference_mode():
        pb = session.preprocess(one, labels=False)
        before = read_launches()["K4"]
        card = session.model.encode_frame(pb)
        torch.cuda.synchronize()
        frame_k4 = read_launches()["K4"] - before
        t0 = time.perf_counter()
        host = host_model.encode_frame(
            {k: v.cpu() if torch.is_tensor(v) else v for k, v in pb.items()})
        host_s = time.perf_counter() - t0
    err = norm_rel(card, host)
    tokens = (cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1]) // 8 * (
        (cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0]) // 8) + (
        cfg.POINTS.CHANNELS // 8) * (cfg.POINTS.HORIZON_RESOLUTION // 8)
    emit({"phase": "serving_large", "config": "muvo.yml LARGE", "batch": 1,
          "sequence": seq, "tokens_per_frame": tokens,
          "deployment_tick_ms": deploy_ms, "sim_tick_ms": sim_ms,
          "sim_tick_ms_median": statistics.median(sim_ms),
          "deployment_tick_ms_median": statistics.median(deploy_ms),
          "peak_mib": peak_mib, "launches": launches,
          "launches_by_type": typed, "encodes": encodes,
          "K4_predicted": predicted_k4, "frame_K4_launches": frame_k4,
          "embedding_vs_host_norm_rel": err, "tol": DECODE_TOL,
          "host_encode_s": host_s})
    if launches["K4"] != predicted_k4 or frame_k4 != (
            cfg.MODEL.TRANSFORMER.N_LAYERS):
        raise AssertionError(f"K4: {launches['K4']} launches for {encodes} "
                             f"encodes (predicted {predicted_k4}), "
                             f"{frame_k4} for one frame")
    if launches["K5"] or launches["K6-dq"] or launches["K6-dkv"]:
        raise AssertionError(f"a backward kernel ran in serving: {launches}")
    if not err <= DECODE_TOL:
        raise AssertionError(f"card embedding differs from host: {err}")
    return typed


def training_large_phase(dev):
    """build_flagship_step(large=True): timed steps with K4 and K5 as
    predicted; then gradients of one step with the split backward (K6)
    against the fused one's (K5), each leaf within the bf16 tolerance plus
    NOISE_FACTOR x the fused gradient's own noise on it: the larger of its
    change between two runs (K5's dq sums by atomics, in an order that does
    not always change) and its change when the backward starts from a
    scaled loss (``seed_noise``), which draws every bf16 rounding of the
    backward anew whether the atomics repeat or not. A leaf whose gradient
    sums many bf16 terms (a first BatchNorm's bias) moves by a few 1e-2
    under either, as under the split backward."""
    from muvo_tpu_torch.training.flagship import (build_flagship_step,
                                                  set_flash_bwd)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fs = build_flagship_step(large=True, device=dev)
    launches = run_train_steps(fs, dev, "training_large", "muvo.yml LARGE")
    model = fs.trainer.state.model
    layers = fs.cfg.MODEL.TRANSFORMER.N_LAYERS

    def grads(bwd):
        set_flash_bwd(model, bwd)
        before = read_launches()
        t0 = time.perf_counter()
        _, g = fs.trainer.grads(fs.batch, stochastic=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counted = {k: v - before[k] for k, v in read_launches().items()}
        return ({k: v.detach().float().clone() for k, v in g.items()
                 if v is not None}, ms, counted)

    fused, fused_ms, _ = grads("fused")
    reset_launches()  # the split step's path
    split, split_ms, _ = grads("split")
    split_launches, split_typed = read_launches(), read_typed_launches()
    split2_ms = grads("split")[1]
    fused2, fused2_ms, _ = grads("fused")
    rerun = {k: norm_rel(fused2[k], g) for k, g in fused.items()}
    moved = seed_noise(fs.trainer, fs.batch, fused)
    noise = {k: max(rerun[k], moved[k]) for k in fused}
    rel = {k: norm_rel(split[k], g) for k, g in fused.items()}
    tol = FLASH_TOL[torch.bfloat16]
    limit = {k: tol + NOISE_FACTOR * noise[k] for k in rel}
    bad = {k: (rel[k], rerun[k], moved[k]) for k in rel
           if not rel[k] <= limit[k]}
    tightest = sorted(rel, key=lambda k: rel[k] / limit[k])[-5:]
    emit({"phase": "training_large_split", "launches": split_launches,
          "launches_by_type": split_typed,
          "grads_ms_fused": [fused_ms, fused2_ms],
          "grads_ms_split": [split_ms, split2_ms],
          "max_grad_norm_rel": max(rel.values()),
          "median_grad_norm_rel": statistics.median(rel.values()),
          "worst_grad": max(rel, key=rel.get),
          "fused_noise_median": statistics.median(noise.values()),
          "fused_noise_max": max(noise.values()),
          "fused_rerun_median": statistics.median(rerun.values()),
          "fused_rerun_max": max(rerun.values()),
          "fused_seed_noise_median": statistics.median(moved.values()),
          "fused_seed_noise_max": max(moved.values()),
          "tightest": {k: {"rel": rel[k], "rerun": rerun[k],
                           "seed": moved[k], "limit": limit[k]}
                       for k in tightest},
          "grad_leaves": len(rel), "tol": tol,
          "noise_factor": NOISE_FACTOR})
    if (split_launches["K6-dq"], split_launches["K6-dkv"],
            split_launches["K5"]) != (layers, layers, 0):
        raise AssertionError(f"the split step launched {split_launches}")
    if bad:
        raise AssertionError(f"split and fused gradients differ "
                             f"(rel, rerun, seed): {bad}")
    del fs, model, fused, fused2, split
    torch.cuda.empty_cache()
    return launches, split_typed


def measured_row(kid, dtype, results, backward, flash):
    """The row that the kernels line reports for ``kid`` in ``dtype``
    ("float32" or "bfloat16"): a voxel kernel at its MAIN_SHAPE stage (the
    forward ones at batch MAIN_BATCH, fp32 K2 at conv2.conv1), a flash
    kernel at the training case."""
    t = getattr(torch, dtype)
    if kid in ("K1", "K2"):
        stage = ("conv2.conv1" if (kid, dtype) == ("K2", "float32")
                 else MAIN_SHAPE[kid])
        return results[(kid, stage, MAIN_BATCH, t)]
    if kid in ZCONV_KERNELS:
        return backward[(kid, MAIN_SHAPE[kid], t)]
    return flash[(kid, "microbench" if kid == "K4-mb" else "training", t)]


def summary_row(kid, dtype, row, paths):
    """One entry of the kernels line: ``launches`` sums the main paths'
    counts of ``kid`` in ``dtype`` (``paths``: {path: {kernel: {type:
    launches}}}, each read from the counters just after its run)."""
    by_path = {name: counts[kid][dtype] for name, counts in paths.items()
               if counts.get(kid, {}).get(dtype)}
    shape = row.get("shape", row.get("input"))
    source = (F32_SOURCES.get(kid, SOURCES[kid]) if dtype == "float32"
              else SOURCES[kid])
    per_step = {cfg: paths[path].get(kid, {}).get(dtype, 0) // TRAIN_STEPS
                for cfg, path in (("muvo.yml", "training"),
                                  ("muvo.yml LARGE", "training_large"))}
    return {
        "name": KERNEL_NAMES[kid], "id": kid, "route": "cuda",
        "source": f"muvo_tpu_torch/csrc/{source}",
        "replaces": REPLACES[kid],
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_per_train_step": per_step,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": shape or [row["bh"], row["n"], row["d"]],
        "stage": row.get("stage", row.get("case")), "dtype": dtype,
    }


def kernel_entries(paths, results, backward, flash):
    """The kernels line: one entry for each kernel and type that a main
    path launched (``paths``: {path: {kernel: {type: launches}}}); raises
    if a kernel was launched on no main path."""
    kernels = [summary_row(kid, dtype,
                           measured_row(kid, dtype, results, backward, flash),
                           paths)
               for kid in KERNEL_NAMES for dtype in ("float32", "bfloat16")
               if any(counts.get(kid, {}).get(dtype)
                      for counts in paths.values())]
    idle = [kid for kid in KERNEL_NAMES
            if not any(k["id"] == kid for k in kernels)]
    if idle:
        raise AssertionError(f"not launched on any main path: {idle}")
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a "
              "GPU", file=sys.stderr)
        return 2
    from muvo_tpu_torch.ops._build import build_all, build_log

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built,
          "ptxas": [ln.strip()
                    for name in ("zconv", "zconv_f32", "zconv_dw",
                                 "zconv_dw_tc", "flash_attention")
                    for ln in build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln or "Performance Loss" in ln]})

    results = kernel_phase(dev)
    backward = backward_kernel_phase(dev)
    flash = flash_kernel_phase(dev)
    paths = {"serving": serving_phase(dev, muvo_cfg()),
             "training": training_phase(dev),
             "serving_large": serving_large_phase(dev)}
    paths["training_large"], paths["training_large_split"] = (
        training_large_phase(dev))
    paths["microbench"] = microbench_phase()

    emit({"kernels": kernel_entries(paths, results, backward, flash)})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
