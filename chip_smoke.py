#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [PHASE ...]

Phases, each printing JSON lines; a failed phase raises and the script
exits nonzero (there is no CPU fallback). With no arguments every phase
below runs, on one card. Named phases (PHASES, e.g. ``health
profile_step``) run alone, in this order, after the device and build
phases; a phase on train_entry's drive (ON_ENTRY_DRIVE) brings
train_entry with it, and ``train_ddp_all`` (train_ddp with a rank on each
visible card, NCCL) runs only when named. A run of named phases prints no
kernels line, and its last line names the phases.

1. device: the card's name and nvidia-smi's name and power limit.
2. build: compiles muvo_tpu_torch/csrc/*.cu (one nvcc each, in parallel).
3. kernels: K1 (zconv3d_leaky) and K2 (upzconv3d_leaky) at the voxel
   decoder's four serving shapes, batch 1 and 5, fp32 and bf16: each is held
   against its plain PyTorch version on the card (TF32 off), and timed beside
   the plain version, one library call and the bound. In bf16 both are the
   tensor-core kernel (zconv_tc_kernel): K2 on the small-z grid, K1 on the
   view zconv.k1_route picks (z pairs folded into channels at conv3.conv2);
   fp32 K1 and K2 are the register-tiled f32conv::zconv_f32_kernel and
   zconv_up_f32_kernel (zconv_f32.cu). Each row names the kernel that ran
   in ``impl``; a bf16 row must name the tensor-core kernel, an fp32 K1
   row zconv_f32_kernel, an fp32 K2 row zconv_up_f32_kernel, and for each
   a second launch must give the same bits. Then K1 and K2 as the eval
   step calls them (no autograd, inside bf16 autocast, fp32 activations,
   weights and bias that the wrapper casts and folds itself) at the
   observation decode's batch (4) and their main stages, and at the
   imagination decode's batch (2) at every stage, held against the plain
   version on the bf16-cast inputs.
4. backward_kernels: K1-dx, K2-dx, K3 and K3-up at the four training shapes
   (batch 24 = 4 sequences of 6 frames), bf16 and fp32, held against their
   plain versions and timed beside them, one library call
   (aten.convolution_backward) and the bound. bf16 K1-dx is
   zconv_tc_kernel on K1's view, bf16 K2-dx zconv_tc_kernel with the
   adjoint fold; fp32 K1-dx and K2-dx are fp32 K1's register-tiled walk
   on the masked cotangent, f32conv::zconv_dx_f32_kernel and (on the
   small-z view with the adjoint fold) zconv_dxup_f32_kernel
   (zconv_f32.cu); bf16 K3 and K3-up are tc::dw_tc_kernel
   (zconv_dw_tc.cu), fp32 ones the register-tiled f32dw::dw_f32_kernel
   (zconv_dw.cu, its plane staging shared with zconv_f32.cu); each row
   names its kernel in ``impl``. A dx row must name the tensor-core kernel
   (bf16) or its fp32 kernel, and every dW row the kernel zconv.DW_IMPL
   gives its type; a second launch of every dx and dW kernel must give the
   same bits.
5. flash_kernels: K4 (flash forward), K5 (fused backward), K6-dq and K6-dkv
   (split backward) at the LARGE training shape (bh 48 = 8 heads x 6
   frames, n 5184, d 48), at d 32, at a ragged n, with seq_len < n and at
   n and seq_len just past a 128-row tile, fp32
   (TF32 off) and bf16, each held against its plain version and timed
   beside it (FLASH_ITERS launches), one library call
   (scaled_dot_product_attention, or its backward alone) and the bound;
   K4-mb (the microbenchmark's kernel) once. K5 in every case named in
   ``last_impl`` as the dispatch picks it (fp32: the register-tiled
   fp32::flash_bwd_kv_f32<D, true>). K6 in every case: each kernel
   named in ``last_impl`` as the dispatch picks it (bf16: the hopper
   kernels, flash_bwd_dq_wgmma and flash_bwd_wgmma<D, false>; fp32: the
   register-tiled fp32::flash_bwd_q_f32<D> and flash_bwd_kv_f32<D,
   false>), the same bits on a second launch; in bf16 K6-dkv's dk and dv equal to K5's (one
   kernel, the same products in the same order) and K6-dq's dq reported
   against K5's; in fp32 K6's outputs and K5's dk, dv equal to the plain
   version's.
6. serving: muvo.yml at full width with seeded random weights, driven
   through DeploymentSession (deployment_forward, then sim_forward with a
   5-step imagination); K1 and K2 must be launched (on zconv_f32_kernel
   and zconv_up_f32_kernel) and K4 not (648 tokens a frame), outputs must be
   finite with muvo_tpu's shapes, and one decode on the card must match the
   same decode run by the port on the host CPU.
7. training: build_flagship_step (muvo.yml at full width, 4 x 6 frames, bf16
   autocast, decoder remat, AdamW + OneCycle), 3 warm-up steps, then timed
   steps; every kernel's launches must rise by what the model predicts and
   every loss must be finite. Then one fp32 train step at tiny_test_cfg
   (voxel 64^3: conv2 and conv3 take the kernels) on the card against the
   same step on the host CPU, same weights and batch, no sampling noise or
   dropout.
8. train_entry: ``python -m muvo_tpu_torch.train``'s ``main`` on a
   recorded drive written at muvo.yml's sizes (24 frames of 600x960 RGB,
   60,000 LiDAR points and 192x192x64 voxel rows each, and a val0 drive):
   muvo.yml as it is (batch 1, ACCUMULATE_GRAD_BATCHES 16, bf16, remat
   off), 18 steps with one optimizer update, validation and a checkpoint
   at 16, then a second run resumed from that checkpoint (restored bit for
   bit on the card) to step 20. Every logged loss finite; bf16 K1, K2,
   K1-dx, K2-dx, K3 and K3-up launched as predicted in the training and
   the validation steps; no flash kernel. Step ms, frames/s, peak MiB and
   the checkpoints' seconds. The validation logs the panels of its first
   batch (those whose package is installed, by importlib's find_spec).
9. prediction: ``python -m muvo_tpu_torch.prediction``'s ``main`` on that
   drive, restoring the step-16 checkpoint: the three test samplers, one
   batch each, observed once and imagined PREDICTION.N_SAMPLES (1) times,
   bf16; then ``python -m muvo_tpu_torch.sim_run``'s ``main`` over the
   drive's 12 sequences (fp32 serving). Every metric finite; bf16 K1 and
   K2 launched 4 times a test batch, fp32 K1 and K2 4 times a sim_run
   step, nothing else; the card's metric suite against the host's on the
   same outputs, labels and LiDAR columns (confusion matrices and SSC
   counts equal, SSIM, PSNR and Chamfer within 1e-4). The metrics, the
   median ms of observe_step, imagine_step and MetricSuite.update, test
   batches a second, peak MiB, the panels drawn and the packages found.
10. train_heads: ``main`` again on that drive (its integer BEV PNGs and
   depth-semantic PNGs), muvo.yml with the BEV decoder and its instance
   heads, the LiDAR segmentation, semantic-image and depth decoders, the
   RGB instance loss, EVAL.MASK_VIEW and PointPillars on 60,000 points a
   frame: 10 steps (batch 1, bf16, remat off) with one validation. Every
   logged loss finite and each new term logged at the three scales; bf16
   K1, K2, K1-dx, K2-dx, K3 and K3-up launched as predicted; the trained
   PointPillarNet on the drive's first frame, card against host in fp32
   within 1e-5. Step ms, frames/s, host ms between steps, peak MiB, and
   the loader's decode ms a frame beside muvo.yml's.
11. train_lifting: ``main`` again on that drive with the default config
   (the MILE branch: frustum lifting, backbone_bev, LiDAR and the RSSM;
   batch 3 of RF 1 + FH 1, bf16) for 8 steps, then one_frame.yml (no
   RSSM, batch 8 of 1 frame) for 4, each validating once, as users run
   them but for the data root, the log dir, the length and the intervals.
   Every logged loss finite, the KL term only with the RSSM; bf16 K1, K2,
   K1-dx, K2-dx, K3 and K3-up launched as predicted (the default config's
   256 voxel channels put conv3 alone on the kernels, as muvo_tpu's
   Pallas path); the trained model's FrustumPooling on the drive's first
   frame, card against host in fp32, within 1e-5. Step ms, frames/s, host
   ms between steps, pooling ms, peak MiB.
12. train_options: (a) the flagship step of phase 7 with muvo.yml's other
   options (MODEL.MEASUREMENTS, resnet34 camera and LiDAR trunks) on a
   batch that carries the measurement keys: 3 warm-up steps, timed steps,
   every loss finite, the six voxel kernels launched as predicted. (b)
   ``main`` on the drive with POINTS.DEVICE_PROJECTION (muvo.yml as users
   run it: batch 1 x 6, bf16) for 8 steps with one validation: the loader
   ships the raw points, PreProcess projects them on the card. Losses
   finite; bf16 K1, K2, K1-dx, K2-dx, K3 and K3-up 2 each a step; step
   ms and host ms between steps beside train_entry's; the projection's
   CUDA-event ms, and its range view against the host projection
   (float64) of the same points, under 1% of the pixels apart.
13. serving_mobilevit: test_mobilevit_2d.yml (MobileViTV2 camera and
   LiDAR trunks) at full width through DeploymentSession, fp32: fp32 K1
   and K2 4 launches each a sim tick, K4 none, outputs finite with
   muvo_tpu's shapes, one frame's embedding and one decode on the card
   against the port's host run within 1e-3. Tick ms and peak MiB.
14. serving_lifting: through DeploymentSession at full width, fp32:
   muvo.yml with MODEL.TRANSFORMER.BEV (40 x 104 stride-8 features lifted
   over 37 depth bins onto the 48 x 48 grid, 12 x 12 image tokens), then
   the default config (the MILE branch with the BEV, lidar_re,
   lidar_segmentation and 192x192x64 voxel decoders). fp32 K1 and K2
   launched as predicted a sim tick (fp32 K2 in four Cout slices at the
   default config's conv3.conv1), nothing else; outputs finite with
   muvo_tpu's shapes; one frame's embedding and one decode against the
   host run within 1e-3, and that frame's FrustumPooling within 1e-5.
   Tick ms, pooling ms (CUDA events) and peak MiB.
15. serving_options: as serving_mobilevit, muvo.yml with MODEL.MEASUREMENTS
   and resnet34 camera and LiDAR trunks, then muvo.yml with
   EVAL.RESOLUTION FACTOR 2 (the encoders see the half-sized frames, the
   decoders keep the crop's size); then TriPlaneVoxelDecoder (3 scales,
   48 x 48 x 16 planes of 64 channels, 512 classifier channels) on the
   card against the host within 1e-4, timed with CUDA events.
16. serving_large: muvo.yml with MODEL.TRANSFORMER.LARGE (stride-8 features,
   5,184 fusion tokens a frame) through DeploymentSession, fp32: K4 must be
   launched once a layer for each encode, outputs must be finite with
   muvo_tpu's shapes, and one frame's embedding on the card must match the
   port's host run (the math attention path).
17. training_large: build_flagship_step(large=True) (1 x 6 frames, bf16),
   3 warm-up steps, then timed steps with K4 and K5 launched once a layer a
   step; then gradients with the split backward (K6, not K5) against the
   fused backward's, each leaf within 2e-2 plus 8x the fused gradient's
   own noise (its change on a rerun, or from a scaled loss, the larger).
   tools/torch_large_grad_check.py repeats this phase alone.
18. microbench: tools/torch_flash_microbench.py, K4-mb and K4 at bh 16.
19. train_ddp (after train_options, on train_entry's drive): two ranks
   on the one card under gloo, each a spawned process joining the group
   as torchrun starts it (muvo_tpu_torch/parallel/mesh.py). muvo.yml's
   step without noise on one sequence each, in bf16 and in fp32, the
   gradients averaged over the ranks, against one process's step at batch
   2 from the same weights (losses; each gradient leaf within its
   tolerance plus 8x the one process's own noise); then ``train.main``
   under both ranks (global batch 2, ACCUMULATE_GRAD_BATCHES 2, 4 steps):
   the ranks' parameters bit-equal, one checkpoint by rank 0 with
   world_size 2, bf16 K1, K2, K1-dx, K2-dx, K3 and K3-up launched as
   predicted on each rank (the path train_ddp of the kernels line).
   Each rank's step ms and peak MiB, the all-reduce ms.
20. train_rl: the PPO expert (XtMaCNN, beta) on the kinematic
   env's 15 x 192 x 192 birdview, fp32: one 512-step rollout, the
   deterministic forward and one update card against host within 1e-5,
   then one epoch of 256-sample minibatches. Rollout frames/s, update ms.
21. pipeline (last): collect -> voxelise -> train -> drive at muvo.yml's
   full width through the port's entry points, on the kinematic env
   (600 x 960 RGB and depth, 60,000 LiDAR points, a 192 x 192 birdview):
   (a) the untrained expert on the card records a 26-frame train and a
   23-frame val0 episode with ``data_collect.run_episode`` and the port's
   DataWriter, each asserted valid (frames/s, the writer's save s); (b)
   ``tools.generate_voxels.process_run`` at 192x192x64, one frame's rows
   equal to the plain numpy functions run inline (s a frame); (c)
   ``train.main`` on the drive, muvo.yml as users run it (batch 1, bf16,
   remat off), 4 steps with one validation and one checkpoint: losses
   finite, bf16 K1, K2, K1-dx, K2-dx, K3 and K3-up as predicted (the
   path pipeline_train); (d) ``evaluate.build_agent`` on that checkpoint
   and ``evaluate.run_episode`` for 30 ticks observed and 30 dreaming,
   each tick's fp32 K1 and K2 as predicted for its one decode, K4 not,
   controls finite and in range (the path closed_loop), then 10 ticks
   under torch.profiler (the device's idle share) and the last tick's
   decode card against host within 1e-3. Tick ms (median, p90), the
   agent's host ms (``_obs_to_frame``) and the rest, peak MiB.

22. health (after pipeline): the training-health run of
   muvo_tpu_torch/tools/health_run.py at muvo.yml's full width and full
   frames, cut to a smoke test: one training and one held-out episode of 24
   steps collected with the scripted driver (600 x 960, 30,000 points),
   voxelised, the random-init weights and the constant prediction evaluated
   on one held-out batch of 2 (the constant one launching no kernel),
   ``train.main`` for 4 steps at batch 2 (ACCUMULATE_GRAD_BATCHES 1,
   decoder remat) with a checkpoint, that checkpoint evaluated. Metrics and
   losses finite, the restored step right; bf16 K1, K2, K1-dx, K2-dx, K3
   and K3-up launched as predicted in training (the path health_train), K1
   and K2 in the evaluations (health_evaluate). Frames/s, the writer's save
   s, voxel s a frame, step ms, peak MiB, both evaluations' metrics.
23. profile_step: muvo_tpu_torch/tools/profile_step.py's run_and_trace
   on the flagship step (2 warm steps, 3 traced with a record_function
   range around every submodule): every port kernel in the trace
   attributed to a MuvoWorldModel/voxel_decoder/... scope, the device
   time that no scope claims (the [unattributed] and [backward] buckets)
   under UNSCOPED_SHARE of the step's and the world model's scopes at
   least MODEL_SHARE, the six bf16 voxel kernels launched as predicted
   (the path profile_step); the top 10 scopes at depth 3 in ms a step.

Each main path's launch counts are set to 0 just before it runs and read
just after; each wrapper counts its launches by the tensors' type. The
kernels line has one entry for each kernel and type that a main path
launched, with that type's counts by path, and every kernel must have been
launched on some main path.
The last three lines are the kernels summary, nvidia-smi's name and power
limit, and {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
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


def default_shapes():
    """SHAPES' rows for the default config's kernel-path convs (256 voxel
    feature channels: conv3 alone, its K2 and K2-dx in slices), read from
    its decoder (voxel_kernel_convs), each stage named "default ..."."""
    return tuple((kid, f"default {stage}", (x, y, zin, c), cout)
                 for kid, stage, x, y, zin, c, cout
                 in voxel_kernel_convs(config()))


def train_batch(cfg) -> int:
    """Frames the voxel decoder decodes in one train step of ``cfg``."""
    return cfg.BATCHSIZE * (cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)


# the stage each voxel kernel's kernels-line entry reports (fp32 K2 at
# conv2.conv1, where its kernel has the least room)
MAIN_SHAPE = {"K1": "conv3.conv2", "K2": "conv3.conv1", "K1-dx": "conv3.conv2",
              "K2-dx": "conv3.conv1", "K3": "conv3.conv2",
              "K3-up": "conv3.conv1"}
MAIN_BATCH = 5  # the imagination rollout decodes 5 states at once
TRAIN_BATCH = 24  # the flagship train step decodes 4 x 6 frames
TRAIN_STEPS = 5   # timed flagship steps
# train_entry: a first run of 18 steps, saved at 16 (VAL_CHECK_INTERVAL),
# resumed from there to 20
TRAIN_ENTRY_STEPS, RESUME_STEP, RESUME_STEPS = 18, 16, 20
# the backward kernels by the forward kernel they differentiate
BACKWARD = {"K1": ("K1-dx", "K3"), "K2": ("K2-dx", "K3-up")}
ZCONV_KERNELS = ("K1", "K2", "K1-dx", "K2-dx", "K3", "K3-up")
KERNEL_NAMES = {"K1": "zconv3d_leaky", "K2": "upzconv3d_leaky",
                "K1-dx": "zconv3d_dx", "K2-dx": "upzconv3d_dx",
                "K3": "zconv3d_dw", "K3-up": "upzconv3d_dw",
                "K4": "flash_fwd", "K5": "flash_bwd", "K6-dq": "flash_bwd_dq",
                "K6-dkv": "flash_bwd_dkv", "K4-mb": "flash_matmul"}
# each kernel's source; where fp32 has its own, in F32_SOURCES (fp32 K1,
# K2, K1-dx, K2-dx, K3 and K3-up: the register-tiled CUDA-core kernels,
# whose plane staging is csrc/zconv_stage.cuh's)
SOURCES = {"K1": "zconv.cu", "K2": "zconv.cu", "K1-dx": "zconv.cu",
           "K2-dx": "zconv.cu", "K3": "zconv_dw_tc.cu",
           "K3-up": "zconv_dw_tc.cu",
           "K4": "flash_attention.cu", "K5": "flash_attention.cu",
           "K6-dq": "flash_attention.cu", "K6-dkv": "flash_attention.cu",
           "K4-mb": "flash_attention.cu"}
F32_SOURCES = {"K1": "zconv_f32.cu", "K2": "zconv_f32.cu",
               "K1-dx": "zconv_f32.cu", "K2-dx": "zconv_f32.cu",
               "K3": "zconv_dw.cu", "K3-up": "zconv_dw.cu"}
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
    for kid, stage, shape, cout in SHAPES + default_shapes():
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
                            else zconv.K2_F32_IMPL if up
                            else zconv.K1_F32_IMPL)
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
                    "impl": impl, "repeat_equal": True,
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
    autocast_rows(dev, gen, fns)
    return results


def autocast_rows(dev, gen, fns):
    """K1 and K2 as the eval step calls them: no autograd, inside bf16
    autocast, on fp32 activations, weights and bias (the wrapper casts
    them and folds the weights itself), at the observation decode's batch
    (muvo.yml's BATCHSIZE x RECEPTIVE_FIELD) at the MAIN_SHAPE stages, and
    at the imagination decode's batch (BATCHSIZE x FUTURE_HORIZON) at
    every stage; at the default config's stages at its observation and
    imagination decodes' batch (3) and one_frame.yml's (8); each held
    against its plain version on the bf16-cast inputs."""
    cfg = muvo_cfg()
    observe_b = cfg.BATCHSIZE * cfg.RECEPTIVE_FIELD
    imagine_b = cfg.BATCHSIZE * cfg.FUTURE_HORIZON
    rows = [(observe_b, case) for case in SHAPES
            if MAIN_SHAPE[case[0]] == case[1]]
    rows += [(imagine_b, case) for case in SHAPES]
    for yml in (None, "one_frame.yml"):
        lcfg = config(yml)
        rows += [(lcfg.BATCHSIZE * lcfg.RECEPTIVE_FIELD, case)
                 for case in default_shapes()]
    for b, (kid, stage, shape, cout) in rows:
        kernel, plain = fns[kid]
        c = shape[-1]
        x = torch.randn((b, *shape), generator=gen, device=dev)
        w = torch.randn((cout, c, 3, 3, 3), generator=gen, device=dev) / (
            27 * c) ** 0.5
        bias = torch.randn((cout,), generator=gen, device=dev)
        with torch.no_grad():
            with torch.autocast("cuda", torch.bfloat16):
                out = kernel(x, w, bias, 0.2)
                impl = kernel.last_impl
                again = kernel(x, w, bias, 0.2)
            what = f"{kid} {stage} B={b} fp32 under bf16 autocast"
            require_kernel(what, impl, TC_IMPL, out, again)
            if out.dtype != torch.bfloat16:
                raise AssertionError(f"{what}: output is {out.dtype}")
            ref = plain(x.bfloat16(), w.bfloat16(), bias.bfloat16(), 0.2)
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
        emit({"phase": "kernel_autocast", "kernel": kid, "stage": stage,
              "shape": [b, *shape], "cout": cout, "dtype": "float32",
              "autocast": "bfloat16", "impl": impl, "repeat_equal": True,
              "max_abs_err": err, "rel_err": rel, "tol": BF16_TOL})
        if not (rel <= BF16_TOL):
            raise AssertionError(f"{what}: relative error {rel} > "
                                 f"{BF16_TOL}")
        del x, w, bias, out, again, ref


def backward_kernel_phase(dev):
    """K1-dx, K2-dx, K3 and K3-up at the training shapes, against their
    plain versions on the same inputs: muvo.yml's stages at the flagship
    step's TRAIN_BATCH, the default config's at its own step's frames."""
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import zconv

    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    cases = [(*case, TRAIN_BATCH) for case in SHAPES]
    cases += [(*case, train_batch(config())) for case in default_shapes()]
    for fwd, stage, shape, cout, batch in cases:
        up = fwd == "K2"
        dx_id, dw_id = BACKWARD[fwd]
        c = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((batch, *shape), generator=gen,
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
                require_kernel(f"{dx_id} {stage} {dtype}", dx_impl,
                               TC_IMPL if dtype == torch.bfloat16
                               else zconv.K2_DX_F32_IMPL if up
                               else zconv.K1_DX_F32_IMPL,
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
                require_kernel(f"{dw_id} {stage} {dtype}", impl,
                               zconv.DW_IMPL[dtype], dw, dw2)
                if not torch.equal(db, db2):
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
                        "stage": stage, "input": [batch, *shape],
                        "cotangent": list(out.shape),
                        "dtype": str(dtype).replace("torch.", ""),
                        "impl": impl,  # the kernel (and view) that ran
                        "repeat_equal": True,  # checked above
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


def voxel_kernel_convs(cfg):
    """The voxel decoder's convs on the kernel path, in order, for one
    decode: [(kernel, stage, X, Y, Zin, C, Cout)], the shapes of one
    sample, read from the decoder the config builds (on the meta device,
    which holds no data): each block, in the order the decoder registers
    and runs them, doubles its input's size, and one that
    stylegan.kernel_stage puts on the kernels runs conv1 as K2 and conv2
    as K1 (conv2 and conv3 with muvo.yml's 64 feature channels, conv3 with
    the default config's 256)."""
    from muvo_tpu_torch.models.stylegan import DecoderBlock, kernel_stage
    from muvo_tpu_torch.models.world_model import MuvoWorldModel

    if not cfg.VOXEL_SEG.ENABLED:
        return []
    with torch.device("meta"):
        decoder = MuvoWorldModel(cfg).voxel_decoder
    x, y, z = decoder.constant_tensor.shape[1:]
    convs = []
    for name, block in decoder.named_modules():
        if not isinstance(block, DecoderBlock):
            continue
        cout, c = block.conv1.conv_act[0].weight.shape[:2]
        if kernel_stage(z, c, cout):
            convs += [("K2", f"{name}.conv1", 2 * x, 2 * y, z, c, cout),
                      ("K1", f"{name}.conv2", 2 * x, 2 * y, 2 * z, cout,
                       cout)]
        x, y, z = 2 * x, 2 * y, 2 * z
    return convs


def predicted_launches(cfg, smem_optin=None):
    """bf16 kernel launches per train step the model's code predicts: each
    kernel-path conv (voxel_kernel_convs) runs its forward kernel, twice
    with the voxel decoder rematerialised, and its dx and dW kernels once,
    each forward and dx kernel once for each slice zconv.channel_slices
    gives it on this card's shared memory (``smem_optin``, read from the
    card if None); on the LARGE path (5,184 tokens, flash from 2048) each
    transformer layer runs K4 once and K5 once (the transformer is outside
    every checkpoint)."""
    from muvo_tpu_torch.ops import zconv

    counts = dict.fromkeys(("K1", "K2", "K1-dx", "K2-dx", "K3", "K3-up"), 0)
    for kid, _, _, _, zin, c, cout in voxel_kernel_convs(cfg):
        if smem_optin is None:
            smem_optin = zconv._f32_limits(0)[1]
        for k in (kid, kid + "-dx"):
            counts[k] += len(zconv.channel_slices(k, torch.bfloat16, zin, c,
                                                  cout, smem_optin))
        counts["K3-up" if kid == "K2" else "K3"] += 1
    fwd = 2 if cfg.MODEL.REMAT else 1
    counts["K1"] *= fwd
    counts["K2"] *= fwd
    layers = cfg.MODEL.TRANSFORMER.N_LAYERS if (
        cfg.MODEL.TRANSFORMER.ENABLED and cfg.MODEL.TRANSFORMER.LARGE) else 0
    return {**counts, "K4": layers, "K5": layers, "K6-dq": 0, "K6-dkv": 0,
            "K4-mb": 0}


def predicted_eval_launches(cfg, smem_optin=None):
    """bf16 kernel launches per eval step: the observation's decode and,
    where the model imagines (the RSSM and a horizon), the imagination's
    decode run the forward kernels of each kernel-path conv (K2 in its
    slices), never rematerialised."""
    per_step = predicted_launches(cfg, smem_optin)
    fwd = 2 if cfg.MODEL.REMAT else 1
    decodes = 2 if (cfg.MODEL.TRANSITION.ENABLED
                    and cfg.FUTURE_HORIZON > 0) else 1
    return {kid: per_step[kid] // fwd * decodes if kid in ("K1", "K2")
            else 0 for kid in KERNEL_NAMES}


def predicted_fp32_decode_launches(cfg, dev):
    """fp32 K1 and K2 launches of one decode on the card: each kernel-path
    conv launches once for each slice of Cout its weights need
    (zconv.channel_slices on this card's shared memory)."""
    from muvo_tpu_torch.ops import zconv

    optin = zconv._f32_limits(dev.index or 0)[1]
    counts = {"K1": 0, "K2": 0}
    for kid, _, _, _, zin, c, cout in voxel_kernel_convs(cfg):
        counts[kid] += len(zconv.channel_slices(kid, torch.float32, zin, c,
                                                cout, optin))
    return counts


def norm_rel(got, want):
    """|got - want| / |want| in float64 (inf where only want is zero), on
    ``want``'s device (a host copy of the card's leaves costs seconds a
    model)."""
    want = want.detach().double()
    got = got.detach().to(want.device, torch.float64)
    num, den = (got - want).norm().item(), want.norm().item()
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


def host_noise(trainer, batch, grads):
    """Per leaf, the largest norm-relative change of ``trainer``'s gradient
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
                        p.shape, generator=gen).to(p.device)))
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


BEV_CLASSES = 8  # background, road, lane markings, vehicle, pedestrian,
                 # green, yellow and red light (dataset_utils' stack)


def birdview_masks(rs, bev_h: int, bev_w: int):
    """One frame's BEV_CLASSES binary masks (C, h, w) with a road, lane
    markings on it, a few dozen vehicles and pedestrians (separate boxes,
    so the instance labels count more than 32 in some frames) and a light,
    background where nothing else is."""
    import numpy as np

    masks = np.zeros((BEV_CLASSES, bev_h, bev_w), np.uint8)
    masks[1, :, bev_w // 3:2 * bev_w // 3] = 1
    masks[2, ::8, bev_w // 2 - 1:bev_w // 2 + 1] = 1
    for cls, count, size in ((3, rs.randint(10, 40), 8), (4, 12, 3)):
        for _ in range(count):
            y, x = rs.randint(0, bev_h - size), rs.randint(0, bev_w - size)
            masks[cls, y:y + size, x:x + size - 2] = 1
    masks[5 + rs.randint(3), 4:8, 4:8] = 1
    masks[0] = masks[1:].sum(0) == 0
    return masks


def depth_semantic_frame(rs, h: int, w: int):
    """One frame of CARLA's depth-semantic camera (h, w, 4) uint8: depth
    in [0, 1] coded in 24 bits (R * 65536 + G * 256 + B over 2^24 - 1;
    sky past 0.999) over rows, and the tag channel in blocks of CARLA's
    tags 0..22 (vehicles 10 and pedestrians 4 among them)."""
    import numpy as np

    depth = np.linspace(1.0, 0.002, h)[:, None] * rs.uniform(0.5, 1.0, w)
    depth[: h // 6] = 1.0
    code = np.round(depth * (256 ** 3 - 1)).astype(np.int64)
    frame = np.empty((h, w, 4), np.uint8)
    frame[..., 0] = code // 65536
    frame[..., 1] = code // 256 % 256
    frame[..., 2] = code % 256
    tags = rs.randint(0, 23, (h // 20 + 1, w // 20 + 1))
    frame[..., 3] = np.kron(tags, np.ones((20, 20), np.int64))[:h, :w]
    return frame


def record_drive(run_dir: Path, cfg, n_frames: int, seed: int) -> int:
    """A recorded drive at ``cfg``'s sizes in the CARLA dataset's layout
    (muvo_tpu_torch/data/dataset.py's module docstring), written with PIL
    and pandas from a numpy seed: RGB PNGs of IMAGE.SIZE, route-map PNGs,
    the bit-packed integer BEV PNGs of BEV.SIZE (BEV_CLASSES bits), the
    depth-semantic PNGs of IMAGE.SIZE, POINTS.N_PER_SECOND / CARLA_FPS
    semantic LiDAR points a frame inside the sensor's field of view,
    sparse voxel rows (x, y, z, tag) on VOXEL.SIZE (a ground plane and
    scattered cells), and the actions, speed, a reward of at least 0.6 and
    the value. Returns the bytes written."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    from muvo_tpu_torch.data.dataset_utils import binary_to_integer

    rs = np.random.RandomState(seed)
    h, w = cfg.IMAGE.SIZE
    bev_w, bev_h = cfg.BEV.SIZE
    n_points = int(cfg.POINTS.N_PER_SECOND / 10)  # CARLA_FPS
    vx, vy, vz = cfg.VOXEL.SIZE
    down, up = (math.radians(a) for a in cfg.POINTS.FOV)
    files = (("image", "png"), ("routemap", "png"), ("birdview", "png"),
             ("depth_semantic", "png"), ("points_semantic", "npy"),
             ("voxel", "npy"))
    for sub, _ in files:
        (run_dir / sub).mkdir(parents=True, exist_ok=True)
    rows = []
    for t in range(n_frames):
        row = {k: f"{k}/{k}_{t:09d}.{ext}" for k, ext in files}
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            run_dir / row["image"])
        masks = birdview_masks(rs, bev_h, bev_w)
        packed = binary_to_integer(masks.reshape(BEV_CLASSES, -1).T,
                                   BEV_CLASSES).reshape(bev_h, bev_w)
        # 16-bit grayscale: PNG's integer mode that Pillow keeps saving
        Image.fromarray(packed.astype(np.uint16)).save(
            run_dir / row["birdview"])
        Image.fromarray(depth_semantic_frame(rs, h, w)).save(
            run_dir / row["depth_semantic"])
        route = np.zeros((192, 192), np.uint8)
        route[rs.randint(40, 90):150, 90:102] = 255
        Image.fromarray(route, mode="L").save(run_dir / row["routemap"])
        azimuth = rs.uniform(-math.pi, math.pi, n_points)
        elevation = rs.uniform(down, up, n_points)
        rng = rs.uniform(2.0, 60.0, n_points)
        xyz = np.stack([rng * np.cos(elevation) * np.cos(azimuth),
                        rng * np.cos(elevation) * np.sin(azimuth),
                        rng * np.sin(elevation)], -1).astype(np.float32)
        np.save(run_dir / row["points_semantic"],
                {"points_xyz": xyz,
                 "ObjTag": rs.randint(0, 23, n_points).astype(np.uint8)})
        ground = np.stack(np.meshgrid(np.arange(vx), np.arange(vy),
                                      indexing="ij"), -1).reshape(-1, 2)
        scattered = rs.randint(0, [vx, vy, vz], (20000, 3))
        cells = np.concatenate([np.c_[ground, np.full(len(ground), 10)],
                                scattered])
        tags = rs.choice(np.r_[np.arange(23), 255], len(cells))
        np.save(run_dir / row["voxel"],
                np.c_[cells, tags].astype(np.uint16))
        throttle = rs.uniform(-0.5, 1.0)
        rows.append({**{f"{k}_path": v for k, v in row.items()},
                     "n_classes": BEV_CLASSES,
                     "action": np.array([max(throttle, 0.0),
                                         rs.uniform(-1, 1),
                                         max(-throttle, 0.0)], np.float32),
                     "speed": np.array([rs.uniform(0, 10)], np.float32),
                     "reward": rs.uniform(0.6, 1.0),
                     "value": np.array([rs.uniform(-1, 1)], np.float32)})
    pd.DataFrame(rows).to_pickle(run_dir / "pd_dataframe.pkl")
    return sum(f.stat().st_size for f in run_dir.rglob("*") if f.is_file())


def _tree_diff(got, want, path=""):
    """Paths where ``got`` (tensors anywhere) and ``want`` (host tensors)
    differ in structure, dtype or bits."""
    if torch.is_tensor(want):
        if not (torch.is_tensor(got) and got.dtype == want.dtype
                and torch.equal(got.detach().cpu(), want)):
            return [path]
        return []
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path + " (keys)"]
        return [d for k in want for d in _tree_diff(got[k], want[k],
                                                     f"{path}.{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [path + " (length)"]
        return [d for i, (g, v) in enumerate(zip(got, want))
                for d in _tree_diff(g, v, f"{path}[{i}]")]
    return [] if got == want else [path]


@contextlib.contextmanager
def instrumented_train_loop(dev):
    """Wraps what muvo_tpu_torch.train calls: each train and eval step is
    timed on the host clock ending in a synchronize, with the host time
    between two train steps (loader, copies, logging, validation,
    checkpoints); the eval steps' kernel launches are counted apart; each
    checkpoint save and restore is timed, and every restored state is held
    to the checkpoint it came from, bit for bit: the model's parameters and
    buffers, AdamW's moments, the accumulated gradients and counts; the
    names of the validation's logged panels are kept."""
    from muvo_tpu_torch.training.checkpoint import (CheckpointManager,
                                                    strip_prefix)
    from muvo_tpu_torch.training.logging import MetricsLogger
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    rec = {"train_ms": [], "gap_ms": [], "eval_ms": [], "save_s": [],
           "restore_s": [], "restored": [], "val_launches": {},
           "panels": []}
    originals = (WorldModelTrainer.train_step, WorldModelTrainer.eval_step,
                 CheckpointManager.save, CheckpointManager.restore,
                 MetricsLogger.log_image, MetricsLogger.log_video)
    train_step, eval_step, save, restore, log_image, log_video = originals
    last_end = []

    def sync():
        torch.cuda.synchronize(dev)

    def timed_train_step(self, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        if last_end:
            rec["gap_ms"].append((t0 - last_end.pop()) * 1e3)
        out = train_step(self, *args, **kwargs)
        sync()
        last_end.append(time.perf_counter())
        rec["train_ms"].append((last_end[0] - t0) * 1e3)
        return out

    def counted_eval_step(self, *args, **kwargs):
        before = read_typed_launches()
        sync()
        t0 = time.perf_counter()
        out = eval_step(self, *args, **kwargs)
        sync()
        rec["eval_ms"].append((time.perf_counter() - t0) * 1e3)
        for kid, types in read_typed_launches().items():
            for dtype, n in types.items():
                n -= before.get(kid, {}).get(dtype, 0)
                if n:
                    counts = rec["val_launches"].setdefault(kid, {})
                    counts[dtype] = counts.get(dtype, 0) + n
        return out

    def timed_save(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = save(self, *args, **kwargs)
        rec["save_s"].append(time.perf_counter() - t0)
        rec["ckpt_mib"] = Path(out).stat().st_size / 2 ** 20
        return out

    def checked_restore(self, step=None, state=None, with_optimizer=True):
        t0 = time.perf_counter()
        payload = restore(self, step, state, with_optimizer)
        sync()
        seconds = time.perf_counter() - t0
        if payload is not None and state is not None:
            rec["restore_s"].append(seconds)
            diff = _tree_diff(state.model.state_dict(),
                              strip_prefix(payload["state_dict"]), "model")
            # a resume restores the optimizer too
            diff += (_tree_diff(state.optimizer.state_dict(),
                                payload["optimizer"], "optimizer")
                     if with_optimizer else ["optimizer not restored"])
            rec["restored"].append({"step": payload["step"],
                                    "state_step": state.step,
                                    "differ": diff[:10]})
        return payload

    def named_image(self, step, name, image):
        if not name.endswith("_strip"):  # a video's film strip: logged
            rec["panels"].append(name)
        return log_image(self, step, name, image)

    def named_video(self, step, name, frames, fps=2):
        rec["panels"].append(name)
        return log_video(self, step, name, frames, fps)

    patched = (WorldModelTrainer, "train_step", timed_train_step), (
        WorldModelTrainer, "eval_step", counted_eval_step), (
        CheckpointManager, "save", timed_save), (
        CheckpointManager, "restore", checked_restore), (
        MetricsLogger, "log_image", named_image), (
        MetricsLogger, "log_video", named_video)
    for owner, name, fn in patched:
        setattr(owner, name, fn)
    try:
        yield rec
    finally:
        for (owner, name, _), fn in zip(patched, originals):
            setattr(owner, name, fn)


def logged_losses(log_dir: str):
    """Every record of a run's metrics.jsonl; raises on a non-finite
    loss."""
    with open(Path(log_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    for r in records:
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {r['step']}: non-finite {bad}")
    return records


def train_entry_phase(dev, work: Path):
    """``muvo_tpu_torch.train.main`` on a recorded drive at muvo.yml's full
    width (pandas and Pillow import on the card machine, so the drive is
    written in the dataset's on-disk layout and decoded by the loader, not
    made on the device): muvo.yml as it is (batch 1, ACCUMULATE_GRAD_BATCHES
    16, bf16 autocast, remat off) but for the data root, the log dir, the
    run's length and its intervals. A first run of TRAIN_ENTRY_STEPS steps
    crosses an epoch (12 sequences of 6 frames at stride 2 in 24 frames),
    makes its one optimizer update and validates and saves at step 16; a
    second run resumes from that checkpoint (restored bit for bit on the
    card) at epoch 1, batch 4, and takes 4 steps. Every logged loss must be
    finite; bf16 K1, K2, K1-dx, K2-dx, K3 and K3-up must be launched as
    predicted for remat off over the training steps and, K1 and K2, over
    the validation steps, and no flash kernel. The validation logs the
    panels of its first batch: every panel but those whose package
    ``undrawable_panels`` finds missing. The drive and the step-16
    checkpoint stay in ``work`` for the prediction phase. Returns the
    launches by type, the panels and the median host ms between steps."""
    from muvo_tpu_torch.train import main as train_main
    from muvo_tpu_torch.training.flagship import MUVO_YML
    from muvo_tpu_torch.training.visualise import undrawable_panels

    cfg = muvo_cfg()
    undrawable = undrawable_panels()
    t0 = time.perf_counter()
    data = work / "drives"
    written = sum(record_drive(data / "trainval" / split / "Town01"
                               / "0000", cfg, frames, seed)
                  for split, frames, seed in (("train", 24, 0),
                                              ("val0", 14, 1)))
    write_s = time.perf_counter() - t0
    base = ["--config-file", str(MUVO_YML),
            "DATASET.DATAROOT", str(data),
            "DATASET.FILTER_BEGINNING_OF_RUN_SEC", "0.0",
            "LOGGING_INTERVAL", "4", "VAL_CHECK_INTERVAL", "16",
            "LIMIT_VAL_BATCHES", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with instrumented_train_loop(dev) as rec:
        t0 = time.perf_counter()
        first = train_main(base + ["LOG_DIR", str(work / "first"),
                                   "STEPS", str(TRAIN_ENTRY_STEPS)],
                           device=dev)
        first_s = time.perf_counter() - t0
        first_steps = len(rec["train_ms"])
        updates = first.trainer.state.optimizer.updates
        first_log = first.log_dir
        ckpts = Path(first_log) / "checkpoints"
        resume = work / "resume"
        resume.mkdir()
        for name in (f"ckpt_{RESUME_STEP}.pt", f"meta_{RESUME_STEP}.json"):
            os.link(ckpts / name, resume / name)
        del first
        t0 = time.perf_counter()
        second = train_main(base + ["LOG_DIR", str(work / "second"),
                                    "STEPS", str(RESUME_STEPS),
                                    "PRETRAINED.PATH", str(resume)],
                            device=dev)
        second_s = time.perf_counter() - t0
    typed = read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    records = logged_losses(first_log) + logged_losses(second.log_dir)
    start, end = second.start_step, second.step
    del second
    n_train, n_val = len(rec["train_ms"]), len(rec["eval_ms"])
    val = rec["val_launches"]
    train = {kid: {t: n - val.get(kid, {}).get(t, 0) for t, n in types.items()
                   if n - val.get(kid, {}).get(t, 0)}
             for kid, types in typed.items()}
    per_step, per_eval = predicted_launches(cfg), predicted_eval_launches(cfg)
    timed = rec["train_ms"][3:first_steps]
    median = statistics.median(timed)
    frames = cfg.BATCHSIZE * (cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    emit({"phase": "train_entry", "config": "muvo.yml",
          "batch": cfg.BATCHSIZE, "frames_per_step": frames,
          "precision": str(cfg.PRECISION), "remat": bool(cfg.MODEL.REMAT),
          "accumulate": cfg.OPTIMIZER.ACCUMULATE_GRAD_BATCHES,
          "recording_mb": written / 1e6, "write_s": write_s,
          "first_run_s": first_s, "second_run_s": second_s,
          "train_steps": n_train, "val_steps": n_val, "updates": updates,
          "resumed_at": start, "ended_at": end,
          "step_ms": rec["train_ms"], "step_ms_median": median,
          "frames_per_s": frames / (median / 1e3),
          "host_gap_ms_median": statistics.median(rec["gap_ms"]),
          "eval_ms": rec["eval_ms"], "peak_mib": peak_mib,
          "ckpt_save_s": rec["save_s"], "ckpt_restore_s": rec["restore_s"],
          "ckpt_mib": rec.get("ckpt_mib"), "restored": rec["restored"],
          "launches_train_by_type": train, "launches_val_by_type": val,
          "launches_per_step_predicted": per_step,
          "launches_per_eval_predicted": per_eval,
          "logged_records": len(records), "panels": rec["panels"],
          "panels_undrawable": undrawable})
    if updates != 1 or (start, end) != (RESUME_STEP, RESUME_STEPS):
        raise AssertionError(f"{updates} updates in the first run; the "
                             f"second ran from {start} to {end}")
    if n_train != TRAIN_ENTRY_STEPS + RESUME_STEPS - RESUME_STEP or n_val != 1:
        raise AssertionError(f"{n_train} train and {n_val} eval steps")
    if [r["step"] for r in rec["restored"]] != [RESUME_STEP] or any(
            r["differ"] for r in rec["restored"]):
        raise AssertionError(f"the restore was not bit-equal to the "
                             f"checkpoint: {rec['restored']}")
    if not any("train_loss" in r for r in records):
        raise AssertionError("no training loss was logged")
    for kid in KERNEL_NAMES:
        for what, counts, want in (
                ("training", train, per_step[kid] * n_train),
                ("validation", val, per_eval[kid] * n_val)):
            got = counts.get(kid, {})
            if got.get("bfloat16", 0) != want or set(got) - {"bfloat16"}:
                raise AssertionError(f"{kid}: {got} launches in the "
                                     f"{what} steps, predicted {want} bf16")
    drawn = {name.split("/", 1)[1] for name in rec["panels"]}
    if not drawn or drawn & set(undrawable):
        raise AssertionError(f"panels {sorted(drawn)} with {undrawable} "
                             f"undrawable")
    return (typed, {"drawn": rec["panels"], "undrawable": undrawable},
            statistics.median(rec["gap_ms"]))


HEADS_STEPS = 10  # train_heads: 3 warm-up steps, 7 timed, one validation
# the label branches, heads and LiDAR encoder train_heads adds to muvo.yml
HEADS = ("SEMANTIC_SEG.ENABLED", "LIDAR_SEG.ENABLED", "SEMANTIC_IMAGE.ENABLED",
         "DEPTH.ENABLED", "LOSSES.RGB_INSTANCE", "EVAL.MASK_VIEW",
         "MODEL.LIDAR.POINT_PILLAR.ENABLED")
HEAD_TERMS = ("bev_segmentation", "bev_center", "bev_offset", "lidar_seg",
              "semantic_image", "depth")
PILLAR_TOL = 1e-5  # PointPillarNet card against host, fp32, norm-relative


def train_heads_phase(dev, work: Path):
    """``muvo_tpu_torch.train.main`` on the train_entry phase's drive
    (its integer BEV PNGs and depth-semantic PNGs decoded by the loader)
    with muvo.yml plus HEADS: the BEV decoder with its instance heads, the
    LiDAR segmentation, semantic-image and depth decoders, the RGB
    instance loss, the out-of-view BEV mask, and PointPillars on 60,000
    points a frame in place of the range view (which stays the LiDAR
    labels'). Batch 1, bf16, remat off: HEADS_STEPS steps, validation and
    a checkpoint at the last. Every logged loss finite and each of
    HEAD_TERMS present at the three scales, in training and validation;
    bf16 K1, K2, K1-dx, K2-dx, K3 and K3-up launched as predicted, no
    flash kernel. Then the loader's decode ms a frame under muvo.yml and
    under this config, and the trained PointPillarNet on the drive's
    first frame, card against host in fp32 (eval and training mode),
    within PILLAR_TOL. Returns the launches by type."""
    from muvo_tpu_torch.data.dataset import CarlaDataset
    from muvo_tpu_torch.train import main as train_main
    from muvo_tpu_torch.training.flagship import MUVO_YML

    heads = [x for key in HEADS for x in (key, "True")]
    data = ["DATASET.DATAROOT", str(work / "drives"),
            "DATASET.FILTER_BEGINNING_OF_RUN_SEC", "0.0"]
    cfg = muvo_cfg()
    cfg.merge_from_list(heads + data)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with instrumented_train_loop(dev) as rec:
        t0 = time.perf_counter()
        run = train_main(["--config-file", str(MUVO_YML), *data, *heads,
                          "LOG_DIR", str(work / "heads"),
                          "STEPS", str(HEADS_STEPS),
                          "LOGGING_INTERVAL", "1",
                          "VAL_CHECK_INTERVAL", str(HEADS_STEPS),
                          "LIMIT_VAL_BATCHES", "1"], device=dev)
        run_s = time.perf_counter() - t0
    typed = read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    records = logged_losses(run.log_dir)
    n_train, n_val = len(rec["train_ms"]), len(rec["eval_ms"])
    val = rec["val_launches"]
    train = {kid: {t: n - val.get(kid, {}).get(t, 0) for t, n in types.items()
                   if n - val.get(kid, {}).get(t, 0)}
             for kid, types in typed.items()}
    per_step, per_eval = predicted_launches(cfg), predicted_eval_launches(cfg)

    # the loader's decode of a frame, muvo.yml's against this config's
    # (one thread decodes a step's 6 frames): the mean of 6 frames, after
    # a first, untimed one, in turns (muvo.yml, heads, heads, muvo.yml)
    base = muvo_cfg()
    base.merge_from_list(data)
    datasets = {"muvo.yml": CarlaDataset(base, "train", 1),
                "heads": CarlaDataset(cfg, "train", 1)}
    decode_ms = {name: [] for name in datasets}
    for name in ("muvo.yml", "heads", "heads", "muvo.yml"):
        frame = datasets[name][0]
        t0 = time.perf_counter()
        for i in range(1, 7):
            frame = datasets[name][i]
        decode_ms[name].append((time.perf_counter() - t0) * 1e3 / 6)

    # PointPillarNet of the trained model on the drive's first frame
    frame = datasets["heads"][0]
    points = torch.from_numpy(frame["points_raw"])
    num = torch.from_numpy(frame["num_points"])
    net = run.trainer.state.model.point_pillars
    pillar_err = {}
    for mode in ("eval", "train"):
        card, host = copy.deepcopy(net), copy.deepcopy(net).cpu()
        card.train(mode == "train")
        host.train(mode == "train")
        with torch.no_grad():
            got = card(points.to(dev), num.to(dev)).cpu()
            pillar_err[mode] = norm_rel(got, host(points, num))
    del run, net
    median = statistics.median(rec["train_ms"][3:])
    frames = cfg.BATCHSIZE * (cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    losses = {k for r in records for k in r}
    want_terms = {f"{split}_{term}_{k}" for split in ("train", "val0")
                  for term in HEAD_TERMS for k in (1, 2, 4)}
    emit({"phase": "train_heads", "config": "muvo.yml + " + " ".join(HEADS),
          "batch": cfg.BATCHSIZE, "frames_per_step": frames,
          "points_per_frame": int(frame["num_points"][0]),
          "precision": str(cfg.PRECISION), "remat": bool(cfg.MODEL.REMAT),
          "run_s": run_s, "train_steps": n_train, "val_steps": n_val,
          "step_ms": rec["train_ms"], "step_ms_median": median,
          "frames_per_s": frames / (median / 1e3),
          "host_gap_ms_median": statistics.median(rec["gap_ms"]),
          "decode_ms_a_frame": decode_ms,
          "eval_ms": rec["eval_ms"], "peak_mib": peak_mib,
          "launches_train_by_type": train, "launches_val_by_type": val,
          "launches_per_step_predicted": per_step,
          "launches_per_eval_predicted": per_eval,
          "logged_records": len(records),
          "head_terms_missing": sorted(want_terms - losses),
          "last_train_losses": next(r for r in reversed(records)
                                    if "train_loss" in r),
          "val_losses": next((r for r in records if "val0_loss" in r
                              or any(k.startswith("val0_") for k in r)),
                             None),
          "point_pillars_vs_host_norm_rel": pillar_err, "tol": PILLAR_TOL,
          "panels": rec["panels"]})
    if n_train != HEADS_STEPS or n_val != 1:
        raise AssertionError(f"{n_train} train and {n_val} eval steps")
    if want_terms - losses:
        raise AssertionError(f"loss terms not logged: "
                             f"{sorted(want_terms - losses)}")
    for kid in KERNEL_NAMES:
        for what, counts, want in (
                ("training", train, per_step[kid] * n_train),
                ("validation", val, per_eval[kid] * n_val)):
            got = counts.get(kid, {})
            if got.get("bfloat16", 0) != want or set(got) - {"bfloat16"}:
                raise AssertionError(f"{kid}: {got} launches in the "
                                     f"{what} steps, predicted {want} bf16")
    if not max(pillar_err.values()) <= PILLAR_TOL:
        raise AssertionError(f"PointPillarNet card differs from host: "
                             f"{pillar_err}")
    torch.cuda.empty_cache()
    return typed


# train_lifting's runs: (label, yml or None for the default config, steps);
# each validates once, at its last step
LIFTING_TRAINED = (("default config", None, 8),
                   ("one_frame.yml", "one_frame.yml", 4))
REPLAY_FRAMES = 360  # a validation run the every-50th sampler takes 8 from


def replay_run(src: Path, dst: Path, n_frames: int):
    """A recorded run at ``dst`` that replays ``src``'s frames in turn for
    ``n_frames`` frames: its file folders are links to ``src``'s, its
    dataframe ``src``'s rows repeated. The reference's validation sampler
    takes every 50th sequence of a split, so a batch of b needs 50 (b - 1)
    + 1 of them: more than a short drive holds."""
    import pandas as pd

    dst.mkdir(parents=True)
    for sub in src.iterdir():
        if sub.is_dir():
            (dst / sub.name).symlink_to(sub.resolve(),
                                        target_is_directory=True)
    df = pd.read_pickle(src / "pd_dataframe.pkl")
    rows = [i % len(df) for i in range(n_frames)]
    df.iloc[rows].reset_index(drop=True).to_pickle(dst / "pd_dataframe.pkl")


def train_lifting_phase(dev, work: Path):
    """``muvo_tpu_torch.train.main`` on the train_entry phase's drive, its
    validation split extended by a REPLAY_FRAMES-frame replay of the
    training frames (``replay_run``: batches of 3 and 8 need 101 and 351
    sequences under the every-50th validation sampler), with each of
    LIFTING_TRAINED as users run it, setting only the data root (and
    DATASET.FILTER_BEGINNING_OF_RUN_SEC 0, which would drop 1 s of the
    drive's 2.4), the log dir, the run's length and its intervals: the
    default config (the MILE branch with lifting, LiDAR and the RSSM;
    batch 3 of RF 1 + FH 1, PRECISION 16-mixed, remat off), then
    one_frame.yml (no RSSM, batch 8 of 1 frame, FH 0). Every logged loss
    finite; the KL term logged for the default config and not for
    one_frame.yml; bf16 K1, K2, K1-dx, K2-dx, K3 and K3-up launched as
    predicted_launches and predicted_eval_launches give (the default
    config's 256 voxel channels put conv3 alone on the kernels), no flash
    kernel; the trained model's FrustumPooling on the drive's first frame,
    card against host in fp32, within POOL_TOL. Step ms, frames/s, host ms
    between steps, pooling ms and peak MiB. Returns the launches by type,
    summed over both runs."""
    from muvo_tpu_torch.data.dataset import CarlaDataset
    from muvo_tpu_torch.models.preprocess import PreProcess
    from muvo_tpu_torch.train import main as train_main

    data = ["DATASET.DATAROOT", str(work / "drives"),
            "DATASET.FILTER_BEGINNING_OF_RUN_SEC", "0.0"]
    drives = work / "drives" / "trainval"
    replay_run(drives / "train" / "Town01" / "0000",
               drives / "val0" / "Town01" / "0001", REPLAY_FRAMES)
    configs = Path(__file__).resolve().parent / "muvo_tpu_torch" / "configs"
    typed_all = {}
    for label, yml, steps in LIFTING_TRAINED:
        cfg = config(yml, data)
        argv = (["--config-file", str(configs / yml)] if yml else []) + data
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        with instrumented_train_loop(dev) as rec:
            t0 = time.perf_counter()
            run = train_main(argv + [
                "LOG_DIR", str(work / f"lifting_{yml or 'default'}"),
                "STEPS", str(steps), "LOGGING_INTERVAL", "1",
                "VAL_CHECK_INTERVAL", str(steps), "LIMIT_VAL_BATCHES", "1"],
                device=dev)
            run_s = time.perf_counter() - t0
        typed = read_typed_launches()
        peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        records = logged_losses(run.log_dir)
        n_train, n_val = len(rec["train_ms"]), len(rec["eval_ms"])
        val = rec["val_launches"]
        train = {kid: {t: n - val.get(kid, {}).get(t, 0)
                       for t, n in types.items()
                       if n - val.get(kid, {}).get(t, 0)}
                 for kid, types in typed.items()}
        per_step = predicted_launches(cfg)
        per_eval = predicted_eval_launches(cfg)

        # the trained model's lifting of the drive's first frame, fp32
        seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
        frame = CarlaDataset(cfg, "train", seq)[0]
        batch = {k: torch.as_tensor(v)[None].to(dev)
                 for k, v in frame.items()}
        model = run.trainer.state.model.eval()
        with torch.inference_mode():
            pb = PreProcess(cfg)(batch, training=False, labels=False)
        args, shapes = pooling_inputs(model, pb)
        pool_err, pool_ms, points = pooling_vs_host(model.frustum_pooling,
                                                    args)
        del run, model, args
        median = statistics.median(rec["train_ms"][3:])
        frames = cfg.BATCHSIZE * seq
        kl = sorted({k for r in records for k in r if "probabilistic" in k})
        emit({"phase": "train_lifting", "config": label,
              "batch": cfg.BATCHSIZE, "frames_per_step": frames,
              "precision": str(cfg.PRECISION),
              "remat": bool(cfg.MODEL.REMAT),
              "transition": bool(cfg.MODEL.TRANSITION.ENABLED),
              "voxel_channels": cfg.VOXEL_SEG.DIMENSION,
              "kernel_convs": voxel_kernel_convs(cfg), "run_s": run_s,
              "train_steps": n_train, "val_steps": n_val,
              "step_ms": rec["train_ms"], "step_ms_median": median,
              "frames_per_s": frames / (median / 1e3),
              "host_gap_ms_median": statistics.median(rec["gap_ms"]),
              "eval_ms": rec["eval_ms"], "peak_mib": peak_mib,
              "launches_train_by_type": train, "launches_val_by_type": val,
              "launches_per_step_predicted": per_step,
              "launches_per_eval_predicted": per_eval,
              "logged_records": len(records), "kl_terms": kl,
              "last_train_losses": next(r for r in reversed(records)
                                        if "train_loss" in r),
              "features": list(pb["image"].shape), **shapes,
              "points": points, "pooling_ms": pool_ms,
              "pooling_vs_host_norm_rel": pool_err, "pool_tol": POOL_TOL,
              "panels": rec["panels"]})
        if n_train != steps or n_val != 1:
            raise AssertionError(f"{label}: {n_train} train and {n_val} "
                                 f"eval steps")
        if bool(kl) != bool(cfg.MODEL.TRANSITION.ENABLED):
            raise AssertionError(f"{label}: KL terms {kl} with "
                                 f"TRANSITION.ENABLED "
                                 f"{cfg.MODEL.TRANSITION.ENABLED}")
        for kid in KERNEL_NAMES:
            for what, counts, want in (
                    ("training", train, per_step[kid] * n_train),
                    ("validation", val, per_eval[kid] * n_val)):
                got = counts.get(kid, {})
                if got.get("bfloat16", 0) != want or set(got) - {"bfloat16"}:
                    raise AssertionError(f"{label} {kid}: {got} launches in "
                                         f"the {what} steps, predicted "
                                         f"{want} bf16")
        if not pool_err <= POOL_TOL:
            raise AssertionError(f"{label}: FrustumPooling card differs "
                                 f"from host: {pool_err}")
        add_launches(typed_all, typed)
        torch.cuda.empty_cache()
    return typed_all


PROJECTION_STEPS = 8  # train_options' recorded-drive run: 3 warm-up, 5
PROJECTION_ITERS = 20  # timed projections of one batch
PROJECTION_SHARE = 0.01  # card vs host range view: mismatching pixels,
# muvo_tpu's own limit (tests/test_device_projection.py)


def projection_vs_host(dev, cfg):
    """The drive's first sequence (SERVE_SEQ frames of up to 60,000 raw
    points) projected on the card as PreProcess does under
    POINTS.DEVICE_PROJECTION, before the LIDAR_RE.SCALE division: the
    median CUDA-event ms of PROJECTION_ITERS projections, and the share of
    pixels whose (x, y, z, depth) differ by more than 1e-3 from the host
    projection (RangeProjector.project: the native float64 kernel, else
    numpy) of the same points, frame by frame."""
    import numpy as np

    from muvo_tpu_torch.data.dataset import CarlaDataset
    from muvo_tpu_torch.geometry.range_view import RangeProjector
    from muvo_tpu_torch.models.preprocess import PreProcess

    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    frame = CarlaDataset(cfg, "train", seq)[0]
    raw = {k: torch.as_tensor(frame[k])[None].to(dev)
           for k in ("points_raw", "points_sem", "num_points")}
    pre = PreProcess(cfg)
    ms = []
    for _ in range(PROJECTION_ITERS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = pre._device_range_projection(dict(raw))
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    card = out["range_view_pcd_xyzd"][0].cpu().numpy()
    proj = RangeProjector(cfg.POINTS.CHANNELS, cfg.POINTS.HORIZON_RESOLUTION,
                          cfg.POINTS.FOV[0], cfg.POINTS.FOV[1],
                          cfg.POINTS.LIDAR_POSITION)
    differ = []
    for f in range(seq):
        n = int(frame["num_points"][f])
        depth, xyz, _ = proj.project(frame["points_raw"][f, :n],
                                     frame["points_sem"][f, :n])
        host = np.concatenate([xyz, depth[..., None]], -1)
        differ.append((np.abs(card[f] - host) > 1e-3).any(-1))
    differ = np.stack(differ)
    return {"projection_ms": ms,
            "projection_ms_median": statistics.median(ms),
            "points": [int(n) for n in frame["num_points"]],
            "pixels_hit": int((card[..., 3] >= 0).sum()),
            "pixels_differ": int(differ.sum()),
            "pixels_differ_share": float(differ.mean()),
            "share_limit": PROJECTION_SHARE}


def train_options_phase(dev, work: Path, entry_gap_ms: float):
    """(a) The flagship step (build_flagship_step: 4 x 6 frames, bf16
    autocast, decoder remat) with OPTIONS (measurements, resnet34 camera
    and LiDAR trunks) through run_train_steps: 3 warm-up steps, timed
    steps, every loss finite, the six voxel kernels launched as
    predicted_launches gives. (b) ``muvo_tpu_torch.train.main`` on the
    train_entry phase's drive with POINTS.DEVICE_PROJECTION: muvo.yml as
    users run it (batch 1 x 6, bf16, remat off) for PROJECTION_STEPS steps
    and one validation; the loader ships the raw points and PreProcess
    projects them on the card. Every logged loss finite; bf16 K1, K2,
    K1-dx, K2-dx, K3 and K3-up launched as predicted, no other kernel;
    step ms and host ms between steps beside train_entry's
    (``entry_gap_ms``); then ``projection_vs_host``, within
    PROJECTION_SHARE. Returns the launches by type of (a) and (b)."""
    from muvo_tpu_torch.train import main as train_main
    from muvo_tpu_torch.training.flagship import MUVO_YML, build_flagship_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fs = build_flagship_step(device=dev, opts=OPTIONS)
    typed = run_train_steps(fs, dev, "train_options",
                            "flagship + MEASUREMENTS + resnet34")
    del fs
    torch.cuda.empty_cache()

    opts = ["DATASET.DATAROOT", str(work / "drives"),
            "DATASET.FILTER_BEGINNING_OF_RUN_SEC", "0.0",
            "POINTS.DEVICE_PROJECTION", "True"]
    cfg = config("muvo.yml", opts)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with instrumented_train_loop(dev) as rec:
        t0 = time.perf_counter()
        run = train_main(["--config-file", str(MUVO_YML), *opts,
                          "LOG_DIR", str(work / "projection"),
                          "STEPS", str(PROJECTION_STEPS),
                          "LOGGING_INTERVAL", "1",
                          "VAL_CHECK_INTERVAL", str(PROJECTION_STEPS),
                          "LIMIT_VAL_BATCHES", "1"], device=dev)
        run_s = time.perf_counter() - t0
    drive = read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    records = logged_losses(run.log_dir)
    del run
    n_train, n_val = len(rec["train_ms"]), len(rec["eval_ms"])
    val = rec["val_launches"]
    train = {kid: {t: n - val.get(kid, {}).get(t, 0) for t, n in
                   types.items() if n - val.get(kid, {}).get(t, 0)}
             for kid, types in drive.items()}
    per_step, per_eval = predicted_launches(cfg), predicted_eval_launches(cfg)
    median = statistics.median(rec["train_ms"][3:])
    frames = cfg.BATCHSIZE * (cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    projection = projection_vs_host(dev, cfg)
    emit({"phase": "train_options", "config": "muvo.yml DEVICE_PROJECTION",
          "batch": cfg.BATCHSIZE, "frames_per_step": frames,
          "precision": str(cfg.PRECISION), "remat": bool(cfg.MODEL.REMAT),
          "run_s": run_s, "train_steps": n_train, "val_steps": n_val,
          "step_ms": rec["train_ms"], "step_ms_median": median,
          "frames_per_s": frames / (median / 1e3),
          "host_gap_ms": rec["gap_ms"],
          "host_gap_ms_median": statistics.median(rec["gap_ms"]),
          "train_entry_host_gap_ms_median": entry_gap_ms,
          "eval_ms": rec["eval_ms"], "peak_mib": peak_mib,
          "launches_train_by_type": train, "launches_val_by_type": val,
          "launches_per_step_predicted": per_step,
          "launches_per_eval_predicted": per_eval,
          "logged_records": len(records),
          "last_train_losses": next(r for r in reversed(records)
                                    if "train_loss" in r), **projection})
    if n_train != PROJECTION_STEPS or n_val != 1:
        raise AssertionError(f"DEVICE_PROJECTION: {n_train} train and "
                             f"{n_val} eval steps")
    for kid in KERNEL_NAMES:
        for what, counts, want in (
                ("training", train, per_step[kid] * n_train),
                ("validation", val, per_eval[kid] * n_val)):
            got = counts.get(kid, {})
            if got.get("bfloat16", 0) != want or set(got) - {"bfloat16"}:
                raise AssertionError(f"DEVICE_PROJECTION {kid}: {got} "
                                     f"launches in the {what} steps, "
                                     f"predicted {want} bf16")
    if not projection["pixels_differ_share"] < PROJECTION_SHARE:
        raise AssertionError(f"card range view differs from the host's: "
                             f"{projection['pixels_differ_share']}")
    return add_launches(typed, drive)


METRIC_TOL = 1e-4  # card against host suite: SSIM, PSNR, Chamfer, relative


@contextlib.contextmanager
def instrumented_prediction(dev):
    """Wraps what muvo_tpu_torch.prediction calls: each observe_step,
    imagine_step and MetricSuite.update timed on the host clock ending in a
    synchronize, each Evaluator.run timed with its batches counted and the
    host ms its loop waited for each batch from device_prefetch, host
    copies of the first two updates' outputs and labels kept, the last
    Evaluator that ran, and what restore_pretrained restored."""
    from muvo_tpu_torch import prediction
    from muvo_tpu_torch.training import evaluator
    from muvo_tpu_torch.training.evaluator import Evaluator, MetricSuite
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    rec = {"observe_ms": [], "imagine_ms": [], "update_ms": [], "run_s": [],
           "run_batches": [], "wait_ms": [], "updates": [], "restored": [],
           "evaluator": None}
    originals = (WorldModelTrainer.observe_step,
                 WorldModelTrainer.imagine_step, MetricSuite.update,
                 Evaluator.run, prediction.restore_pretrained,
                 evaluator.device_prefetch)
    observe, imagine, update, run, restore, prefetch = originals

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            rec[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    def kept_update(self, batch, output, generator=None):
        if len(rec["updates"]) < 2:
            rec["updates"].append(tuple(
                {k: v.cpu() for k, v in tree.items() if torch.is_tensor(v)}
                for tree in (batch, output)))
        return timed(update, "update_ms")(self, batch, output, generator)

    def waited_prefetch(iterator, device):
        # the loop's wait for each batch: the loader's decode the step
        # did not hide, the pinning and the copies' queueing
        inner = prefetch(iterator, device)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(inner)
                except StopIteration:
                    return
                rec["wait_ms"][-1].append((time.perf_counter() - t0) * 1e3)
                yield batch
        finally:
            inner.close()

    def counted_run(self, loader, max_batches=None):
        rec["evaluator"] = self
        rec["wait_ms"].append([])
        before = len(rec["observe_ms"])
        t0 = time.perf_counter()
        out = run(self, loader, max_batches)
        rec["run_s"].append(time.perf_counter() - t0)
        rec["run_batches"].append(len(rec["observe_ms"]) - before)
        return out

    def recorded_restore(path, state, with_optimizer=True):
        restored = restore(path, state, with_optimizer)
        rec["restored"].append({"checkpoint": restored, "step": state.step,
                                "optimizer": with_optimizer})
        return restored

    WorldModelTrainer.observe_step = timed(observe, "observe_ms")
    WorldModelTrainer.imagine_step = timed(imagine, "imagine_ms")
    MetricSuite.update = kept_update
    Evaluator.run = counted_run
    prediction.restore_pretrained = recorded_restore
    evaluator.device_prefetch = waited_prefetch
    try:
        yield rec
    finally:
        (WorldModelTrainer.observe_step, WorldModelTrainer.imagine_step,
         MetricSuite.update, Evaluator.run, prediction.restore_pretrained,
         evaluator.device_prefetch) = originals


def suite_card_vs_host(cfg, dev, updates):
    """The metric suite on the card against the same suite on the host, on
    copies of the same outputs and labels, each update's LiDAR columns
    drawn from one host generator: confusion matrices and SSC counts
    equal, the running SSIM, PSNR and Chamfer totals within METRIC_TOL
    relative. Returns {state key: relative error, or "equal"}."""
    from muvo_tpu_torch.training.evaluator import MetricSuite

    card, host = MetricSuite(cfg, dev), MetricSuite(cfg, "cpu")
    for i, (labels, output) in enumerate(updates):
        card.update({k: v.to(dev) for k, v in labels.items()},
                    {k: v.to(dev) for k, v in output.items()},
                    torch.Generator().manual_seed(i))
        host.update(labels, output, torch.Generator().manual_seed(i))
    found, bad = {}, []
    for key, want in host.state.items():
        got = card.state[key]
        if torch.is_tensor(want):  # a confusion matrix
            found[key] = "equal" if torch.equal(got.cpu(), want) else "differ"
        elif "total" in want:  # a running mean
            rel = abs(got["total"].item() - want["total"].item()) / max(
                abs(want["total"].item()), 1e-30)
            found[key] = rel
            if not (rel <= METRIC_TOL and got["count"].item()
                    == want["count"].item()):
                bad.append(key)
            continue
        else:  # the SSC counts
            found[key] = ("equal" if all(torch.equal(got[k].cpu(), v)
                                          for k, v in want.items())
                          else "differ")
        if found[key] != "equal":
            bad.append(key)
    if bad:
        raise AssertionError(f"card metric suite differs from host: {found}")
    return found


def chamfer_ms(cfg, dev, labels, output):
    """Mean ms of metrics.chamfer_batch on the card at an update's shapes
    and the evaluator's 10,000 columns, and its samples (b x s)."""
    from muvo_tpu_torch import metrics
    from muvo_tpu_torch.training.evaluator import CHAMFER_COLUMNS

    scale = cfg.LIDAR_RE.SCALE
    pred = output["lidar_reconstruction_1"].to(dev) * scale
    target = labels["range_view_label_1"].to(dev) * scale
    b, s, h, w, c = pred.shape
    idx = torch.randint(0, h * w, (CHAMFER_COLUMNS,), device=dev)
    p = pred.reshape(b * s, h * w, c)[:, idx, :-1]
    t = target.reshape(b * s, h * w, c)[:, idx, :-1]
    return time_ms(lambda: metrics.chamfer_batch(p, t)), b * s


def steady_evaluation(argv, evaluator):
    """``evaluator`` over every sequence of the drive of ``argv``, in
    order, from one loader as prediction.main builds it: the test batches
    a second once the loader's decode thread runs ahead of the steps."""
    from muvo_tpu_torch.config import get_cfg, get_parser
    from muvo_tpu_torch.data.dataset import make_dataset
    from muvo_tpu_torch.data.loader import DataLoader

    cfg = get_cfg(get_parser().parse_args(argv))
    ds = make_dataset(cfg, "train", cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    evaluator.run(DataLoader(ds, cfg.BATCHSIZE, shuffle=False,
                             sampler=range(len(ds)),
                             num_workers=min(cfg.N_WORKERS, 1)))


def prediction_phase(dev, work: Path, panels):
    """``python -m muvo_tpu_torch.prediction``'s ``main`` on the drive of
    the train_entry phase, restoring its step-16 checkpoint (muvo.yml as
    it is: batch 1, bf16, remat off, PREDICTION.N_SAMPLES 1; the three
    test samplers yield one batch each on its 12 sequences, each from a
    cold loader), then the same Evaluator over all 12 sequences in turn
    (steady_evaluation), then ``muvo_tpu_torch.sim_run``'s over the same
    drive. Every metric must be finite; bf16 K1 and K2 launched as
    predicted_eval_launches says for each test batch and nothing else;
    fp32 K1 and K2 twice a block for each sim_run step (its decode and its
    imagination's) and nothing else; the card's metric suite equal to the
    host's on the first two updates' outputs and labels. Prints the
    metrics, the median ms of observe_step and imagine_step (cold and
    steady) and of MetricSuite.update, the mean ms of the
    Chamfer distance at the reconstruction's shapes, test batches a
    second (cold: the three samplers; steady: the 12 sequences), the
    loop's waits for the loader, the peak MiB of prediction.main, and the
    panels of train_entry's validation. Returns the launches by type of
    each run."""
    import importlib.util

    from muvo_tpu_torch import prediction, sim_run
    from muvo_tpu_torch.training.flagship import MUVO_YML

    cfg = muvo_cfg()
    if cfg.PREDICTION.N_SAMPLES != 1:
        raise AssertionError(f"N_SAMPLES {cfg.PREDICTION.N_SAMPLES}: the "
                             f"launch counts assume 1")
    argv = ["--config-file", str(MUVO_YML),
            "DATASET.DATAROOT", str(work / "drives"),
            "DATASET.FILTER_BEGINNING_OF_RUN_SEC", "0.0",
            "PRETRAINED.PATH", str(work / "resume")]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with instrumented_prediction(dev) as rec:
        t0 = time.perf_counter()
        results = prediction.main(argv, device=dev)
        prediction_s = time.perf_counter() - t0
        peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        steady_evaluation(argv, rec["evaluator"])
    typed = read_typed_launches()
    reset_launches()
    t0 = time.perf_counter()
    stats = sim_run.main(argv, device=dev)
    sim_s = time.perf_counter() - t0
    sim_typed = read_typed_launches()
    suite = suite_card_vs_host(cfg, dev, rec["updates"])
    cd_ms, cd_samples = chamfer_ms(cfg, dev, *rec["updates"][-1])

    n_batches = sum(rec["run_batches"])  # the steady run's too
    cold_batches, cold_s = rec["run_batches"][:3], rec["run_s"][:3]
    steady_batches, steady_s = rec["run_batches"][3], rec["run_s"][3]
    steady_wait = rec["wait_ms"][3]
    n_cold = sum(cold_batches)  # one imagination a batch: N_SAMPLES 1
    observe_ms, imagine_ms = rec["observe_ms"], rec["imagine_ms"]
    per_eval = predicted_eval_launches(cfg)  # one imagination a batch
    want = {kid: {"bfloat16": n * n_batches} for kid, n in per_eval.items()
            if n}
    want_sim = {kid: {"float32": n * len(stats)}
                for kid, n in per_eval.items() if n}
    emit({"phase": "prediction", "config": "muvo.yml",
          "batch": cfg.BATCHSIZE, "precision": str(cfg.PRECISION),
          "n_samples": cfg.PREDICTION.N_SAMPLES, "results": results,
          "restored": rec["restored"], "batches_by_sampler": rec["run_batches"],
          "observe_ms": rec["observe_ms"], "imagine_ms": rec["imagine_ms"],
          "update_ms": rec["update_ms"],
          # cold: the three samplers' batches; steady: the steady run's,
          # while the loader's decode thread works beside the steps
          "observe_ms_median": statistics.median(observe_ms[:n_cold]),
          "imagine_ms_median": statistics.median(imagine_ms[:n_cold]),
          "steady_observe_ms_median": statistics.median(observe_ms[n_cold:]),
          "steady_imagine_ms_median": statistics.median(imagine_ms[n_cold:]),
          "update_ms_median": statistics.median(rec["update_ms"]),
          "evaluator_s": rec["run_s"],
          "cold_test_batches_per_s": sum(cold_batches) / sum(cold_s),
          "steady_batches": steady_batches,
          "steady_batches_per_s": steady_batches / steady_s,
          "loader_wait_ms": rec["wait_ms"],
          "steady_wait_ms_median": statistics.median(steady_wait[1:]),
          "steady_wait_share": sum(steady_wait) / (steady_s * 1e3),
          "prediction_main_s": prediction_s, "peak_mib": peak_mib,
          "launches_by_type": typed, "launches_predicted": want,
          "sim_run_steps": len(stats), "sim_run_s": sim_s,
          "sim_run_launches_by_type": sim_typed,
          "sim_run_launches_predicted": want_sim,
          "chamfer_ms": cd_ms, "chamfer_samples": cd_samples,
          "suite_card_vs_host": suite, "metric_tol": METRIC_TOL,
          "panels_drawn": panels["drawn"],
          "panels_undrawable": panels["undrawable"],
          "packages": {name: importlib.util.find_spec(name) is not None
                       for name in ("cv2", "matplotlib", "PIL")}})
    if rec["restored"] != [{"checkpoint": True, "step": RESUME_STEP,
                            "optimizer": False}]:
        raise AssertionError(f"restored {rec['restored']}, not the step "
                             f"{RESUME_STEP} checkpoint's model")
    if [len(w) for w in rec["wait_ms"]] != rec["run_batches"]:
        raise AssertionError(f"loader waits {rec['wait_ms']} for "
                             f"{rec['run_batches']} batches")
    if len(results) != 6 or min(rec["run_batches"]) < 1:
        raise AssertionError(f"{rec['run_batches']} batches by sampler; "
                             f"results {sorted(results)}")
    bad = [(name, key) for name, scores in results.items()
           for key, v in scores.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    if typed != want or sim_typed != want_sim:
        raise AssertionError(f"launches {typed} and {sim_typed} in sim_run, "
                             f"predicted {want} and {want_sim}")
    if not stats or not all(math.isfinite(v) for s in stats
                            for v in s.values()):
        raise AssertionError(f"sim_run: {stats}")
    return typed, sim_typed


def muvo_cfg(name: str = "muvo.yml"):
    """A config of muvo_tpu_torch/configs (muvo.yml unless named)."""
    from muvo_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent / "muvo_tpu_torch"
                            / "configs" / name))
    return cfg


def decode_vs_host(session, host_model, cfg):
    """The card's decode of the session's carry (K1/K2 inside) against the
    port's host decode (plain versions) on the same carry and weights:
    ({output: norm-relative error}, host seconds)."""
    from muvo_tpu_torch.inference import DeploymentSession, LatentCarry

    carry = session.carry
    card = session.decode(carry)
    host = DeploymentSession(host_model, cfg, device="cpu")
    t0 = time.perf_counter()
    on_host = host.decode(LatentCarry(*(t.cpu() for t in carry)))
    host_s = time.perf_counter() - t0
    err = {}
    for key, want in on_host.items():
        got = card[key].float().cpu()
        err[key] = ((got - want).abs().max()
                    / want.abs().max().clamp_min(1e-12)).item()
    return err, host_s


def embedding_vs_host(session, host_model, batch, cfg):
    """One frame's embedding on the card against the port's host run, same
    weights and preprocessed input: (norm-relative error, host seconds,
    the card encode's launches)."""
    from muvo_tpu_torch.utils.network import remove_past

    one = session._tensors(remove_past(batch, cfg.RECEPTIVE_FIELD))
    with torch.inference_mode():
        pb = session.preprocess(one, labels=False)
        before = read_launches()
        card = session.model.encode_frame(pb)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in read_launches().items()}
        t0 = time.perf_counter()
        host = host_model.encode_frame(
            {k: v.cpu() if torch.is_tensor(v) else v for k, v in pb.items()})
        host_s = time.perf_counter() - t0
    return norm_rel(card, host), host_s, launches


def serving_phase(dev, cfg):
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.inference import DeploymentSession
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
    for kernel, want in ((zconv.zconv3d_leaky, zconv.K1_F32_IMPL),
                         (zconv.upzconv3d_leaky, zconv.K2_F32_IMPL)):
        if kernel.last_impl != want:
            raise AssertionError(f"serving ran {kernel.last_impl}, not "
                                 f"{want}")
    if launches["K4"]:  # 648 tokens a frame take the math path
        raise AssertionError(f"flash attention ran on muvo.yml's 648 tokens: "
                             f"{launches}")
    check_serving_outputs(cfg, out, sim_out, imagined)
    decode_err, host_s = decode_vs_host(session, host_model, cfg)
    worst = max(decode_err.values())
    emit({"phase": "serving", "batch": 1,
          "sequence": seq, "deployment_tick_ms": deploy_ms,
          "sim_tick_ms": sim_ms,
          "sim_tick_ms_median": statistics.median(sim_ms),
          "deployment_tick_ms_median": statistics.median(deploy_ms),
          "peak_mib": peak_mib, "launches": launches,
          "launches_by_type": typed, "launches_per_sim_tick": sim_launches,
          "K1_impl": zconv.zconv3d_leaky.last_impl,
          "K2_impl": zconv.upzconv3d_leaky.last_impl,
          "decode_vs_host_norm_rel": decode_err,
          "decode_tol": DECODE_TOL, "host_decode_s": host_s})
    if not worst <= DECODE_TOL:
        raise AssertionError(f"card decode differs from host decode: {worst}")
    return typed


SERVE_SEQ = 6  # frames a serving tick sees: a 5-step imagination


def serve_config(dev, cfg, phase: str, label: str, seed: int):
    """``cfg`` at full width through DeploymentSession, fp32, batch 1,
    weights from ``seed``: 3 deployment_forward ticks, then 3 sim_forward
    ticks on a SERVE_SEQ-frame batch (the frame at RECEPTIVE_FIELD 6
    observed, 5 imagined). fp32 K1 and K2 must be launched as
    predicted_fp32_decode_launches gives for two decodes (the observation's
    and the imagination's) each sim tick, no other kernel (K4 not: under
    2,048 tokens a frame); outputs finite with muvo_tpu's shapes; one
    frame's embedding and one decode on the card against the port's host
    run within DECODE_TOL. Emits ``phase``'s line for ``label`` and
    returns the launches by type."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.inference import DeploymentSession
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.ops import zconv

    torch.manual_seed(seed)
    model = MuvoWorldModel(cfg)
    host_model = copy.deepcopy(model).eval().requires_grad_(False)
    session = DeploymentSession(
        model, cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    batch = synthetic_batch(cfg, batch_size=1, sequence_length=SERVE_SEQ,
                            seed=0)

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    deploy_ms, sim_ms, per_tick = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        out = session.deployment_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        deploy_ms.append((time.perf_counter() - t0) * 1e3)
    session.reset()
    for _ in range(3):
        before = read_launches()
        t0 = time.perf_counter()
        sim_out, imagined = session.sim_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        sim_ms.append((time.perf_counter() - t0) * 1e3)
        per_tick.append({k: v - before[k] for k, v in read_launches().items()
                         if v - before[k]})
    launches, typed = read_launches(), read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    decode = predicted_fp32_decode_launches(cfg, dev)
    check_serving_outputs(cfg, out, sim_out, imagined, SERVE_SEQ)
    embed_err, embed_host_s, _ = embedding_vs_host(session, host_model,
                                                   batch, cfg)
    decode_err, decode_host_s = decode_vs_host(session, host_model, cfg)
    emit({"phase": phase, "config": label,
          "encoders": [cfg.MODEL.ENCODER.NAME, cfg.MODEL.LIDAR.ENCODER],
          "batch": 1, "sequence": SERVE_SEQ,
          "deployment_tick_ms": deploy_ms, "sim_tick_ms": sim_ms,
          "sim_tick_ms_median": statistics.median(sim_ms),
          "deployment_tick_ms_median": statistics.median(deploy_ms),
          "peak_mib": peak_mib, "launches": launches,
          "launches_by_type": typed, "launches_per_sim_tick": per_tick,
          "K1_impl": zconv.zconv3d_leaky.last_impl,
          "K2_impl": zconv.upzconv3d_leaky.last_impl,
          "embedding_vs_host_norm_rel": embed_err,
          "decode_vs_host_norm_rel": decode_err, "tol": DECODE_TOL,
          "host_encode_s": embed_host_s, "host_decode_s": decode_host_s})
    want = {kid: 2 * n for kid, n in decode.items() if n}
    if any(tick != want for tick in per_tick):
        raise AssertionError(f"{label}: launches a sim tick {per_tick}, "
                             f"predicted {want}")
    if set(typed) != set(want) or any(set(t) != {"float32"}
                                      for t in typed.values()):
        raise AssertionError(f"{label}: serving launched {typed}, "
                             f"predicted fp32 {sorted(want)} only")
    for kernel, impl in ((zconv.zconv3d_leaky, zconv.K1_F32_IMPL),
                         (zconv.upzconv3d_leaky, zconv.K2_F32_IMPL)):
        if kernel.last_impl != impl:
            raise AssertionError(f"{label}: serving ran {kernel.last_impl}, "
                                 f"not {impl}")
    worst = max(embed_err, *decode_err.values())
    if not worst <= DECODE_TOL:
        raise AssertionError(f"{label}: card differs from host: embedding "
                             f"{embed_err}, decode {decode_err}")
    del session, model, host_model
    torch.cuda.empty_cache()
    return typed


def add_launches(total, typed):
    """Adds ``typed`` ({kernel: {type: launches}}) into ``total``."""
    for kid, types in typed.items():
        for dtype, n in types.items():
            counts = total.setdefault(kid, {})
            counts[dtype] = counts.get(dtype, 0) + n
    return total


def serving_mobilevit_phase(dev):
    """test_mobilevit_2d.yml (muvo.yml with MobileViTV2 camera and LiDAR
    trunks) through ``serve_config``: fp32 K1 and K2 4 launches each a sim
    tick, K4 none."""
    return serve_config(dev, muvo_cfg("test_mobilevit_2d.yml"),
                        "serving_mobilevit", "test_mobilevit_2d.yml", seed=2)


# serving_options' configurations: (label, muvo.yml's options changed).
# muvo_tpu runs EVAL.RESOLUTION's forward (its loss stops at the RGB term:
# the decoders keep IMAGE.CROP's size), so it is served here too.
OPTIONS = ["MODEL.MEASUREMENTS.ENABLED", "True", "MODEL.ENCODER.NAME",
           "resnet34", "MODEL.LIDAR.ENCODER", "resnet34"]
SERVED_OPTIONS = (("muvo.yml MEASUREMENTS resnet34", OPTIONS),
                  ("muvo.yml EVAL.RESOLUTION FACTOR 2",
                   ["EVAL.RESOLUTION.ENABLED", "True",
                    "EVAL.RESOLUTION.FACTOR", "2"]))
# TriPlaneVoxelDecoder on the card: 3 scales, planes (X, Y, Z) at scale 1
# and halved at 2 and 4, their channels, the classifier's, the classes
TRIPLANE = {"planes": (48, 48, 16), "channels": 64, "feature_channels": 512,
            "n_classes": 2}
TRIPLANE_TOL = 1e-4  # card vs host, fp32 (TF32 off), norm-relative
TRIPLANE_ITERS = 10  # timed calls


def triplane_vs_host(dev):
    """TriPlaneVoxelDecoder (TRIPLANE's sizes, seeded weights and planes)
    on the card against a host copy: each scale within TRIPLANE_TOL; the
    median CUDA-event ms of TRIPLANE_ITERS calls; no kernel of the port
    launched (its 3x3x3 conv is F.conv3d, as muvo_tpu runs it in XLA)."""
    from muvo_tpu_torch.models.stylegan import TriPlaneVoxelDecoder

    x, y, z = TRIPLANE["planes"]
    c = TRIPLANE["channels"]
    torch.manual_seed(5)
    host = TriPlaneVoxelDecoder(c, TRIPLANE["n_classes"],
                                TRIPLANE["feature_channels"]).eval()
    gen = torch.Generator().manual_seed(6)
    planes = [{}, {}, {}]
    for s in TriPlaneVoxelDecoder.SCALES:
        for plane, shape in zip(planes, ((x // s, y // s), (x // s, z // s),
                                         (y // s, z // s))):
            plane[f"rgb_{s}"] = torch.randn((1, *shape, c), generator=gen)
    card = copy.deepcopy(host).to(dev)
    on_card = [{k: v.to(dev) for k, v in p.items()} for p in planes]
    reset_launches()
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = host(*planes)
        host_s = time.perf_counter() - t0
        got = card(*on_card)
        ms = []
        for _ in range(TRIPLANE_ITERS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            card(*on_card)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    err = {k: norm_rel(got[k], w) for k, w in want.items()}
    launched = {k: n for k, n in read_launches().items() if n}
    emit({"phase": "serving_options", "config": "TriPlaneVoxelDecoder",
          **TRIPLANE, "outputs": {k: list(v.shape) for k, v in got.items()},
          "ms": ms, "ms_median": statistics.median(ms), "host_s": host_s,
          "vs_host_norm_rel": err, "tol": TRIPLANE_TOL,
          "launches": launched})
    if not max(err.values()) <= TRIPLANE_TOL:
        raise AssertionError(f"TriPlaneVoxelDecoder card differs from "
                             f"host: {err}")
    if launched:
        raise AssertionError(f"TriPlaneVoxelDecoder launched {launched}")
    del card, on_card
    torch.cuda.empty_cache()


def serving_options_phase(dev):
    """Each of SERVED_OPTIONS through ``serve_config`` (muvo.yml with
    measurements and resnet34 camera and LiDAR trunks, on a batch that
    carries the measurement keys; muvo.yml with EVAL.RESOLUTION FACTOR 2),
    then ``triplane_vs_host``. Returns the launches by type, summed."""
    typed = {}
    for label, opts in SERVED_OPTIONS:
        add_launches(typed, serve_config(dev, config("muvo.yml", opts),
                                         "serving_options", label, seed=4))
    triplane_vs_host(dev)
    return typed


POOL_TOL = 1e-5  # FrustumPooling card vs host, fp32, norm-relative: the
# cells are the same bits, only the order of the atomic adds differs
POOL_ITERS = 20  # timed FrustumPooling calls
# serving_lifting's configurations: (label, yml or None for the default
# config, overrides)
LIFTING_SERVED = (("muvo.yml TRANSFORMER.BEV", "muvo.yml",
                   ["MODEL.TRANSFORMER.BEV", "True"]),
                  ("default config", None, []))


def config(yml=None, opts=()):
    """muvo_tpu_torch/configs/``yml`` (the defaults where None) with the
    dotted ``opts``."""
    from muvo_tpu_torch.config import get_cfg

    cfg = muvo_cfg(yml) if yml else get_cfg()
    cfg.merge_from_list(list(opts))
    return cfg


def pooling_inputs(model, pb):
    """What ``model``'s FrustumPooling is called with in an encode of the
    preprocessed ``pb`` (fp32, no autograd), and the shapes it and the
    BEV down-sampler (where there is one) give: ((x, depth, intrinsics,
    pose), {"bev": shape, "tokens": shape})."""
    seen, shapes = [], {}

    def pooled(module, args, out):
        seen.append(args)
        shapes["bev"] = list(out.shape)

    def tokens(module, args, out):
        shapes["tokens"] = list(out.shape)

    hooks = [model.frustum_pooling.register_forward_hook(pooled)]
    if getattr(model, "down_sample_bev", False):
        hooks.append(model.bev_down_sample_4.register_forward_hook(tokens))
    try:
        with torch.inference_mode():
            model.encode_frame(pb)
    finally:
        for h in hooks:
            h.remove()
    return seen[0], shapes


def pooling_vs_host(pool, args):
    """FrustumPooling on the card against a host copy on the same inputs
    ``args`` (on the card): (norm-relative error, median CUDA-event ms of
    POOL_ITERS calls, the points that count in the card's call)."""
    host = copy.deepcopy(pool).cpu()
    x, depth, k, pose = args
    with torch.inference_mode():
        got = pool(*args)
        want = host(*(a.cpu() for a in args))
        flat, valid = pool.cells(x.shape[1], x.shape[2], k, pose)
        keep = valid.reshape(x.shape[0], pool.D, *x.shape[1:3]) & (
            pool.depth_mask(depth).permute(0, 3, 1, 2) if pool.sparse
            else True)
        ms = []
        for _ in range(POOL_ITERS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            pool(*args)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    return (norm_rel(got, want), statistics.median(ms),
            {"kept": int(keep.sum()), "points": int(valid.numel()),
             "inside_grid": int(valid.sum())})


def serving_lifting_phase(dev):
    """Camera lifting served through DeploymentSession at full width, fp32,
    batch 1, seeded random weights, for each of LIFTING_SERVED: muvo.yml
    with MODEL.TRANSFORMER.BEV (stride-8 features lifted over 37 depth bins
    onto the 48 x 48 grid, 12 x 12 image tokens), and the default config
    (the MILE branch: 64-channel lifting, backbone_bev, the range view, the
    BEV, lidar_re, lidar_segmentation and voxel decoders). 3
    deployment_forward ticks, then 3 sim_forward ticks on a SERVE_SEQ-frame
    batch (5 imagined). fp32 K1 and K2 launched as
    predicted_fp32_decode_launches gives for two decodes a sim tick, no
    other kernel; outputs finite with muvo_tpu's shapes; one frame's
    embedding and one decode on the card against the port's host run
    within DECODE_TOL; that frame's FrustumPooling, card against host,
    within POOL_TOL. Returns the launches by type, summed over both."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.inference import DeploymentSession
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.ops import zconv
    from muvo_tpu_torch.utils.network import remove_past

    typed_all = {}
    for label, yml, opts in LIFTING_SERVED:
        cfg = config(yml, opts)
        torch.manual_seed(3)
        model = MuvoWorldModel(cfg)
        host_model = copy.deepcopy(model).eval().requires_grad_(False)
        session = DeploymentSession(
            model, cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        batch = synthetic_batch(cfg, batch_size=1, sequence_length=SERVE_SEQ,
                                seed=0)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        deploy_ms, sim_ms, per_tick = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            out = session.deployment_forward(batch, is_dreaming=False)
            torch.cuda.synchronize()
            deploy_ms.append((time.perf_counter() - t0) * 1e3)
        session.reset()
        for _ in range(3):
            before = read_launches()
            t0 = time.perf_counter()
            sim_out, imagined = session.sim_forward(batch, is_dreaming=False)
            torch.cuda.synchronize()
            sim_ms.append((time.perf_counter() - t0) * 1e3)
            per_tick.append({k: v - before[k]
                             for k, v in read_launches().items()
                             if v - before[k]})
        typed = read_typed_launches()
        peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        decode = predicted_fp32_decode_launches(cfg, dev)
        check_serving_outputs(cfg, out, sim_out, imagined, SERVE_SEQ)
        embed_err, embed_host_s, _ = embedding_vs_host(session, host_model,
                                                       batch, cfg)
        decode_err, decode_host_s = decode_vs_host(session, host_model, cfg)
        with torch.inference_mode():
            pb = session.preprocess(session._tensors(
                remove_past(batch, SERVE_SEQ)), labels=False)
        args, shapes = pooling_inputs(session.model, pb)
        pool_err, pool_ms, points = pooling_vs_host(
            session.model.frustum_pooling, args)
        emit({"phase": "serving_lifting", "config": label, "batch": 1,
              "sequence": SERVE_SEQ,
              "features": list(args[0].shape), "depth": list(args[1].shape),
              **shapes, "points": points,
              "deployment_tick_ms": deploy_ms, "sim_tick_ms": sim_ms,
              "sim_tick_ms_median": statistics.median(sim_ms),
              "deployment_tick_ms_median": statistics.median(deploy_ms),
              "pooling_ms": pool_ms, "peak_mib": peak_mib,
              "launches_by_type": typed, "launches_per_sim_tick": per_tick,
              "launches_per_decode_predicted": decode,
              "K1_impl": zconv.zconv3d_leaky.last_impl,
              "K2_impl": zconv.upzconv3d_leaky.last_impl,
              "embedding_vs_host_norm_rel": embed_err,
              "decode_vs_host_norm_rel": decode_err, "tol": DECODE_TOL,
              "pooling_vs_host_norm_rel": pool_err, "pool_tol": POOL_TOL,
              "host_encode_s": embed_host_s, "host_decode_s": decode_host_s})
        want = {kid: 2 * n for kid, n in decode.items() if n}
        if any(tick != want for tick in per_tick):
            raise AssertionError(f"{label}: launches a sim tick {per_tick}, "
                                 f"predicted {want}")
        if set(typed) != set(want) or any(set(t) != {"float32"}
                                          for t in typed.values()):
            raise AssertionError(f"{label}: serving launched {typed}, "
                                 f"predicted fp32 {sorted(want)} only")
        worst = max(embed_err, *decode_err.values())
        if not worst <= DECODE_TOL:
            raise AssertionError(f"{label}: card differs from host: "
                                 f"embedding {embed_err}, decode "
                                 f"{decode_err}")
        if not pool_err <= POOL_TOL:
            raise AssertionError(f"{label}: FrustumPooling card differs "
                                 f"from host: {pool_err}")
        add_launches(typed_all, typed)
        del session, model, host_model, args
        torch.cuda.empty_cache()
    return typed_all


def check_serving_outputs(cfg, out, sim_out, imagined, seq=None):
    """muvo_tpu's shapes and finite values for a deployment_forward output,
    a sim_forward output and its imagination of a ``seq``-frame batch
    (RECEPTIVE_FIELD + FUTURE_HORIZON unless given)."""
    seq = seq or cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    fh = seq - 1
    s_h, s_w = (cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1],
                cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0])
    lidar = (cfg.POINTS.CHANNELS, cfg.POINTS.HORIZON_RESOLUTION)
    expect = {"throttle_brake": (1,), "steering": (1,)}
    if cfg.EVAL.RGB_SUPERVISION:
        expect.update(rgb_1=(s_h, s_w, 3), rgb_4=(s_h // 4, s_w // 4, 3))
    if cfg.LIDAR_RE.ENABLED:
        expect["lidar_reconstruction_1"] = (*lidar, 4)
    if cfg.LIDAR_SEG.ENABLED:
        expect["lidar_segmentation_1"] = (*lidar, cfg.LIDAR_SEG.N_CLASSES)
    if cfg.SEMANTIC_SEG.ENABLED:
        expect["bev_segmentation_1"] = (cfg.BEV.SIZE[1], cfg.BEV.SIZE[0],
                                        cfg.SEMANTIC_SEG.N_CHANNELS)
    if cfg.VOXEL_SEG.ENABLED:
        expect.update(voxel_1=(*cfg.VOXEL.SIZE, cfg.VOXEL_SEG.N_CLASSES),
                      voxel_2=(*(v // 2 for v in cfg.VOXEL.SIZE),
                               cfg.VOXEL_SEG.N_CLASSES))
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
            k5_impl = fa.flash_bwd.last_impl
            if k5_impl != fa.kernel_name("K5", dtype, d):
                raise AssertionError(f"K5 {label} {dtype}: ran {k5_impl}")
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
                       "impl": _wrapper(kid).last_impl,
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
    err, host_s, frame = embedding_vs_host(session, host_model, batch, cfg)
    frame_k4 = frame["K4"]
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


DDP_RANKS = 2  # train_ddp: ranks sharing the one card under gloo
# the steps held against one process: as trained (bf16 autocast), and in
# fp32 (TF32 off), where the one process's own noise is small enough for
# the check to see a fault (in bf16 a relative 1e-7 change of the
# parameters moves its gradient leaves by a median 0.32 norm-relative)
DDP_CHECKS = ("bfloat16", "float32")
DDP_STEPS = 4  # train.main steps under the ranks (ACCUMULATE 2: 2 updates)
DDP_TIMEOUT = 600.0  # seconds each rank may take
RL_STEPS = 512  # train_rl: one rollout of the kinematic env
RL_BATCH = 256  # PPO's minibatch
RL_CHECK = 64  # the minibatch of the card-against-host update
RL_TOL = 1e-5  # PPO policy card against host, fp32, norm-relative


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def state_sha256(model) -> str:
    """sha256 of a model's parameters and buffers, in state_dict order."""
    import hashlib

    h = hashlib.sha256()
    for key, value in model.state_dict().items():
        h.update(key.encode())
        h.update(value.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def ddp_rank_step(cfg, dev, rows, dtype: str, work: Path):
    """A rank's step without noise from the seed's weights on ``rows`` in
    ``dtype`` ("bfloat16": autocast; "float32": TF32 off), timed (the last
    of three warm), its gradients averaged over the ranks and timed; rank
    0 saves the losses and the averaged gradients to ddp_<dtype>.pt."""
    from muvo_tpu_torch.parallel import mesh
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = WorldModelTrainer(cfg, device=dev,
                                compute_dtype=getattr(torch, dtype))
    trainer.init_state(seed=0)
    grads_ms = []
    for _ in range(2):  # the second is timed warm
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        metrics, _ = trainer.grads(rows, stochastic=False)
        torch.cuda.synchronize(dev)
        grads_ms.append((time.perf_counter() - t0) * 1e3)
    model = trainer.state.model
    t0 = time.perf_counter()
    mesh.average_gradients(model.parameters())
    torch.cuda.synchronize(dev)
    out = {"grads_ms": grads_ms,
           "allreduce_ms": (time.perf_counter() - t0) * 1e3,
           "allreduce_mib": sum(p.grad.numel() * p.grad.element_size()
                                for p in model.parameters()
                                if p.grad is not None) / 2 ** 20,
           "peak_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20}
    if mesh.rank() == 0:
        torch.save({"losses": {k: v.item() for k, v in metrics.items()},
                    "grads": {n: p.grad.cpu() for n, p in
                              model.named_parameters()}},
                   work / f"ddp_{dtype}.pt")
    return out


def ddp_rank(rank: int, world: int, port: int, work: str, argv):
    """One rank of train_ddp (a process of its own, joining the group as
    torchrun would start it): muvo.yml's step without noise on its half
    of a seeded batch of ``world`` in each of DDP_CHECKS (ddp_rank_step),
    then ``train.main`` with ``argv`` on the drive, its launches counted.
    Writes ddp_rank<r>.json."""
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world),
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.parallel import mesh
    from muvo_tpu_torch.train import main as train_main

    work = Path(work)
    out = {"rank": rank}
    try:
        dev = mesh.init_from_env()
        out.update(device=str(dev), backend=dist.get_backend())
        cfg = muvo_cfg()
        batch = synthetic_batch(cfg, world, seed=5)
        rows = {k: v[rank:rank + 1] for k, v in batch.items()}
        for dtype in DDP_CHECKS:
            out[dtype] = ddp_rank_step(cfg, dev, rows, dtype, work)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        with instrumented_train_loop(dev) as rec:
            run = train_main(list(argv), device=dev)
        out["launches"] = read_typed_launches()
        out.update(train_ms=rec["train_ms"], gap_ms=rec["gap_ms"],
                   save_s=rec["save_s"], log_dir=run.log_dir,
                   steps=run.step, updates=run.trainer.state.optimizer.updates,
                   state_sha256=state_sha256(run.trainer.state.model),
                   main_peak_mib=torch.cuda.max_memory_allocated(dev)
                   / 2 ** 20)
    except BaseException as e:
        out["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        (work / f"ddp_rank{rank}.json").write_text(json.dumps(out))
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ddp_ranks(work: Path, argv, world: int):
    """``world`` ddp_rank processes, spawned; every rank's record. A rank
    that fails, exits nonzero or outlives DDP_TIMEOUT fails the phase (the
    others are stopped)."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=ddp_rank,
                         args=(r, world, port, str(work), argv), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    start = time.monotonic()
    try:
        for p in procs:
            p.join(max(0.0, DDP_TIMEOUT - (time.monotonic() - start)))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    records = [json.loads(path.read_text()) if path.is_file() else {}
               for path in (work / f"ddp_rank{r}.json"
                            for r in range(world))]
    if late or any(p.exitcode for p in procs) or any(
            "error" in r or not r for r in records):
        raise AssertionError(f"train_ddp ranks: late {late}, exit codes "
                             f"{[p.exitcode for p in procs]}, "
                             f"{[r.get('error') for r in records]}")
    return records


DDP_TOL = {"bfloat16": (BF16_TOL, BF16_TOL),  # (each loss, each leaf)
           "float32": (LOSS_TOL, GRAD_TOL)}


def ddp_vs_one(cfg, dev, dtype: str, saved, world: int):
    """The ranks' ``dtype`` step (``saved``: rank 0's losses and averaged
    gradients) against one process's at batch ``world``, same weights:
    each loss term within DDP_TOL's first relative, each gradient leaf
    within its second norm-relative plus NOISE_FACTOR x the one process's
    own noise, the larger of its change from a rescaled loss (seed_noise)
    and from every parameter moved by a relative ULP (host_noise).
    Returns (readings, failures)."""
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    one = WorldModelTrainer(cfg, device=dev,
                            compute_dtype=getattr(torch, dtype))
    one.init_state(seed=0)
    batch = synthetic_batch(cfg, world, seed=5)
    want_m, want_g = one.grads(batch, stochastic=False)
    want_g = {k: g.detach().clone() for k, g in want_g.items()}
    seeded = seed_noise(one, batch, want_g)
    moved = host_noise(one, batch, want_g)
    noise = {k: max(seeded[k], moved[k]) for k in want_g}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    del one
    torch.cuda.empty_cache()
    loss_tol, grad_tol = DDP_TOL[dtype]
    loss_rel = {k: abs(saved["losses"][k] - v.item()) / max(abs(v.item()),
                                                           1e-6)
                for k, v in want_m.items()}
    grad_rel = {k: norm_rel(saved["grads"][k], g) for k, g in want_g.items()}
    failures = [(k, grad_rel[k], noise[k]) for k in grad_rel
                if not grad_rel[k] <= grad_tol + NOISE_FACTOR * noise[k]]
    failures += [(k, v) for k, v in loss_rel.items() if not v <= loss_tol]
    return {"one_process_peak_mib": peak,
            "check_s": time.perf_counter() - t0,
            "max_loss_rel": max(loss_rel.values()),
            "worst_loss": max(loss_rel, key=loss_rel.get),
            "max_grad_norm_rel": max(grad_rel.values()),
            "median_grad_norm_rel": statistics.median(grad_rel.values()),
            "worst_grad": max(grad_rel, key=grad_rel.get),
            "seed_noise_median": statistics.median(seeded.values()),
            "ulp_noise_median": statistics.median(moved.values()),
            "worst_over_noise": max((grad_rel[k] - grad_tol)
                                    / max(noise[k], 1e-30)
                                    for k in grad_rel),
            "worst_leaves_over_noise": sorted(
                ((k, grad_rel[k], noise[k]) for k in grad_rel),
                key=lambda t: -(t[1] - grad_tol) / max(t[2], 1e-30))[:5],
            "grad_leaves": len(grad_rel), "loss_tol": loss_tol,
            "grad_tol": grad_tol}, failures


def train_ddp_phase(dev, work: Path, world: int = DDP_RANKS):
    """``world`` ranks (DDP_RANKS sharing the one card under gloo, unless
    asked for more; NCCL where every rank has a card of its own) at
    muvo.yml's full width, one sequence each. (a) One step without noise
    from the seed's weights on a seeded batch of ``world``, in bf16 (as
    trained) and in fp32, its gradients averaged over the ranks, held
    against one process's step at that batch with the same weights
    (ddp_vs_one). (b) ``train.main`` on train_entry's drive under the
    ranks, muvo.yml but for a global batch of ``world``,
    ACCUMULATE_GRAD_BATCHES 2 and DDP_STEPS steps: the ranks' parameters
    and buffers bit-equal at the end, rank 0 alone logging and writing one
    checkpoint whose sidecar records the world size, bf16 K1, K2, K1-dx,
    K2-dx, K3 and K3-up launched as predicted on each rank. Prints each
    rank's step ms, the gradients' all-reduce ms and each rank's peak MiB.
    Returns the ranks' launches by type, summed."""
    from muvo_tpu_torch.training.flagship import MUVO_YML

    phase_t0 = time.perf_counter()
    cfg = muvo_cfg()
    argv = ["--config-file", str(MUVO_YML),
            "DATASET.DATAROOT", str(work / "drives"),
            "DATASET.FILTER_BEGINNING_OF_RUN_SEC", "0.0",
            "LOG_DIR", str(work / "ddp"), "BATCHSIZE", str(world),
            "OPTIMIZER.ACCUMULATE_GRAD_BATCHES", "2",
            "STEPS", str(DDP_STEPS), "LOGGING_INTERVAL", "1",
            "VAL_CHECK_INTERVAL", "1000"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ddp_ranks(work, argv, world)
    ranks_s = time.perf_counter() - t0
    checks, failures = {}, {}
    for dtype in DDP_CHECKS:
        path = work / f"ddp_{dtype}.pt"
        saved = torch.load(path, weights_only=True)
        path.unlink()
        checks[dtype], failures[dtype] = ddp_vs_one(cfg, dev, dtype, saved,
                                                    world)
        checks[dtype].update({key: [r[dtype][key] for r in ranks]
                              for key in ("grads_ms", "allreduce_ms",
                                          "peak_mib")},
                             allreduce_mib=ranks[0][dtype]["allreduce_mib"])
    per_step = predicted_launches(cfg)
    launches = {}
    for r in ranks:
        for kid, types in r["launches"].items():
            for dtype, n in types.items():
                counts = launches.setdefault(kid, {})
                counts[dtype] = counts.get(dtype, 0) + n
    ckpts = sorted(Path(ranks[0]["log_dir"], "checkpoints").glob("ckpt_*"))
    meta = Path(ranks[0]["log_dir"], "checkpoints", f"meta_{DDP_STEPS}.json")
    recorded = json.loads(meta.read_text())["metadata"]["world_size"]
    records = logged_losses(ranks[0]["log_dir"])
    emit({"phase": "train_ddp", "config": "muvo.yml", "ranks": world,
          "backend": [r["backend"] for r in ranks],
          "devices": [r["device"] for r in ranks], "ranks_s": ranks_s,
          "phase_s": time.perf_counter() - phase_t0,
          "steps_vs_one_process": checks, "noise_factor": NOISE_FACTOR,
          "main_step_ms": [r["train_ms"] for r in ranks],
          "main_gap_ms": [r["gap_ms"] for r in ranks],
          "main_peak_mib": [r["main_peak_mib"] for r in ranks],
          "ckpt_save_s": [r["save_s"] for r in ranks],
          "updates": [r["updates"] for r in ranks],
          "state_sha256": [r["state_sha256"] for r in ranks],
          "checkpoints": [p.name for p in ckpts], "world_size": recorded,
          "logged_records": len(records), "launches": launches,
          "launches_per_rank_step_predicted": per_step})
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    if set(r["backend"] for r in ranks) != {backend} or (
            backend == "nccl"
            and len({r["device"] for r in ranks}) != world):
        raise AssertionError(f"{world} ranks on {torch.cuda.device_count()} "
                             f"card(s) must use {backend}, a card each "
                             f"where they have one")
    if any(failures.values()):
        raise AssertionError(f"the {world}-rank steps differ from one "
                             f"process's: "
                             f"{ {k: v[:5] for k, v in failures.items()} }")
    if len({r["state_sha256"] for r in ranks}) != 1:
        raise AssertionError("the ranks' parameters differ after train.main")
    if [r["updates"] for r in ranks] != [DDP_STEPS // 2] * world:
        raise AssertionError(f"updates {[r['updates'] for r in ranks]}")
    if [p.name for p in ckpts] != [f"ckpt_{DDP_STEPS}.pt"] or (
            recorded != world):
        raise AssertionError(f"checkpoints {ckpts}, world_size {recorded}")
    if [r["step"] for r in records if "train_loss" in r] != list(
            range(1, DDP_STEPS + 1)):
        raise AssertionError("rank 0 did not log each step once")
    for kid in KERNEL_NAMES:
        want = per_step[kid] * DDP_STEPS * world
        got = launches.get(kid, {})
        if got.get("bfloat16", 0) != want or set(got) - {"bfloat16"}:
            raise AssertionError(f"{kid}: {got} launches under the ranks, "
                                 f"predicted {want} bf16")
    return launches


def rl_batch(buffer, idx):
    return {k: v[idx] for k, v in buffer.flatten().items()}


def train_rl_phase(dev):
    """The PPO expert at full width: XtMaCNN on the kinematic env's
    15 x 192 x 192 birdview (fp32, TF32 off). One RL_STEPS-step rollout
    with sampled actions; the deterministic forward on 16 of its frames
    and one PPO update on RL_CHECK of them, card against host from the same
    weights, within RL_TOL norm-relative (each output, each parameter
    after the update); then PPO's train over the rollout, one epoch of
    RL_BATCH minibatches. Prints the rollout's frames/s and the update
    ms."""
    import numpy as np

    from muvo_tpu_torch.rl.policy import PpoPolicy
    from muvo_tpu_torch.rl.ppo import PPO, RolloutBuffer
    from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv
    from muvo_tpu_torch.train_rl import rollout

    phase_t0 = time.perf_counter()
    torch.manual_seed(0)
    host = PpoPolicy()
    policy = copy.deepcopy(host).to(dev)
    env = KinematicDrivingEnv(seed=0, episode_steps=300)
    obs = env.reset()
    buffer = RolloutBuffer(RL_STEPS, {"birdview": (15, 192, 192),
                                      "state": (6,)})
    generator = torch.Generator(device=dev).manual_seed(1)
    state = {"last_done": 0.0, "ep_reward": 0.0, "episodes": []}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    obs = rollout(env, obs, policy, buffer, generator, dev, state)
    torch.cuda.synchronize(dev)
    rollout_s = time.perf_counter() - t0
    buffer.compute_returns_and_advantage(np.zeros(1, np.float32),
                                         np.array([state["last_done"]]))
    check = rl_batch(buffer, np.arange(16))
    with torch.no_grad():
        got = policy(torch.from_numpy(check["obs_birdview"]).to(dev),
                     torch.from_numpy(check["obs_state"]).to(dev),
                     deterministic=True)
        want = host(torch.from_numpy(check["obs_birdview"]),
                    torch.from_numpy(check["obs_state"]),
                    deterministic=True)
    forward_rel = [norm_rel(g, w) for g, w in zip(got, want)]
    mb = rl_batch(buffer, np.arange(RL_CHECK))
    card_ppo = PPO(copy.deepcopy(policy), batch_size=RL_CHECK)
    host_ppo = PPO(host, batch_size=RL_CHECK)
    card_m = card_ppo.update(mb)
    host_m = host_ppo.update(mb)
    update_rel = {k: norm_rel(v, dict(host.named_parameters())[k])
                  for k, v in card_ppo.policy.named_parameters()}
    loss_rel = {k: abs(card_m[k].item() - v.item()) / max(abs(v.item()), 1)
                for k, v in host_m.items()}
    ppo = PPO(policy, batch_size=RL_BATCH, n_epochs=1)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    summary = ppo.train(buffer)
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    emit({"phase": "train_rl", "policy": "XtMaCNN beta",
          "birdview": [15, 192, 192], "rollout_steps": RL_STEPS,
          "rollout_s": rollout_s, "rollout_frames_per_s": RL_STEPS / rollout_s,
          "episodes": len(state["episodes"]), "ppo_batch": RL_BATCH,
          "updates": summary["n_updates"], "train_s": train_s,
          "update_ms": train_s / max(summary["n_updates"], 1) * 1e3,
          "peak_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20,
          "forward_rel": forward_rel,
          "update_max_rel": max(update_rel.values()),
          "update_worst": max(update_rel, key=update_rel.get),
          "update_loss_rel": max(loss_rel.values()), "tol": RL_TOL,
          "phase_s": time.perf_counter() - phase_t0, "summary": summary})
    if not max(forward_rel) <= RL_TOL:
        raise AssertionError(f"policy forward card vs host: {forward_rel}")
    if not (max(update_rel.values()) <= RL_TOL
            and max(loss_rel.values()) <= RL_TOL):
        raise AssertionError(f"PPO update card vs host: "
                             f"{max(update_rel.values())}, {loss_rel}")
    if summary["n_updates"] != RL_STEPS // RL_BATCH or not all(
            math.isfinite(summary[k]) for k in ("loss", "kl")):
        raise AssertionError(f"PPO train: {summary}")


PIPELINE_SEED = 0  # the collection env's seed (the drive's is +1)
# frames a split: 10 for FILTER_BEGINNING_OF_RUN_SEC 1.0, then 6-frame
# sequences at stride 2: 4 (train) and 1 (val0) after the filter
PIPELINE_FRAMES = {"train": 26, "val0": 23}
PIPELINE_STEPS = 4  # train.main steps on the collected drive, validating
                    # and saving at the last
DRIVE_TICKS = 30    # closed-loop ticks observed, and as many dreaming
PROFILED_TICKS = 10  # observed ticks under torch.profiler: the idle share
LIDAR_POINTS = 60000  # a frame's LiDAR points, as train_entry's drive


def busy_ms(prof) -> float:
    """The union of the device's kernel and copy intervals in a
    torch.profiler run, in ms; raises if it recorded none."""
    intervals = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.time_range.end > e.time_range.start)
    if not intervals:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for s, e in intervals:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def kinematic_env(cfg, seed: int, episode_steps: int):
    """The CARLA-free env at muvo.yml's sizes: the camera's 600 x 960 RGB
    and depth, the 192 x 192 birdview, LIDAR_POINTS points a frame."""
    from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv

    return KinematicDrivingEnv(seed=seed, episode_steps=episode_steps,
                               image_hw=tuple(cfg.IMAGE.SIZE),
                               bev_hw=(192, 192), lidar_points=LIDAR_POINTS)


def collect_drive(dev, cfg, data: Path):
    """(a) The untrained PPO expert (seeded, deterministic, on the card)
    drives the kinematic env through ``data_collect.run_episode`` into the
    port's DataWriter, one episode a split of PIPELINE_FRAMES. The
    expert brakes gently and stands still, so each episode is valid (no
    route deviation, not blocked within 100 steps) and its mean reward
    near 0, under muvo.yml's FILTER_NORM_REWARD (0.6)."""
    from muvo_tpu_torch import data_collect
    from muvo_tpu_torch.rl.agent import RlBirdviewAgent
    from muvo_tpu_torch.sim.data_writer import DataWriter

    expert = RlBirdviewAgent(device=dev)
    out = {}
    for split, frames in PIPELINE_FRAMES.items():
        run = data / "trainval" / split / "Town01" / "0000"
        writer = DataWriter(str(run), "hero", run_info={"town": "Town01"})
        save = writer.save_files
        saved = []

        def timed_save():
            t0 = time.perf_counter()
            save()
            saved.append(time.perf_counter() - t0)

        writer.save_files = timed_save
        t0 = time.perf_counter()
        valid, _, reward = data_collect.run_episode(
            kinematic_env(cfg, PIPELINE_SEED, 300), expert, writer, frames)
        seconds = time.perf_counter() - t0
        if not (valid and saved):
            raise AssertionError(f"the {split} episode is not valid")
        out[split] = {"run": run, "frames": frames, "seconds": seconds,
                      "save_s": saved[0], "frames_per_s": frames / seconds,
                      "mean_reward": reward / frames}
    return out


def voxelise_drive(cfg, runs):
    """(b) ``tools.generate_voxels.process_run`` at VOXEL.SIZE on each
    run, then the first train frame's rows against the plain numpy
    functions run inline on its files: equal."""
    import numpy as np
    import pandas as pd
    from PIL import Image

    from muvo_tpu_torch.data_collect import load_obs_configs
    from muvo_tpu_torch.geometry import voxel
    from muvo_tpu_torch.tools import generate_voxels as gv

    fov = load_obs_configs()["hero"]["depth_semantic"]["fov"]
    args = dict(fov=fov, resolution=cfg.VOXEL.RESOLUTION,
                size=list(cfg.VOXEL.SIZE),
                offset=gv.voxel_offset_from_cfg(cfg.VOXEL), workers=1)
    seconds = {}
    for split, r in runs.items():
        t0 = time.perf_counter()
        gv.process_run(str(r["run"]), **args)
        seconds[split] = (time.perf_counter() - t0) / r["frames"]
    run = runs["train"]["run"]
    row = pd.read_pickle(run / "pd_dataframe.pkl").iloc[0]
    img = np.asarray(Image.open(run / row["depth_semantic_path"]))
    pcd, sem = voxel.depth_to_pcd(voxel.decode_depth(img[..., :3]),
                                  img[..., -1], fov)
    lidar = np.load(run / row["points_semantic_path"],
                    allow_pickle=True).item()
    pcd, sem = voxel.merge_point_clouds(
        voxel.convert_coor_img(pcd, gv.CAMERA_POS), sem,
        voxel.convert_coor_lidar(lidar["points_xyz"].astype(np.float64),
                                 gv.LIDAR_POS), lidar["ObjTag"])
    coords, vsem = voxel.voxel_filter(pcd, sem, args["resolution"],
                                      args["size"], args["offset"])
    want = np.concatenate([coords.astype(np.uint16),
                           vsem[:, None].astype(np.uint16)], axis=1)
    got = np.load(run / row["voxel_path"])
    if not (got.dtype == want.dtype and np.array_equal(got, want)
            and len(got)):
        raise AssertionError(f"voxel rows {got.shape} differ from the "
                             f"inline run's {want.shape}")
    return {"s_per_frame": seconds, "rows_frame0": len(got)}


def train_on_drive(dev, cfg, data: Path, work: Path):
    """(c) ``train.main`` on the collected drive, muvo.yml as users run it
    (batch 1, ACCUMULATE_GRAD_BATCHES 16, bf16, remat off) but for the
    data root, the reward filter (the untrained expert's drive), the log
    dir and the run's length: PIPELINE_STEPS steps, one validation and one
    checkpoint at the last. Every logged loss finite; bf16 K1, K2, K1-dx,
    K2-dx, K3 and K3-up as predicted over the training and the validation
    steps. Returns the launches by type, the checkpoint directory and the
    readings."""
    from muvo_tpu_torch.train import main as train_main
    from muvo_tpu_torch.training.flagship import MUVO_YML

    argv = ["--config-file", str(MUVO_YML), "DATASET.DATAROOT", str(data),
            "DATASET.FILTER_NORM_REWARD", "-1.0",
            "LOG_DIR", str(work / "pipeline_logs"),
            "STEPS", str(PIPELINE_STEPS), "LOGGING_INTERVAL", "1",
            "VAL_CHECK_INTERVAL", str(PIPELINE_STEPS),
            "LIMIT_VAL_BATCHES", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with instrumented_train_loop(dev) as rec:
        t0 = time.perf_counter()
        run = train_main(argv, device=dev)
        run_s = time.perf_counter() - t0
    typed = read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    records = logged_losses(run.log_dir)
    ckpts = Path(run.log_dir) / "checkpoints"
    n_train, n_val = len(rec["train_ms"]), len(rec["eval_ms"])
    del run
    val = rec["val_launches"]
    train = {kid: {t: n - val.get(kid, {}).get(t, 0) for t, n in types.items()
                   if n - val.get(kid, {}).get(t, 0)}
             for kid, types in typed.items()}
    per_step, per_eval = predicted_launches(cfg), predicted_eval_launches(cfg)
    if (n_train, n_val) != (PIPELINE_STEPS, 1) or not any(
            "train_loss" in r for r in records):
        raise AssertionError(f"{n_train} train and {n_val} eval steps, "
                             f"{len(records)} logged records")
    if [p.name for p in ckpts.glob("ckpt_*.pt")] != [
            f"ckpt_{PIPELINE_STEPS}.pt"]:
        raise AssertionError(f"checkpoints: {sorted(ckpts.iterdir())}")
    for kid in KERNEL_NAMES:
        for what, counts, want in (
                ("training", train, per_step[kid] * n_train),
                ("validation", val, per_eval[kid] * n_val)):
            got = counts.get(kid, {})
            if got.get("bfloat16", 0) != want or set(got) - {"bfloat16"}:
                raise AssertionError(f"{kid}: {got} launches in the "
                                     f"{what} steps, predicted {want} bf16")
    return typed, ckpts, {
        "run_s": run_s, "step_ms": rec["train_ms"],
        "step_ms_median": statistics.median(rec["train_ms"][1:]),
        "host_gap_ms": rec["gap_ms"], "eval_ms": rec["eval_ms"],
        "ckpt_save_s": rec["save_s"], "ckpt_mib": rec.get("ckpt_mib"),
        "peak_mib": peak_mib, "logged_records": len(records),
        "launches_train_by_type": train, "launches_val_by_type": val,
        "launches_per_step_predicted": per_step,
        "launches_per_eval_predicted": per_eval}


def drive_agent(agent, cfg, ticks: int, want, seed: int):
    """``evaluate.run_episode`` on fresh kinematic envs of ``ticks`` steps
    until ``ticks`` ticks have run (an episode may end early on a route
    deviation). Every control finite and in range, every tick's launches
    ``want``. Returns each tick's ms and host ms (``_obs_to_frame``) and
    the episodes' statistics."""
    from muvo_tpu_torch import evaluate

    rec = {"tick_ms": [], "host_ms": [], "bad": []}
    frame, step = agent._obs_to_frame, agent.run_step

    def timed_frame(obs):
        t0 = time.perf_counter()
        out = frame(obs)
        rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def checked_step(obs, timestamp=None):
        before = read_launches()
        t0 = time.perf_counter()
        control = step(obs, timestamp)  # .item() waits for the device
        rec["tick_ms"].append((time.perf_counter() - t0) * 1e3)
        launched = {k: v - before[k] for k, v in read_launches().items()
                    if v - before[k]}
        values = [control[k] for k in ("throttle", "steer", "brake")]
        if (launched != want or not all(map(math.isfinite, values))
                or not (0 <= values[0] <= 1 and -1 <= values[1] <= 1
                        and 0 <= values[2] <= 1)):
            rec["bad"].append((len(rec["tick_ms"]), launched, control))
        return control

    agent._obs_to_frame, agent.run_step = timed_frame, checked_step
    episodes = []
    try:
        while len(rec["tick_ms"]) < ticks:
            stat, _ = evaluate.run_episode(
                kinematic_env(cfg, seed + len(episodes), ticks), agent,
                ticks - len(rec["tick_ms"]))
            episodes.append(stat)
    finally:
        del agent._obs_to_frame, agent.run_step
    if rec["bad"]:
        raise AssertionError(f"ticks off the prediction {want} or out of "
                             f"range: {rec['bad'][:3]}")
    return rec, episodes


def closed_loop(dev, cfg, ckpts: Path):
    """(d) ``evaluate.build_agent`` on the checkpoint, fp32 on the card:
    DRIVE_TICKS ticks observed, then as many dreaming, each decoding the
    192x192x64 voxels once (fp32 K1 and K2 as
    predicted_fp32_decode_launches gives, no other kernel), then
    PROFILED_TICKS observed ticks under torch.profiler for the device's
    idle share, then the last tick's decode on the card against the
    port's host run of the same weights and carry within DECODE_TOL.
    Returns the launches by type and the readings."""
    from torch.profiler import ProfilerActivity, profile

    from muvo_tpu_torch import evaluate

    t0 = time.perf_counter()
    agent = evaluate.build_agent(cfg, str(ckpts), is_dreaming=False,
                                 device=dev)
    build_s = time.perf_counter() - t0
    want = {k: n for k, n in predicted_fp32_decode_launches(cfg, dev).items()
            if n}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    runs = {}
    for label, dreaming in (("observed", False), ("dreaming", True)):
        agent.is_dreaming = dreaming
        rec, episodes = drive_agent(agent, cfg, DRIVE_TICKS, want,
                                    PIPELINE_SEED + 1)
        rest = [t - h for t, h in zip(rec["tick_ms"], rec["host_ms"])]
        runs[label] = {
            "ticks": len(rec["tick_ms"]), "episodes": episodes,
            "tick_ms_median": statistics.median(rec["tick_ms"][1:]),
            "tick_ms_mean": statistics.fmean(rec["tick_ms"][1:]),
            "tick_ms_p90": statistics.quantiles(rec["tick_ms"][1:],
                                                n=10)[-1],
            "host_ms_median": statistics.median(rec["host_ms"][1:]),
            "rest_ms_median": statistics.median(rest[1:]),
            "first_tick_ms": rec["tick_ms"][0]}
    agent.is_dreaming = False
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rec, _ = drive_agent(agent, cfg, PROFILED_TICKS, want,
                             PIPELINE_SEED + 1)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    typed = read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    busy = busy_ms(prof)
    tick_ms = sum(rec["tick_ms"])
    launches = read_launches()
    host_model = copy.deepcopy(agent.session.model).cpu()
    decode_err, host_s = decode_vs_host(agent.session, host_model, cfg)
    if launches["K4"] or set(typed) != set(want) or any(
            set(t) != {"float32"} for t in typed.values()):
        raise AssertionError(f"the drive launched {typed}, predicted fp32 "
                             f"{want} a tick only")
    return typed, {
        "build_agent_s": build_s, "runs": runs,
        "launches_per_tick": want, "peak_mib": peak_mib,
        "profiled_ticks": PROFILED_TICKS,
        "profiled_tick_ms_median": statistics.median(rec["tick_ms"]),
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share_of_wall": 1.0 - busy / wall_ms,
        "device_idle_share_of_ticks": 1.0 - busy / tick_ms,
        # the profiler stretches the host's share of a tick, not the
        # device's busy time: the same busy ms over the unprofiled
        # observed ticks' mean
        "device_idle_share_of_unprofiled_ticks": 1.0 - busy / (
            PROFILED_TICKS * runs["observed"]["tick_ms_mean"]),
        "decode_vs_host": decode_err, "decode_tol": DECODE_TOL,
        "host_decode_s": host_s}


def pipeline_phase(dev, work: Path):
    """Collect -> voxelise -> train -> drive at muvo.yml's full width, in
    ``work``, through the port's entry points: (a) collect_drive, (b)
    voxelise_drive, (c) train_on_drive, (d) closed_loop. Returns the
    launches by type of (c)'s training and validation and of (d)'s
    drive."""
    cfg = muvo_cfg()
    data = work / "pipeline"
    phase_t0 = time.perf_counter()
    collected = collect_drive(dev, cfg, data)
    voxels = voxelise_drive(cfg, collected)
    train_typed, ckpts, trained = train_on_drive(dev, cfg, data, work)
    drive_typed, drove = closed_loop(dev, cfg, ckpts)
    emit({"phase": "pipeline", "config": "muvo.yml",
          "image": list(cfg.IMAGE.SIZE), "lidar_points": LIDAR_POINTS,
          "voxel": list(cfg.VOXEL.SIZE), "env_seed": PIPELINE_SEED,
          "collect": {split: {k: v for k, v in r.items() if k != "run"}
                      for split, r in collected.items()},
          "voxelise": voxels, "train": trained, "drive": drove,
          "phase_s": time.perf_counter() - phase_t0})
    worst = max(drove["decode_vs_host"].values())
    if not worst <= DECODE_TOL:
        raise AssertionError(f"the agent's decode differs from the host's: "
                             f"{worst}")
    return train_typed, drive_typed


HEALTH_EPISODE_STEPS = 24  # a health episode's steps, in each split
HEALTH_TRAIN_STEPS = 4     # train.main steps of the health phase
HEALTH_EVAL_BATCHES = 1    # held-out batches each evaluation scores
# the health run's train.main overrides (runs/health_torch/SUMMARY.md) but
# for the length, the logging and the validation interval
HEALTH_OPTS = ("BATCHSIZE", "2", "MODEL.REMAT", "True",
               "MODEL.REMAT_ENCODER", "False", "N_WORKERS", "2",
               "OPTIMIZER.ACCUMULATE_GRAD_BATCHES", "1", "STEPS", "4",
               "LOGGING_INTERVAL", "1", "VAL_CHECK_INTERVAL", "4",
               "LIMIT_VAL_BATCHES", "1")


@contextlib.contextmanager
def timed_saves(rec):
    """Each DataWriter.save_files' seconds into ``rec``."""
    from muvo_tpu_torch.sim.data_writer import DataWriter

    save = DataWriter.save_files

    def timed(self):
        t0 = time.perf_counter()
        save(self)
        rec.append(time.perf_counter() - t0)

    DataWriter.save_files = timed
    try:
        yield rec
    finally:
        DataWriter.save_files = save


def health_phase(dev, work: Path):
    """The training-health run at muvo.yml's full width and full frames
    (muvo_tpu_torch/tools/health_run.py, python -m muvo_tpu_torch.train),
    cut to a smoke test: (a) ``collect`` one training and one held-out
    episode of HEALTH_EPISODE_STEPS steps with the scripted driver (600 x
    960, 30,000 points), a thread a split; (b) ``voxelize``; (c)
    ``evaluate --random-init`` on HEALTH_EVAL_BATCHES batches of 2; (d)
    ``train.main`` for HEALTH_TRAIN_STEPS steps at batch 2, ACCUMULATE 1,
    decoder remat, a checkpoint at the last; (e) ``evaluate`` that
    checkpoint. Every metric and loss finite, the restored step right, bf16
    K1, K2, K1-dx, K2-dx, K3 and K3-up launched as predicted in (d) and K1,
    K2 in (c) and (e), nothing else. Returns the launches by type of the
    training and of the two evaluations."""
    from concurrent.futures import ThreadPoolExecutor

    from muvo_tpu_torch.tools import health_run
    from muvo_tpu_torch.train import main as train_main
    from muvo_tpu_torch.training.flagship import MUVO_YML

    data = work / "health"
    phase_t0 = time.perf_counter()
    saves = []
    with timed_saves(saves), ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        jobs = [pool.submit(health_run.collect, str(data), split, 1,
                            HEALTH_EPISODE_STEPS, seed0)
                for split, seed0 in (("train", health_run.TRAIN_SEED0),
                                     ("val", health_run.VAL_SEED0))]
        runs = [run for job in jobs for run in job.result()]
        collect_s = time.perf_counter() - t0
    frames = sum(len(os.listdir(Path(run) / "image")) for run in runs)
    t0 = time.perf_counter()
    health_run.voxelize(str(data), health_run.flagship_cfg(str(data)))
    voxel_s = (time.perf_counter() - t0) / frames

    cfg = health_run.flagship_cfg(str(data))
    cfg.merge_from_list(list(HEALTH_OPTS))
    fwd = 2 if cfg.MODEL.REMAT else 1
    per_step = predicted_launches(cfg)
    decodes = HEALTH_EVAL_BATCHES * (1 + cfg.PREDICTION.N_SAMPLES)
    per_eval = {kid: per_step[kid] // fwd * decodes if kid in ("K1", "K2")
                else 0 for kid in KERNEL_NAMES}

    def evaluated(ckpt="", step=None):
        reset_launches()
        t0 = time.perf_counter()
        out = health_run.evaluate(
            str(data), ckpt, not ckpt, HEALTH_EVAL_BATCHES,
            str(work / f"health_eval_{step or 0}.json"), step=step,
            device=dev)
        seconds = time.perf_counter() - t0
        typed = read_typed_launches()
        for kid in KERNEL_NAMES:
            got = typed.get(kid, {})
            if got.get("bfloat16", 0) != per_eval[kid] or set(got) - {
                    "bfloat16"}:
                raise AssertionError(f"evaluate launched {kid} {got}, "
                                     f"predicted {per_eval[kid]} bf16")
        values = [v for part in ("recon", "imagine")
                  for v in out[part].values()]
        if not (values and all(map(math.isfinite, values))
                and out["step"] == (step or 0)):
            raise AssertionError(f"evaluation of step {step}: {out}")
        return out, seconds, typed

    floor, floor_s, floor_typed = evaluated()
    reset_launches()
    t0 = time.perf_counter()
    constant = health_run.evaluate(
        str(data), "", False, HEALTH_EVAL_BATCHES,
        str(work / "health_eval_constant.json"), device=dev, constant=True)
    constant_s = time.perf_counter() - t0
    values = [v for part in ("recon", "imagine")
              for v in constant[part].values()]
    if any(read_launches().values()) or not (
            values and all(map(math.isfinite, values))
            and constant["recon"]["voxel_recall"] == 1.0):
        raise AssertionError(f"constant prediction: {constant}, launches "
                             f"{read_launches()}")
    argv = ["--config-file", str(MUVO_YML), "DATASET.DATAROOT", str(data),
            "DATASET.FILTER_BEGINNING_OF_RUN_SEC", "0.0",
            "DATASET.FILTER_NORM_REWARD", "-1000.0",
            "LOG_DIR", str(work / "health_logs"), *HEALTH_OPTS]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with instrumented_train_loop(dev) as rec:
        run = train_main(argv, device=dev)
    train_typed = read_typed_launches()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    records = logged_losses(run.log_dir)
    ckpts = Path(run.log_dir) / "checkpoints"
    del run
    if len(rec["train_ms"]) != HEALTH_TRAIN_STEPS or not any(
            "train_loss" in r for r in records):
        raise AssertionError(f"{len(rec['train_ms'])} train steps, "
                             f"{len(records)} logged records")
    for kid in KERNEL_NAMES:
        got = train_typed.get(kid, {})
        want = per_step[kid] * HEALTH_TRAIN_STEPS
        if got.get("bfloat16", 0) != want or set(got) - {"bfloat16"}:
            raise AssertionError(f"train.main launched {kid} {got}, "
                                 f"predicted {want} bf16")
    trained, trained_s, trained_typed = evaluated(str(ckpts),
                                                  HEALTH_TRAIN_STEPS)
    evals = {kid: {"bfloat16": floor_typed[kid]["bfloat16"]
                   + trained_typed[kid]["bfloat16"]}
             for kid in floor_typed}
    emit({"phase": "health", "config": "muvo.yml", "frames": frames,
          "image": list(health_run.IMAGE_HW),
          "lidar_points": health_run.LIDAR_POINTS,
          "collect_s": collect_s, "frames_per_s": frames / collect_s,
          "save_s": saves, "voxel_s_per_frame": voxel_s,
          "step_ms": rec["train_ms"],
          "step_ms_median": statistics.median(rec["train_ms"][1:]),
          "host_gap_ms": rec["gap_ms"], "ckpt_save_s": rec["save_s"],
          "ckpt_mib": rec.get("ckpt_mib"), "peak_mib": peak_mib,
          "launches_per_step_predicted": per_step,
          "launches_train_by_type": train_typed,
          "launches_per_evaluation_predicted": per_eval,
          "launches_evaluate_by_type": evals,
          "evaluate_s": [floor_s, trained_s], "constant_s": constant_s,
          "random_init": {k: floor[k] for k in ("recon", "imagine")},
          "constant": {k: constant[k] for k in ("recon", "imagine")},
          "trained": {k: trained[k] for k in ("step", "recon", "imagine")},
          "phase_s": time.perf_counter() - phase_t0})
    return train_typed, evals


# the port's kernels by their CUDA names (tools/torch_profile_train.py's
# groups)
PORT_KERNEL = (r"zconv_tc_kernel|zconv_kernel<|zconv_(up_|dx_|dxup_)?f32_"
               r"kernel|dw_tc_kernel|dw_f32_kernel|sum_rows_kernel|"
               r"flash_fwd_|flash_bwd_|flash_dq_flush_kernel|scale_q_kernel")
# the most of the step's device time that no scope may claim: kernels
# outside every module range and every phase bucket (a broken backward
# mapping lands them here) ...
UNSCOPED = ("[unattributed]", "[backward]")
UNSCOPED_SHARE = 0.01
# ... and the least that the world model's scopes must claim (a broken
# forward hook leaves its kernels in the [loss] bucket around the model)
MODEL_SHARE = 0.85


def profile_step_phase(dev, work: Path):
    """``tools.profile_step.run_and_trace`` on the flagship step at full
    width (2 warm steps, 3 traced with the module scopes): every port
    kernel of the trace is attributed to a
    ``MuvoWorldModel/voxel_decoder/...`` scope, the UNSCOPED buckets hold
    under UNSCOPED_SHARE of the device time and the model's scopes at
    least MODEL_SHARE, and the six bf16 voxel kernels launched as
    predicted. Prints the top 10 scopes at depth 3 (ms a step). Returns
    the launches by type."""
    import re

    from muvo_tpu_torch.tools import profile_step as ps

    trace_dir = work / "profile_step"
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    reset_launches()
    path, fs = ps.run_and_trace(str(trace_dir), device=dev)
    typed = read_typed_launches()
    steps = ps.WARM_STEPS + ps.TRACED_STEPS
    per_step = predicted_launches(fs.cfg)
    del fs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    events = ps.load_trace(str(trace_dir))
    by_name = ps.summarize(str(trace_dir), top=10, events=events)
    by_scope = ps.summarize_by_scope(str(trace_dir), depth=3, top=10,
                                     events=events)
    components = ps.summarize_by_scope(str(trace_dir), depth=2, top=10,
                                       events=events)
    rows = ps.attribute(events)
    read_s = time.perf_counter() - t0
    port = Counter((r["scope"], r["name"]) for r in rows
                   if re.search(PORT_KERNEL, r["name"]))
    stray = sorted({k for k in port
                    if not k[0].startswith("MuvoWorldModel/voxel_decoder/")})
    n = ps.TRACED_STEPS
    unscoped = sum(by_scope["ms"].get(k, 0.0) for k in UNSCOPED)
    model_ms = sum(v for k, v in by_scope["ms"].items()
                   if k.startswith("MuvoWorldModel"))
    top = sorted(by_scope["ms"].items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "profile_step", "config": "muvo.yml flagship step",
          "trace_mib": Path(path).stat().st_size / 2 ** 20,
          "trace_events": len(events), "read_s": read_s,
          "device_ms_per_step": by_name["total_ms"] / n,
          "unscoped_ms_per_step": unscoped / n,
          "model_scopes_ms_per_step": model_ms / n,
          "top_scopes_depth3_ms_per_step": [[k, v / n] for k, v in top],
          "scopes_depth2_ms_per_step": {
              k: v / n for k, v in sorted(components["ms"].items(),
                                          key=lambda kv: -kv[1])},
          "buckets_ms_per_step": {k: v / n for k, v in by_scope["ms"].items()
                                  if k.startswith("[")},
          "port_kernels": {f"{s} {name}": c for (s, name), c in port.items()},
          "launches_by_type": typed, "launches_per_step_predicted": per_step,
          "phase_s": time.perf_counter() - phase_t0})
    # a sanity sum: both read the same device events, so they agree by
    # construction; the attribution is held by the checks below
    if not abs(by_scope["total_ms"] - by_name["total_ms"]) <= (
            1e-3 * by_name["total_ms"]):
        raise AssertionError(f"by scope {by_scope['total_ms']} ms, by name "
                             f"{by_name['total_ms']}")
    if not unscoped < UNSCOPED_SHARE * by_name["total_ms"]:
        raise AssertionError(f"{unscoped} ms of {by_name['total_ms']} in "
                             f"{UNSCOPED}, claimed by no scope")
    if not model_ms >= MODEL_SHARE * by_name["total_ms"]:
        raise AssertionError(f"the model's scopes claim {model_ms} ms of "
                             f"{by_name['total_ms']}")
    if not port or stray:
        raise AssertionError(f"port kernels outside the voxel decoder's "
                             f"scopes: {stray[:10]} ({len(port)} found)")
    for kid in KERNEL_NAMES:
        got = typed.get(kid, {})
        if got.get("bfloat16", 0) != per_step[kid] * steps or set(got) - {
                "bfloat16"}:
            raise AssertionError(f"profile_step launched {kid} {got}, "
                                 f"predicted {per_step[kid] * steps} bf16")
    return typed


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


# the phases in the order they run; train_ddp_all only when named
PHASES = ("kernel", "backward_kernel", "flash_kernel", "serving", "training",
          "train_entry", "prediction", "train_heads", "train_lifting",
          "train_options", "train_ddp", "train_ddp_all",
          "serving_mobilevit", "serving_lifting", "serving_options",
          "serving_large", "training_large", "microbench", "train_rl",
          "pipeline", "health", "profile_step")
# the phases on train_entry's recorded drive (prediction and train_options
# also read its panels and host gaps)
ON_ENTRY_DRIVE = ("prediction", "train_heads", "train_lifting",
                  "train_options", "train_ddp", "train_ddp_all")


def main(argv=None) -> int:
    named = sys.argv[1:] if argv is None else list(argv)
    if set(named) - set(PHASES):
        print(f"chip_smoke: phases are {' '.join(PHASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a "
              "GPU", file=sys.stderr)
        return 2
    run = set(named) or set(PHASES) - {"train_ddp_all"}
    if run & set(ON_ENTRY_DRIVE):
        run.add("train_entry")
    from muvo_tpu_torch.ops._build import build_all, build_log

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator, before a phase reads it
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

    results = kernel_phase(dev) if "kernel" in run else None
    backward = backward_kernel_phase(dev) if "backward_kernel" in run else None
    flash = flash_kernel_phase(dev) if "flash_kernel" in run else None
    paths = {}
    if "serving" in run:
        paths["serving"] = serving_phase(dev, muvo_cfg())
    if "training" in run:
        paths["training"] = training_phase(dev)
    work = Path(__file__).resolve().parent / "build" / f"run_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    try:
        if "train_entry" in run:
            paths["train_entry"], panels, entry_gap_ms = train_entry_phase(
                dev, work)
        if "prediction" in run:
            paths["prediction"], paths["sim_run"] = prediction_phase(
                dev, work, panels)
        if "train_heads" in run:
            paths["train_heads"] = train_heads_phase(dev, work)
        if "train_lifting" in run:
            paths["train_lifting"] = train_lifting_phase(dev, work)
        if "train_options" in run:
            paths["train_options"] = train_options_phase(dev, work,
                                                         entry_gap_ms)
        if "train_ddp" in run:
            paths["train_ddp"] = train_ddp_phase(dev, work)
        if "train_ddp_all" in run:
            shutil.rmtree(work / "ddp", ignore_errors=True)
            train_ddp_phase(dev, work, torch.cuda.device_count())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "serving_mobilevit" in run:
        paths["serving_mobilevit"] = serving_mobilevit_phase(dev)
    if "serving_lifting" in run:
        paths["serving_lifting"] = serving_lifting_phase(dev)
    if "serving_options" in run:
        paths["serving_options"] = serving_options_phase(dev)
    if "serving_large" in run:
        paths["serving_large"] = serving_large_phase(dev)
    if "training_large" in run:
        paths["training_large"], paths["training_large_split"] = (
            training_large_phase(dev))
    if "microbench" in run:
        paths["microbench"] = microbench_phase()
    if "train_rl" in run:
        train_rl_phase(dev)
    for phase in ("pipeline", "health", "profile_step"):
        if phase not in run:
            continue
        shutil.rmtree(work, ignore_errors=True)
        try:
            if phase == "pipeline":
                paths["pipeline_train"], paths["closed_loop"] = (
                    pipeline_phase(dev, work))
            elif phase == "health":
                paths["health_train"], paths["health_evaluate"] = (
                    health_phase(dev, work))
            else:
                paths["profile_step"] = profile_step_phase(dev, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    done = {"ok": True}
    if named:
        done["phases"] = [p for p in PHASES if p in run]
    else:
        emit({"kernels": kernel_entries(paths, results, backward, flash)})
    print(nvidia_smi(), flush=True)
    emit({**done, "device": {"platform": "gpu",
                             "kind": torch.cuda.get_device_name(0),
                             "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
