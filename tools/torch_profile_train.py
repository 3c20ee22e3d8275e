#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one GPU.

    python3 tools/torch_profile_train.py [--steps 3] [--large] [--out PATH]

Builds the flagship step (muvo_tpu_torch.training.flagship: muvo.yml at
full width, 4 sequences of 6 frames, bf16 autocast, decoder remat, AdamW +
OneCycle; ``--large``: the LARGE step, 1 sequence of 6 frames with 5,184
fusion tokens a frame through the flash kernels), warms it up, then
measures:

1. phases: host-clock milliseconds, each ending in torch.cuda.synchronize,
   of the parts of one step: preprocess (labels and augmentation), forward
   (model and every loss, under autocast), backward (with the decoders'
   recompute) and optimizer (AdamW); median of --steps repeats;
2. kernels: torch.profiler over --steps whole train steps: the wall time,
   the device's busy time (the union of its kernels' intervals) and idle
   share, device time summed by kernel name and by group. The port's
   kernels are named: zconv_f32_kernel<CO> and zconv_dx_f32_kernel (fp32),
   zconv_kernel<bf16> (past 64 channels) and zconv_tc_kernel<N, K, false,
   DX> (bf16, no edge terms) are K1 and K1-dx (bf16: one kernel, launched
   on the flipped weights for dx), zconv_up_f32_kernel<CO> (fp32) and
   zconv_tc_kernel<N, K, true, false> (bf16) K2, zconv_dxup_f32_kernel
   (fp32) and zconv_tc_kernel<N, K, true, true> (bf16) K2-dx,
   dw_f32_kernel<false>
   (fp32) and dw_tc_kernel<N, MT, false> (bf16) K3, dw_f32_kernel<true>
   and dw_tc_kernel<N, MT, true> K3-up, sum_rows_kernel K3's second pass,
   flash_fwd_wgmma<D, true> (bf16) and flash_fwd_f32<D, true> K4,
   flash_bwd_wgmma<D, true> (bf16, with flash_dq_flush_kernel, its last
   pass) and flash_bwd_kv_f32<D, true> (fp32) K5,
   flash_bwd_dq_wgmma<D> (bf16) and flash_bwd_q_f32<D> (fp32) K6-dq,
   flash_bwd_wgmma<D, false> (bf16) and flash_bwd_kv_f32<D, false> (fp32)
   K6-dkv, and scale_q_kernel the first pass of bf16 K5 and K6-dkv
   (q^ for their TMA), a group of its own.

Prints one JSON object and writes it to --out. Needs CUDA; it has no CPU
mode.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from torch_profile_serving import _busy_us  # noqa: E402

# device-time groups, first match wins
GROUPS = (
    ("K4 (flash_fwd_wgmma / flash_fwd_f32<D, true>)",
     r"flash_fwd_(wgmma|f32)<[^>]*true>"),
    ("K5 (flash_bwd_wgmma<D, true> or flash_bwd_kv_f32<D, true>, "
     "with flash_dq_flush_kernel)",
     r"flash_bwd_(wgmma|kv_f32)<\d+, true>|flash_dq_flush_kernel"),
    ("K6-dq (flash_bwd_dq_wgmma<D>, fp32 flash_bwd_q_f32<D>)",
     r"flash_bwd_dq_wgmma|flash_bwd_q_f32"),
    ("K6-dkv (flash_bwd_wgmma<D, false>, fp32 flash_bwd_kv_f32<D, false>)",
     r"flash_bwd_(wgmma|kv_f32)<\d+, false>"),
    ("q^ for K5 and K6-dkv (scale_q_kernel)", r"scale_q_kernel"),
    ("K1 + K1-dx (zconv_f32_kernel<CO>, zconv_dx_f32_kernel, bf16 "
     "zconv_kernel<bf16>, zconv_tc_kernel<N, K, false, DX>)",
     r"zconv_(dx_)?f32_kernel|zconv_kernel<[^>]*>|"
     r"zconv_tc_kernel<\d+, \d+, false, "),
    ("K2 (zconv_up_f32_kernel<CO>, bf16 zconv_tc_kernel<N, K, true, "
     "false>)", r"zconv_up_f32_kernel|zconv_tc_kernel<\d+, \d+, true, false>"),
    ("K2-dx (zconv_dxup_f32_kernel, bf16 zconv_tc_kernel<N, K, true, "
     "true>)", r"zconv_dxup_f32_kernel|zconv_tc_kernel<\d+, \d+, true, true>"),
    ("K3 (dw_f32_kernel<false>, bf16 dw_tc_kernel<N, MT, false>)",
     r"dw_f32_kernel<false>|dw_tc_kernel<[^>]*false>"),
    ("K3-up (dw_f32_kernel<true>, bf16 dw_tc_kernel<N, MT, true>)",
     r"dw_f32_kernel<true>|dw_tc_kernel<[^>]*true>"),
    ("K3 second pass (sum_rows_kernel)", r"sum_rows_kernel"),
    ("cuDNN / cuBLAS convolutions and GEMMs",
     r"cudnn|xmma|gemm|cutlass|implicit_convolve|dgrad|wgrad|conv|"
     r"Kernel2|nchwToNhwc|nhwcToNchw"),
    ("optimizer (AdamW)", r"multi_tensor|adam|Adam"),
    ("reductions", r"reduce|Reduce|norm|Norm|softmax|topk|sort"),
    ("elementwise and copies", r"elementwise|vectorized|copy|fill|where|"
                               r"cat|index|gather|scatter"),
)


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--large", action="store_true",
                    help="the LARGE step (stride-8 features, flash kernels)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    out_path = Path(args.out or ROOT / "build" / (
        "torch_profile_train_large.json" if args.large
        else "torch_profile_train.json"))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    from muvo_tpu_torch.training.flagship import build_flagship_step
    from muvo_tpu_torch.training.objectives import compute_loss, reduce_loss
    from muvo_tpu_torch.utils.precision import autocast

    dev = torch.device("cuda", 0)
    fs = build_flagship_step(large=args.large, device=dev)
    trainer, cfg = fs.trainer, fs.cfg
    model = trainer.state.model
    for _ in range(3):  # builds the kernels, warms cuDNN and the allocator
        trainer.train_step(fs.batch, fs.generator)
    torch.cuda.synchronize()

    # ---- phases of one step ------------------------------------------
    times = defaultdict(list)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    def forward(pb):
        with autocast(trainer.device, trainer.compute_dtype):
            output, _ = model(pb, training=True, generator=fs.generator)
        return reduce_loss(compute_loss(cfg, pb, output))

    for _ in range(args.steps):
        pb = timed("preprocess", lambda: trainer.preprocess(
            dict(fs.batch), training=True, generator=fs.generator))
        loss = timed("forward", lambda: forward(pb))
        timed("backward", loss.backward)
        timed("optimizer", trainer.state.optimizer.step)
        del pb, loss
    phase_ms = {k: statistics.median(v) for k, v in times.items()}

    # ---- kernels over whole steps ------------------------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(fs.batch, fs.generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    by_name, intervals = defaultdict(float), []
    for e in prof.events():
        # user annotations (Optimizer.step#AdamW.step) span kernels on the
        # device timeline; only kernels, copies and sets count
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        s, t = e.time_range.start, e.time_range.end
        if t <= s:
            continue
        by_name[e.name] += (t - s) / 1e3 / args.steps
        intervals.append((s, t))
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _busy_us(intervals) / 1e3 / args.steps
    by_group = defaultdict(float)
    for name, ms in by_name.items():
        by_group[group_of(name)] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "config": ("muvo.yml LARGE train step" if args.large
                   else "muvo.yml flagship train step"),
        "batch": cfg.BATCHSIZE,
        "frames_per_step": cfg.BATCHSIZE * (cfg.RECEPTIVE_FIELD
                                            + cfg.FUTURE_HORIZON),
        "steps": args.steps, "phase_ms": phase_ms,
        "step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_by_group": sorted(by_group.items(), key=lambda kv: -kv[1]),
        "device_ms_by_kernel": [[k, v] for k, v in top[:30]],
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
