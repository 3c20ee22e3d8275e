#!/usr/bin/env python3
"""Where a serving tick of the PyTorch port spends its time, on one GPU.

    python3 tools/torch_profile_serving.py [--ticks 3] [--large] [--out PATH]

Builds muvo.yml at full width with seeded random weights (as chip_smoke.py
does; ``--large``: with MODEL.TRANSFORMER.LARGE, stride-8 features and
5,184 fusion tokens a frame through the flash kernels), warms a
DeploymentSession up, then measures:

1. phases: host-clock milliseconds, each ending in torch.cuda.synchronize,
   of the three parts of a sim_forward tick at batch 1: observe (preprocess,
   encoders, transformer, RSSM posterior), decode (policy and the three
   decoders on one state) and imagine (a 5-step prior rollout, then the
   decoders on 5 states); median of --ticks repeats;
2. kernels: torch.profiler over --ticks whole sim_forward ticks: the wall
   time, the device's busy time (the union of its kernels' intervals) and
   idle share, and device time summed by kernel name, with the port's own
   kernels (zconv_kernel: K1 and K2; flash_fwd_kernel: K4) named.

Prints one JSON object and writes it to --out. Needs CUDA; it has no CPU
mode.
"""

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _busy_us(intervals):
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--large", action="store_true",
                    help="MODEL.TRANSFORMER.LARGE (flash kernels)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    out_path = Path(args.out or ROOT / "build" / (
        "torch_profile_serving_large.json" if args.large
        else "torch_profile_serving.json"))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    from muvo_tpu_torch.config import get_cfg
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.inference import DeploymentSession, LatentCarry
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.utils.network import remove_past

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "muvo_tpu_torch" / "configs" / "muvo.yml"))
    cfg.MODEL.TRANSFORMER.LARGE = args.large
    torch.manual_seed(0)
    session = DeploymentSession(
        MuvoWorldModel(cfg), cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    batch = synthetic_batch(cfg, batch_size=1, sequence_length=seq, seed=0)
    for _ in range(2):  # builds the kernels, warms cuDNN and the allocator
        session.sim_forward(batch, is_dreaming=False)
    torch.cuda.synchronize()

    # ---- phases of one tick ------------------------------------------
    first = session._tensors(remove_past(batch, cfg.RECEPTIVE_FIELD))
    carry = LatentCarry(*(copy.copy(t) for t in session.carry))
    fh = seq - 1
    actions = torch.cat([torch.as_tensor(batch["throttle_brake"][:, :fh]),
                         torch.as_tensor(batch["steering"][:, :fh])],
                        dim=-1).to(dev)
    phases = {
        "observe": lambda: session.observe_update(first, carry),
        "decode": lambda: session.decode(carry),
        "imagine": lambda: session.imagine_rollout(carry, actions),
    }
    phase_ms = {}
    for name, fn in phases.items():
        times = []
        for _ in range(args.ticks):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        phase_ms[name] = statistics.median(times)

    # ---- kernels over whole ticks ------------------------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            session.reset()
            session.sim_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.ticks
    by_name, intervals = defaultdict(float), []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        if t <= s:
            continue
        by_name[e.name] += (t - s) / 1e3 / args.ticks
        intervals.append((s, t))
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _busy_us(intervals) / 1e3 / args.ticks
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    zconv_ms = sum(v for k, v in by_name.items() if "zconv_kernel" in k)
    flash_ms = sum(v for k, v in by_name.items() if "flash_fwd_kernel" in k)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "config": "muvo.yml LARGE" if args.large else "muvo.yml",
        "batch": 1, "sequence": seq,
        "ticks": args.ticks, "phase_ms": phase_ms,
        "tick_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "zconv_kernels_ms": zconv_ms, "flash_kernels_ms": flash_ms,
        "device_ms_by_kernel": [[k, v] for k, v in top[:25]],
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
