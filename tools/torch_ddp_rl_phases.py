#!/usr/bin/env python3
"""chip_smoke.py's data-parallel and PPO phases alone, on one GPU.

    python3 tools/torch_ddp_rl_phases.py [ddp] [ddp_all] [rl]

Builds the port's kernels, then runs chip_smoke.train_ddp_phase on a
recorded drive that it writes first as train_entry does (24 training
frames at muvo.yml's sizes, under build/, removed afterwards): ``ddp``
with two ranks sharing the first card under gloo, as chip_smoke.py runs
it; ``ddp_all`` with a rank on each visible card (NCCL). Each holds
muvo.yml's bf16 and fp32 steps against one process's, then runs
``muvo_tpu_torch.train.main`` under the ranks. ``rl`` runs
chip_smoke.train_rl_phase (the PPO expert's rollout and update on the
kinematic env, card against host). ``ddp`` and ``rl`` by default. Each
phase prints its JSON lines and raises on a failed check. Needs CUDA; it
has no CPU mode.
"""

import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

PHASES = ("ddp", "ddp_all", "rl")


def main() -> int:
    phases = sys.argv[1:] or ["ddp", "rl"]
    if set(phases) - set(PHASES):
        print(f"phases are {PHASES}, got {phases}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_ddp_rl_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from muvo_tpu_torch.ops._build import build_all

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator, before a phase reads it
    print(chip_smoke.nvidia_smi(), flush=True)
    build_all()
    worlds = [world for phase, world in (
        ("ddp", chip_smoke.DDP_RANKS),
        ("ddp_all", torch.cuda.device_count())) if phase in phases]
    if worlds:
        work = Path(chip_smoke.__file__).resolve().parent / "build" / (
            f"ddp_{os.getpid()}")
        try:
            t0 = time.perf_counter()
            chip_smoke.record_drive(work / "drives" / "trainval" / "train"
                                    / "Town01" / "0000",
                                    chip_smoke.muvo_cfg(), 24, 0)
            print(f"drive written in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            for world in worlds:
                shutil.rmtree(work / "ddp", ignore_errors=True)
                chip_smoke.train_ddp_phase(dev, work, world)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if "rl" in phases:
        chip_smoke.train_rl_phase(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
