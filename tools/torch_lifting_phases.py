#!/usr/bin/env python3
"""chip_smoke.py's camera-lifting phases alone, on one GPU.

    python3 tools/torch_lifting_phases.py [serving] [train]

Builds the port's kernels, then runs chip_smoke.serving_lifting_phase
(muvo.yml with MODEL.TRANSFORMER.BEV, then the default config, served
through DeploymentSession in fp32) and chip_smoke.train_lifting_phase
(``muvo_tpu_torch.train.main`` with the default config, then
one_frame.yml) on a recorded drive that it writes first as train_entry
does (24 training and 14 validation frames at muvo.yml's sizes, under
build/, removed afterwards). Both by default. Each phase prints its JSON
lines and raises on a failed check. Needs CUDA; it has no CPU mode.
"""

import os
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

PHASES = ("serving", "train")


def main() -> int:
    phases = sys.argv[1:] or list(PHASES)
    if set(phases) - set(PHASES):
        print(f"phases are {PHASES}, got {phases}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_lifting_phases: no CUDA device", file=sys.stderr)
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
    if "serving" in phases:
        chip_smoke.serving_lifting_phase(dev)
    if "train" in phases:
        work = Path(chip_smoke.__file__).resolve().parent / "build" / (
            f"lifting_{os.getpid()}")
        cfg = chip_smoke.muvo_cfg()
        try:
            t0 = time.perf_counter()
            for split, frames, seed in (("train", 24, 0), ("val0", 14, 1)):
                chip_smoke.record_drive(work / "drives" / "trainval" / split
                                        / "Town01" / "0000", cfg, frames,
                                        seed)
            print(f"drive written in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            chip_smoke.train_lifting_phase(dev, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
