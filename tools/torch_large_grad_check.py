#!/usr/bin/env python3
"""The LARGE training step's split-against-fused gradient check of
chip_smoke.py, repeated in one process, on one GPU.

    python3 tools/torch_large_grad_check.py [--repeats 3]

Builds the port's kernels, then runs chip_smoke.training_large_phase
--repeats times: each builds the LARGE flagship step (1 sequence of 6
frames, bf16, 5,184 fusion tokens a frame), times its train steps, and
holds every gradient leaf of the split backward (K6) against the fused
one's (K5) within 2e-2 plus 8x the fused gradient's own noise, the larger
of its change on a rerun and its change from a scaled loss. Each phase
prints its JSON lines (``training_large_split`` names the five leaves
nearest their limits); the last line gives how many repeats passed. Exits
1 if one failed. Needs CUDA; it has no CPU mode.
"""

import argparse
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_large_grad_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from muvo_tpu_torch.ops._build import build_all

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator, before the phase reads it
    print(chip_smoke.nvidia_smi(), flush=True)
    build_all()
    failed = []
    for i in range(args.repeats):
        try:
            chip_smoke.training_large_phase(dev)
        except AssertionError:
            traceback.print_exc()
            failed.append(i)
    print(json.dumps({"repeats": args.repeats, "failed": failed}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
