#!/usr/bin/env python3
"""K4-mb against K4 on one GPU: what the softmax costs the flash forward.

    python3 tools/torch_flash_microbench.py [--iters 20] [--out PATH]

K4-mb (muvo_tpu_torch.ops.flash_attention.flash_matmul) is K4's kernel
with the softmax left out: (q^ k^T cast to v's type) v with fp32
accumulation, the port of tools/pallas_smalld_microbench.py's kernel. Both
run at bh 16, n 5184 (the LARGE path's tokens a frame), d 32 and 48, bf16,
timed with CUDA events over --iters launches after a warm-up, each beside
its bound: 4 bh n^2 d operations over the bf16 tensor-core peak and, for
K4, bh n^2 exponentials over the SFUs' rate. Each kernel is first held
against its plain version (norm-relative, bf16 2e-2).

Prints one JSON object and writes it to --out. Needs CUDA; it has no CPU
mode.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BH, N = 16, 5184
BF16_PEAK = 989e12  # H100 SXM dense bf16, NVIDIA's data sheet
# the SFUs: 16 exponentials a clock on each of the 132 SMs at the 1.98 GHz
# boost clock (CUDA programming guide's throughput table, compute 9.0)
EXP_PER_S = 132 * 16 * 1.98e9
TOL = 2e-2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "torch_flash_microbench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from muvo_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for d in (32, 48):
        q, k, v = (torch.randn((BH, N, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        kernels = {
            "K4-mb": (lambda: fa.flash_matmul(q, k, v),
                      lambda: fa.flash_matmul_plain(q, k, v), 0),
            "K4": (lambda: fa.flash_fwd(q, k, v)[0],
                   lambda: fa.flash_fwd_plain(q, k, v)[0], BH * N * N),
        }
        for name, (kernel, plain, exps) in kernels.items():
            got, want = kernel().double(), plain().double()
            rel = ((got - want).norm() / want.norm()).item()
            if not rel <= TOL:
                raise AssertionError(f"{name} d={d}: {rel} > {TOL}")
            for _ in range(3):
                kernel()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                kernel()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.iters
            flops = 4 * BH * N * N * d
            t_ops, t_exp = flops / BF16_PEAK * 1e3, exps / EXP_PER_S * 1e3
            rows.append({
                "kernel": name, "bh": BH, "n": N, "d": d, "dtype": "bfloat16",
                "ms": ms, "norm_rel_err": rel,
                "tflops_per_s": flops / ms / 1e9,
                "bound_ms": max(t_ops, t_exp),
                "bound_by": "exponentials" if t_exp > t_ops else "operations"})
        del q, k, v
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "iters": args.iters, "rows": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
