#!/usr/bin/env python3
"""K4, K4-mb and K5 on one GPU: right at the tile edges, then timed launch by
launch at the LARGE path's shape beside the library's attention.

    python3 tools/torch_flash_probe.py [--iters 12] [--out PATH]

1. edges: bf16 and fp32, K4 (o, lse), K4-mb and K5 (dq, dk, dv) against
   their plain versions at the shapes where the kernels' tiles end (n
   just under, on and past 128, seq_len on and past a 128-key tile, d 32,
   48 and 64), norm-relative (bf16 2e-2, fp32 1e-4, as chip_smoke.py).
2. timing: each kernel --iters times in a row, one CUDA event between
   launches, so a slow launch shows on its own: bf16 K4, K4-mb and K5 at
   bh 48, n 5184, d 48 and 32, fp32 K4 at bh 48 and 8 (the LARGE training
   and serving shapes), each beside scaled_dot_product_attention (and its
   backward alone for K5) on the same inputs.

Prints one JSON object and writes it to --out. Needs CUDA; it has no CPU
mode.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (bh, n, d, seq_len)
EDGES = ((1, 128, 48, None), (2, 127, 32, None), (3, 129, 64, None),
         (2, 257, 48, 128), (2, 257, 32, 129), (2, 300, 48, 200),
         (2, 200, 64, 60), (1, 64, 48, None))
N = 5184
TIMED = ((torch.bfloat16, 48, 48), (torch.bfloat16, 48, 32),
         (torch.float32, 48, 48), (torch.float32, 8, 48))


def norm_rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


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


def inputs(dev, bh, n, d, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "torch_flash_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from muvo_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    edges = []
    for dtype in (torch.bfloat16, torch.float32):
        for bh, n, d, seq_len in EDGES:
            q, k, v, do = inputs(dev, bh, n, d, dtype)
            o, lse = fa.flash_fwd(q, k, v, seq_len)
            got = {"o": o, "lse": lse, "mb": fa.flash_matmul(q, k, v)}
            got.update(zip(("dq", "dk", "dv"),
                           fa.flash_bwd(q, k, v, o, lse, do, seq_len)))
            torch.cuda.synchronize()
            want = dict(zip(("o", "lse"), fa.flash_fwd_plain(q, k, v, seq_len)))
            want["mb"] = fa.flash_matmul_plain(q, k, v)
            want.update(zip(("dq", "dk", "dv"),
                            fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)))
            rel = {key: norm_rel(got[key], want[key]) for key in got}
            edges.append({"dtype": str(dtype).replace("torch.", ""), "bh": bh,
                          "n": n, "d": d, "seq_len": seq_len, "rel": rel})
            bad = {key: r for key, r in rel.items() if not r <= TOL[dtype]}
            if bad:
                raise AssertionError(f"{dtype} {(bh, n, d, seq_len)}: {bad}")
    timed = []
    for dtype, bh, d in TIMED:
        q, k, v, do = inputs(dev, bh, N, d, dtype)
        o, lse = fa.flash_fwd(q, k, v)
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        runs = {"K4": lambda: fa.flash_fwd(q, k, v),
                "K4-mb": lambda: fa.flash_matmul(q, k, v),
                "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4)}
        if dtype == torch.bfloat16:
            lib = F.scaled_dot_product_attention(q4, k4, v4)
            runs["K5"] = lambda: fa.flash_bwd(q, k, v, o, lse, do)
            runs["sdpa_bwd"] = lambda: torch.autograd.grad(
                lib, (q4, k4, v4), do[None], retain_graph=True)
        for name, fn in runs.items():
            ms = per_launch(fn, args.iters)
            timed.append({"kernel": name, "dtype": str(dtype).replace(
                "torch.", ""), "bh": bh, "n": N, "d": d, "ms": ms,
                "ms_median": sorted(ms)[len(ms) // 2]})
        del q, k, v, do, o, lse, q4, k4, v4, runs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "edges": edges, "timed": timed}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
