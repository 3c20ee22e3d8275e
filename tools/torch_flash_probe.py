#!/usr/bin/env python3
"""K4, K4-mb, K5, K6-dq and K6-dkv on one GPU: right at the tile edges, then
timed launch by launch at the LARGE path's shape beside the library's
attention.

    python3 tools/torch_flash_probe.py [--iters 12] [--out PATH]

1. edges: bf16 and fp32, K4 (o, lse), K4-mb, K5 (dq, dk, dv) and K6
   (K6-dq's dq, K6-dkv's dk, dv) against their plain versions at the
   shapes where the kernels' tiles end (n just under, on and past 128,
   seq_len on and past a 128-key tile, d 32, 48 and 64), norm-relative
   (bf16 2e-2, fp32 1e-4, as chip_smoke.py). K6 must give the same bits on
   a second launch and name its kernel in ``last_impl`` as
   ``kernel_name`` does; in bf16 K6-dkv's dk and dv must equal K5's (one
   kernel, the same products in the same order), and K6-dq's dq is
   reported against K5's.
2. timing: each kernel --iters times in a row, one CUDA event between
   launches, so a slow launch shows on its own: bf16 K4, K4-mb, K5, K6-dq
   and K6-dkv at bh 48, n 5184, d 48 and 32, fp32 K4 at bh 48 and 8 (the
   LARGE training and serving shapes), each beside
   scaled_dot_product_attention (and its backward alone for the backward
   kernels) on the same inputs.

3. breakdown: bf16 K5 (``flash_bwd``) and K6-dkv at bh 48, n 5184, d 48,
   32 and 64 under torch.profiler, --reps calls after a warm-up: the device
   ms a call of each launch it makes, by kernel name (the delta
   reduction's copies, product and reduce, the workspace memset,
   scale_q_kernel, flash_bwd_wgmma<D, DQ>, flash_dq_flush_kernel), and
   their sum.

    python3 tools/torch_flash_probe.py --parts breakdown [--reps 5]

runs one part alone (--parts takes a comma-separated list of edges,
timed, breakdown). The result also holds flash_attention.cu's ptxas lines
(registers and spills a kernel, any warning, and the note ptxas gives
where it serializes a kernel's wgmma for want of registers, C7512).
Prints one JSON object and writes it to --out; exits 1 if an edge case
failed (listed under "failed"). Needs CUDA; it has no CPU mode.
"""

import argparse
import json
import subprocess
import sys
from collections import defaultdict
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


def breakdown(fn, reps):
    """{kernel name: device ms a call} of the launches ``fn`` makes, from
    torch.profiler over ``reps`` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        if e.time_range.end > e.time_range.start:
            by_name[e.name] += (e.time_range.end
                                - e.time_range.start) / 1e3 / reps
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def inputs(dev, bh, n, d, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parts", default="edges,timed,breakdown")
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "torch_flash_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from muvo_tpu_torch.ops import flash_attention as fa
    from muvo_tpu_torch.ops._build import build_log

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    parts = set(args.parts.split(","))
    edges, failed = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for bh, n, d, seq_len in (EDGES if "edges" in parts else ()):
            q, k, v, do = inputs(dev, bh, n, d, dtype)
            o, lse = fa.flash_fwd(q, k, v, seq_len)
            got = {"o": o, "lse": lse, "mb": fa.flash_matmul(q, k, v)}
            got.update(zip(("dq", "dk", "dv"),
                           fa.flash_bwd(q, k, v, o, lse, do, seq_len)))
            got["k6_dq"] = fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len)
            got["k6_dk"], got["k6_dv"] = fa.flash_bwd_dkv(q, k, v, o, lse, do,
                                                          seq_len)
            again = (fa.flash_bwd_dq(q, k, v, o, lse, do, seq_len),
                     *fa.flash_bwd_dkv(q, k, v, o, lse, do, seq_len))
            torch.cuda.synchronize()
            want = dict(zip(("o", "lse"), fa.flash_fwd_plain(q, k, v, seq_len)))
            want["mb"] = fa.flash_matmul_plain(q, k, v)
            want.update(zip(("dq", "dk", "dv"),
                            fa.flash_bwd_plain(q, k, v, o, lse, do, seq_len)))
            want.update(k6_dq=want["dq"], k6_dk=want["dk"], k6_dv=want["dv"])
            rel = {key: norm_rel(got[key], want[key]) for key in got}
            k6 = (got["k6_dq"], got["k6_dk"], got["k6_dv"])
            row = {"dtype": str(dtype).replace("torch.", ""), "bh": bh, "n": n,
                   "d": d, "seq_len": seq_len, "rel": rel,
                   "k6_repeat_equal": all(torch.equal(a, b)
                                          for a, b in zip(k6, again)),
                   "k6_impl": [fa.flash_bwd_dq.last_impl,
                               fa.flash_bwd_dkv.last_impl]}
            if dtype == torch.bfloat16:
                row["k6_dkv_equals_k5"] = (torch.equal(got["k6_dk"], got["dk"])
                                           and torch.equal(got["k6_dv"],
                                                           got["dv"]))
                row["k6_dq_vs_k5"] = norm_rel(got["k6_dq"], got["dq"])
            edges.append(row)
            bad = {key: r for key, r in rel.items() if not r <= TOL[dtype]}
            if row["k6_impl"] != [fa.kernel_name(kid, dtype, d)
                                  for kid in ("K6-dq", "K6-dkv")]:
                bad["k6_impl"] = row["k6_impl"]
            for key in ("k6_repeat_equal", "k6_dkv_equals_k5"):
                if row.get(key) is False:
                    bad[key] = False
            if bad:
                failed.append(f"{dtype} {(bh, n, d, seq_len)}: {bad}")
    timed = []
    for dtype, bh, d in (TIMED if "timed" in parts else ()):
        q, k, v, do = inputs(dev, bh, N, d, dtype)
        o, lse = fa.flash_fwd(q, k, v)
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        runs = {"K4": lambda: fa.flash_fwd(q, k, v),
                "K4-mb": lambda: fa.flash_matmul(q, k, v),
                "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4)}
        if dtype == torch.bfloat16:
            lib = F.scaled_dot_product_attention(q4, k4, v4)
            runs["K5"] = lambda: fa.flash_bwd(q, k, v, o, lse, do)
            runs["K6-dq"] = lambda: fa.flash_bwd_dq(q, k, v, o, lse, do)
            runs["K6-dkv"] = lambda: fa.flash_bwd_dkv(q, k, v, o, lse, do)
            runs["sdpa_bwd"] = lambda: torch.autograd.grad(
                lib, (q4, k4, v4), do[None], retain_graph=True)
        for name, fn in runs.items():
            ms = per_launch(fn, args.iters)
            timed.append({"kernel": name, "dtype": str(dtype).replace(
                "torch.", ""), "bh": bh, "n": N, "d": d, "ms": ms,
                "ms_median": sorted(ms)[len(ms) // 2]})
        del q, k, v, do, o, lse, q4, k4, v4, runs
        torch.cuda.empty_cache()
    launches = []
    for d in ((48, 32, 64) if "breakdown" in parts else ()):
        q, k, v, do = inputs(dev, 48, N, d, torch.bfloat16)
        o, lse = fa.flash_fwd(q, k, v)
        for name, fn in (("K5", lambda: fa.flash_bwd(q, k, v, o, lse, do)),
                         ("K6-dkv", lambda: fa.flash_bwd_dkv(q, k, v, o, lse,
                                                             do))):
            ms = breakdown(fn, args.reps)
            launches.append({"kernel": name, "dtype": "bfloat16", "bh": 48,
                             "n": N, "d": d, "reps": args.reps,
                             "device_ms": ms,
                             "device_ms_total": sum(ms.values())})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "edges": edges, "timed": timed, "breakdown": launches,
              "failed": failed}
    result["ptxas"] = [ln.strip() for ln in build_log(
        "flash_attention").splitlines() if "registers" in ln
        or "spill" in ln or "Compiling entry" in ln or "warning" in ln
        or "Performance Loss" in ln]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
