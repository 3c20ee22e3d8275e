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
   launches, so a slow launch shows on its own: K4, K4-mb, K5, K6-dq and
   K6-dkv at bh 48, n 5184, d 48 and 32 in bf16 and fp32, and fp32 K4 at
   bh 8 (the LARGE serving shape), each beside
   scaled_dot_product_attention (and its backward alone for the backward
   kernels) on the same inputs.

3. breakdown: bf16 K5 (``flash_bwd``) and K6-dkv at bh 48, n 5184, d 48,
   32 and 64, and fp32 K5 at d 48 and 32, under torch.profiler, --reps
   calls after a warm-up: the device ms a call of each launch it makes, by
   kernel name (the delta reduction's copies, product and reduce, the
   workspace memset, scale_q_kernel, flash_bwd_wgmma<D, DQ> or
   flash_bwd_kv_f32<D, true>, flash_dq_flush_kernel), and their sum.
4. dq_plans (not in the default --parts): fp32 K6-dq's kernel,
   fp32::flash_bwd_q_f32<D>, under each plan of DQ_PLANS (q rows a
   block, blocks an SM for __launch_bounds__): flash_attention.cu with
   kDqRows and kDqBlocks set to the plan, built by nvcc as the port's
   build does into a library of its own, launched through its
   muvo_flash_bwd_dq at bh 48, n 5184, d 32, 48 and 64, the plans in
   turns (--iters launches each, twice), every plan's dq equal to the
   port's bit for bit, with each plan's ptxas registers and spills
   (reported: only the source's own instantiations must not spill).

    python3 tools/torch_flash_probe.py --parts breakdown [--reps 5]

runs one part alone (--parts takes a comma-separated list of edges,
timed, breakdown, dq_plans). The result also holds flash_attention.cu's
ptxas lines (registers and spills a kernel, any warning, and the note
ptxas gives where it serializes a kernel's wgmma for want of registers,
C7512), and under "ptxas_bwd_kv_f32" and "ptxas_bwd_q_f32" the registers
and spill bytes of each fp32::flash_bwd_kv_f32 and fp32::flash_bwd_q_f32
instantiation. Prints one JSON object and writes it to --out; exits 1 if
an edge case failed, a plan's dq differs from the port's, or an
instantiation of either fp32 backward kernel in the source spills (listed
under "failed"). Needs CUDA; it has no CPU mode.
"""

import argparse
import json
import re
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
         (torch.float32, 48, 48), (torch.float32, 48, 32),
         (torch.float32, 8, 48))
# fp32 K6-dq plans (q rows a block, blocks an SM); the source's kDqRows
# and kDqBlocks are one of them
DQ_PLANS = ((64, 1), (64, 2), (128, 1))
BREAKDOWN = ((torch.bfloat16, 48, ("K5", "K6-dkv")),
             (torch.bfloat16, 32, ("K5", "K6-dkv")),
             (torch.bfloat16, 64, ("K5", "K6-dkv")),
             (torch.float32, 48, ("K5",)), (torch.float32, 32, ("K5",)))


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


def ptxas_entries(log, name):
    """[{entry, registers, spill_stores, spill_loads}] of each kernel
    whose mangled name holds ``name``, from ``nvcc -Xptxas -v``'s log."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = None
            if name in m.group(1):
                cur = {"entry": m.group(1), "registers": None,
                       "spill_stores": None, "spill_loads": None}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def build_dq_plans(out_dir):
    """{plan: (ctypes library, ptxas entries of flash_bwd_q_f32)}: one
    library of flash_attention.cu for each plan of DQ_PLANS, kDqRows and
    kDqBlocks set to it, all built at once."""
    import ctypes

    from muvo_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    pattern = r"(constexpr int kDqRows = )\d+(, kDqBlocks = )\d+(;)"
    if len(re.findall(pattern, src)) != 1:
        raise RuntimeError("flash_attention.cu: kDqRows not found")
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for rows, blocks in DQ_PLANS:
        stem = out_dir / f"flash_attention_r{rows}_b{blocks}"
        stem.with_suffix(".cu").write_text(
            re.sub(pattern, rf"\g<1>{rows}\g<2>{blocks}\g<3>", src))
        log = open(stem.with_suffix(".log"), "w")
        jobs[(rows, blocks)] = (stem, log, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))],
            stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    for plan, (stem, log, proc) in jobs.items():
        rc = proc.wait()
        log.close()
        text = stem.with_suffix(".log").read_text()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for plan {plan}:\n{text}")
        lib = ctypes.CDLL(str(stem.with_suffix(".so")))
        lib.muvo_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.muvo_flash_bwd_dq.restype = ctypes.c_int
        libs[plan] = (lib, ptxas_entries(text, "flash_bwd_q_f32"))
    return libs


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
        if bh == 48:  # the training shape: the backward kernels too
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
    plans, plan_ptxas = [], {}
    if "dq_plans" in parts:
        libs = build_dq_plans(Path(args.out).parent / "dq_plans")
        # reported, not failed: a plan that spills is one the source
        # does not take
        plan_ptxas = {f"rows {r}, blocks {b}": entries
                      for (r, b), (_, entries) in libs.items()}
        for d in (48, 32, 64):
            q, k, v, do = inputs(dev, 48, N, d, torch.float32)
            o, lse = fa.flash_fwd(q, k, v)
            want = fa.flash_bwd_dq(q, k, v, o, lse, do)
            _, _, (delta, head, tail) = fa._backward_args(q, k, v, o, lse,
                                                          do, None)
            ms = defaultdict(list)
            for _ in range(2):  # the plans in turns
                for plan, (lib, _) in libs.items():
                    dq = torch.empty_like(q)

                    def launch():
                        rc = lib.muvo_flash_bwd_dq(*head, dq.data_ptr(),
                                                   *tail)
                        if rc:
                            raise RuntimeError(f"plan {plan}: error {rc}")

                    ms[plan] += per_launch(launch, args.iters)
                    torch.cuda.synchronize()
                    if not torch.equal(dq, want):
                        failed.append(f"plan {plan} d {d}: dq differs")
            for (rows, blocks), t in ms.items():
                plans.append({"rows": rows, "blocks": blocks, "bh": 48,
                              "n": N, "d": d, "ms": t,
                              "ms_median": sorted(t)[len(t) // 2]})
            del q, k, v, do, o, lse, want, delta, head
            torch.cuda.empty_cache()
    launches = []
    for dtype, d, kids in (BREAKDOWN if "breakdown" in parts else ()):
        q, k, v, do = inputs(dev, 48, N, d, dtype)
        o, lse = fa.flash_fwd(q, k, v)
        calls = {"K5": lambda: fa.flash_bwd(q, k, v, o, lse, do),
                 "K6-dkv": lambda: fa.flash_bwd_dkv(q, k, v, o, lse, do)}
        for name in kids:
            ms = breakdown(calls[name], args.reps)
            launches.append({"kernel": name, "dtype": str(dtype).replace(
                "torch.", ""), "bh": 48, "n": N, "d": d, "reps": args.reps,
                "device_ms": ms, "device_ms_total": sum(ms.values())})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "edges": edges, "timed": timed, "breakdown": launches,
              "dq_plans": plans, "ptxas_dq_plans": plan_ptxas,
              "failed": failed}
    log = build_log("flash_attention")
    result["ptxas"] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling entry" in ln or "warning" in ln
                       or "Performance Loss" in ln]
    for name, count in (("bwd_kv_f32", 6), ("bwd_q_f32", 3)):
        entries = ptxas_entries(log, f"flash_{name}")
        result[f"ptxas_{name}"] = entries
        if len(entries) != count or any(e["spill_stores"] or e["spill_loads"]
                                        for e in entries):
            failed.append(f"flash_{name}'s ptxas: {entries}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
