#!/usr/bin/env python3
"""The default config's voxel conv2 stage on the port's kernels against the
conv3d the model runs there, on one GPU.

    python3 tools/torch_conv2_probe.py [--out PATH]

At 256 voxel feature channels (the default config), conv2's block runs
conv1 on 128 -> 64 channels at small z 16 (output z 32) and conv2 on
64 -> 64 at z 32, both past the z where muvo_tpu takes its Pallas path.
stylegan.kernel_stage keeps the block off the kernels because its
channels exceed the bf16 tensor-core kernel's 64-channel tile; the model
runs its plain conv (F.conv3d after the trilinear upsample, cuDNN on the
card). This script times, at the serving decodes' batches 1 and 5 in fp32
(TF32 off) and the training step's 6 in bf16:

- fp32 K2 and K1 launched on the slices of output channels that
  zconv.channel_slices gives them (their blocks cannot hold all 64
  channels' weights), each held against its plain version;
- bf16 K2 and K1, which the tensor-core kernel refuses at these channels
  (the error is recorded);
- the plain conv the model runs, and the library call alone (F.conv3d on
  the upsampled input).

Prints one JSON line a case, then one object with them all, also written
to --out. Needs CUDA; it has no CPU mode.
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

# (kernel, stage, input shape without batch, Cout) at the default config
CASES = (("K2", "conv2.conv1", (96, 96, 16, 128), 64),
         ("K1", "conv2.conv2", (96, 96, 32, 64), 64))
RUNS = ((torch.float32, 1), (torch.float32, 5), (torch.bfloat16, 6))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "torch_conv2_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import zconv
    from muvo_tpu_torch.ops._build import build_all

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build_all()
    optin = zconv._f32_limits(0)[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for kid, stage, shape, cout in CASES:
        up = kid == "K2"
        kernel = zconv.upzconv3d_leaky if up else zconv.zconv3d_leaky
        plain = zconv.upzconv3d_leaky_plain if up else zconv.zconv3d_leaky_plain
        c = shape[-1]
        for dtype, b in RUNS:
            x = torch.randn((b, *shape), generator=gen, device=dev).to(dtype)
            w = (torch.randn((cout, c, 3, 3, 3), generator=gen, device=dev)
                 / (27 * c) ** 0.5).to(dtype)
            bias = torch.randn((cout,), generator=gen, device=dev).to(dtype)
            xin = zconv.upsample2x_z(x) if up else x
            row = {"kernel": kid, "stage": stage, "shape": [b, *shape],
                   "cout": cout, "dtype": str(dtype).replace("torch.", "")}
            with torch.no_grad():
                try:
                    slices = zconv.channel_slices(kid, dtype, shape[2], c,
                                                  cout, optin)
                    before = kernel.launches
                    out = kernel(x, w, bias, 0.2)
                    torch.cuda.synchronize()
                    row["launches"] = kernel.launches - before
                    row["slices"] = slices
                    row["impl"] = kernel.last_impl
                    ref = plain(x, w, bias, 0.2)
                    row["rel_err"] = ((out.float() - ref.float()).abs().max()
                                      / ref.float().abs().max()).item()
                    row["tol"] = TOL[dtype]
                    row["ms"] = time_ms(lambda: kernel(x, w, bias, 0.2))
                    del out, ref
                except (RuntimeError, ValueError) as e:
                    row["refused"] = str(e).splitlines()[0]
                row["plain_ms"] = time_ms(lambda: plain(x, w, bias, 0.2))
                xin_nchw = to_nchw(xin).contiguous()
                row["library_ms"] = time_ms(
                    lambda: F.conv3d(xin_nchw, w, bias, padding=1))
            print(json.dumps(row), flush=True)
            rows.append(row)
            if "rel_err" in row and not row["rel_err"] <= row["tol"]:
                raise AssertionError(f"{kid} {stage} {dtype}: relative error "
                                     f"{row['rel_err']} > {row['tol']}")
            del x, w, bias, xin, xin_nchw
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "rows": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
