#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; a failed phase raises and the script
exits nonzero (there is no CPU fallback):

1. device: the card's name and nvidia-smi's name and power limit.
2. build: compiles muvo_tpu_torch/csrc/*.cu (one nvcc each, in parallel).
3. kernels: K1 (zconv3d_leaky) and K2 (upzconv3d_leaky) at the voxel
   decoder's four serving shapes, batch 1 and 5, fp32 and bf16: each is held
   against its plain PyTorch version on the card (TF32 off), and timed beside
   the plain version, one library call and the bound.
4. serving: muvo.yml at full width with seeded random weights, driven
   through DeploymentSession (deployment_forward, then sim_forward with a
   5-step imagination); the kernels' launch counts must rise, outputs must be
   finite with muvo_tpu's shapes, and one decode on the card must match the
   same decode run by the port on the host CPU.

The last three lines are the kernels summary, nvidia-smi's name and power
limit, and {"ok": true, "device": {...}}.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# the card's published rates (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,     # fp32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores, dense
FP32_TOL = 1e-4   # max |kernel - plain| / max |plain|: summation order only
BF16_TOL = 2e-2   # output rounded to bf16 (and K2's plain upsample rounds)
DECODE_TOL = 1e-3  # card vs host decode, norm-relative, fp32 with TF32 off

# (kernel, stage, input shape without batch, Cout) on muvo.yml's voxel decoder
SHAPES = (
    ("K2", "conv2.conv1", (96, 96, 16, 32), 16),
    ("K1", "conv2.conv2", (96, 96, 32, 16), 16),
    ("K2", "conv3.conv1", (192, 192, 32, 16), 8),
    ("K1", "conv3.conv2", (192, 192, 64, 8), 8),
)
MAIN_SHAPE = {"K1": "conv3.conv2", "K2": "conv3.conv1"}  # summary entries
MAIN_BATCH = 5  # the imagination rollout decodes 5 states at once


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
    fn()
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


def bound(x, w, out, z_out: int, up: bool):
    """Least time for the function: bytes (each input read once, the output
    written once) over HBM bandwidth vs operations over the type's peak."""
    b, X, Y, _, c = x.shape
    cout = out.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, out))
    nbytes += cout * x.element_size()  # bias
    flops = 2 * 27 * c * cout * b * X * Y * z_out
    if up:
        flops += 3 * b * X * Y * z_out * c  # the z interpolation
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev):
    from muvo_tpu_torch.models.layers import to_nchw
    from muvo_tpu_torch.ops import zconv

    fns = {
        "K1": (zconv.zconv3d_leaky, zconv.zconv3d_leaky_plain),
        "K2": (zconv.upzconv3d_leaky, zconv.upzconv3d_leaky_plain),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for kid, stage, shape, cout in SHAPES:
        kernel, plain = fns[kid]
        up = kid == "K2"
        c = shape[-1]
        for b in (1, MAIN_BATCH):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((b, *shape), generator=gen, device=dev).to(dtype)
                w = (torch.randn((cout, c, 3, 3, 3), generator=gen, device=dev)
                     / (27 * c) ** 0.5).to(dtype)
                bias = torch.randn((cout,), generator=gen, device=dev).to(dtype)
                with torch.no_grad():
                    out = kernel(x, w, bias, 0.2)
                    ref = plain(x, w, bias, 0.2)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    rel = err / ref.float().abs().max().item()
                    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
                    z_out = out.shape[3]
                    if up:
                        def library():
                            xs = F.interpolate(to_nchw(x), size=out.shape[1:4],
                                               mode="trilinear",
                                               align_corners=False)
                            return F.conv3d(xs, w, bias, padding=1)
                    else:
                        def library():
                            return F.conv3d(to_nchw(x), w, bias, padding=1)
                    ms = time_ms(lambda: kernel(x, w, bias, 0.2))
                    plain_ms = time_ms(lambda: plain(x, w, bias, 0.2))
                    library_ms = time_ms(library)
                bound_ms, bound_by = bound(x, w, out, z_out, up)
                row = {
                    "phase": "kernel", "kernel": kid, "stage": stage,
                    "shape": [b, *shape], "cout": cout,
                    "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": err, "rel_err": rel, "tol": tol,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                emit(row)
                if not (rel <= tol):
                    raise AssertionError(f"{kid} {stage} B={b} {dtype}: "
                                         f"relative error {rel} > {tol}")
                results[(kid, stage, b, dtype)] = row
                del x, w, bias, out, ref
    return results


def muvo_cfg():
    from muvo_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent / "muvo_tpu_torch"
                            / "configs" / "muvo.yml"))
    return cfg


def serving_phase(dev, cfg):
    from muvo_tpu_torch.data.synthetic import synthetic_batch
    from muvo_tpu_torch.inference import DeploymentSession, LatentCarry
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.ops import zconv

    torch.manual_seed(0)
    model = MuvoWorldModel(cfg)
    host_model = copy.deepcopy(model)
    session = DeploymentSession(
        model, cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    seq = cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON
    batch = synthetic_batch(cfg, batch_size=1, sequence_length=seq, seed=0)
    fh = seq - 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zconv.zconv3d_leaky.launches = 0
    zconv.upzconv3d_leaky.launches = 0
    deploy_ms, sim_ms, sim_launches = [], [], None
    for _ in range(3):
        t0 = time.perf_counter()
        out = session.deployment_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        deploy_ms.append((time.perf_counter() - t0) * 1e3)
    session.reset()
    for _ in range(3):
        before = (zconv.zconv3d_leaky.launches,
                  zconv.upzconv3d_leaky.launches)
        t0 = time.perf_counter()
        sim_out, imagined = session.sim_forward(batch, is_dreaming=False)
        torch.cuda.synchronize()
        sim_ms.append((time.perf_counter() - t0) * 1e3)
        sim_launches = {"K1": zconv.zconv3d_leaky.launches - before[0],
                        "K2": zconv.upzconv3d_leaky.launches - before[1]}
    launches = {"K1": zconv.zconv3d_leaky.launches,
                "K2": zconv.upzconv3d_leaky.launches}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20

    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    s_h, s_w = (cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1],
                cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0])
    expect = {
        "throttle_brake": (1,), "steering": (1,),
        "rgb_1": (s_h, s_w, 3), "rgb_4": (s_h // 4, s_w // 4, 3),
        "lidar_reconstruction_1": (cfg.POINTS.CHANNELS,
                                   cfg.POINTS.HORIZON_RESOLUTION, 4),
        "voxel_1": (*cfg.VOXEL.SIZE, cfg.VOXEL_SEG.N_CLASSES),
        "voxel_2": (*(v // 2 for v in cfg.VOXEL.SIZE),
                    cfg.VOXEL_SEG.N_CLASSES),
    }
    state_dim = (cfg.MODEL.TRANSITION.HIDDEN_STATE_DIM
                 + cfg.MODEL.TRANSITION.STATE_DIM)
    for name, result, steps in (("deployment_forward", out, 1),
                                ("sim_forward", sim_out, 1),
                                ("imagine", imagined, fh)):
        for key, tail in expect.items():
            got = tuple(result[key].shape)
            if got != (1, steps, *tail):
                raise AssertionError(f"{name} {key}: shape {got}")
        for key, v in result.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{name} {key}: non-finite values")
    if tuple(imagined["state"].shape) != (1, fh, state_dim):
        raise AssertionError(f"imagine state shape {imagined['state'].shape}")

    # the card's decode (K1/K2 inside) against the port's host decode
    # (plain versions) on the same carry and weights
    carry = session.carry
    card = session.decode(carry)
    host = DeploymentSession(host_model, cfg, device="cpu")
    t0 = time.perf_counter()
    on_host = host.decode(LatentCarry(*(t.cpu() for t in carry)))
    host_s = time.perf_counter() - t0
    decode_err = {}
    for key, want in on_host.items():
        got = card[key].float().cpu()
        decode_err[key] = ((got - want).abs().max()
                           / want.abs().max().clamp_min(1e-12)).item()
    worst = max(decode_err.values())
    emit({"phase": "serving", "batch": 1,
          "sequence": seq, "deployment_tick_ms": deploy_ms,
          "sim_tick_ms": sim_ms,
          "sim_tick_ms_median": statistics.median(sim_ms),
          "deployment_tick_ms_median": statistics.median(deploy_ms),
          "peak_mib": peak_mib, "launches": launches,
          "launches_per_sim_tick": sim_launches,
          "decode_vs_host_norm_rel": decode_err,
          "decode_tol": DECODE_TOL, "host_decode_s": host_s})
    if not worst <= DECODE_TOL:
        raise AssertionError(f"card decode differs from host decode: {worst}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a "
              "GPU", file=sys.stderr)
        return 2
    from muvo_tpu_torch.ops._build import build_all, build_log

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built,
          "ptxas": [ln.strip() for ln in build_log("zconv").splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})

    results = kernel_phase(dev)
    launches = serving_phase(dev, muvo_cfg())

    summary = []
    for kid, name in (("K1", "zconv3d_leaky"), ("K2", "upzconv3d_leaky")):
        row = results[(kid, MAIN_SHAPE[kid], MAIN_BATCH, torch.float32)]
        summary.append({
            "name": name, "route": "cuda",
            "source": "muvo_tpu_torch/csrc/zconv.cu",
            "replaces": "muvo_tpu/ops/pallas_zconv.py:171",
            "launches": launches[kid], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"],
        })
    emit({"kernels": summary})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
