"""Benchmark: the port's flagship training step on one GPU.

    python -m muvo_tpu_torch.bench [steps] [--large]

Runs build_flagship_step (muvo.yml at full width, 4 sequences of 6 frames,
bf16 autocast with fp32 master weights, decoder remat; ``--large``: the
LARGE step, stride-8 features and 5,184 fusion tokens a frame through the
flash kernels, 1 sequence of 6 frames) for 3 warm-up steps and then
``steps`` timed ones (default 12), and prints ONE JSON line:

    train_step_frames_per_sec_per_chip  frames of the batch / median step time
    step_ms                             median host-clock step time, each step
                                        ending in torch.cuda.synchronize()
    peak_mib                            torch.cuda.max_memory_allocated over
                                        the timed steps
    model_tflops_per_step               the step's model FLOPs: aten's matrix
                                        products and convolutions counted by
                                        torch.utils.flop_counter.FlopCounterMode
                                        over one step with remat off, plus
                                        what runs in the port's kernels, which
                                        the counter cannot see: the voxel
                                        kernels' 3 x 2 * 27 * C * Cout per
                                        output voxel (forward, dx, dW) and
                                        each flash attention's 4 bh L^2 d
                                        (K4) + 8 bh L^2 d (its backward), L
                                        the unmasked token count
    mfu                                 model FLOPs / step time / 989 TFLOP/s
                                        (the H100's dense bf16 peak)

It needs a CUDA device and has no CPU mode.
"""

from __future__ import annotations

import json
import statistics
import time

BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense, NVIDIA's data sheet


def _kernel_flops_hooks(model, counts):
    """Forward hooks adding the model FLOPs of the port's kernels: 3 x each
    voxel conv on the kernel path (its forward, dx and dW), and 4 + 8 x
    bh L^2 d for each attention that takes flash (K4, then K5 or K6)."""
    from muvo_tpu_torch.models.stylegan import ZCONV_MIN_Z, ConvInstanceNorm
    from muvo_tpu_torch.models.transformer import SelfAttention
    from muvo_tpu_torch.ops.attention import uses_flash

    def conv_hook(module, args, out):
        w = module.conv_act[0].weight
        if out.ndim == 5 and out.shape[3] >= ZCONV_MIN_Z:
            voxels = out.shape[0] * out.shape[1] * out.shape[2] * out.shape[3]
            counts[0] += 3 * 2 * 27 * w.shape[0] * w.shape[1] * voxels

    def attention_hook(module, args, out):
        x, seq_len = args[0], (args[1] if len(args) > 1 else None)
        b, n, c = x.shape
        if uses_flash(n, x.device):
            length = n if seq_len is None else min(int(seq_len), n)
            counts[0] += (4 + 8) * b * module.n_heads * length ** 2 * (
                c // module.n_heads)

    hooks = []
    for m in model.modules():
        if isinstance(m, ConvInstanceNorm):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, SelfAttention):
            hooks.append(m.register_forward_hook(attention_hook))
    return hooks


def model_flops(fs) -> float:
    """FLOPs of one training step of the model without remat."""
    from torch.utils.flop_counter import FlopCounterMode

    model = fs.trainer.state.model
    remat = model.remat_decoders
    model.remat_decoders = set()
    kernel = [0]
    hooks = _kernel_flops_hooks(model, kernel)
    try:
        with FlopCounterMode(display=False) as counter:
            fs.trainer.train_step(fs.batch, fs.generator)
    finally:
        model.remat_decoders = remat
        for h in hooks:
            h.remove()
    return float(counter.get_total_flops() + kernel[0])


def main(n_steps: int = 12, warmup: int = 3, large: bool = False) -> dict:
    import torch

    from muvo_tpu_torch.training.flagship import build_flagship_step

    if not torch.cuda.is_available():
        raise SystemExit("muvo_tpu_torch.bench needs a CUDA device")
    fs = build_flagship_step(large=large)
    cfg = fs.cfg
    frames = cfg.BATCHSIZE * (cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    for _ in range(warmup):
        fs.trainer.train_step(fs.batch, fs.generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        metrics = fs.trainer.train_step(fs.batch, fs.generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    median = statistics.median(step_ms)
    flops = model_flops(fs)
    record = {
        "metric": "train_step_frames_per_sec_per_chip",
        "value": frames / (median / 1e3),
        "unit": "frames/s/chip",
        "step_ms": median,
        "step_ms_all": step_ms,
        "peak_mib": peak_mib,
        "model_tflops_per_step": flops / 1e12,
        "mfu": flops / (median / 1e3) / BF16_PEAK_FLOPS,
        "frames_per_step": frames,
        "config": "muvo.yml LARGE" if large else "muvo.yml",
        "loss": float(metrics["loss"]),
        "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the port's training step")
    ap.add_argument("steps", nargs="?", type=int, default=12)
    ap.add_argument("--large", action="store_true",
                    help="the LARGE step (5,184 fusion tokens a frame)")
    a = ap.parse_args()
    main(a.steps, large=a.large)
