"""The compute-type policy (counterpart of muvo_tpu/utils/precision.py).

PRECISION "16-mixed" means bf16 compute with fp32 master weights: the
parameters and the optimizer state stay fp32, the forward runs under
torch.autocast(bfloat16) on the card, the losses upcast to fp32, and the
gradients land in fp32 on the parameters. bf16 keeps fp32's exponent
range, so there is no loss scaling. Autocast rounds only the operations on
its lower-precision list (convolutions, matrix products; the voxel kernels
take bf16 through their autograd Functions) and keeps normalisation and
elementwise work in fp32 where its inputs are fp32, where muvo_tpu's
cast_floating rounds every parameter and input to bf16. On the CPU the
port computes in fp32.
"""

from __future__ import annotations

import contextlib

import torch


def compute_dtype_from_cfg(cfg) -> torch.dtype:
    return torch.bfloat16 if "16" in str(cfg.PRECISION) else torch.float32


def autocast(device: torch.device, dtype: torch.dtype):
    """The forward's autocast context: bf16 on the card, nothing in fp32
    or on the CPU."""
    if device.type == "cuda" and dtype != torch.float32:
        return torch.autocast("cuda", dtype=dtype)
    return contextlib.nullcontext()
