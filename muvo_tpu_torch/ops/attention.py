"""Multi-head attention (counterpart of muvo_tpu/ops/attention.py): the
math path, and the flash kernels from 2048 tokens on the card.

The flagship fusion transformer sees 648 tokens a frame and takes the math
path, as muvo_tpu does; the LARGE path's 5,184 tokens take flash attention
(ops/flash_attention.py: K4 forward, K5 or K6 backward) when the tensors
lie on a CUDA device. On the CPU the math path is the flash kernels' plain
version at every length.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from muvo_tpu_torch.ops.flash_attention import flash_attention

_FLASH_MIN_TOKENS = 2048


def uses_flash(n: int, device: torch.device) -> bool:
    """Whether attention over ``n`` tokens on ``device`` takes the flash
    kernels."""
    return n >= _FLASH_MIN_TOKENS and device.type == "cuda"


def multi_head_attention(q, k, v, n_heads: int,
                         seq_len: Optional[int] = None, bwd: str = "fused"):
    """Bidirectional MHA. q, k, v: (B, N, C), C divisible by n_heads.

    Scaling 1/sqrt(head_dim); logits and softmax in fp32. ``seq_len``: the
    true token count when N is padded; keys at or past it are masked, and
    the pad rows' outputs are junk the caller slices off. ``bwd`` picks the
    flash backward ("fused": K5, "split": K6) where flash runs.
    """
    b, n, c = q.shape
    hd = c // n_heads
    qh = q.reshape(b, n, n_heads, hd)
    kh = k.reshape(b, n, n_heads, hd)
    vh = v.reshape(b, n, n_heads, hd)
    if uses_flash(n, q.device):
        out = flash_attention(qh.transpose(1, 2), kh.transpose(1, 2),
                              vh.transpose(1, 2), seq_len=seq_len, bwd=bwd)
        return out.transpose(1, 2).reshape(b, n, c)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    logits = logits * (1.0 / math.sqrt(hd))
    if seq_len is not None and seq_len < n:
        mask = torch.arange(n, device=q.device) < seq_len
        logits = logits.masked_fill(~mask, -1e30)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
    return out.reshape(b, n, c)
