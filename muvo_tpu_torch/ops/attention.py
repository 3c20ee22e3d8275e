"""Multi-head attention, math path (counterpart of muvo_tpu/ops/attention.py).

The serving path's fusion transformer sees a few hundred tokens per frame,
where muvo_tpu also takes its einsum path; the flash kernels for long
sequences are ported with the LARGE path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def multi_head_attention(q, k, v, n_heads: int,
                         seq_len: Optional[int] = None):
    """Bidirectional MHA. q, k, v: (B, N, C), C divisible by n_heads.

    Scaling 1/sqrt(head_dim); logits and softmax in fp32. ``seq_len``: the
    true token count when N is padded; keys at or past it are masked, and
    the pad rows' outputs are junk the caller slices off.
    """
    b, n, c = q.shape
    hd = c // n_heads
    qh = q.reshape(b, n, n_heads, hd)
    kh = k.reshape(b, n, n_heads, hd)
    vh = v.reshape(b, n, n_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    logits = logits * (1.0 / math.sqrt(hd))
    if seq_len is not None and seq_len < n:
        mask = torch.arange(n, device=q.device) < seq_len
        logits = logits.masked_fill(~mask, -1e30)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
    return out.reshape(b, n, c)
