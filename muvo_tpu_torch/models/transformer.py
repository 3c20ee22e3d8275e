"""Multimodal token-fusion transformer: post-LN, upstream's torch layout
(counterpart of muvo_tpu/models/transformer.py).

Parameter names are those of ``nn.TransformerEncoder`` (layers.{i}.self_attn.
in_proj_weight / out_proj, linear1, linear2, norm1, norm2), but attention
runs through the port's own math path (ops/attention.py), so ``seq_len``
masking is available. Dropout (p 0.1, upstream's) is active only when the
caller asks for it (training), and draws its masks from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from muvo_tpu_torch.ops.attention import multi_head_attention


def apply_dropout(x, p: float, generator: Optional[torch.Generator]):
    """Inverted dropout with its mask drawn from ``generator``."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


class SelfAttention(nn.Module):
    """Parameters named as ``nn.MultiheadAttention``'s."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, seq_len: Optional[int] = None):
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.chunk(3, dim=-1)
        attn = multi_head_attention(q, k, v, self.n_heads, seq_len=seq_len)
        return self.out_proj(attn)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = SelfAttention(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, seq_len: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        p = self.dropout if train else 0.0
        attn = apply_dropout(self.self_attn(x, seq_len), p, generator)
        x = self.norm1(x + attn)
        ff = apply_dropout(F.relu(self.linear1(x)), p, generator)
        ff = apply_dropout(self.linear2(ff), p, generator)
        return self.norm2(x + ff)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, n_layers: int = 6, n_heads: int = 8,
                 dim_feedforward: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, n_heads, dim_feedforward)
            for _ in range(n_layers))

    def forward(self, x, seq_len: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, N, C) tokens; ``train`` turns dropout on."""
        for layer in self.layers:
            x = layer(x, seq_len, train, generator)
        return x
