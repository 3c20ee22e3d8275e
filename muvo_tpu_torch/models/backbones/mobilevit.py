"""MobileViTV2 feature backbone, timm ``mobilevitv2_100`` (counterpart of
muvo_tpu/models/backbones/mobilevit.py).

timm's byobnet layout at width 1.0 ("Separable Self-attention for Mobile
Vision Transformers", arXiv:2206.02680):

    stem   Conv3x3 s2 -> 32, BN, SiLU
    stage0 1x  InvertedResidual(64,  s1, exp 2)
    stage1 2x  InvertedResidual(128, s2/s1)
    stage2 IR(256, s2) + MobileViTV2Block(d=128, depth 2)
    stage3 IR(384, s2) + MobileViTV2Block(d=192, depth 4)
    stage4 IR(512, s2) + MobileViTV2Block(d=256, depth 3)

feature channels (64, 128, 256, 384, 512) at reductions (2, 4, 8, 16, 32).
Parameter names are timm's (``stem.conv``, ``stem.bn``,
``stages.{i}.{j}.conv1_1x1.conv``, ``...transformer.{k}.attn.qkv_proj``),
as muvo_tpu/training/weight_convert.py reads them. NHWC in, a list of NHWC
feature maps out; inside, NCHW, and the tokens [B, d, P, N] as timm lays
them out, so the norms of the transformer are GroupNorm(1): statistics
over all of (d, P, N) of a sample, not per token. A map whose height or
width is odd is resized UP bilinearly (align_corners=True) to the next
multiple of the 2x2 patch before a MobileViTV2 block, and stays there.
BatchNorm follows flax's running-statistics update (layers.BatchNorm2d).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from muvo_tpu_torch.models.layers import BatchNorm2d, to_nchw, to_nhwc


class ConvNormAct(nn.Module):
    """timm ConvNormAct: conv (no bias), BatchNorm, optional SiLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride,
                              (kernel - 1) // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class InvertedResidual(nn.Module):
    """timm BottleneckBlock (bottle_in, linear_out): 1x1 expand (SiLU),
    depthwise 3x3 (SiLU), 1x1 project; the shortcut only at stride 1 with
    matching channels."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand: int = 2):
        super().__init__()
        hidden = in_channels * expand
        self.conv1_1x1 = ConvNormAct(in_channels, hidden, 1)
        self.conv2_kxk = ConvNormAct(hidden, hidden, 3, stride, groups=hidden)
        self.conv3_1x1 = ConvNormAct(hidden, out_channels, 1, act=False)
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x):
        y = self.conv3_1x1(self.conv2_kxk(self.conv1_1x1(x)))
        return y + x if self.residual else y


class SeparableSelfAttention(nn.Module):
    """timm LinearSelfAttention on tokens [B, d, P, N]: one 1x1 projection
    to (1 + 2d) channels; the query's scores softmaxed over N weight the
    keys into one context vector a patch position; out = out_proj(relu(
    values) * context)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.qkv_proj = nn.Conv2d(dim, 1 + 2 * dim, 1)
        self.out_proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        qkv = self.qkv_proj(x)
        query, key, value = qkv.split([1, self.dim, self.dim], dim=1)
        scores = query.softmax(dim=-1)
        context = (key * scores).sum(dim=-1, keepdim=True)
        return self.out_proj(F.relu(value) * context)


class ConvMlp(nn.Module):
    """timm ConvMlp: 1x1 conv, SiLU, 1x1 conv."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


class LinearTransformerBlock(nn.Module):
    """timm LinearTransformerBlock: pre-norm attention, pre-norm ConvMlp,
    both normed by GroupNorm(1)."""

    def __init__(self, dim: int, mlp_ratio: float = 2.0):
        super().__init__()
        self.norm1 = nn.GroupNorm(1, dim, eps=1e-5)
        self.attn = SeparableSelfAttention(dim)
        self.norm2 = nn.GroupNorm(1, dim, eps=1e-5)
        self.mlp = ConvMlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class MobileViTV2Block(nn.Module):
    """timm MobileVitV2Block: depthwise 3x3, 1x1 to the attention width,
    2x2 patches unfolded to [B, d, P, N], the linear transformers, a
    GroupNorm(1), folded back, and a 1x1 projection (no activation)."""

    def __init__(self, channels: int, attn_dim: int, depth: int,
                 patch: int = 2):
        super().__init__()
        self.patch = patch
        self.conv_kxk = ConvNormAct(channels, channels, 3, groups=channels)
        self.conv_1x1 = nn.Conv2d(channels, attn_dim, 1, bias=False)
        self.transformer = nn.Sequential(
            *(LinearTransformerBlock(attn_dim) for _ in range(depth)))
        self.norm = nn.GroupNorm(1, attn_dim, eps=1e-5)
        self.conv_proj = ConvNormAct(attn_dim, channels, 1, act=False)

    def forward(self, x):
        b, _, h, w = x.shape
        p = self.patch
        new_h, new_w = math.ceil(h / p) * p, math.ceil(w / p) * p
        hh, ww = new_h // p, new_w // p
        if (new_h, new_w) != (h, w):
            x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                              align_corners=True)
        x = self.conv_1x1(self.conv_kxk(x))
        d = x.shape[1]
        x = x.reshape(b, d, hh, p, ww, p).permute(0, 1, 3, 5, 2, 4)
        x = self.norm(self.transformer(x.reshape(b, d, p * p, hh * ww)))
        x = x.reshape(b, d, p, p, hh, ww).permute(0, 1, 4, 2, 5, 3)
        return self.conv_proj(x.reshape(b, d, new_h, new_w))


# (channels, attention width, transformer depth) of stages 2-4 at width 1
_VIT_STAGES = ((256, 128, 2), (384, 192, 4), (512, 256, 3))
CHANNELS = (64, 128, 256, 384, 512)


class MobileViTV2Features(nn.Module):
    """The mobilevitv2_100 trunk returning the feature maps at
    ``out_indices`` (reductions 2, 4, 8, 16, 32)."""

    def __init__(self, out_indices: Tuple[int, ...] = (2, 3, 4),
                 in_channels: int = 3):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.stem = ConvNormAct(in_channels, 32, 3, 2)
        stages = [nn.Sequential(InvertedResidual(32, 64)),
                  nn.Sequential(InvertedResidual(64, 128, 2),
                                InvertedResidual(128, 128))]
        c_in = 128
        for c_out, attn_dim, depth in _VIT_STAGES:
            stages.append(nn.Sequential(
                InvertedResidual(c_in, c_out, 2),
                MobileViTV2Block(c_out, attn_dim, depth)))
            c_in = c_out
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        x = self.stem(to_nchw(x))
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return [to_nhwc(feats[i]) for i in self.out_indices]


def feature_channels(out_indices: Sequence[int]):
    return [CHANNELS[i] for i in out_indices]
