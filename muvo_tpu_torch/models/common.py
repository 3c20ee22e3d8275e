"""Shared model components (counterpart of muvo_tpu/models/common.py):
the top-down and bottom-up FPN aggregators, route, speed, route-command and
GPS encoders, the policy, the feature compressor, the BEV 4x down-sampler
and the sine position embedding. NHWC at the public functions; upstream
MUVO's parameter names.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from muvo_tpu_torch.models.backbones.resnet import build_backbone
from muvo_tpu_torch.models.layers import (
    BasicBlock,
    ConvBN,
    adaptive_avg_pool_1x1,
    max_pool_torch,
    resize_bilinear,
    to_nchw,
    to_nhwc,
)


class Decoder(nn.Module):
    """Top-down aggregation to the finest input stride (the LARGE path).

    xs: [s8, s16, s32] NHWC -> NHWC at stride 8: ``conv1`` on xs[-1], then
    for i = 2 .. len(xs) ``upsample_skip_convs[i - 2](xs[-i])`` plus the
    bilinear upsample of the running sum to xs[-i]'s size. (muvo_tpu names
    the skips ``skip{i}``, i from 2; DecoderDS's from 1.)
    """

    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__()
        self.conv1 = ConvBN(in_channels[-1], out_channels)
        self.upsample_skip_convs = nn.ModuleList(
            ConvBN(in_channels[-i], out_channels)
            for i in range(2, len(in_channels) + 1))

    def forward(self, xs: List[torch.Tensor]):
        x = self.conv1(xs[-1])
        for i in range(2, len(xs) + 1):
            x = self.upsample_skip_convs[i - 2](xs[-i]) + resize_bilinear(
                x, xs[-i].shape[1:3])
        return x


class DecoderDS(nn.Module):
    """Bottom-up aggregation to the coarsest stride (max-pool downsampling).

    xs: [s8, s16, s32] NHWC -> NHWC at stride 32.
    """

    def __init__(self, in_channels: Sequence[int], out_channels: int):
        super().__init__()
        self.conv1 = ConvBN(in_channels[0], out_channels)
        self.downsample_skip_convs = nn.ModuleList(
            ConvBN(c, out_channels) for c in in_channels[1:])

    def forward(self, xs: List[torch.Tensor]):
        x = self.conv1(xs[0])
        for i in range(1, len(xs)):
            stride = xs[i - 1].shape[2] // xs[i].shape[2]
            x = self.downsample_skip_convs[i - 1](xs[i]) + max_pool_torch(
                x, stride)
        return x


class RouteEncode(nn.Module):
    """Backbone stride-32 features -> global pool -> linear projection."""

    def __init__(self, out_channels: int, backbone: str = "resnet18"):
        super().__init__()
        self.backbone, (c,) = build_backbone(backbone, out_indices=(4,))
        self.fc = nn.Linear(c, out_channels)

    def forward(self, route):
        return self.fc(adaptive_avg_pool_1x1(self.backbone(route)[0]))


class Policy(nn.Module):
    """4-layer MLP -> tanh over 2 actions."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.fc = nn.Sequential(
            nn.Linear(c, c), nn.ReLU(),
            nn.Linear(c, c), nn.ReLU(),
            nn.Linear(c, c // 2), nn.ReLU(),
            nn.Linear(c // 2, 2), nn.Tanh(),
        )

    def forward(self, x):
        return self.fc(x)


class FeatureCompressor(nn.Sequential):
    """Two BasicBlocks (first strided) + global pool: (N,H,W,C) -> (N, D).
    Keys ``0`` and ``1`` as upstream's ``nn.Sequential``."""

    def __init__(self, in_channels: int, out_channels: int,
                 strides: Sequence[int] = (2, 1)):
        super().__init__(
            BasicBlock(in_channels, out_channels, strides[0], downsample=True),
            BasicBlock(out_channels, out_channels, strides[1],
                       downsample=strides[1] != 1),
        )

    def forward(self, x):
        return adaptive_avg_pool_1x1(super().forward(x))


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: float = 2 * math.pi,
                            device=None) -> torch.Tensor:
    """2-D sine/cosine positional embedding, (h, w, 2*num_pos_feats),
    channel order [pos_y, pos_x]."""
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    y_embed = ones.cumsum(0)
    x_embed = ones.cumsum(1)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


class SpeedEncoder(nn.Sequential):
    """speed (N, 1) -> (N, C); keys ``0`` and ``2`` as upstream's."""

    def __init__(self, channels: int, normalisation: float):
        super().__init__(nn.Linear(1, channels), nn.ReLU(),
                         nn.Linear(channels, channels), nn.ReLU())
        self.normalisation = normalisation

    def forward(self, speed):
        return super().forward(speed / self.normalisation)


class CommandEncoder(nn.Sequential):
    """Route command ids (N,) in [0, 6) -> (N, C): an embedding, then two
    Linear + ReLU layers. Upstream MUVO is not at hand: the keys assume its
    ``nn.Sequential`` of muvo_tpu's citation (mile.py:125-139), so ``0`` is
    the embedding and ``1`` and ``3`` the Linears."""

    def __init__(self, channels: int):
        super().__init__(nn.Embedding(6, channels),
                         nn.Linear(channels, channels), nn.ReLU(),
                         nn.Linear(channels, channels), nn.ReLU())

    def forward(self, command):
        # the batch carries int32 ids; nn.Embedding indexes with int64
        return super().forward(command.long())


class GpsEncoder(nn.Sequential):
    """(N, 4) GPS vectors (this frame's and the next's, 2 each) -> (N, C):
    two Linear + ReLU layers, keys ``0`` and ``2`` as the ``nn.Sequential``
    of muvo_tpu's citation (mile.py:141-146) assumed."""

    def __init__(self, channels: int):
        super().__init__(nn.Linear(4, channels), nn.ReLU(),
                         nn.Linear(channels, channels), nn.ReLU())


class BevDownSample4(nn.Sequential):
    """Two 5x5 stride-2 convs (padding 2, 512 hidden channels, a ReLU
    between) shrinking BEV features 4x; keys ``0`` and ``2`` as
    upstream's ``nn.Sequential``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.Conv2d(in_channels, 512, 5, 2, 2), nn.ReLU(),
                         nn.Conv2d(512, out_channels, 5, 2, 2))

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))
