"""Building-block layers (counterpart of muvo_tpu/models/layers.py).

Public functions and module ``forward``s take and return channels-last
tensors (NHWC, NDHWC) like muvo_tpu's. Inside, they permute to NCHW views
for ``F.conv2d``; a permuted NHWC tensor is a channels_last-strided NCHW
tensor, so the permutes copy nothing. Parameter names and shapes are
upstream MUVO's (torch layout), so its state_dict loads unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC / NDHWC -> NCHW / NCDHW view."""
    return x.movedim(-1, 1)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW / NCDHW -> NHWC / NDHWC view."""
    return x.movedim(1, -1)


class ConvBN(nn.Sequential):
    """Conv -> BatchNorm -> ReLU; keys ``0`` (conv) and ``1`` (bn) as
    upstream's ``nn.Sequential``. NHWC in and out."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                      bias=False),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
        )

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))


class BasicBlock(nn.Module):
    """Upstream's resnet BasicBlock (muvo/layers/layers.py). Its optional
    1x1 downsample conv hard-codes stride 2 whatever the block's stride,
    as upstream (and muvo_tpu/models/layers.py:59-63) do."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, planes, 1, 2, bias=False),
            nn.BatchNorm2d(planes, eps=1e-5),
        ) if downsample else None)

    def forward(self, x):
        x = to_nchw(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return to_nhwc(F.relu(y + shortcut))


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on NHWC tensors: torch's own output geometry
    (in - 1) * stride - 2 * padding + kernel + output_padding, which
    muvo_tpu reproduces with lax.conv_transpose."""

    def forward(self, x):
        return to_nhwc(super().forward(to_nchw(x)))


def max_pool_torch(x, window: int, stride: Optional[int] = None,
                   padding: int = 0):
    """torch max_pool2d on NHWC (floor output size, -inf padding)."""
    return to_nhwc(F.max_pool2d(to_nchw(x), window, stride or window,
                                padding))


def adaptive_avg_pool_1x1(x):
    """Global average pool of N...C -> (N, C)."""
    return x.mean(dim=tuple(range(1, x.ndim - 1)))


def leaky_relu_torch(x, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def upsample2x_bilinear(x):
    """2x bilinear upsample of NHWC, half-pixel centres (align_corners=False,
    which equals jax.image.resize 'linear' for 2x upsampling)."""
    return to_nhwc(F.interpolate(to_nchw(x), scale_factor=2, mode="bilinear",
                                 align_corners=False)).contiguous()


def upsample2x_trilinear(x):
    """2x trilinear upsample of NDHWC, half-pixel centres."""
    return to_nhwc(F.interpolate(to_nchw(x), scale_factor=2,
                                 mode="trilinear",
                                 align_corners=False)).contiguous()


def upsample2x_xy(x):
    """2x bilinear upsample of an NDHWC tensor over X and Y only; z is left
    to the fused z-upsample conv (ops/zconv.upzconv3d_leaky), as
    muvo_tpu's upsample2x_xy_folded leaves it to its Pallas kernel."""
    b, X, Y, Z, C = x.shape
    x4 = x.reshape(b, X, Y, Z * C)
    y4 = F.interpolate(to_nchw(x4), scale_factor=2, mode="bilinear",
                       align_corners=False)
    return to_nhwc(y4).reshape(b, 2 * X, 2 * Y, Z, C).contiguous()
