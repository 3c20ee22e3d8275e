"""Building-block layers (counterpart of muvo_tpu/models/layers.py).

Public functions and module ``forward``s take and return channels-last
tensors (NHWC, NDHWC) like muvo_tpu's. Inside, they permute to NCHW views
for ``F.conv2d``; a permuted NHWC tensor is a channels_last-strided NCHW
tensor, so the permutes copy nothing. Parameter names and shapes are
upstream MUVO's (torch layout), so its state_dict loads unchanged.
"""

from __future__ import annotations

import contextlib
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


_frozen_stats = False


@contextlib.contextmanager
def frozen_batch_stats(frozen: bool = True):
    """BatchNorm layers in training mode normalise with batch statistics
    but leave their running statistics alone (a checkpointed block's
    recompute must not update them a second time)."""
    global _frozen_stats
    before, _frozen_stats = _frozen_stats, frozen
    try:
        yield
    finally:
        _frozen_stats = before


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (NCHW) whose running statistics follow flax's
    BatchNorm, as muvo_tpu trains them: momentum 0.9 (torch's 0.1) with the
    BIASED batch variance, where torch's update uses the unbiased one.
    Normalisation is torch's own (biased variance, eps 1e-5)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if _frozen_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        # torch's kernel updates copies of the running statistics with the
        # batch statistics it computes in fp32 (autograd keeps the copies);
        # the variance's share is then rescaled from unbiased to biased,
        # which costs no pass over x
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum
        with torch.no_grad():
            self.running_mean.copy_(mean)
            added = var - keep * self.running_var
            self.running_var.mul_(keep).add_(added * ((n - 1) / max(n, 1)))
        return y


class ConvBN(nn.Sequential):
    """Conv -> BatchNorm -> ReLU; keys ``0`` (conv) and ``1`` (bn) as
    upstream's ``nn.Sequential``. NHWC in and out."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                      bias=False),
            BatchNorm2d(out_channels, eps=1e-5),
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
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, planes, 1, 2, bias=False),
            BatchNorm2d(planes, eps=1e-5),
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


def resize_bilinear(x, size):
    """Bilinear resize of NHWC up to ``size`` (h, w): muvo_tpu's
    ``jax.image.resize(..., "linear")``, which for upsampling equals
    F.interpolate with align_corners=False and no antialiasing (half-pixel
    centres, edges clamped). The top-down FPN only ever upsamples; a size
    below the input's raises, since jax's downsampling antialiases
    (models/preprocess.py carries those weights for the label pyramids)."""
    h, w = int(size[0]), int(size[1])
    if h < x.shape[1] or w < x.shape[2]:
        raise ValueError(f"resize_bilinear only upsamples: "
                         f"{tuple(x.shape[1:3])} -> {(h, w)}")
    return to_nhwc(F.interpolate(to_nchw(x), size=(h, w), mode="bilinear",
                                 align_corners=False, antialias=False))


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
