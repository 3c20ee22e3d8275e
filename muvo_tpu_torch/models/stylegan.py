"""Latent-conditioned (StyleGAN-like) decoders: image/range-view and 3-D
voxel (counterpart of muvo_tpu/models/stylegan.py).

A learned constant (voxel) or a projected latent (image) is convolved and
upsampled under adaptive instance normalisation driven by the latent state
w, with heads at downsample factors 4, 2 and 1. Output keys match
muvo_tpu's (``rgb_1``, ``lidar_reconstruction_2``, ``voxel_4``, ...);
tensors are channels-last (NHWC, NDHWC).

The voxel decoder's large stages run their 3x3x3 convs through the port's
CUDA kernels (ops/zconv.py) exactly where muvo_tpu takes its Pallas path:
every stage whose upsampled z exceeds 18 (conv2 and conv3 with muvo.yml).
There x/y are upsampled bilinearly first, then K2 fuses the z-upsample
into conv1, and K1 runs conv2, each followed by AdaIN.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from muvo_tpu_torch.models.layers import (
    to_nchw,
    to_nhwc,
    upsample2x_bilinear,
    upsample2x_trilinear,
    upsample2x_xy,
)
from muvo_tpu_torch.ops.zconv import upzconv3d_leaky, zconv3d_leaky

# muvo_tpu takes the Pallas z-fold path for a conv whose z exceeds this
# (ops/pallas_zconv.py:889,899); the port takes K1/K2 there.
ZCONV_MIN_Z = 19


class AdaptiveInstanceNorm(nn.Module):
    """Instance norm over the spatial dims, then scale/bias from the style.

    Single-pass statistics in fp32: var = E[x^2] - E[x]^2, clamped at 0,
    eps 1e-8 (muvo_tpu/models/stylegan.py:109-123).
    """

    def __init__(self, latent_n_channels: int, out_channels: int,
                 epsilon: float = 1e-8):
        super().__init__()
        self.epsilon = epsilon
        self.latent_affine = nn.Linear(latent_n_channels, 2 * out_channels)

    def forward(self, x, w):
        spatial = tuple(range(1, x.ndim - 1))
        n = 1
        for d in spatial:
            n *= x.shape[d]
        x32 = x.float()
        mean = x32.sum(spatial, keepdim=True) / n
        var = (x32.square().sum(spatial, keepdim=True) / n
               - mean.square()).clamp_min(0.0)
        x = ((x32 - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        style = self.latent_affine(w)
        style = style.reshape(style.shape[:1] + (1,) * len(spatial) + (-1,))
        scale, bias = style.chunk(2, dim=-1)
        return scale * x + bias


class ConvInstanceNorm(nn.Module):
    """3x3(x3) conv + LeakyReLU(0.2) + AdaIN."""

    def __init__(self, in_channels: int, out_channels: int,
                 latent_n_channels: int, ndim: int = 2):
        super().__init__()
        conv = nn.Conv2d if ndim == 2 else nn.Conv3d
        self.conv_act = nn.Sequential(
            conv(in_channels, out_channels, 3, padding=1),
            nn.LeakyReLU(0.2),
        )
        self.adaptive_norm = AdaptiveInstanceNorm(latent_n_channels,
                                                  out_channels)

    def forward(self, x, w, z_upsample: bool = False):
        """``z_upsample``: x is an NDHWC tensor at half z; the conv upsamples
        z first (K2). 3-D convs whose output z exceeds 18 run K1/K2."""
        conv = self.conv_act[0]
        z_out = x.shape[3] * (2 if z_upsample else 1) if x.ndim == 5 else 0
        if z_out >= ZCONV_MIN_Z:
            fn = upzconv3d_leaky if z_upsample else zconv3d_leaky
            x = fn(x.contiguous(), conv.weight, conv.bias, 0.2)
        elif z_upsample:
            raise ValueError("the fused z-upsample conv needs output z > 18")
        else:
            x = to_nhwc(self.conv_act(to_nchw(x)))
        return self.adaptive_norm(x, w)


class DecoderBlock(nn.Module):
    """2x upsample -> ConvInstanceNorm x2, for 2-D and 3-D."""

    def __init__(self, in_channels: int, out_channels: int,
                 latent_n_channels: int, ndim: int = 2):
        super().__init__()
        self.conv1 = ConvInstanceNorm(in_channels, out_channels,
                                      latent_n_channels, ndim)
        self.conv2 = ConvInstanceNorm(out_channels, out_channels,
                                      latent_n_channels, ndim)

    def forward(self, x, w):
        if x.ndim == 5 and 2 * x.shape[3] >= ZCONV_MIN_Z:
            # kernel path: x/y here, z inside K2 (as upsample2x_xy_folded +
            # upzconv3d_leaky_folded in muvo_tpu)
            x = self.conv1(upsample2x_xy(x), w, z_upsample=True)
        else:
            up = upsample2x_bilinear if x.ndim == 4 else upsample2x_trilinear
            x = self.conv1(up(x), w)
        return self.conv2(x, w)


# output key prefix and upstream head module name per head type
HEADS = {
    "rgb": ("rgb", "rgb_head"),
    "lidar_re": ("lidar_reconstruction", "lidar_re_head"),
    "lidar_seg": ("lidar_segmentation", "seg_head"),
    "sem_image": ("semantic_image", "sem_head"),
    "depth": ("depth", "depth_head"),
    "voxel": ("voxel", "segmentation_head"),
}


class SingleConvHead(nn.Module):
    """1x1(x1) conv head on a channels-last tensor -> {f"{prefix}_{k}"}."""

    def __init__(self, in_channels: int, n_classes: int,
                 downsample_factor: int, head: str, ndim: int = 2):
        super().__init__()
        self.key = f"{HEADS[head][0]}_{downsample_factor}"
        self.torch_name = HEADS[head][1]
        conv = nn.Conv2d if ndim == 2 else nn.Conv3d
        self.add_module(self.torch_name,
                        nn.Sequential(conv(in_channels, n_classes, 1)))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        conv = getattr(self, self.torch_name)[0]
        w = conv.weight.reshape(conv.weight.shape[0], -1)
        return {self.key: F.linear(x, w, conv.bias)}


class ConvDecoder(nn.Module):
    """Dense -> transposed-conv pyramid -> heads at 1/4, 1/2 and 1.

    constant_size (5, 13) decodes to 320x832 (the RGB crop), (1, 16) to
    64x1024 (the LiDAR range view).
    """

    def __init__(self, latent_n_channels: int, out_channels: int,
                 constant_size: Tuple[int, int] = (5, 13), head: str = "rgb",
                 base_channels: int = 512):
        super().__init__()
        n = base_channels
        self.linear = nn.Sequential(nn.Linear(latent_n_channels, n))
        self.pre_transpose_conv = nn.Sequential(
            nn.ConvTranspose2d(n, n, tuple(constant_size)), nn.ELU(),
            nn.ConvTranspose2d(n, n, 5, 2, 2, output_padding=1), nn.ELU(),
            nn.ConvTranspose2d(n, n, 5, 2, 2, output_padding=1), nn.ELU(),
            nn.ConvTranspose2d(n, n, 6, 2, 2), nn.ELU(),
        )
        self.trans_conv1 = nn.Sequential(
            nn.ConvTranspose2d(n, n // 2, 6, 2, 2), nn.ELU())
        self.trans_conv2 = nn.Sequential(
            nn.ConvTranspose2d(n // 2, n // 4, 6, 2, 2), nn.ELU())
        self.trans_conv3 = nn.Sequential(
            nn.ConvTranspose2d(n // 4, n // 8, 6, 2, 2), nn.ELU())
        self.head_4 = SingleConvHead(n // 2, out_channels, 4, head)
        self.head_2 = SingleConvHead(n // 4, out_channels, 2, head)
        self.head_1 = SingleConvHead(n // 8, out_channels, 1, head)

    def forward(self, w) -> Dict[str, torch.Tensor]:
        x = self.linear(w)[:, :, None, None]  # NCHW inside
        x = self.pre_transpose_conv(x)
        x = self.trans_conv1(x)
        out = self.head_4(to_nhwc(x))
        x = self.trans_conv2(x)
        out.update(self.head_2(to_nhwc(x)))
        x = self.trans_conv3(x)
        out.update(self.head_1(to_nhwc(x)))
        return out


class VoxelDecoder(nn.Module):
    """3-D AdaIN conv pyramid to (X, Y, Z) = 64 * constant_size; channels
    2n -> n -> n/2 -> n/4 -> n/8 for feature_channels n (64 in muvo.yml)."""

    def __init__(self, latent_n_channels: int, semantic_n_channels: int,
                 feature_channels: int = 512,
                 constant_size: Tuple[int, int, int] = (3, 3, 1)):
        super().__init__()
        n = feature_channels
        self.constant_tensor = nn.Parameter(
            torch.randn(2 * n, *constant_size))
        self.first_norm = AdaptiveInstanceNorm(latent_n_channels, 2 * n)
        self.first_conv = ConvInstanceNorm(2 * n, n, latent_n_channels, 3)
        self.middle_conv = nn.ModuleList(
            DecoderBlock(n, n, latent_n_channels, 3) for _ in range(3))
        self.conv1 = DecoderBlock(n, n // 2, latent_n_channels, 3)
        self.conv2 = DecoderBlock(n // 2, n // 4, latent_n_channels, 3)
        self.conv3 = DecoderBlock(n // 4, n // 8, latent_n_channels, 3)
        self.head_4 = SingleConvHead(n // 2, semantic_n_channels, 4, "voxel", 3)
        self.head_2 = SingleConvHead(n // 4, semantic_n_channels, 2, "voxel", 3)
        self.head_1 = SingleConvHead(n // 8, semantic_n_channels, 1, "voxel", 3)

    def forward(self, w) -> Dict[str, torch.Tensor]:
        const = self.constant_tensor.movedim(0, -1)  # (X, Y, Z, 2n)
        x = const[None].expand(w.shape[0], *const.shape)
        x = self.first_norm(x, w)
        x = self.first_conv(x, w)
        for block in self.middle_conv:
            x = block(x, w)
        x = self.conv1(x, w)
        out = self.head_4(x)
        x = self.conv2(x, w)
        out.update(self.head_2(x))
        x = self.conv3(x, w)
        out.update(self.head_1(x))
        return out
