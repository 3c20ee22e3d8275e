"""Latent-conditioned (StyleGAN-like) decoders: image/range-view, BEV and
3-D voxel, and the tri-plane voxel decoder (counterpart of
muvo_tpu/models/stylegan.py).

A learned constant (BEV, voxel) or a projected latent (image) is convolved
and upsampled under adaptive instance normalisation driven by the latent
state w, with heads at downsample factors 4, 2 and 1. Output keys match
muvo_tpu's (``rgb_1``, ``lidar_reconstruction_2``, ``bev_segmentation_4``,
``voxel_4``, ...); tensors are channels-last (NHWC, NDHWC).

The voxel decoder's large stages run their 3x3x3 convs through the port's
CUDA kernels (ops/zconv.py) where muvo_tpu takes its Pallas path and
their channels fit the kernels (``kernel_stage``: conv2 and conv3 with
muvo.yml, conv3 with the default config's 256 feature channels). There x/y
are upsampled bilinearly first, then K2 fuses the z-upsample into conv1,
and K1 runs conv2, each followed by AdaIN. Under autograd the
two convs run inside ops/zconv.py's autograd Function, whose backward
launches K1-dx / K2-dx and K3; AdaIN, the upsampling and the small stages
differentiate through plain autograd, as muvo_tpu runs them in XLA. The
tri-plane decoder's 3x3x3 conv is F.conv3d: muvo_tpu runs it in XLA too.
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
from muvo_tpu_torch.ops.zconv import (
    TC_MAX_CHANNELS,
    upzconv3d_leaky,
    zconv3d_leaky,
)

# muvo_tpu takes the Pallas z-fold path for a conv whose z exceeds this
# (ops/pallas_zconv.py:889,899); the port takes K1/K2 there.
ZCONV_MIN_Z = 19


def kernel_stage(zs: int, c_in: int, cout: int) -> bool:
    """The voxel block of small z ``zs`` runs K2 (conv1, fusing the
    z-upsample) and K1 (conv2): its upsampled z exceeds 18 and its
    channels fit the bf16 tensor-core kernel's tile (zconv.TC_MAX_CHANNELS
    input and output channels). Wider blocks, as the default config's conv2
    (128 -> 64), run the plain conv, as muvo_tpu runs them in XLA."""
    return 2 * zs >= ZCONV_MIN_Z and max(c_in, cout) <= TC_MAX_CHANNELS


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

    def forward(self, x, w, kernel: bool = False, z_upsample: bool = False):
        """``kernel``: the conv runs K1, or with ``z_upsample`` K2 (x is an
        NDHWC tensor at half z, the conv upsamples z first); else the
        plain conv."""
        conv = self.conv_act[0]
        if kernel:
            fn = upzconv3d_leaky if z_upsample else zconv3d_leaky
            x = fn(x.contiguous(), conv.weight, conv.bias, 0.2)
        elif z_upsample:
            raise ValueError("the fused z-upsample conv runs on the kernel "
                             "path only")
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
        if x.ndim == 5 and kernel_stage(x.shape[3], x.shape[4],
                                        self.conv1.conv_act[0].out_channels):
            # x/y here, z inside K2 (as upsample2x_xy_folded +
            # upzconv3d_leaky_folded in muvo_tpu)
            x = self.conv1(upsample2x_xy(x), w, kernel=True, z_upsample=True)
            return self.conv2(x, w, kernel=True)
        up = upsample2x_bilinear if x.ndim == 4 else upsample2x_trilinear
        return self.conv2(self.conv1(up(x), w), w)


def pointwise(conv, x):
    """A 1x1 (or 1x1x1) conv ``conv`` on channels-last ``x``, as one
    matmul over the channel axis."""
    return F.linear(x, conv.weight.reshape(conv.weight.shape[0], -1),
                    conv.bias)


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
        return {self.key: pointwise(getattr(self, self.torch_name)[0], x)}


class SegmentationHead(nn.Module):
    """The BEV head: 1x1 convs to the segmentation logits, the instance
    offsets and the sigmoid of the instance centres ->
    {bev_segmentation_k, bev_instance_offset_k, bev_instance_center_k}."""

    def __init__(self, in_channels: int, n_classes: int,
                 downsample_factor: int):
        super().__init__()
        self.k = downsample_factor
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(in_channels, n_classes, 1))
        self.instance_offset_head = nn.Sequential(
            nn.Conv2d(in_channels, 2, 1))
        self.instance_center_head = nn.Sequential(
            nn.Conv2d(in_channels, 1, 1))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        k = self.k
        return {
            f"bev_segmentation_{k}": pointwise(self.segmentation_head[0], x),
            f"bev_instance_offset_{k}": pointwise(
                self.instance_offset_head[0], x),
            f"bev_instance_center_{k}": torch.sigmoid(
                pointwise(self.instance_center_head[0], x)),
        }


class BevDecoder(nn.Module):
    """2-D AdaIN conv pyramid from a learned constant to (h, w) = 64 *
    constant_size (192 x 192 from (3, 3)), with a SegmentationHead at 1/4,
    1/2 and 1; channels n -> n/2 -> n/4 -> n/8 for base_channels n."""

    def __init__(self, latent_n_channels: int, semantic_n_channels: int,
                 constant_size: Tuple[int, int] = (3, 3),
                 base_channels: int = 512):
        super().__init__()
        n = base_channels
        self.constant_tensor = nn.Parameter(torch.randn(n, *constant_size))
        self.first_norm = AdaptiveInstanceNorm(latent_n_channels, n)
        self.first_conv = ConvInstanceNorm(n, n, latent_n_channels)
        self.middle_conv = nn.ModuleList(
            DecoderBlock(n, n, latent_n_channels) for _ in range(3))
        self.conv1 = DecoderBlock(n, n // 2, latent_n_channels)
        self.conv2 = DecoderBlock(n // 2, n // 4, latent_n_channels)
        self.conv3 = DecoderBlock(n // 4, n // 8, latent_n_channels)
        self.head_4 = SegmentationHead(n // 2, semantic_n_channels, 4)
        self.head_2 = SegmentationHead(n // 4, semantic_n_channels, 2)
        self.head_1 = SegmentationHead(n // 8, semantic_n_channels, 1)

    def forward(self, w) -> Dict[str, torch.Tensor]:
        return _constant_pyramid(self, w)


def _constant_pyramid(decoder, w) -> Dict[str, torch.Tensor]:
    """The BEV and voxel decoders' pass: the learned constant broadcast
    over the batch, AdaIN, the first conv, the three middle blocks, then
    conv1..conv3 with a head after each."""
    const = decoder.constant_tensor.movedim(0, -1)  # (..., C)
    x = const[None].expand(w.shape[0], *const.shape)
    x = decoder.first_norm(x, w)
    x = decoder.first_conv(x, w)
    for block in decoder.middle_conv:
        x = block(x, w)
    x = decoder.conv1(x, w)
    out = decoder.head_4(x)
    x = decoder.conv2(x, w)
    out.update(decoder.head_2(x))
    x = decoder.conv3(x, w)
    out.update(decoder.head_1(x))
    return out


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
        return _constant_pyramid(self, w)


class VoxelDecoderScale(nn.Module):
    """Tri-plane fusion into a dense grid (muvo_tpu's VoxelDecoderScale,
    upstream's names): the xy (B, X, Y, C), xz (B, X, Z, C) and yz
    (B, Y, Z, C) planes each weighed by a 1x1 conv to one channel,
    broadcast into (B, X, Y, Z, C) and fused as xy against xz plus xy
    against yz, each pair by the two-way softmax of its weights (the
    larger subtracted first); then ``classifier``: a 3x3x3 SAME conv to
    ``feature_channels``, softplus, a 1x1x1 conv to ``n_classes``.
    Channels-last in and out."""

    def __init__(self, in_channels: int, n_classes: int,
                 feature_channels: int = 512):
        super().__init__()
        self.weight_xy_decoder = nn.Conv2d(in_channels, 1, 1)
        self.weight_xz_decoder = nn.Conv2d(in_channels, 1, 1)
        self.weight_yz_decoder = nn.Conv2d(in_channels, 1, 1)
        self.classifier = nn.Sequential(
            nn.Conv3d(in_channels, feature_channels, 3, padding=1),
            nn.Softplus(),
            nn.Conv3d(feature_channels, n_classes, 1))

    def forward(self, planes) -> torch.Tensor:
        xy, xz, yz = planes
        f_xy, f_xz, f_yz = xy[:, :, :, None], xz[:, :, None], yz[:, None]
        g_xy = pointwise(self.weight_xy_decoder, xy)[:, :, :, None]
        g_xz = pointwise(self.weight_xz_decoder, xz)[:, :, None]
        g_yz = pointwise(self.weight_yz_decoder, yz)[:, None]

        def att(t1, w1, t2, w2):
            m = torch.maximum(w1, w2)
            e1, e2 = torch.exp(w1 - m), torch.exp(w2 - m)
            z = e1 + e2
            return t1 * (e1 / z) + t2 * (e2 / z)

        fused = att(f_xy, g_xy, f_xz, g_xz) + att(f_xy, g_xy, f_yz, g_yz)
        cls1, _, cls2 = self.classifier
        x = F.softplus(cls1(to_nchw(fused)))
        return pointwise(cls2, to_nhwc(x))


class TriPlaneVoxelDecoder(nn.Module):
    """Multi-scale tri-plane voxel decoder (upstream's VoxelDecoder0): a
    VoxelDecoderScale ``decoder_{s}`` for each scale s of 1, 2 and 4 on
    the planes ``xy``, ``xz``, ``yz`` given as {"rgb_{s}": plane} ->
    {"voxel_{s}": (B, X, Y, Z, n_classes)}. No model path builds it, as
    in muvo_tpu."""

    SCALES = (1, 2, 4)

    def __init__(self, in_channels: int, n_classes: int,
                 feature_channels: int = 512):
        super().__init__()
        for scale in self.SCALES:
            self.add_module(f"decoder_{scale}", VoxelDecoderScale(
                in_channels, n_classes, feature_channels))

    def forward(self, xy, xz, yz) -> Dict[str, torch.Tensor]:
        return {f"voxel_{s}": getattr(self, f"decoder_{s}")(
            (xy[f"rgb_{s}"], xz[f"rgb_{s}"], yz[f"rgb_{s}"]))
            for s in self.SCALES}
