"""ResNet feature backbone, timm ``features_only`` compatible.

Counterpart of muvo_tpu/models/backbones/resnet.py. Parameter names follow
timm's resnet (conv1, bn1, layer{1..4}.{i}.{conv1,bn1,conv2,bn2,downsample}),
as muvo_tpu/training/weight_convert.py reads them. NHWC in, a list of NHWC
feature maps out:

    index:      0    1    2    3    4
    reduction:  2    4    8    16   32
    channels:   64   64   128  256  512
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from muvo_tpu_torch.models.layers import to_nchw, to_nhwc


class _ResNetBasicBlock(nn.Module):
    """timm BasicBlock on NCHW (internal to the backbone)."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, planes, 1, stride, bias=False),
            nn.BatchNorm2d(planes, eps=1e-5),
        ) if stride != 1 or in_channels != planes else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(y + shortcut)


def feature_channels(out_indices: Sequence[int]):
    return [(64, 64, 128, 256, 512)[i] for i in out_indices]


class ResNetFeatures(nn.Module):
    """ResNet-18 trunk returning the feature maps at ``out_indices``
    (stem/2, layer1/4, layer2/8, layer3/16, layer4/32)."""

    def __init__(self, out_indices: Tuple[int, ...] = (2, 3, 4),
                 in_channels: int = 3):
        super().__init__()
        self.out_indices = tuple(out_indices)
        width = 64
        self.conv1 = nn.Conv2d(in_channels, width, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        c_in = width
        for stage, n_blocks in enumerate((2, 2, 2, 2)):
            planes = width * 2 ** stage
            blocks = []
            for i in range(n_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(_ResNetBasicBlock(c_in, planes, stride))
                c_in = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        feats = {}
        x = F.relu(self.bn1(self.conv1(to_nchw(x))))
        feats[0] = x
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            feats[stage] = x
        return [to_nhwc(feats[i]) for i in self.out_indices]


def build_backbone(name: str, out_indices: Sequence[int] = (2, 3, 4),
                   in_channels: int = 3):
    """Backbone registry: returns (module, channels at out_indices)."""
    if name != "resnet18":
        raise ValueError(f"backbone {name!r} is not ported")
    return (ResNetFeatures(tuple(out_indices), in_channels=in_channels),
            feature_channels(out_indices))
