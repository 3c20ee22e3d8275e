"""Feature extractors and heads of the PPO expert (counterpart of
muvo_tpu/rl/networks.py), in NCHW with carla-roach's rl_birdview names.

The birdview arrives as (N, C, H, W) and flattens in (C, H, W) order, as
carla-roach's ``nn.Flatten`` does; muvo_tpu's NHWC ``Dense_1`` reads the
same features in (H, W, C) order, so weights carried between the two
permute those rows (muvo_tpu_torch/weights.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (out channels, kernel, stride) of XtMaCNN's VALID convs
XTMA_CONVS = ((8, 5, 2), (16, 5, 2), (32, 5, 2), (64, 3, 2), (128, 3, 2),
              (256, 3, 1))


def _state_mlp(state_dim: int, states_neurons: Sequence[int]):
    """``state_linear``: Linear + ReLU for each width."""
    layers, width = [], state_dim
    for n in states_neurons:
        layers += [nn.Linear(width, n), nn.ReLU()]
        width = n
    return nn.Sequential(*layers)


class XtMaCNN(nn.Module):
    """Birdview CNN and state MLP fused into one feature vector: six VALID
    convs (8-16-32-64-128-256), then the 1,024 flattened features beside
    the state MLP's through Linear 512 and Linear ``features_dim``."""

    def __init__(self, birdview_shape: Tuple[int, int, int] = (15, 192, 192),
                 state_dim: int = 6, features_dim: int = 256,
                 states_neurons: Sequence[int] = (256,)):
        super().__init__()
        c, h, w = birdview_shape
        layers = []
        for out, k, s in XTMA_CONVS:
            layers += [nn.Conv2d(c, out, k, s), nn.ReLU()]
            c, h, w = out, (h - k) // s + 1, (w - k) // s + 1
        self.cnn = nn.Sequential(*layers, nn.Flatten())
        self.flat_shape = (c, h, w)  # the birdview's features, flattened
        self.state_linear = _state_mlp(state_dim, states_neurons)
        self.linear = nn.Sequential(
            nn.Linear(c * h * w + states_neurons[-1], 512), nn.ReLU(),
            nn.Linear(512, features_dim), nn.ReLU())
        self.features_dim = features_dim

    def forward(self, birdview, state):
        x = torch.cat([self.cnn(birdview), self.state_linear(state)], -1)
        return self.linear(x)


class ResBlock(nn.Module):
    """relu-conv-relu-conv residual block (``conv0``, ``conv1``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + self.conv1(F.relu(self.conv0(F.relu(x))))


class DownStack(nn.Module):
    """``firstconv``, a 3x3 stride-2 max pool padded by 1, ``blocks``."""

    def __init__(self, in_channels: int, channels: int, nblock: int):
        super().__init__()
        self.firstconv = nn.Conv2d(in_channels, channels, 3, padding=1)
        self.blocks = nn.ModuleList(ResBlock(channels) for _ in range(nblock))

    def forward(self, x):
        x = F.max_pool2d(self.firstconv(x), 3, 2, padding=1)
        for block in self.blocks:
            x = block(x)
        return x


class ImpalaCNN(nn.Module):
    """IMPALA-style residual CNN stacks and the state MLP fused by one
    Linear (``dense``)."""

    def __init__(self, birdview_shape: Tuple[int, int, int] = (15, 192, 192),
                 state_dim: int = 6, chans: Sequence[int] = (16, 32, 32, 64,
                                                             64),
                 states_neurons: Sequence[int] = (256,),
                 features_dim: int = 256, nblock: int = 2,
                 final_relu: bool = True):
        super().__init__()
        c, h, w = birdview_shape
        stacks = []
        for ch in chans:
            stacks.append(DownStack(c, ch, nblock))
            c, h, w = ch, (h - 1) // 2 + 1, (w - 1) // 2 + 1
        self.stacks = nn.ModuleList(stacks)
        self.flat_shape = (c, h, w)
        self.nblock = nblock
        self.state_linear = _state_mlp(state_dim, states_neurons)
        self.dense = nn.Linear(c * h * w + states_neurons[-1], features_dim)
        self.final_relu = final_relu
        self.features_dim = features_dim

    def forward(self, birdview, state):
        x = birdview
        for stack in self.stacks:
            x = stack(x)
        x = torch.cat([F.relu(x).flatten(1), self.state_linear(state)], -1)
        x = self.dense(x)
        return F.relu(x) if self.final_relu else x


class MLPHead(nn.Module):
    """Linear + ReLU for each width of ``arch``, then Linear ``out_dim``
    (softplus on it with ``out_softplus``)."""

    def __init__(self, in_dim: int, arch: Sequence[int], out_dim: int,
                 out_softplus: bool = False):
        super().__init__()
        layers = []
        for n in arch:
            layers += [nn.Linear(in_dim, n), nn.ReLU()]
            in_dim = n
        self.net = nn.Sequential(*layers, nn.Linear(in_dim, out_dim))
        self.out_softplus = out_softplus

    def forward(self, x):
        x = self.net(x)
        return F.softplus(x) if self.out_softplus else x


FEATURE_EXTRACTORS = {
    "xtma_cnn": XtMaCNN,
    "impala_cnn": ImpalaCNN,
}
