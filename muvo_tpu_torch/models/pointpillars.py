"""PointPillars LiDAR encoder (counterpart of muvo_tpu/models/pointpillars.py).

Points arrive as a fixed-capacity padded tensor (B, P, 3) with a count a
frame, as the dataset writes them, and every step keeps that static shape:
a point that is padding or outside the grid goes to a spare pillar slot
that is dropped at the end. Each point is decorated with 8 features (xyz,
xyz less its pillar's mean, x and y less the pillar's centre), goes
through a PointNet (Linear, masked BatchNorm, ReLU, twice), and each
pillar keeps the channel-wise maximum of its points; empty pillars are 0.
Pillar statistics are ``index_add_`` and ``scatter_reduce(..., "amax")`` over
a dense (ny * nx + 1) index a frame.

Upstream MUVO's layout quirks stay (muvo/models/common.py:724-761): the
canvas rows are the FLIPPED x grid coordinate and its columns the y one,
and the decoration's pillar centres swap the grid axes. Parameter names
are upstream's (``point_net.net.{0,1,3,4}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from muvo_tpu_torch.parallel import mesh


class MaskedBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over the valid points only: in training, mask-weighted
    biased statistics, and flax's running update (momentum 0.9 on the
    running value) with the biased variance, as muvo_tpu's MaskedBatchNorm;
    in eval, the running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x, mask):
        x32 = x.float()
        if self.training:
            m = mask[:, None].float()
            stats = self._global_stats if mesh.is_active() else self._stats
            mean, var = stats(x32, m)
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(self.momentum * mean)
                self.running_var.mul_(keep).add_(self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return y * self.weight + self.bias

    @staticmethod
    def _stats(x32, m):
        cnt = m.sum().clamp_min(1.0)
        mean = (x32 * m).sum(0) / cnt
        return mean, ((x32 - mean) ** 2 * m).sum(0) / cnt

    @staticmethod
    def _global_stats(x32, m):
        """In a group of ranks: the valid points' mean and biased variance
        over the global batch, from each rank's count, masked mean and sum
        of squared deviations (mesh.combine_moments)."""
        c = x32.shape[1]
        count = m.sum().reshape(1)
        local = (x32 * m).sum(0) / count.clamp_min(1.0)
        m2 = ((x32 - local) ** 2 * m).sum(0)
        rows = mesh.batch_stats_gather(torch.cat([count, local, m2]))
        mean, var = mesh.combine_moments(rows[:, :1], rows[:, 1:c + 1],
                                         rows[:, c + 1:])
        return mean.to(x32.dtype), var.to(x32.dtype)


class PointNet(nn.Module):
    """(Linear, MaskedBatchNorm1d, ReLU) for each width, over the
    flattened points; ``net`` holds them as upstream's Sequential does."""

    def __init__(self, in_channels: int, num_features: Sequence[int]):
        super().__init__()
        layers = []
        for f in num_features:
            layers += [nn.Linear(in_channels, f), MaskedBatchNorm1d(f),
                       nn.ReLU()]
            in_channels = f
        self.net = nn.Sequential(*layers)

    def forward(self, x, mask):
        for layer in self.net:
            x = (layer(x, mask) if isinstance(layer, MaskedBatchNorm1d)
                 else layer(x))
        return x


class PointPillarNet(nn.Module):
    """(B, P, 3) padded points and (B,) counts -> (B, ny, nx, C) canvas."""

    def __init__(self, num_features: Sequence[int] = (32, 32),
                 min_x: float = -48.0, max_x: float = 48.0,
                 min_y: float = -48.0, max_y: float = 48.0,
                 pixels_per_meter: int = 5):
        super().__init__()
        self.min_x, self.max_x = min_x, max_x
        self.min_y, self.max_y = min_y, max_y
        self.pixels_per_meter = pixels_per_meter
        self.nx = int((max_x - min_x) * pixels_per_meter)
        self.ny = int((max_y - min_y) * pixels_per_meter)
        self.out_channels = num_features[-1]
        self.point_net = PointNet(8, num_features)

    def forward(self, points, num_points):
        b, p, _ = points.shape
        nx, ny, ppm = self.nx, self.ny, self.pixels_per_meter
        slots = ny * nx + 1  # the last: padding and out-of-range points
        px, py = points[..., 0], points[..., 1]
        in_count = (torch.arange(p, device=points.device)[None, :]
                    < num_points.reshape(b, 1))
        valid = (in_count & (px >= self.min_x) & (px < self.max_x)
                 & (py >= self.min_y) & (py < self.max_y))
        # truncation toward zero, then clamped, as muvo_tpu's astype
        cx = ((px - self.min_x) * ppm).to(torch.int64).clamp(0, nx - 1)
        cy = ((py - self.min_y) * ppm).to(torch.int64).clamp(0, ny - 1)
        row = (ny - 1 - cx).clamp(0, ny - 1)
        col = cy.clamp(0, nx - 1)
        pillar = torch.where(valid, row * nx + col,
                             torch.full_like(row, slots - 1))
        index = (pillar + slots * torch.arange(b, device=points.device)[:, None]
                 ).reshape(-1)

        with torch.no_grad():  # the cluster means carry no gradient
            m = valid.reshape(-1, 1).to(points.dtype)
            flat = points.reshape(-1, 3)
            sums = flat.new_zeros(b * slots, 3).index_add_(0, index, flat * m)
            counts = flat.new_zeros(b * slots).index_add_(0, index, m[:, 0])
            means = sums / counts.clamp_min(1.0)[:, None]
            cluster_mean = means[index].reshape(b, p, 3)

        # the decoration's swapped grid axes (upstream's quirk)
        x_centers = cy.to(points.dtype) / ppm + self.min_x
        y_centers = cx.to(points.dtype) / ppm + self.min_y
        feats = torch.cat([points, points - cluster_mean,
                           (px - x_centers)[..., None],
                           (py - y_centers)[..., None]], dim=-1)

        flat_valid = valid.reshape(-1)
        point_feats = self.point_net(feats.reshape(b * p, 8), flat_valid)
        c = point_feats.shape[-1]
        low = torch.finfo(point_feats.dtype).min
        masked = torch.where(flat_valid[:, None], point_feats,
                             torch.full_like(point_feats, low))
        # the identity of max is -inf, as in jax's segment_max: ties among
        # a pillar's points share its gradient evenly, on both sides
        pooled = point_feats.new_full((b * slots, c), float("-inf"))
        pooled = pooled.scatter_reduce(0, index[:, None].expand(-1, c),
                                       masked, "amax", include_self=True)
        pooled = torch.where(pooled <= low / 2, torch.zeros_like(pooled),
                             pooled)
        return pooled.reshape(b, slots, c)[:, :-1].reshape(b, ny, nx, c)
