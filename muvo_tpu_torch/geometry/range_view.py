"""LiDAR range-view (spherical) projection, on the host and on the device.

An own copy of ``RangeProjector`` in muvo_tpu/geometry/range_view.py (a
test holds its host side equal). Semantics match the reference projection
(muvo/utils/geometry_utils.py:166-244): points are first restored to the
raw CARLA sensor frame (undo y-flip and sensor offset), then projected to
an H x W range image with a nearest-point-wins z-buffer. ``project`` takes
the native C kernel (muvo_tpu_torch/native) when it builds, else the
vectorised numpy path ``project_numpy``. ``project_torch`` is muvo_tpu's
``project_jax`` for POINTS.DEVICE_PROJECTION: fixed-capacity padded
clouds of many frames in one pass, on the tensors' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the z-buffer key of a padded point, above every finite float32's bits
NO_POINT = 0x7F7FFFFF


class RangeProjector:
    def __init__(self, h=64, w=1024, fov_down=-30.0, fov_up=10.0,
                 lidar_position=(1.0, 0.0, 2.0)):
        self.fov_up = fov_up / 180.0 * np.pi
        self.fov_down = fov_down / 180.0 * np.pi
        self.fov = self.fov_up - self.fov_down
        self.h = int(h)
        self.w = int(w)
        self.lidar_position = np.asarray(lidar_position, dtype=np.float64)

    def _pixel_coords(self, points_np):
        """Spherical pixel coordinates for ego-frame points (numpy)."""
        # undo the ego-frame conversion: back to the raw CARLA lidar frame
        points_carla = points_np * np.array([1.0, -1.0, 1.0])
        points_carla = points_carla - self.lidar_position

        depth = np.linalg.norm(points_carla, 2, axis=1)
        x = points_carla[:, 0]
        y = -points_carla[:, 1]  # CARLA is left-handed
        z = points_carla[:, 2]

        yaw = np.arctan2(y, x)
        with np.errstate(invalid="ignore", divide="ignore"):
            pitch = np.arcsin(np.where(depth > 0,
                                       z / np.maximum(depth, 1e-12), 0.0))

        proj_w = 0.5 * (1.0 - yaw / np.pi) * self.w
        proj_h = (1.0 - (pitch + abs(self.fov_down)) / self.fov) * self.h

        proj_w = np.clip(np.floor(proj_w), 0, self.w - 1).astype(np.int32)
        proj_h = np.clip(np.floor(proj_h), 0, self.h - 1).astype(np.int32)
        return depth, proj_h, proj_w

    def project(self, points, semantics):
        """Project ego-frame points -> (depth HxW, xyz HxWx3, sem HxW).

        Pixels with no point get depth -1, xyz 0, sem 0. Where several
        points land on one pixel the nearest wins.
        """
        from muvo_tpu_torch import native

        if native.available():
            out = native.range_project(
                np.asarray(points, np.float32),
                np.asarray(semantics, np.uint8),
                self.h, self.w, self.fov_down, self.fov_up,
                self.lidar_position,
            )
            if out is not None:
                return out
        return self.project_numpy(points, semantics)

    def project_numpy(self, points, semantics):
        points = np.asarray(points, dtype=np.float64)
        semantics = np.asarray(semantics)
        depth, proj_h, proj_w = self._pixel_coords(points)

        # Descending depth: the final (closest) write wins.
        order = np.argsort(depth)[::-1]
        depth = depth[order]
        proj_h = proj_h[order]
        proj_w = proj_w[order]
        points = points[order]
        semantics = semantics[order]

        range_depth = np.full((self.h, self.w), -1, dtype=np.float32)
        range_xyz = np.zeros((self.h, self.w, 3), dtype=np.float32)
        range_sem = np.zeros((self.h, self.w), dtype=np.uint8)
        range_depth[proj_h, proj_w] = depth
        range_xyz[proj_h, proj_w] = points
        range_sem[proj_h, proj_w] = semantics
        return range_depth, range_xyz, range_sem

    def project_torch(self, points, semantics, valid):
        """Project padded ego-frame clouds of n frames at once: points
        (n, P, 3), semantics (n, P), valid (n, P) bool (False marks
        padding) -> depth (n, H, W), xyz (n, H, W, 3), sem (n, H, W).

        float32 throughout, as muvo_tpu's ``project_jax``, vmapped there
        and batched here by a pixel offset a frame. Pixels with no valid
        point get depth -1, xyz 0, sem 0. The nearest point wins: the
        z-buffer key is |depth|'s float32 bits as int32 (positive floats
        order as their bits do), padding NO_POINT, and the two
        ``segment_min``s are ``scatter_reduce_(amin)``s, so equal depths
        go to the lowest point index.
        """
        points = points.float()
        n, p = points.shape[:2]
        dev = points.device
        flip = torch.tensor([1.0, -1.0, 1.0], device=dev)
        pts = points * flip - torch.tensor(self.lidar_position,
                                           dtype=torch.float32, device=dev)
        depth = torch.linalg.norm(pts, dim=-1)
        x, y, z = pts[..., 0], -pts[..., 1], pts[..., 2]
        yaw = torch.atan2(y, x)
        pitch = torch.asin(torch.where(depth > 0,
                                       z / depth.clamp_min(1e-12), 0.0))
        proj_w = torch.floor(0.5 * (1.0 - yaw / math.pi) * self.w).clamp(
            0, self.w - 1).long()
        proj_h = torch.floor(
            (1.0 - (pitch + abs(self.fov_down)) / self.fov) * self.h
        ).clamp(0, self.h - 1).long()
        num_pix = self.h * self.w
        frame = torch.arange(n, device=dev)[:, None]
        pix = (frame * num_pix + proj_h * self.w + proj_w).reshape(-1)

        key = torch.where(valid, depth.abs().view(torch.int32),
                          NO_POINT).reshape(-1)
        seg_min = torch.full((n * num_pix,), NO_POINT, dtype=torch.int32,
                             device=dev).scatter_reduce_(0, pix, key, "amin")
        hit = seg_min < NO_POINT
        is_winner = valid.reshape(-1) & (key == seg_min[pix])
        idx = torch.arange(p, device=dev).expand(n, p).reshape(-1)
        winner = torch.full((n * num_pix,), p, dtype=torch.long,
                            device=dev).scatter_reduce_(
            0, pix, torch.where(is_winner, idx, p), "amin")
        # the winner's row in the flattened (n * P) cloud
        row = (frame * p + torch.where(hit.view(n, num_pix),
                                       winner.view(n, num_pix), 0)).reshape(-1)
        hw = (n, self.h, self.w)
        range_depth = torch.where(hit, depth.reshape(-1)[row], -1.0)
        range_xyz = torch.where(hit[:, None], points.reshape(-1, 3)[row], 0.0)
        range_sem = torch.where(hit, semantics.reshape(-1)[row], 0)
        return (range_depth.view(hw), range_xyz.view(*hw, 3),
                range_sem.view(hw))
