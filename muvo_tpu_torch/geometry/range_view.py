"""LiDAR range-view (spherical) projection, on the host.

An own copy of ``RangeProjector``'s host side in
muvo_tpu/geometry/range_view.py (a test holds it equal). Semantics match
the reference projection (muvo/utils/geometry_utils.py:166-244): points
are first restored to the raw CARLA sensor frame (undo y-flip and sensor
offset), then projected to an H x W range image with a nearest-point-wins
z-buffer. ``project`` takes the native C kernel (muvo_tpu_torch/native)
when it builds, else the vectorised numpy path ``project_numpy``.
"""

from __future__ import annotations

import numpy as np


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
