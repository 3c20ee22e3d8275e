"""Camera and BEV geometry: intrinsics, extrinsics, view masks (numpy),
and the closed-form inverse of batched intrinsics (torch).

An own copy of the functions of muvo_tpu/geometry/camera.py (tests hold
them equal). Semantics match the reference
(muvo/utils/geometry_utils.py:8-91, muvo/data/dataset.py:372-385).
"""

from __future__ import annotations

import numpy as np
import torch


def calculate_geometry(image_fov, height, width, forward, right, up, pitch,
                       yaw, roll):
    """Pinhole intrinsics + camera->ego extrinsics for a single camera."""
    f = width / (2 * np.tan(image_fov * np.pi / 360.0))
    cx = width / 2
    cy = height / 2
    intrinsics = np.float32([[f, 0, cx], [0, f, cy], [0, 0, 1]])
    extrinsics = get_extrinsics(forward, right, up, pitch, yaw, roll)
    return intrinsics, extrinsics


def get_extrinsics(forward, right, up, pitch, yaw, roll):
    """Camera-frame (right, down, forward) -> ego-frame (forward, left, up)."""
    if not pitch == yaw == roll == 0.0:
        raise ValueError("only zero-rotation camera rigs are supported")
    return np.float32([
        [0, 0, 1, forward],
        [-1, 0, 0, -right],
        [0, -1, 0, up],
        [0, 0, 0, 1],
    ])


def calculate_geometry_from_config(cfg):
    fov = cfg.IMAGE.FOV
    h, w = cfg.IMAGE.SIZE
    forward, right, up = cfg.IMAGE.CAMERA_POSITION
    pitch, yaw, roll = cfg.IMAGE.CAMERA_ROTATION
    return calculate_geometry(fov, h, w, forward, right, up, pitch, yaw, roll)


def bev_params_to_intrinsics(size, scale, offsetx):
    """BEV 'camera' intrinsics: metres (forward, left) -> BEV pixels.

    size: (width, height) px; scale: m/px; offsetx: ego offset forward in px.
    """
    return np.array(
        [
            [1 / scale, 0, size[0] / 2 + offsetx],
            [0, -1 / scale, size[1] / 2],
            [0, 0, 1],
        ],
        dtype=np.float32,
    )


def intrinsics_inverse(intrinsics: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched pinhole intrinsics (..., 3, 3):
    [[1/fx, 0, -cx/fx], [0, 1/fy, -cy/fy], [0, 0, 1]]."""
    fx = intrinsics[..., 0, 0]
    fy = intrinsics[..., 1, 1]
    cx = intrinsics[..., 0, 2]
    cy = intrinsics[..., 1, 2]
    one = torch.ones_like(fx)
    zero = torch.zeros_like(fx)
    return torch.stack([
        torch.stack([1 / fx, zero, -cx / fx], -1),
        torch.stack([zero, 1 / fy, -cy / fy], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def get_out_of_view_mask(cfg) -> np.ndarray:
    """Mask of BEV pixels invisible from the (cropped) front camera."""
    fov = cfg.IMAGE.FOV
    w = cfg.IMAGE.SIZE[1]
    resolution = cfg.BEV.RESOLUTION

    f = w / (2 * np.tan(fov * np.pi / 360.0))
    c_u = w / 2 - cfg.IMAGE.CROP[0]  # adjust optical centre for the crop

    bev_left = -np.round((cfg.BEV.SIZE[0] // 2) * resolution, decimals=1)
    bev_right = np.round((cfg.BEV.SIZE[0] // 2) * resolution, decimals=1)
    bev_bottom = 0.01
    camera_offset = (
        cfg.BEV.SIZE[1] / 2 + cfg.BEV.OFFSET_FORWARD
    ) * resolution + cfg.IMAGE.CAMERA_POSITION[0]
    bev_top = np.round(cfg.BEV.SIZE[1] * resolution - camera_offset, decimals=1)

    x = np.arange(bev_left, bev_right, resolution)
    z = np.arange(bev_bottom, bev_top, resolution)
    ucoords = x / z[:, None] * f + c_u

    new_w = cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0]
    mask = (ucoords >= 0) & (ucoords < new_w)
    mask = ~mask[::-1]
    behind = np.ones((int(camera_offset / resolution), mask.shape[1]), dtype=bool)
    return np.vstack([mask, behind])
