"""Camera and BEV geometry: intrinsics and extrinsics (numpy).

An own copy of the numpy functions of muvo_tpu/geometry/camera.py (a test
holds them equal). Semantics match the reference
(muvo/utils/geometry_utils.py:8-91, muvo/data/dataset.py:372-385).
"""

from __future__ import annotations

import numpy as np


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
