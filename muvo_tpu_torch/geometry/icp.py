"""Point-to-point ICP registration (pure numpy; open3d replacement).

Counterpart of reference muvo/utils/geometry_utils.py:248-267
(compute_pcd_transformation, used to derive ego trajectories from predicted
point clouds for visualisation). SVD-based rigid alignment with
nearest-neighbour correspondences.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _rigid_from_correspondences(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Best-fit rigid transform (4x4) mapping src -> dst (Kabsch/SVD)."""
    src_c = src.mean(axis=0)
    dst_c = dst.mean(axis=0)
    H = (src - src_c).T @ (dst - dst_c)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = dst_c - R @ src_c
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def icp_point_to_point(source: np.ndarray, target: np.ndarray,
                       threshold: float = 0.02, max_iterations: int = 50,
                       init: np.ndarray = None) -> np.ndarray:
    """Iterative closest point; returns the 4x4 source->target transform.

    Correspondences are brute-force nearest neighbours (fine at the
    visualisation point counts); pairs beyond ``threshold`` are rejected
    once any pair is within it (matching open3d's max_correspondence_distance
    semantics loosely).
    """
    src = np.asarray(source, np.float64)
    dst = np.asarray(target, np.float64)
    T = np.eye(4) if init is None else np.asarray(init, np.float64).copy()
    if len(src) == 0 or len(dst) == 0:
        return T

    prev_err = np.inf
    for _ in range(max_iterations):
        moved = src @ T[:3, :3].T + T[:3, 3]
        d2 = ((moved[:, None, :] - dst[None, :, :]) ** 2).sum(-1)
        nn = d2.argmin(axis=1)
        dists = np.sqrt(d2[np.arange(len(src)), nn])
        keep = dists <= max(threshold, np.median(dists))
        if keep.sum() < 3:
            break
        step = _rigid_from_correspondences(moved[keep], dst[nn[keep]])
        T = step @ T
        err = dists[keep].mean()
        if abs(prev_err - err) < 1e-8:
            break
        prev_err = err
    return T


def compute_pcd_transformation(pcd1, pcd2, Rt: Dict, threshold: float = 0.02
                               ) -> Tuple[np.ndarray, Dict]:
    """Register pcd2 onto pcd1 and accumulate the trajectory pose.

    Rt: {'Rot': (3,3), 'pos': (3,1)} accumulated pose; returns
    (transformation, updated Rt) with the reference's accumulation rule.
    """
    if len(pcd1) > 0 and len(pcd2) > 0:
        transformation = icp_point_to_point(pcd2, pcd1, threshold)
    else:
        transformation = np.eye(4)

    R = transformation[:3, :3]
    t = transformation[:3, -1:]
    Rot = R @ Rt["Rot"]
    pos = Rt["pos"] + Rt["Rot"] @ t
    return transformation, {"Rot": Rot, "pos": pos}
