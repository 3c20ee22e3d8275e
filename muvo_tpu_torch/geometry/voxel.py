"""Point-cloud voxelisation and depth-camera back-projection.

An own copy of muvo_tpu/geometry/voxel.py (a test holds it equal).
Semantics match the reference offline preprocessing (reference:
data/data_preprocessing.py:71-247): CARLA 24-bit depth decode, pinhole
back-projection, sensor-frame conversions, point-cloud merging with ego-box
masking, and the voxel filter that assigns each occupied cell the label of the
point nearest the cell centre (with a RoadLines priority override).

The voxel filter here is fully vectorised (the reference loops per voxel in
Python); identical output up to ties between equidistant points.
"""

from __future__ import annotations

import numpy as np

from muvo_tpu_torch.constants import EGO_VEHICLE_DIMENSION

# CARLA semantic tag for RoadLines (thin structures get priority labels).
ROADLINES_TAG = 6


def decode_depth(depth_color: np.ndarray) -> np.ndarray:
    """CARLA 24-bit RGB-encoded depth -> metres. depth_color: (..., 3) uint8
    in (R, G, B) channel order as stored by CARLA."""
    depth_color = depth_color.astype(np.float64)
    normalized = (
        256.0 ** 2 * depth_color[..., 2]
        + 256.0 * depth_color[..., 1]
        + depth_color[..., 0]
    ) / (256.0 ** 3 - 1)
    return 1000.0 * normalized


def depth_to_pcd(depth, semantic, fov, max_range=100.0):
    """Back-project a depth image into camera-frame points.

    depth: (H, W) metres; semantic: (H, W). Returns (points (M,3), sem (M,1)).
    Camera frame axes are (right, down, forward).
    """
    h, w = depth.shape
    f = w / (2.0 * np.tan(fov * np.pi / 360.0))
    cx, cy = w / 2.0, h / 2.0

    flat_depth = depth.reshape(-1, 1)
    valid = (flat_depth < 1000).squeeze(-1)
    flat_depth = flat_depth[valid]

    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    xx = xx.reshape(-1, 1)[valid]
    yy = yy.reshape(-1, 1)[valid]
    x = (xx - cx) * flat_depth / f
    y = (yy - cy) * flat_depth / f
    points = np.concatenate([x, y, flat_depth], axis=1)
    sem = semantic.reshape(-1, 1)[valid]
    in_range = np.linalg.norm(points, axis=1) < max_range
    return points[in_range], sem[in_range]


def convert_coor_img(pcd: np.ndarray, camera_pos) -> np.ndarray:
    """Camera frame (right, down, forward) -> ego frame (forward, left, up)."""
    forward, right, up = camera_pos
    mat = np.float32([
        [0, 0, 1, forward],
        [-1, 0, 0, -right],
        [0, -1, 0, up],
        [0, 0, 0, 1],
    ])
    homo = np.concatenate([pcd, np.ones((pcd.shape[0], 1))], axis=1)
    return (mat @ homo.T).T[:, :3]


def convert_coor_lidar(pcd: np.ndarray, lidar_pos) -> np.ndarray:
    """Raw CARLA lidar frame -> ego frame: add sensor offset, flip y."""
    out = pcd + np.asarray(lidar_pos)
    out[:, 1] *= -1
    return out


def mask_ego_box(points: np.ndarray, semantics: np.ndarray, dims=None):
    """Drop points inside the ego-vehicle bounding box."""
    x, y, z = dims if dims is not None else EGO_VEHICLE_DIMENSION
    box = np.array([[-x / 2, -y / 2, 0], [x / 2, y / 2, z]])
    inside = ((box[0] < points) & (points < box[1])).all(axis=1)
    return points[~inside], semantics[~inside]


def merge_point_clouds(img_pcd, img_sem, lidar_pcd, lidar_sem, mask_ego=True):
    """Fuse depth-camera and LiDAR point clouds (both already ego-frame)."""
    pcd = np.concatenate([img_pcd, lidar_pcd], axis=0)
    sem = np.concatenate([np.ravel(img_sem), np.ravel(lidar_sem)], axis=0)
    if mask_ego:
        pcd, sem = mask_ego_box(pcd, sem)
    return pcd, sem


def voxel_filter(pcd, sem, voxel_resolution, voxel_size, offset,
                 priority_label=ROADLINES_TAG):
    """Voxelise a labelled point cloud.

    For every occupied cell, the label is that of the point closest to the
    cell centre — unless any point in the cell carries ``priority_label``
    (RoadLines), which wins outright.

    Returns (voxels (K,3) uint16 cell coords, semantics (K,) uint8).
    """
    pcd = np.asarray(pcd, dtype=np.float64)
    sem = np.asarray(sem).reshape(-1)
    voxel_size = np.asarray(voxel_size)
    offset = np.asarray(offset, dtype=np.float64) + voxel_resolution * voxel_size / 2

    pcd_b = pcd + offset
    keep = ((0 <= pcd_b) & (pcd_b < voxel_size * voxel_resolution)).all(axis=1)
    pcd_b, sem_b = pcd_b[keep], sem[keep]
    if pcd_b.shape[0] == 0:
        return np.zeros((0, 3), np.uint16), np.zeros((0,), np.uint8)

    dx, dy, _ = voxel_size
    cell, frac = np.divmod(pcd_b, voxel_resolution)
    h = cell[:, 0] + cell[:, 1] * dx + cell[:, 2] * dx * dy
    dist = np.sum(frac ** 2, axis=1)

    # Sort by (cell, distance-to-centre): the first point of each cell group is
    # the nearest one.
    order = np.lexsort((dist, h))
    h, cell, sem_b = h[order], cell[order], sem_b[order]

    uniq_h, first = np.unique(h, return_index=True)
    group = np.searchsorted(uniq_h, h)  # group id per point
    labels = sem_b[first]

    has_priority = np.zeros(uniq_h.shape[0], dtype=bool)
    np.logical_or.at(has_priority, group, sem_b == priority_label)
    labels = np.where(has_priority, priority_label, labels)

    return cell[first].astype(np.uint16), labels.astype(np.uint8)


def densify_voxels(voxel_coords, voxel_sem, grid_size):
    """Sparse (K,3)+(K,) voxel rows -> dense uint8 grid of ``grid_size``."""
    from muvo_tpu_torch import native

    if native.available() and voxel_coords.shape[0]:
        out = native.densify_voxels(voxel_coords, voxel_sem, grid_size)
        if out is not None:
            return out
    grid = np.zeros(tuple(grid_size), dtype=np.uint8)
    if voxel_coords.shape[0]:
        c = voxel_coords.astype(np.int64)
        grid[c[:, 0], c[:, 1], c[:, 2]] = voxel_sem
    return grid


def lidar_to_histogram_features(lidar, cfg):
    """Three-plane (xy/xz/yz) occupancy histograms of a point cloud.

    Mirrors reference muvo/utils/geometry_utils.py:94-163.
    """
    offset = np.asarray(cfg.VOXEL.EV_POSITION) * cfg.VOXEL.RESOLUTION
    ppm = cfg.POINTS.HISTOGRAM.RESOLUTION
    hist_max = cfg.POINTS.HISTOGRAM.HIST_MAX
    xr = cfg.POINTS.HISTOGRAM.X_RANGE
    yr = cfg.POINTS.HISTOGRAM.Y_RANGE
    zr = cfg.POINTS.HISTOGRAM.Z_RANGE

    xbins = np.linspace(-offset[0], -offset[0] + xr / ppm, xr + 1)
    ybins = np.linspace(-offset[1], -offset[1] + yr / ppm, yr + 1)
    zbins = np.linspace(-offset[2], -offset[2] + zr / ppm, zr + 1)

    def splat(points, b1, b2):
        hist = np.histogramdd(points, bins=(b1, b2))[0]
        return np.minimum(hist, hist_max) / hist_max

    def plane(slabs, cols, b1, b2):
        feats = [splat(s[..., cols], b1, b2) for s in slabs]
        feats.append(sum(feats))
        return np.stack(feats, axis=0).astype(np.float32)

    z = lidar[..., 2]
    xy = plane(
        [lidar[z <= 0], lidar[(0 < z) & (z <= 2.5)], lidar[z > 2.5]],
        [0, 1], xbins, ybins,
    )
    y = lidar[..., 1]
    xz = plane(
        [lidar[y >= 1.5], lidar[(-1.5 < y) & (y < 1.5)], lidar[y <= -1.5]],
        [0, 2], xbins, zbins,
    )
    x = lidar[..., 0]
    yz = plane(
        [lidar[x < -2.5], lidar[(-2.5 <= x) & (x <= 10)], lidar[x > 10]],
        [1, 2], ybins, zbins,
    )
    return xy, xz, yz
