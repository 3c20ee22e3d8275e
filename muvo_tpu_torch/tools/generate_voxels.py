"""Offline voxelisation: fuse depth-camera + LiDAR point clouds into semantic
occupancy voxel grids, one file per frame.

The port's copy of tools/generate_voxels.py (counterpart of reference
data/generate_voxels.py), on the port's geometry/voxel.py: walks every run
directory, merges the depth-camera back-projection with the semantic LiDAR
cloud in the ego frame, applies the voxel filter, and saves sparse
``voxel/voxel_NNNNNNNNN.npy`` rows (x, y, z, semantic), appending a
``voxel_path`` column to the run's pd_dataframe.pkl.

Usage:
    python -m muvo_tpu_torch.tools.generate_voxels --dataroot /path/ds \
        --version trainval \
        [--mode train] [--workers 4] [--fov 110] [--resolution 0.2] \
        [--size 192 192 64] [--offset -12.8 0.0 -4.0]
"""

from __future__ import annotations

import argparse
import os
from functools import partial
from glob import glob
from multiprocessing import Pool

import numpy as np

from muvo_tpu_torch.geometry.voxel import (
    convert_coor_img,
    convert_coor_lidar,
    decode_depth,
    depth_to_pcd,
    merge_point_clouds,
    voxel_filter,
)

CAMERA_POS = (1.0, 0.0, 2.0)
LIDAR_POS = (1.0, 0.0, 2.0)


def voxel_offset_from_cfg(voxel_cfg):
    """Grid origin (metres) so the ego lands at VOXEL.EV_POSITION.

    offset = -EV_POSITION * RESOLUTION on every axis. No extra half-extent
    correction is needed on y (or any axis): EV_POSITION is the ego's voxel
    INDEX within the grid, so it already encodes the centring (e.g. the
    reference's muvo.yml puts EV_POSITION[1] at SIZE[1]/2)."""
    return [-float(voxel_cfg.EV_POSITION[i]) * voxel_cfg.RESOLUTION
            for i in range(3)]


def voxelize_one(args, fov, resolution, size, offset):
    run_path, idx, depth_file, lidar_file = args
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(run_path, depth_file)))
    depth = decode_depth(img[..., :3])
    semantic = img[..., -1]
    img_pcd, img_sem = depth_to_pcd(depth, semantic, fov)
    img_pcd = convert_coor_img(img_pcd, CAMERA_POS)

    lidar = np.load(os.path.join(run_path, lidar_file), allow_pickle=True).item()
    lidar_pcd = convert_coor_lidar(lidar["points_xyz"].astype(np.float64).copy(),
                                   LIDAR_POS)
    lidar_sem = lidar["ObjTag"]

    pcd, sem = merge_point_clouds(img_pcd, img_sem, lidar_pcd, lidar_sem)
    voxels, vsem = voxel_filter(pcd, sem, resolution, size, offset)
    rows = np.concatenate([voxels.astype(np.uint16),
                           vsem[:, None].astype(np.uint16)], axis=1)

    out_dir = os.path.join(run_path, "voxel")
    os.makedirs(out_dir, exist_ok=True)
    out_name = f"voxel_{idx:09d}.npy"
    np.save(os.path.join(out_dir, out_name), rows)
    return os.path.join("voxel", out_name)


def process_run(run_path, fov, resolution, size, offset, workers):
    import pandas as pd

    df_path = os.path.join(run_path, "pd_dataframe.pkl")
    if not os.path.isfile(df_path):
        return
    df = pd.read_pickle(df_path)
    if "depth_semantic_path" not in df or "points_semantic_path" not in df:
        print(f"skip {run_path}: missing depth/lidar columns")
        return

    jobs = [
        (run_path, i, df.iloc[i]["depth_semantic_path"],
         df.iloc[i]["points_semantic_path"])
        for i in range(len(df))
    ]
    fn = partial(voxelize_one, fov=fov, resolution=resolution, size=size,
                 offset=offset)
    if workers > 1:
        with Pool(workers) as pool:
            paths = pool.map(fn, jobs)
    else:
        paths = [fn(j) for j in jobs]
    df["voxel_path"] = paths
    pd.to_pickle(df, df_path)
    print(f"{run_path}: wrote {len(paths)} voxel frames")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--version", default="trainval")
    ap.add_argument("--mode", default="*")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--fov", type=float, default=110)
    ap.add_argument("--resolution", type=float, default=0.2)
    ap.add_argument("--size", type=int, nargs=3, default=[192, 192, 64])
    ap.add_argument("--offset", type=float, nargs=3, default=[-12.8, 0.0, -4.0])
    args = ap.parse_args()

    pattern = os.path.join(args.dataroot, args.version, args.mode, "*", "*")
    for run_path in sorted(glob(pattern)):
        if os.path.isdir(run_path):
            process_run(run_path, args.fov, args.resolution, args.size,
                        args.offset, args.workers)


if __name__ == "__main__":
    main()
