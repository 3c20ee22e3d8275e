"""Offline LiDAR preprocessing: split episode-level semantic point clouds
into per-frame files with the sensor-frame correction applied.

The port's copy of tools/preprocess_pcd.py (counterpart of reference
data/pcd.py): loads each run's
``point_clouds_semantic.npy`` (list of per-frame dicts), applies the y-flip +
sensor-offset transform, saves ``points_semantic/points_semantic_NNNNNNNNN.npy``
and records the paths in pd_dataframe.pkl.

Usage:
    python -m muvo_tpu_torch.tools.preprocess_pcd --dataroot /path/ds \
        [--version trainval] [--mode train] [--workers 4]
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from multiprocessing import Pool

import numpy as np

LIDAR_POS = (1.0, 0.0, 2.0)


def save_frame(args):
    run_path, idx, frame = args
    xyz = frame["points_xyz"].astype(np.float64)
    xyz[:, 1] *= -1
    xyz += np.asarray(LIDAR_POS)
    out = {
        "points_xyz": xyz.astype(np.float32),
        "ObjTag": frame["ObjTag"],
        "ObjIdx": frame.get("ObjIdx"),
        "CosAngel": frame.get("CosAngel"),
    }
    out_dir = os.path.join(run_path, "points_semantic")
    os.makedirs(out_dir, exist_ok=True)
    name = f"points_semantic_{idx:09d}.npy"
    np.save(os.path.join(out_dir, name), out)
    return os.path.join("points_semantic", name)


def process_run(run_path, workers):
    import pandas as pd

    episode_file = os.path.join(run_path, "point_clouds_semantic.npy")
    df_path = os.path.join(run_path, "pd_dataframe.pkl")
    if not (os.path.isfile(episode_file) and os.path.isfile(df_path)):
        return
    frames = np.load(episode_file, allow_pickle=True)
    jobs = [(run_path, i, f if isinstance(f, dict) else f.item())
            for i, f in enumerate(frames)]
    if workers > 1:
        with Pool(workers) as pool:
            paths = pool.map(save_frame, jobs)
    else:
        paths = [save_frame(j) for j in jobs]
    df = pd.read_pickle(df_path)
    df["points_semantic_path"] = paths[: len(df)]
    pd.to_pickle(df, df_path)
    print(f"{run_path}: wrote {len(paths)} lidar frames")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--version", default="trainval")
    ap.add_argument("--mode", default="*")
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args()

    pattern = os.path.join(args.dataroot, args.version, args.mode, "*", "*")
    for run_path in sorted(glob(pattern)):
        if os.path.isdir(run_path):
            process_run(run_path, args.workers)


if __name__ == "__main__":
    main()
