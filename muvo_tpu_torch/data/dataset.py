"""CARLA on-disk dataset: run indexing, reward filtering, stride-sampled
sequence pointers, per-frame decode.

An own copy of muvo_tpu/data/dataset.py: the same recording gives the
same arrays, bit for bit, in both packages (a test holds them equal).
Semantics match reference muvo/data/dataset.py:144-385, with channels-last
output and all device-side work (label pyramids, normalisation) deferred to
muvo_tpu_torch.models.preprocess. A DATAROOT of 'synthetic' produces random data
with the same contract for smoke runs.

Folder layout (reference README.md:42-79):
    dataroot/<version>/<mode>/<town>/<run>/{pd_dataframe.pkl, image/...,
    routemap/..., birdview/..., points_semantic/..., voxel/...,
    depth_semantic/...}
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from muvo_tpu_torch.constants import CARLA_FPS, EGO_VEHICLE_DIMENSION, label_remap_table
from muvo_tpu_torch.data.dataset_utils import calculate_birdview_labels, integer_to_binary
from muvo_tpu_torch.data.synthetic import synthetic_batch
from muvo_tpu_torch.geometry.camera import calculate_geometry_from_config
from muvo_tpu_torch.geometry.range_view import RangeProjector
from muvo_tpu_torch.geometry.voxel import densify_voxels


def _label_connected_components(mask: np.ndarray) -> np.ndarray:
    import scipy.ndimage

    labeled, _ = scipy.ndimage.label(mask.astype(np.int64))
    return labeled


class CarlaDataset:
    def __init__(self, cfg, mode: str = "train", sequence_length: int = 1,
                 dataset_root: Optional[str] = None, towns_filter: str = "*",
                 runs_filter: str = "*"):
        self.cfg = cfg
        self.mode = mode
        self.sequence_length = sequence_length
        root = dataset_root if dataset_root else cfg.DATASET.DATAROOT
        self.dataset_path = os.path.join(root, cfg.DATASET.VERSION, mode)
        self.intrinsics, self.extrinsics = calculate_geometry_from_config(cfg)
        self.remap = label_remap_table()
        self.pcd = RangeProjector(
            cfg.POINTS.CHANNELS, cfg.POINTS.HORIZON_RESOLUTION,
            cfg.POINTS.FOV[0], cfg.POINTS.FOV[1], cfg.POINTS.LIDAR_POSITION,
        )

        import pandas as pd

        self.data: Dict[str, "pd.DataFrame"] = {}
        for town_path in sorted(glob(os.path.join(self.dataset_path, towns_filter))):
            town = os.path.basename(town_path)
            for run_path in sorted(glob(os.path.join(self.dataset_path, town,
                                                     runs_filter))):
                run = os.path.basename(run_path)
                df_path = os.path.join(run_path, "pd_dataframe.pkl")
                if os.path.isfile(df_path):
                    self.data[f"{town}/{run}"] = pd.read_pickle(df_path)

        self.data_pointers = self._get_data_pointers()

    def _get_data_pointers(self) -> List[Tuple[str, List[int]]]:
        pointers = []
        n_filtered = 0
        stride = int(self.cfg.DATASET.STRIDE_SEC * CARLA_FPS)
        start_index = int(CARLA_FPS * self.cfg.DATASET.FILTER_BEGINNING_OF_RUN_SEC)
        for run, df in self.data.items():
            run_length = len(df["reward"])
            if df["reward"].sum() / run_length < self.cfg.DATASET.FILTER_NORM_REWARD:
                n_filtered += 1
                continue
            total = len(df) - stride * self.sequence_length
            for i in range(start_index, total):
                pointers.append(
                    (run, list(range(i, i + stride * self.sequence_length, stride)))
                )
        print(f"Filtered {n_filtered} runs in {self.dataset_path}")

        if self.cfg.EVAL.DATASET_REDUCTION:
            import random

            random.seed(0)
            final = int(len(pointers) / self.cfg.EVAL.DATASET_REDUCTION_FACTOR)
            pointers = random.sample(pointers, final)
        return pointers

    def __len__(self):
        return len(self.data_pointers)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        # The reference skips a corrupt frame and returns a short sequence
        # (dataset.py:217-221). A short sequence changes the batch shape,
        # so instead a bad frame falls back to a neighbouring sample,
        # keeping every batch full-shape.
        for attempt in range(len(self.data_pointers)):
            j = (i + attempt) % len(self.data_pointers)
            run_id, indices = self.data_pointers[j]
            frames = []
            for t in indices:
                try:
                    frames.append(self._load_frame(run_id, t))
                except Exception:
                    print(f"{run_id}, {t} data is invalid")
                    break
            if len(frames) == len(indices):
                batch: Dict[str, np.ndarray] = {}
                for k in frames[0]:
                    batch[k] = np.stack([f[k] for f in frames])
                return batch
        raise RuntimeError("every sequence in the dataset has an invalid frame")

    # ------------------------------------------------------------------
    def _load_frame(self, run_id: str, t: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        cfg = self.cfg
        row = self.data[run_id].iloc[t]
        out: Dict[str, np.ndarray] = {}

        image = np.asarray(
            Image.open(os.path.join(self.dataset_path, run_id, row["image_path"]))
        )
        out["image"] = image  # (H, W, 3) uint8

        route_map = np.asarray(
            Image.open(os.path.join(self.dataset_path, run_id, row["routemap_path"]))
        )
        out["route_map"] = np.broadcast_to(
            route_map[..., None], (*route_map.shape, 3)
        ).copy()

        if cfg.SEMANTIC_SEG.ENABLED:
            birdview_int = np.asarray(
                Image.open(
                    os.path.join(self.dataset_path, run_id, row["birdview_path"])
                )
            )
            h, w = birdview_int.shape
            n_classes = row["n_classes"]
            birdview = integer_to_binary(
                birdview_int.reshape(-1), n_classes
            ).reshape(h, w, n_classes)
            out["birdview"] = birdview
            label = calculate_birdview_labels(
                birdview.transpose(2, 0, 1), n_classes
            )
            out["birdview_label"] = label[..., None].astype(np.int32)
            instance_mask = birdview[..., 3].astype(bool) | birdview[..., 4].astype(bool)
            out["instance_label"] = _label_connected_components(instance_mask)[
                ..., None
            ].astype(np.int32)

        # -- semantic LiDAR ------------------------------------------------
        pcd_semantic = np.load(
            os.path.join(self.dataset_path, run_id, row["points_semantic_path"]),
            allow_pickle=True,
        ).item()
        points = pcd_semantic["points_xyz"].astype(np.float64)
        points = points + np.asarray(cfg.POINTS.LIDAR_POSITION)
        points[:, 1] *= -1
        semantics = self.remap[pcd_semantic["ObjTag"]]

        x, y, z = EGO_VEHICLE_DIMENSION
        ego_box = np.array([[-x / 2, -y / 2, 0], [x / 2, y / 2, z]])
        inside = ((ego_box[0] < points) & (points < ego_box[1])).all(axis=1)
        points, semantics = points[~inside], semantics[~inside]

        if cfg.POINTS.DEVICE_PROJECTION:
            # ship fixed-capacity raw points; projection happens on device
            max_pts = int(cfg.POINTS.N_PER_SECOND / CARLA_FPS)
            fixed = np.zeros((max_pts, 3), np.float32)
            fixed_sem = np.zeros((max_pts,), np.int32)
            n = min(points.shape[0], max_pts)
            fixed[:n] = points[:n]
            fixed_sem[:n] = semantics[:n]
            out["points_raw"] = fixed
            out["points_sem"] = fixed_sem
            out["num_points"] = np.int32(n)
        else:
            rd, rxyz, rsem = self.pcd.project(points, semantics)
            if cfg.MODEL.LIDAR.ENABLED:
                out["range_view_pcd_xyzd"] = np.concatenate(
                    [rxyz, rd[..., None]], axis=-1
                ).astype(np.float32)
            if cfg.LIDAR_SEG.ENABLED:
                out["range_view_pcd_seg"] = rsem[..., None].astype(np.int32)

        if cfg.MODEL.LIDAR.POINT_PILLAR.ENABLED:
            max_pts = int(cfg.POINTS.N_PER_SECOND / CARLA_FPS)
            fixed = np.zeros((max_pts, 3), np.float32)
            n = min(points.shape[0], max_pts)
            fixed[:n] = points[:n]
            out["points_raw"] = fixed
            out["num_points"] = np.int32(n)

        if cfg.VOXEL_SEG.ENABLED:
            voxel_data = np.load(
                os.path.join(self.dataset_path, run_id, row["voxel_path"])
            )
            coords = voxel_data[:, :-1]
            sem = voxel_data[:, -1].copy()
            sem[sem == 255] = 0
            sem = self.remap[sem]
            out["voxel"] = densify_voxels(coords, sem, cfg.VOXEL.SIZE)

        # -- depth + semantic camera --------------------------------------
        if (cfg.SEMANTIC_IMAGE.ENABLED or cfg.DEPTH.ENABLED
                or cfg.LOSSES.RGB_INSTANCE):
            depth_semantic = np.asarray(
                Image.open(
                    os.path.join(self.dataset_path, run_id,
                                 row["depth_semantic_path"])
                )
            )
            semantic_image = depth_semantic[..., -1]
            if cfg.LOSSES.RGB_INSTANCE:
                mask = (semantic_image == 10) | (semantic_image == 4)
                out["image_instance_mask"] = mask[..., None]
            if cfg.SEMANTIC_IMAGE.ENABLED:
                out["semantic_image"] = self.remap[semantic_image][..., None].astype(
                    np.int32
                )
            if cfg.DEPTH.ENABLED:
                depth_color = depth_semantic[..., :-1].astype(float)
                out["depth_color"] = (depth_color / 255.0).astype(np.float32)
                depth = (
                    256 ** 2 * depth_color[..., 0] + 256 * depth_color[..., 1]
                    + depth_color[..., 2]
                ) / (256 ** 3 - 1)
                depth[depth > 0.999] = -1
                out["depth"] = depth[..., None].astype(np.float32)

        throttle, steering, brake = row["action"]
        throttle_brake = throttle if throttle > 0 else -brake
        out["steering"] = np.array([steering], np.float32)
        out["throttle_brake"] = np.array([throttle_brake], np.float32)
        out["speed"] = np.asarray(row["speed"], np.float32).reshape(-1)[:1]
        out["reward"] = np.clip(
            np.array([row["reward"]], np.float32), -1.0, 1.0
        )
        out["value_function"] = np.array([row["value"]], np.float32)
        out["intrinsics"] = self.intrinsics.copy()
        out["extrinsics"] = self.extrinsics.copy()
        return out


class SyntheticDataset:
    """Random data with the CarlaDataset contract (DATAROOT == 'synthetic')."""

    def __init__(self, cfg, sequence_length: int, length: int = 256):
        self.cfg = cfg
        self.sequence_length = sequence_length
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        batch = synthetic_batch(self.cfg, 1, self.sequence_length, seed=i)
        return {k: v[0] for k, v in batch.items()}


def make_dataset(cfg, mode: str, sequence_length: int):
    if cfg.DATASET.DATAROOT == "synthetic":
        return SyntheticDataset(cfg, sequence_length)
    if cfg.DATASET.FRAME_CACHE:
        from muvo_tpu_torch.data.frame_cache import CachedCarlaDataset

        cache_dir = (None if cfg.DATASET.FRAME_CACHE == "auto"
                     else os.path.join(cfg.DATASET.FRAME_CACHE, mode))
        return CachedCarlaDataset(cfg, mode=mode,
                                  sequence_length=sequence_length,
                                  cache_dir=cache_dir)
    return CarlaDataset(cfg, mode=mode, sequence_length=sequence_length)
