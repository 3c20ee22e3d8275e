"""Synthetic batches with the CARLA dataset's key set (numpy, channels-last).

An own copy of muvo_tpu/data/synthetic.py: the same seed gives the same
arrays in both packages (a test holds them equal), so a batch made here
feeds either model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from muvo_tpu_torch.constants import CARLA_FPS
from muvo_tpu_torch.geometry.camera import calculate_geometry_from_config


def synthetic_batch(cfg, batch_size: int = 1, sequence_length: int = None,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Random batch with the full key set the model/preprocessor expects."""
    rng = np.random.RandomState(seed)
    b = batch_size
    s = sequence_length or (cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    h, w = cfg.IMAGE.SIZE
    lidar_h, lidar_w = cfg.POINTS.CHANNELS, cfg.POINTS.HORIZON_RESOLUTION

    intrinsics, extrinsics = calculate_geometry_from_config(cfg)

    batch = {
        "image": rng.randint(0, 255, (b, s, h, w, 3), dtype=np.uint8),
        "route_map": rng.randint(0, 255, (b, s, cfg.ROUTE.SIZE * 3,
                                          cfg.ROUTE.SIZE * 3, 3), dtype=np.uint8),
        "speed": rng.uniform(0, 10, (b, s, 1)).astype(np.float32),
        "intrinsics": np.broadcast_to(intrinsics, (b, s, 3, 3)).copy(),
        "extrinsics": np.broadcast_to(extrinsics, (b, s, 4, 4)).copy(),
        "throttle_brake": rng.uniform(-1, 1, (b, s, 1)).astype(np.float32),
        "steering": rng.uniform(-1, 1, (b, s, 1)).astype(np.float32),
        "reward": rng.uniform(-1, 1, (b, s, 1)).astype(np.float32),
        "value_function": rng.uniform(-1, 1, (b, s, 1)).astype(np.float32),
    }

    if cfg.SEMANTIC_SEG.ENABLED:
        n_cls = cfg.SEMANTIC_SEG.N_CHANNELS
        bev_w, bev_h = cfg.BEV.SIZE
        batch["birdview"] = rng.randint(0, 2, (b, s, bev_h, bev_w, n_cls)).astype(
            np.float32
        )
        batch["birdview_label"] = rng.randint(
            0, n_cls, (b, s, bev_h, bev_w, 1), dtype=np.int32
        )
        batch["instance_label"] = rng.randint(
            0, 4, (b, s, bev_h, bev_w, 1), dtype=np.int32
        )

    if cfg.POINTS.DEVICE_PROJECTION:
        n_pts = 4096
        pts = rng.uniform(-40, 40, (b, s, n_pts, 3)).astype(np.float32)
        pts[..., 2] = rng.uniform(0, 6, (b, s, n_pts))
        batch["points_raw"] = pts
        batch["num_points"] = np.full((b, s), n_pts, np.int32)
        batch["points_sem"] = rng.randint(
            0, cfg.LIDAR_SEG.N_CLASSES, (b, s, n_pts), dtype=np.int32
        )
    elif cfg.MODEL.LIDAR.ENABLED or cfg.LIDAR_RE.ENABLED:
        rv = rng.uniform(0, 50, (b, s, lidar_h, lidar_w, 4)).astype(np.float32)
        batch["range_view_pcd_xyzd"] = rv
    if cfg.LIDAR_SEG.ENABLED and not cfg.POINTS.DEVICE_PROJECTION:
        batch["range_view_pcd_seg"] = rng.randint(
            0, cfg.LIDAR_SEG.N_CLASSES, (b, s, lidar_h, lidar_w, 1), dtype=np.int32
        )
    if cfg.MODEL.LIDAR.POINT_PILLAR.ENABLED:
        max_pts = int(cfg.POINTS.N_PER_SECOND / CARLA_FPS)
        batch["points_raw"] = rng.uniform(-40, 40, (b, s, max_pts, 3)).astype(
            np.float32
        )
        batch["num_points"] = np.full((b, s), max_pts // 2, dtype=np.int32)

    if cfg.VOXEL_SEG.ENABLED:
        batch["voxel"] = rng.randint(
            0, cfg.VOXEL_SEG.N_CLASSES, (b, s, *cfg.VOXEL.SIZE), dtype=np.uint8
        )

    if cfg.SEMANTIC_IMAGE.ENABLED:
        batch["semantic_image"] = rng.randint(
            0, cfg.SEMANTIC_IMAGE.N_CLASSES, (b, s, h, w, 1), dtype=np.int32
        )
    if cfg.DEPTH.ENABLED:
        batch["depth"] = rng.uniform(0.5, 60, (b, s, h, w, 1)).astype(np.float32)
    if cfg.MODEL.MEASUREMENTS.ENABLED:
        batch["route_command"] = rng.randint(0, 6, (b, s), dtype=np.int32)
        batch["route_command_next"] = rng.randint(0, 6, (b, s), dtype=np.int32)
        batch["gps_vector"] = rng.uniform(-1, 1, (b, s, 2)).astype(np.float32)
        batch["gps_vector_next"] = rng.uniform(-1, 1, (b, s, 2)).astype(np.float32)
    return batch


def tiny_test_cfg(overrides: Dict = None):
    """A small config for CPU tests: 1/5-scale images, tiny voxel grid."""
    from muvo_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.defrost()
    cfg.IMAGE.SIZE = (96, 160)
    cfg.IMAGE.CROP = [16, 16, 144, 80]  # -> 64 x 128
    cfg.ROUTE.SIZE = 32
    cfg.POINTS.CHANNELS = 64
    cfg.POINTS.HORIZON_RESOLUTION = 128
    cfg.BEV.SIZE = [64, 64]
    cfg.VOXEL.SIZE = [64, 64, 64]
    cfg.MODEL.TRANSFORMER.ENABLED = True
    cfg.MODEL.TRANSFORMER.CHANNELS = 64
    cfg.MODEL.EMBEDDING_DIM = 64
    cfg.MODEL.TRANSITION.HIDDEN_STATE_DIM = 96
    cfg.MODEL.TRANSITION.STATE_DIM = 48
    cfg.MODEL.TRANSITION.ACTION_LATENT_DIM = 16
    cfg.MODEL.SPEED.CHANNELS = 8
    cfg.MODEL.ROUTE.CHANNELS = 8
    cfg.SEMANTIC_SEG.ENABLED = False
    cfg.VOXEL_SEG.ENABLED = True
    cfg.VOXEL_SEG.DIMENSION = 16
    cfg.VOXEL_SEG.N_CLASSES = 2
    cfg.VOXEL_SEG.USE_WEIGHTS = False
    cfg.LIDAR_SEG.ENABLED = False
    cfg.LIDAR_RE.ENABLED = True
    cfg.EVAL.RGB_SUPERVISION = True
    cfg.RECEPTIVE_FIELD = 2
    cfg.FUTURE_HORIZON = 1
    cfg.BATCHSIZE = 1
    if overrides:
        cfg.merge_from_dict(overrides)
    return cfg
