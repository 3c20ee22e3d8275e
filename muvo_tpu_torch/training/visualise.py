"""TensorBoard visualisation of reconstructions and imaginations
(counterpart of muvo_tpu/training/visualise.py).

Counterpart of the reference trainer's visualise hooks
(muvo/trainer.py:569-966): GT-vs-prediction sequence strips with the
receptive-field / future-horizon separator for RGB (plus acc/steer bars),
BEV segmentation, LiDAR range view, point-cloud top-down (pcd_xy) and
ICP-derived trajectories, optical-flow panels, route-map input strip,
matplotlib 3-D voxel renders, and frame stacks for the lidar/depth videos.

The panels in PANEL_PACKAGES draw with an optional package (OpenCV or
matplotlib, imported where they draw). Where ``importlib.util.find_spec``
finds no such package, ``visualise_step`` does not draw those panels
(``undrawable_panels`` names them); a panel that it draws and that fails
raises.
"""

from __future__ import annotations

import importlib.util
from typing import Dict, List, Optional

import numpy as np
import torch

from muvo_tpu_torch.visualisation import (
    action_bar,
    convert_bev_to_image,
    denormalise_image,
    optical_flow_image,
    pcd_xy_image,
    range_view_to_image,
    sequence_strip,
    trajectory_plot,
    voxel_figure_image,
    voxel_to_bev_image,
)


PANEL_PACKAGES = {"rgb": "cv2", "flow": "cv2", "trajectory": "cv2",
                  "voxel_3d": "matplotlib", "voxel_3d_imagine": "matplotlib"}


def undrawable_panels() -> List[str]:
    """The panels whose package (PANEL_PACKAGES) is not installed."""
    return sorted(name for name, package in PANEL_PACKAGES.items()
                  if importlib.util.find_spec(package) is None)


def _to_np(tree):
    """Every tensor of a (nested) dict as a numpy array on the host."""
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _cat_time(output, imagine, key, max_frames):
    """Concatenate reconstruction + imagination along time, capped."""
    seq = output[key]
    if imagine is not None and key in imagine:
        seq = np.concatenate([seq, imagine[key]], axis=1)
    return seq[:, :max_frames]


def _points_from_range_view(rv_frame: np.ndarray, scale: float,
                            max_points: int = 600) -> np.ndarray:
    """(h, w, 4) xyz+d range view -> (N, 3) valid points (subsampled)."""
    xyz = rv_frame[..., :3].reshape(-1, 3) * scale
    depth = rv_frame[..., 3].reshape(-1) * scale
    pts = xyz[depth > 0.1]
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points + 1]
    return pts


def visualise_step(cfg, batch: Dict, output: Dict,
                   output_imagine: Optional[Dict] = None,
                   max_frames: int = 8) -> Dict[str, np.ndarray]:
    """Returns {panel_name: (H, W, 3) uint8 image | (T, H, W, 3) video}.

    batch/output: preprocessed batch + model output; sample 0 is rendered.
    Video-valued panels carry a 'video/' name prefix for the logger.
    """
    batch = _to_np(batch)
    output = _to_np(output)
    imagine = _to_np(output_imagine) if output_imagine else None
    frames = next(v for v in output.values() if isinstance(v, np.ndarray))
    rf = min(cfg.RECEPTIVE_FIELD, frames.shape[1])
    panels: Dict[str, np.ndarray] = {}
    skip = set(undrawable_panels())

    def gt_frame(key, t):
        # labels cover the full sequence; reconstruction covers rf frames
        return batch[key][0, t]

    def seq_of(key_out, key_in, render):
        pred_seq = _cat_time(output, imagine, key_out, max_frames)[0]
        s = pred_seq.shape[0]
        gt = sequence_strip([render(gt_frame(key_in, t), True)
                             for t in range(s)], rf)
        pred = sequence_strip([render(pred_seq[t], False)
                               for t in range(s)], rf)
        return np.concatenate([gt, pred], axis=0), pred_seq, s

    # ---- RGB: acc/steer bars + target + prediction strips ----------------
    if (cfg.EVAL.RGB_SUPERVISION and "rgb_1" in output
            and "rgb" not in skip):
        def render_rgb(img, is_gt):
            if is_gt:
                return denormalise_image(img, cfg.IMAGE.IMAGENET_MEAN,
                                         cfg.IMAGE.IMAGENET_STD)
            return (np.clip(img, 0, 1) * 255).astype(np.uint8)

        pred_seq = _cat_time(output, imagine, "rgb_1", max_frames)[0]
        s = pred_seq.shape[0]
        w = pred_seq.shape[2]
        tiles = []
        for t in range(s):
            acc = float(batch["throttle_brake"][0, t, 0])
            steer = float(batch["steering"][0, t, 0])
            tiles.append(np.concatenate([
                action_bar(w, acc),  # green/red throttle-brake
                action_bar(w, steer, positive_colour=(0, 0, 200),
                           negative_colour=(0, 0, 200)),  # blue steer
                render_rgb(gt_frame("rgb_label_1", t), True),
                render_rgb(pred_seq[t], False),
            ], axis=0))
        panels["rgb"] = sequence_strip(tiles, rf)

        # optical-flow panels (reference trainer.py:723-753)
        gt_imgs = [render_rgb(gt_frame("rgb_label_1", t), True)
                   for t in range(s)]
        pred_imgs = [render_rgb(pred_seq[t], False) for t in range(s)]
        if s >= 2:
            flow_gt = [optical_flow_image(gt_imgs[t - 1], gt_imgs[t])
                       for t in range(1, s)]
            flow_pred = [optical_flow_image(pred_imgs[t - 1], pred_imgs[t])
                         for t in range(1, s)]
            panels["flow"] = np.concatenate(
                [sequence_strip(flow_gt, rf - 1),
                 sequence_strip(flow_pred, rf - 1)], axis=0)

    # ---- BEV segmentation -------------------------------------------------
    if cfg.SEMANTIC_SEG.ENABLED and "bev_segmentation_1" in output:
        def render_bev(x, is_gt):
            label = x[..., 0] if is_gt else np.argmax(x, axis=-1)
            return convert_bev_to_image(label)

        panels["bev"], _, _ = seq_of("bev_segmentation_1",
                                     "birdview_label_1", render_bev)

    # ---- LiDAR range view + pcd_xy + ICP trajectory -----------------------
    if cfg.LIDAR_RE.ENABLED and "lidar_reconstruction_1" in output:
        scale = cfg.LIDAR_RE.SCALE

        def render_range(x, is_gt):
            return range_view_to_image(x[..., -1] * scale)

        strip, pred_seq, s = seq_of("lidar_reconstruction_1",
                                    "range_view_label_1", render_range)
        panels["range_view"] = strip
        # video: target over prediction per frame (reference add_video fps=2)
        frames = [np.concatenate([render_range(gt_frame(
            "range_view_label_1", t), True), render_range(pred_seq[t], False)],
            axis=0) for t in range(s)]
        panels["video/lidar"] = np.stack(frames)

        # top-down point-cloud projection strip
        gt_pts = [_points_from_range_view(gt_frame("range_view_label_1", t),
                                          scale) for t in range(s)]
        pred_pts = [_points_from_range_view(pred_seq[t], scale)
                    for t in range(s)]
        panels["pcd_xy"] = np.concatenate(
            [sequence_strip([pcd_xy_image(p) for p in gt_pts], rf),
             sequence_strip([pcd_xy_image(p) for p in pred_pts], rf)],
            axis=0)

        # ICP ego-trajectory from consecutive clouds (reference :810-842)
        if s >= 2 and "trajectory" not in skip:
            from muvo_tpu_torch.geometry.icp import compute_pcd_transformation

            def icp_track(point_seq: List[np.ndarray]) -> np.ndarray:
                rt = {"Rot": np.eye(3), "pos": np.zeros((3, 1))}
                positions = [rt["pos"][:, 0].copy()]
                for t in range(1, len(point_seq)):
                    if len(point_seq[t - 1]) < 8 or len(point_seq[t]) < 8:
                        positions.append(positions[-1])
                        continue
                    _, rt = compute_pcd_transformation(
                        point_seq[t - 1], point_seq[t], rt, threshold=5)
                    positions.append(rt["pos"][:, 0].copy())
                return np.asarray(positions)

            traj_gt = trajectory_plot(icp_track(gt_pts))
            traj_pred = trajectory_plot(icp_track(pred_pts))
            panels["trajectory"] = np.concatenate([traj_gt, traj_pred],
                                                  axis=1)

    # ---- LiDAR semantic segmentation --------------------------------------
    if cfg.LIDAR_SEG.ENABLED and "lidar_segmentation_1" in output:
        from muvo_tpu_torch.constants import VOXEL_COLOURS

        def render_lseg(x, is_gt):
            label = x[..., 0] if is_gt else np.argmax(x, axis=-1)
            return convert_bev_to_image(label, VOXEL_COLOURS)

        panels["lidar_seg"], _, _ = seq_of("lidar_segmentation_1",
                                           "range_view_seg_label_1",
                                           render_lseg)

    # ---- semantic image ----------------------------------------------------
    if cfg.SEMANTIC_IMAGE.ENABLED and "semantic_image_1" in output:
        from muvo_tpu_torch.constants import VOXEL_COLOURS

        def render_sem(x, is_gt):
            label = x[..., 0] if is_gt else np.argmax(x, axis=-1)
            return convert_bev_to_image(label, VOXEL_COLOURS)

        panels["sem_image"], _, _ = seq_of("semantic_image_1",
                                           "semantic_image_label_1",
                                           render_sem)

    # ---- depth video -------------------------------------------------------
    if cfg.DEPTH.ENABLED and "depth_1" in output:
        def render_depth(x):
            d = (np.clip(x[..., 0], 0, 1) * 255).astype(np.uint8)
            return np.stack([d] * 3, axis=-1)

        pred_seq = _cat_time(output, imagine, "depth_1", max_frames)[0]
        frames = [np.concatenate([render_depth(gt_frame("depth_label_1", t)),
                                  render_depth(pred_seq[t])], axis=0)
                  for t in range(pred_seq.shape[0])]
        panels["video/depth"] = np.stack(frames)

    # ---- voxels: top-down strip + matplotlib 3-D renders -------------------
    if cfg.VOXEL_SEG.ENABLED and "voxel_1" in output:
        def render_voxel(x, is_gt):
            vox = x if is_gt else np.argmax(x, axis=-1)
            if vox.ndim == 4:  # (X, Y, Z, 1) labels
                vox = vox[..., 0]
            return voxel_to_bev_image(vox.astype(np.int64))

        panels["voxel_topdown"], _, _ = seq_of("voxel_1", "voxel_label_1",
                                               render_voxel)
        if "voxel_3d" not in skip:
            gt_vox = batch["voxel_label_1"][0, 0]
            if gt_vox.ndim == 4:
                gt_vox = gt_vox[..., 0]
            pred_vox = np.argmax(output["voxel_1"][0, 0], axis=-1)
            panels["voxel_3d"] = np.concatenate(
                [voxel_figure_image(gt_vox.astype(np.int64)),
                 voxel_figure_image(pred_vox.astype(np.int64))], axis=1)
        if (imagine is not None and "voxel_1" in imagine
                and "voxel_3d_imagine" not in skip):
            gt_im = batch["voxel_label_1"][0, min(
                rf, batch["voxel_label_1"].shape[1] - 1)]
            if gt_im.ndim == 4:
                gt_im = gt_im[..., 0]
            pred_im = np.argmax(imagine["voxel_1"][0, 0], axis=-1)
            panels["voxel_3d_imagine"] = np.concatenate(
                [voxel_figure_image(gt_im.astype(np.int64)),
                 voxel_figure_image(pred_im.astype(np.int64))], axis=1)

    # ---- input route map (reference :944-957) ------------------------------
    if cfg.MODEL.ROUTE.ENABLED and "route_map" in batch:
        s = min(batch["route_map"].shape[1], max_frames)

        def render_route(x):
            img = x
            if img.ndim == 3 and img.shape[-1] == 3:
                lo, hi = float(img.min()), float(img.max())
                img = (img - lo) / max(hi - lo, 1e-6)
                return (img * 255).astype(np.uint8)
            return (np.clip(img, 0, 1) * 255).astype(np.uint8)

        panels["input_route_map"] = sequence_strip(
            [render_route(batch["route_map"][0, t]) for t in range(s)], rf)

    return panels
