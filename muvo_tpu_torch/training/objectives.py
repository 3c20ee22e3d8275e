"""The training objective: per-head weighted losses (counterpart of
muvo_tpu/training/objectives.py, term for term).

Per-scale (1, 2, 4) losses with 1/k discounts, KL balancing, the BEV
segmentation and instance centre / offset terms, the RGB instance term,
and the MonoScene SemScal / GeoScal terms for voxels. The reward term
keeps muvo_tpu's form, though neither model decodes a reward.
"""

from __future__ import annotations

from typing import Dict

import torch

from muvo_tpu_torch.constants import SEMANTIC_SEG_WEIGHTS, VOXEL_SEG_WEIGHTS
from muvo_tpu_torch.losses import (
    kl_loss,
    regression_loss,
    segmentation_loss,
    spatial_regression_loss,
    ssim,
    voxel_losses_fused,
)


def _weights(table, enabled: bool, device):
    return (torch.as_tensor(table, dtype=torch.float32, device=device)
            if enabled else None)


def _same_size(output: Dict, batch: Dict, key: str, label: str):
    """Raises where an output and its label differ in size. The decoders
    size their outputs from IMAGE.CROP; EVAL.RESOLUTION resizes the image
    labels only, so with it the RGB loss cannot compare them (muvo_tpu's
    loss fails at the same term)."""
    got, want = output[key].shape[2:4], batch[label].shape[2:4]
    if got != want:
        raise ValueError(
            f"{key} is {tuple(got)} (from IMAGE.CROP) but {label} is "
            f"{tuple(want)}: EVAL.RESOLUTION resizes the labels, not the "
            f"decoders, so this loss cannot be taken")


def compute_loss(cfg, batch: Dict, output: Dict) -> Dict[str, torch.Tensor]:
    losses: Dict[str, torch.Tensor] = {}
    action_weight = cfg.LOSSES.WEIGHT_ACTION
    device = batch["image"].device

    if "throttle_brake" in output:
        losses["throttle_brake"] = action_weight * regression_loss(
            output["throttle_brake"], batch["throttle_brake"], norm=1)
    if "steering" in output:
        losses["steering"] = action_weight * regression_loss(
            output["steering"], batch["steering"], norm=1)

    # a one-step sequence (the RECEPTIVE_FIELD 1 observation of an eval
    # step) has no KL term: upstream's first step reads t=1's sigma, which
    # it lacks (upstream and muvo_tpu give NaN there)
    if (cfg.MODEL.TRANSITION.ENABLED and "prior" in output
            and "posterior" in output
            and output["posterior"]["mu"].shape[1] > 1):
        losses["probabilistic"] = cfg.LOSSES.WEIGHT_PROBABILISTIC * kl_loss(
            output["prior"], output["posterior"],
            alpha=cfg.LOSSES.KL_BALANCING_ALPHA)

    if cfg.SEMANTIC_SEG.ENABLED:
        weights = _weights(SEMANTIC_SEG_WEIGHTS, cfg.SEMANTIC_SEG.USE_WEIGHTS,
                           device)
        for k in (1, 2, 4):
            discount = 1.0 / k
            seg = segmentation_loss(
                output[f"bev_segmentation_{k}"],
                batch[f"birdview_label_{k}"][..., 0],
                use_top_k=cfg.SEMANTIC_SEG.USE_TOP_K,
                top_k_ratio=cfg.SEMANTIC_SEG.TOP_K_RATIO, weights=weights)
            losses[f"bev_segmentation_{k}"] = (
                discount * cfg.LOSSES.WEIGHT_SEGMENTATION * seg)
            center = spatial_regression_loss(
                output[f"bev_instance_center_{k}"],
                batch[f"center_label_{k}"], norm=2)
            offset = spatial_regression_loss(
                output[f"bev_instance_offset_{k}"],
                batch[f"offset_label_{k}"], norm=1,
                ignore_index=cfg.INSTANCE_SEG.IGNORE_INDEX)
            center = cfg.INSTANCE_SEG.CENTER_LOSS_WEIGHT * center
            offset = cfg.INSTANCE_SEG.OFFSET_LOSS_WEIGHT * offset
            losses[f"bev_center_{k}"] = (
                discount * cfg.LOSSES.WEIGHT_INSTANCE * center)
            # offsets are already discounted in the labels
            losses[f"bev_offset_{k}"] = cfg.LOSSES.WEIGHT_INSTANCE * offset

    if cfg.EVAL.RGB_SUPERVISION:
        rgb_weight = 0.1
        for k in (1, 2, 4):
            discount = 1.0 / k
            _same_size(output, batch, f"rgb_{k}", f"rgb_label_{k}")
            rgb = spatial_regression_loss(output[f"rgb_{k}"],
                                          batch[f"rgb_label_{k}"], norm=1)
            rgb_instance = 0.0
            if cfg.LOSSES.RGB_INSTANCE:
                rgb_instance = spatial_regression_loss(
                    output[f"rgb_{k}"], batch[f"rgb_label_{k}"], norm=1,
                    instance_mask=batch[f"image_instance_mask_{k}"])
            if cfg.LOSSES.SSIM:
                ssim_loss = 1 - ssim(output[f"rgb_{k}"],
                                     batch[f"rgb_label_{k}"], channel=3)
                losses[f"ssim_{k}"] = rgb_weight * discount * ssim_loss * 0.6
            losses[f"rgb_{k}"] = rgb_weight * discount * (
                rgb + 0.5 * rgb_instance)

    if cfg.LIDAR_RE.ENABLED:
        for k in (1, 2, 4):
            discount = 1.0 / k
            out = output[f"lidar_reconstruction_{k}"]
            label = batch[f"range_view_label_{k}"]
            re = spatial_regression_loss(out[..., :3], label[..., :3], norm=2)
            depth = spatial_regression_loss(out[..., -1:], label[..., -1:],
                                            norm=1)
            losses[f"lidar_re_{k}"] = re * discount * cfg.LOSSES.WEIGHT_LIDAR_RE
            losses[f"lidar_depth_{k}"] = (
                depth * discount * cfg.LOSSES.WEIGHT_LIDAR_RE)

    if cfg.LIDAR_SEG.ENABLED:
        weights = _weights(VOXEL_SEG_WEIGHTS, cfg.LIDAR_SEG.USE_WEIGHTS,
                           device)
        for k in (1, 2, 4):
            seg = segmentation_loss(
                output[f"lidar_segmentation_{k}"],
                batch[f"range_view_seg_label_{k}"][..., 0],
                use_top_k=cfg.LIDAR_SEG.USE_TOP_K,
                top_k_ratio=cfg.LIDAR_SEG.TOP_K_RATIO, weights=weights)
            losses[f"lidar_seg_{k}"] = (
                seg / k * cfg.LOSSES.WEIGHT_LIDAR_SEG)

    if cfg.SEMANTIC_IMAGE.ENABLED:
        weights = _weights(VOXEL_SEG_WEIGHTS, cfg.SEMANTIC_IMAGE.USE_WEIGHTS,
                           device)
        for k in (1, 2, 4):
            seg = segmentation_loss(
                output[f"semantic_image_{k}"],
                batch[f"semantic_image_label_{k}"][..., 0],
                use_top_k=cfg.SEMANTIC_IMAGE.USE_TOP_K,
                top_k_ratio=cfg.SEMANTIC_IMAGE.TOP_K_RATIO, weights=weights)
            losses[f"semantic_image_{k}"] = (
                seg / k * cfg.LOSSES.WEIGHT_SEM_IMAGE)

    if cfg.DEPTH.ENABLED:
        for k in (1, 2, 4):
            d = spatial_regression_loss(output[f"depth_{k}"],
                                        batch[f"depth_label_{k}"], norm=1)
            losses[f"depth_{k}"] = d / k * cfg.LOSSES.WEIGHT_DEPTH

    if cfg.VOXEL_SEG.ENABLED:
        weights = _weights(VOXEL_SEG_WEIGHTS, cfg.VOXEL_SEG.USE_WEIGHTS,
                           device)
        for k in (1, 2, 4):
            discount = 1.0 / k
            vox, semscal, geoscal = voxel_losses_fused(
                output[f"voxel_{k}"], batch[f"voxel_label_{k}"],
                use_top_k=cfg.VOXEL_SEG.USE_TOP_K,
                top_k_ratio=cfg.VOXEL_SEG.TOP_K_RATIO, weights=weights)
            w = discount * cfg.LOSSES.WEIGHT_VOXEL
            losses[f"voxel_{k}"] = w * vox
            losses[f"sem_scal_{k}"] = w * semscal
            losses[f"geo_scal_{k}"] = w * geoscal

    if cfg.MODEL.REWARD.ENABLED:
        losses["reward"] = cfg.LOSSES.WEIGHT_REWARD * regression_loss(
            output["reward"], batch["reward"], norm=1)
    return losses


def reduce_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(losses.values())
