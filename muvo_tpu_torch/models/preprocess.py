"""Serving-time batch preprocessing (counterpart of the ``training=False``
part of muvo_tpu/models/preprocess.py's PreProcess).

uint8 images -> /255, the route map resized (nearest) to ROUTE.SIZE, the
camera crop and its intrinsics, the LiDAR range-view scale, then ImageNet
normalisation. Label pyramids and augmentation belong to training and are
not ported here. Layout stays channels-last.
"""

from __future__ import annotations

from typing import Dict

import torch


def _nearest_resize(x, out_h: int, out_w: int):
    """torch-style nearest resize of (..., h, w, c): source index
    floor(i * h / out_h)."""
    h, w = x.shape[-3], x.shape[-2]
    rows = torch.floor(torch.arange(out_h, device=x.device, dtype=torch.float64)
                       * (h / out_h)).long()
    cols = torch.floor(torch.arange(out_w, device=x.device, dtype=torch.float64)
                       * (w / out_w)).long()
    return x.index_select(-3, rows).index_select(-2, cols)


class PreProcess:
    def __init__(self, cfg):
        if cfg.EVAL.RESOLUTION.ENABLED:
            raise NotImplementedError("EVAL.RESOLUTION is not ported")
        self.cfg = cfg
        self.crop = tuple(cfg.IMAGE.CROP)
        self.route_map_size = cfg.ROUTE.SIZE
        self.image_mean = tuple(cfg.IMAGE.IMAGENET_MEAN)
        self.image_std = tuple(cfg.IMAGE.IMAGENET_STD)

    def _normalise(self, x):
        mean = torch.tensor(self.image_mean, device=x.device)
        std = torch.tensor(self.image_std, device=x.device)
        return (x - mean) / std

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict:
        batch = dict(batch)
        left, top, right, bottom = self.crop
        # crop before the float conversion: identical values, fewer bytes
        image = batch["image"][..., top:bottom, left:right, :]
        batch["image"] = self._normalise(image.float() / 255.0)

        if "route_map" in batch:
            rm = batch["route_map"].float() / 255.0
            rm = _nearest_resize(rm, self.route_map_size, self.route_map_size)
            batch["route_map"] = self._normalise(rm)

        if "intrinsics" in batch:
            k = batch["intrinsics"].clone()
            k[..., 0, 2] -= left
            k[..., 1, 2] -= top
            batch["intrinsics"] = k

        if self.cfg.LIDAR_RE.ENABLED and "range_view_pcd_xyzd" in batch:
            batch["range_view_pcd_xyzd"] = (
                batch["range_view_pcd_xyzd"].float() / self.cfg.LIDAR_RE.SCALE)
        return batch
