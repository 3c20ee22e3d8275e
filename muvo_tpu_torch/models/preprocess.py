"""Batch preprocessing on the device (counterpart of
muvo_tpu/models/preprocess.py's PreProcess).

uint8 images -> /255, the route map resized (nearest) to ROUTE.SIZE, the
camera crop and its intrinsics, the label pyramids, in training the pixel
and route augmentation, then ImageNet normalisation, in muvo_tpu's order.
Layout stays channels-last.

Label pyramids: ``rgb_label_{1,2,4}`` and ``depth_label_{1,2,4}`` (the
cropped image in [0, 1] and the cropped depth, downsampled with
jax.image.resize's antialiased linear weights, which are built here per
axis: a 2x step weighs four input pixels 1/8, 3/8, 3/8, 1/8);
``birdview_label_*`` and ``instance_label_*`` (out-of-view pixels zeroed
under EVAL.MASK_VIEW, rotated 90 degrees clockwise as frustum pooling
lays BEV out, nearest) with the instances' ``center_label_*`` and
``offset_label_*``; ``semantic_image_label_*``, ``image_instance_mask_*``,
``range_view_label_*`` and ``range_view_seg_label_*`` (nearest); and
``voxel_label_{1,2,4}`` (strided slices); ``depth_mask`` marks the depths
inside BEV.FRUSTUM_POOL.D_BOUND.

EVAL.RESOLUTION resizes the cropped ``image``, ``image_instance_mask`` and
``semantic_image`` by 1 / FACTOR with the same linear weights, in float32
as muvo_tpu's resize returns its integer and boolean keys too, and scales
the intrinsics' first two rows; ``depth`` keeps the crop's size, and so
do the decoders' outputs (their sizes come from IMAGE.CROP).
POINTS.DEVICE_PROJECTION builds ``range_view_pcd_xyzd`` (and with
LIDAR_SEG ``range_view_pcd_seg``) here from the padded raw points
(``points_raw``, ``num_points``, ``points_sem``) with
``RangeProjector.project_torch``, before the LIDAR_RE.SCALE division and
the label pyramids, also when no labels are asked for.

Augmentation draws every random number from an explicit torch.Generator
(torch and JAX streams differ, so the tests compare the helpers with fixed
parameters). As in muvo_tpu, the colour-jitter order is fixed (brightness,
contrast, saturation, hue).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from muvo_tpu_torch.geometry.camera import get_out_of_view_mask
from muvo_tpu_torch.geometry.range_view import RangeProjector
from muvo_tpu_torch.utils.instance import center_offset_labels


# ---------------------------------------------------------------------------
# resizing
# ---------------------------------------------------------------------------
def _nearest_resize(x, out_h: int, out_w: int):
    """torch-style nearest resize of (..., h, w, c): source index
    floor(i * h / out_h); a strided slice for integer factors."""
    h, w = x.shape[-3], x.shape[-2]
    if h % out_h == 0 and w % out_w == 0:
        return x[..., ::h // out_h, ::w // out_w, :]
    rows = torch.floor(torch.arange(out_h, device=x.device, dtype=torch.float64)
                       * (h / out_h)).long()
    cols = torch.floor(torch.arange(out_w, device=x.device, dtype=torch.float64)
                       * (w / out_w)).long()
    return x.index_select(-3, rows).index_select(-2, cols)


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of jax.image.resize(method="linear") along one
    axis: a triangle kernel widened by in/out when downsampling
    (antialiased), half-pixel centres, each row normalised."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - dist)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0.0).T.astype(np.float32)


def _bilinear_resize(x, out_h: int, out_w: int):
    """jax.image.resize(linear) of (..., h, w, c) as two per-axis products."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    ah = torch.from_numpy(linear_resize_matrix(h, out_h)).to(x.device, x.dtype)
    aw = torch.from_numpy(linear_resize_matrix(w, out_w)).to(x.device, x.dtype)
    y = torch.einsum("oh,...hwc->...owc", ah, x)
    return torch.einsum("pw,...owc->...opc", aw, y)


def _pyramid(batch, key_in: str, key_out: str):
    """{key_out}_1/2/4 nearest-downsampled label pyramids."""
    batch[f"{key_out}_1"] = batch[key_in]
    h, w = batch[key_in].shape[-3], batch[key_in].shape[-2]
    for k in (2, 4):
        batch[f"{key_out}_{k}"] = _nearest_resize(batch[f"{key_out}_{k // 2}"],
                                                  h // k, w // k)
    return batch


# ---------------------------------------------------------------------------
# image ops (one frame, (h, w, c) in [0, 1])
# ---------------------------------------------------------------------------
def _reflect_pad(img, half: int, axis: int):
    n = img.shape[axis]
    idx = torch.cat([torch.arange(half, 0, -1), torch.arange(n),
                     torch.arange(n - 2, n - 2 - half, -1)]).to(img.device)
    return img.index_select(axis, idx)


def _conv1d(im, kern, axis: int):
    """Valid-mode 1-D convolution along ``axis`` via shifted slices."""
    window = kern.shape[0]
    out_len = im.shape[axis] - window + 1
    acc = None
    for t in range(window):
        term = im.narrow(axis, t, out_len) * kern[t]
        acc = term if acc is None else acc + term
    return acc


def _gaussian_blur(img, window: int, std):
    """Separable gaussian blur with reflect padding."""
    half = window // 2
    x = torch.arange(window, dtype=torch.float32, device=img.device) - half
    kern = torch.exp(-(x ** 2) / (2 * std ** 2))
    kern = kern / kern.sum()
    img = _conv1d(_reflect_pad(img, half, 0), kern, 0)
    return _conv1d(_reflect_pad(img, half, 1), kern, 1)


def _adjust_sharpness(img, factor):
    """torchvision adjust_sharpness: blend with a fixed 3x3 smoothing; the
    border rows and columns keep the original."""
    kern = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                        device=img.device) / 13.0
    padded = torch.cat([img[:1], img, img[-1:]], dim=0)
    padded = torch.cat([padded[:, :1], padded, padded[:, -1:]], dim=1)
    h, w = img.shape[:2]
    smoothed = sum(padded[i:i + h, j:j + w] * kern[i, j]
                   for i in range(3) for j in range(3))
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    border = (rows == 0) | (rows == h - 1) | (cols == 0) | (cols == w - 1)
    smoothed = torch.where(border[..., None], img, smoothed)
    return torch.clamp(img + (factor - 1.0) * (img - smoothed), 0.0, 1.0)


def _rgb_to_grayscale(img):
    w = torch.tensor([0.299, 0.587, 0.114], device=img.device)
    return (img * w).sum(-1, keepdim=True)


def _adjust_hue(img, hue_factor):
    """Rotate hue by hue_factor (a fraction of a turn) in YIQ space."""
    yiq = np.array([[0.299, 0.587, 0.114],
                    [0.5959, -0.2746, -0.3213],
                    [0.2115, -0.5227, 0.3112]])
    rgb_from_yiq = torch.from_numpy(np.linalg.inv(yiq)).float().to(img.device)
    yiq = torch.from_numpy(yiq).float().to(img.device)
    theta = 2 * math.pi * torch.as_tensor(hue_factor, dtype=torch.float32,
                                          device=img.device)
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, c, -s]),
                       torch.stack([zero, s, c])])
    m = rgb_from_yiq @ rot @ yiq
    return torch.clamp(torch.einsum("hwc,dc->hwd", img, m), 0, 1)


def _color_jitter(img, fb, fc, fs, fh, apply):
    """Brightness, contrast, saturation and hue with the given factors,
    applied where ``apply`` is true (muvo_tpu's _color_jitter, factors
    drawn by the caller)."""
    out = torch.clamp(img * fb, 0, 1)
    gray_mean = _rgb_to_grayscale(out).mean()
    out = torch.clamp(gray_mean + fc * (out - gray_mean), 0, 1)
    gray = _rgb_to_grayscale(out)
    out = torch.clamp(gray + fs * (out - gray), 0, 1)
    out = _adjust_hue(out, fh)
    return torch.where(apply, out, img)


def _affine(maps, angle, tx, ty, sc, shx):
    """Rotation (radians), translation (pixels), scale and shear (radians)
    of (s, h, w, c) maps about the centre: each output pixel samples the
    input bilinearly at the inverse transform, zero outside
    (map_coordinates order 1, mode constant)."""
    h, w = maps.shape[1:3]
    cos, sin = torch.cos(angle), torch.sin(angle)
    a = cos / sc
    b = (sin + shx * cos) / sc
    cx, cy = w / 2.0, h / 2.0
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=maps.device),
        torch.arange(w, dtype=torch.float32, device=maps.device),
        indexing="ij")
    x0 = xs - cx - tx
    y0 = ys - cy - ty
    src_x = a * x0 + b * y0 + cx
    src_y = -sin / sc * x0 + cos / sc * y0 + cy
    y_lo, x_lo = torch.floor(src_y), torch.floor(src_x)
    out = torch.zeros_like(maps)
    for yi, wy in ((y_lo, 1 - (src_y - y_lo)), (y_lo + 1, src_y - y_lo)):
        for xi, wx in ((x_lo, 1 - (src_x - x_lo)), (x_lo + 1, src_x - x_lo)):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            yc = yi.clamp(0, h - 1).long()
            xc = xi.clamp(0, w - 1).long()
            val = maps[:, yc, xc]
            out = out + (wy * wx)[None, ..., None] * torch.where(
                valid[None, ..., None], val, torch.zeros_like(val))
    return out


def _uniform(generator, device, low, high, shape=()):
    u = torch.rand(shape, generator=generator, device=device)
    return low + (high - low) * u


# ---------------------------------------------------------------------------
class PreProcess:
    def __init__(self, cfg):
        self.cfg = cfg
        self.crop = tuple(cfg.IMAGE.CROP)
        self.route_map_size = cfg.ROUTE.SIZE
        self.center_sigma = cfg.INSTANCE_SEG.CENTER_LABEL_SIGMA_PX
        self.ignore_index = cfg.INSTANCE_SEG.IGNORE_INDEX
        self.min_depth, self.max_depth = cfg.BEV.FRUSTUM_POOL.D_BOUND[:2]
        self.image_mean = tuple(cfg.IMAGE.IMAGENET_MEAN)
        self.image_std = tuple(cfg.IMAGE.IMAGENET_STD)
        self.bev_out_of_view_mask = (
            torch.from_numpy(get_out_of_view_mask(cfg)) if cfg.EVAL.MASK_VIEW
            else None)
        self.scale = (1.0 / cfg.EVAL.RESOLUTION.FACTOR
                      if cfg.EVAL.RESOLUTION.ENABLED else None)
        points = cfg.POINTS
        self.range_projector = (
            RangeProjector(points.CHANNELS, points.HORIZON_RESOLUTION,
                           points.FOV[0], points.FOV[1],
                           points.LIDAR_POSITION)
            if points.DEVICE_PROJECTION else None)

    def _normalise(self, x):
        mean = torch.tensor(self.image_mean, device=x.device)
        std = torch.tensor(self.image_std, device=x.device)
        return (x - mean) / std

    def __call__(self, batch: Dict[str, torch.Tensor], training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 labels: bool = True) -> Dict:
        """``labels=False`` skips the label pyramids (serving needs none);
        ``training`` with a ``generator`` augments."""
        batch = dict(batch)
        left, top, right, bottom = self.crop
        # crop before the float conversion: identical values, fewer bytes
        for key in ("image", "depth", "depth_color", "semantic_image",
                    "image_instance_mask"):
            if key in batch:
                batch[key] = batch[key][..., top:bottom, left:right, :]
        batch["image"] = batch["image"].float() / 255.0

        if "route_map" in batch:
            rm = batch["route_map"].float() / 255.0
            batch["route_map"] = _nearest_resize(rm, self.route_map_size,
                                                 self.route_map_size)

        if "intrinsics" in batch:
            k = batch["intrinsics"].clone()
            k[..., 0, 2] -= left
            k[..., 1, 2] -= top
            batch["intrinsics"] = k
        if self.scale is not None:
            batch = self._rescale(batch, self.scale)

        if (self.range_projector is not None
                and "range_view_pcd_xyzd" not in batch
                and "points_raw" in batch):
            batch = self._device_range_projection(batch)
        if self.cfg.LIDAR_RE.ENABLED and "range_view_pcd_xyzd" in batch:
            batch["range_view_pcd_xyzd"] = (
                batch["range_view_pcd_xyzd"].float() / self.cfg.LIDAR_RE.SCALE)

        if labels:
            batch = self.prepare_labels(batch)
        if training and generator is not None:
            batch = self.augmentation(batch, generator)

        batch["image"] = self._normalise(batch["image"])
        if "route_map" in batch:
            batch["route_map"] = self._normalise(batch["route_map"])
        if "depth" in batch:
            batch["depth_mask"] = ((batch["depth"] > self.min_depth)
                                   & (batch["depth"] < self.max_depth))
        return batch

    def _rescale(self, batch, scale: float):
        """The cropped image and its per-pixel labels resized by ``scale``
        (linear weights, in float32: muvo_tpu's resize of an integer or
        boolean key is float32 too), the intrinsics' first two rows
        scaled."""
        h, w = batch["image"].shape[-3], batch["image"].shape[-2]
        h1, w1 = int(round(h * scale)), int(round(w * scale))
        for key in ("image", "image_instance_mask", "semantic_image"):
            if key in batch:
                batch[key] = _bilinear_resize(batch[key].float(), h1, w1)
        if "intrinsics" in batch:
            k = batch["intrinsics"].clone()
            k[..., :2, :] *= scale
            batch["intrinsics"] = k
        return batch

    def _device_range_projection(self, batch):
        """The range view (b, s, H, W, 4: x, y, z, depth) and, with
        LIDAR_SEG, its semantics (b, s, H, W, 1) from the padded raw points
        points_raw (b, s, P, 3), num_points (b, s) and points_sem (b, s,
        P; zeros where absent), every frame in one projection."""
        proj = self.range_projector
        pts = batch["points_raw"]
        b, s, p, _ = pts.shape
        num = batch["num_points"].reshape(b * s)
        sems = batch.get("points_sem")
        sems = (sems.reshape(b * s, p) if sems is not None
                else torch.zeros((b * s, p), dtype=torch.int32,
                                 device=pts.device))
        valid = torch.arange(p, device=pts.device)[None, :] < num[:, None]
        depth, xyz, sem = proj.project_torch(pts.reshape(b * s, p, 3), sems,
                                             valid)
        batch["range_view_pcd_xyzd"] = torch.cat(
            [xyz, depth[..., None]], dim=-1).reshape(b, s, proj.h, proj.w, 4)
        if self.cfg.LIDAR_SEG.ENABLED:
            batch["range_view_pcd_seg"] = sem.reshape(
                b, s, proj.h, proj.w)[..., None]
        return batch

    # ------------------------------------------------------------------
    def _bev(self, label):
        """A BEV label (..., h, w, 1): out-of-view pixels zeroed under
        EVAL.MASK_VIEW, then rotated 90 degrees clockwise over (h, w), as
        frustum pooling lays out its BEV."""
        if self.bev_out_of_view_mask is not None:
            mask = self.bev_out_of_view_mask.to(label.device)[..., None]
            label = torch.where(mask, torch.zeros_like(label), label)
        return torch.rot90(label, k=-1, dims=(-3, -2))

    def prepare_labels(self, batch):
        cfg = self.cfg
        if "birdview_label" in batch:
            batch["birdview_label"] = self._bev(batch["birdview_label"])
            batch = _pyramid(batch, "birdview_label", "birdview_label")

        if "instance_label" in batch:
            batch["instance_label"] = self._bev(batch["instance_label"])
            batch = _pyramid(batch, "instance_label", "instance_label")
            for k in (1, 2, 4):
                center, offset = center_offset_labels(
                    batch[f"instance_label_{k}"][..., 0],
                    sigma=self.center_sigma / k,
                    ignore_index=self.ignore_index)
                batch[f"center_label_{k}"] = center
                batch[f"offset_label_{k}"] = offset
            batch["center_label"] = batch["center_label_1"]
            batch["offset_label"] = batch["offset_label_1"]

        if cfg.EVAL.RGB_SUPERVISION:
            batch["rgb_label_1"] = batch["image"]
            h, w = batch["image"].shape[-3], batch["image"].shape[-2]
            for k in (2, 4):
                batch[f"rgb_label_{k}"] = _bilinear_resize(
                    batch[f"rgb_label_{k // 2}"], h // k, w // k)
            if cfg.LOSSES.RGB_INSTANCE and "image_instance_mask" in batch:
                batch = _pyramid(batch, "image_instance_mask",
                                 "image_instance_mask")

        if cfg.SEMANTIC_IMAGE.ENABLED and "semantic_image" in batch:
            batch = _pyramid(batch, "semantic_image", "semantic_image_label")

        if cfg.DEPTH.ENABLED and "depth" in batch:
            batch["depth_label_1"] = batch["depth"]
            h, w = batch["depth"].shape[-3], batch["depth"].shape[-2]
            for k in (2, 4):
                batch[f"depth_label_{k}"] = _bilinear_resize(
                    batch[f"depth_label_{k // 2}"], h // k, w // k)

        if cfg.LIDAR_RE.ENABLED and "range_view_pcd_xyzd" in batch:
            batch = _pyramid(batch, "range_view_pcd_xyzd", "range_view_label")

        if cfg.LIDAR_SEG.ENABLED and "range_view_pcd_seg" in batch:
            batch = _pyramid(batch, "range_view_pcd_seg",
                             "range_view_seg_label")

        if cfg.VOXEL_SEG.ENABLED and "voxel" in batch:
            batch["voxel_label_1"] = batch["voxel"]
            for k in (2, 4):
                batch[f"voxel_label_{k}"] = batch[f"voxel_label_{k // 2}"][
                    ..., ::2, ::2, ::2]
        return batch

    # ------------------------------------------------------------------
    def augmentation(self, batch, generator: torch.Generator):
        batch = self._pixel_augmentation(batch, generator)
        return self._route_augmentation(batch, generator)

    def _pixel_augmentation(self, batch, gen):
        aug = self.cfg.IMAGE.AUGMENTATION
        image = batch["image"]  # (b, s, h, w, 3) in [0, 1]
        flat = image.reshape((-1,) + tuple(image.shape[2:]))
        dev = image.device
        n = flat.shape[0]
        u = _uniform(gen, dev, 0.0, 1.0, (n,))
        std = _uniform(gen, dev, aug.BLUR_STD[0], aug.BLUR_STD[1], (n,))
        sharp = _uniform(gen, dev, aug.SHARPEN_FACTOR[0],
                         aug.SHARPEN_FACTOR[1], (n,))
        b_, c_, s_, h_ = (aug.COLOR_JITTER_BRIGHTNESS,
                          aug.COLOR_JITTER_CONTRAST,
                          aug.COLOR_JITTER_SATURATION, aug.COLOR_JITTER_HUE)
        fb = _uniform(gen, dev, max(0, 1 - b_), 1 + b_, (n,))
        fc = _uniform(gen, dev, max(0, 1 - c_), 1 + c_, (n,))
        fs = _uniform(gen, dev, max(0, 1 - s_), 1 + s_, (n,))
        fh = _uniform(gen, dev, -h_, h_, (n,))
        apply = _uniform(gen, dev, 0.0, 1.0, (n,)) < aug.COLOR_PROB
        frames = []
        for i, ui in enumerate(u.tolist()):  # one host sync for the choices
            img = flat[i]
            if ui < aug.BLUR_PROB:
                img = _gaussian_blur(img, aug.BLUR_WINDOW, std[i])
            elif ui < aug.BLUR_PROB + aug.SHARPEN_PROB:
                img = _adjust_sharpness(img, sharp[i])
            frames.append(_color_jitter(img, fb[i], fc[i], fs[i], fh[i],
                                        apply[i]))
        batch["image"] = torch.stack(frames).reshape(image.shape)
        return batch

    def _route_augmentation(self, batch, gen):
        if "route_map" not in batch:
            return batch
        cfg = self.cfg.ROUTE
        rm = batch["route_map"]  # (b, s, h, w, 3)
        b, h = rm.shape[0], rm.shape[2]
        dev = rm.device
        p0 = cfg.AUGMENTATION_DROPOUT
        p1 = p0 + cfg.AUGMENTATION_END_OF_ROUTE
        p2 = p1 + cfg.AUGMENTATION_SMALL_ROTATION
        p3 = p2 + cfg.AUGMENTATION_LARGE_ROTATION
        out = []
        for i, ui in enumerate(_uniform(gen, dev, 0.0, 1.0, (b,)).tolist()):
            maps = rm[i]
            if ui < p0:
                maps = torch.zeros_like(maps)
            elif ui < p1:
                height = torch.randint(0, h, (), generator=gen, device=dev)
                rows = torch.arange(h, device=dev)[None, :, None, None]
                maps = torch.where(rows < height, 0.0, maps)
            elif ui < p3:
                degrees = cfg.AUGMENTATION_DEGREES if ui < p2 else 180.0
                maps = self._random_affine(maps, gen, degrees)
            out.append(maps)
        batch["route_map"] = torch.stack(out)
        return batch

    def _random_affine(self, maps, gen, degrees: float):
        cfg = self.cfg.ROUTE
        dev = maps.device
        h, w = maps.shape[1:3]
        tr, sc, sh = (cfg.AUGMENTATION_TRANSLATE, cfg.AUGMENTATION_SCALE,
                      cfg.AUGMENTATION_SHEAR)
        angle = _uniform(gen, dev, -degrees, degrees) * math.pi / 180
        tx = _uniform(gen, dev, -tr[0], tr[0]) * w
        ty = _uniform(gen, dev, -tr[1], tr[1]) * h
        scale = _uniform(gen, dev, sc[0], sc[1])
        shx = _uniform(gen, dev, -sh[0], sh[0]) * math.pi / 180
        return _affine(maps, angle, tx, ty, scale, shx)
