"""Visualisation helpers: BEV/voxel colouring, range-view images, composed
prediction strips for TensorBoard.

Counterpart of reference muvo/visualisation.py + the trainer's visualise
hooks (muvo/trainer.py:569-957), numpy/PIL-based (host-side only).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from muvo_tpu_torch.constants import BIRDVIEW_COLOURS, VOXEL_COLOURS


def convert_bev_to_image(bev_label: np.ndarray,
                         colours: np.ndarray = BIRDVIEW_COLOURS) -> np.ndarray:
    """(h, w) int labels -> (h, w, 3) uint8 RGB."""
    label = np.clip(bev_label.astype(np.int64), 0, len(colours) - 1)
    return colours[label]


def voxel_to_bev_image(voxel: np.ndarray,
                       colours: np.ndarray = VOXEL_COLOURS) -> np.ndarray:
    """(X, Y, Z) semantic voxels -> top-down projection image.

    The highest occupied voxel wins (top-down view).
    """
    x, y, z = voxel.shape
    heights = np.arange(z)[None, None, :]
    occupied = voxel > 0
    top = np.where(occupied, heights, -1).max(axis=-1)  # (x, y)
    has = top >= 0
    labels = np.zeros((x, y), np.int64)
    labels[has] = voxel[np.nonzero(has)[0], np.nonzero(has)[1], top[has]]
    return colours[np.clip(labels, 0, len(colours) - 1)]


def range_view_to_image(range_depth: np.ndarray, max_depth: float = 80.0
                        ) -> np.ndarray:
    """(h, w) depth -> grayscale uint8 visualisation (invalid = black)."""
    valid = range_depth > 0
    norm = np.clip(range_depth / max_depth, 0, 1)
    img = (255 * (1 - norm)).astype(np.uint8)
    img[~valid] = 0
    return np.stack([img] * 3, axis=-1)


def denormalise_image(image: np.ndarray,
                      mean=(0.485, 0.456, 0.406),
                      std=(0.229, 0.224, 0.225)) -> np.ndarray:
    """Imagenet-normalised (h, w, 3) float -> uint8 RGB."""
    img = image * np.asarray(std) + np.asarray(mean)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def draw_action_gauge(width: int, value: float, label: str = "") -> np.ndarray:
    """Horizontal [-1, 1] gauge bar as a (16, width, 3) uint8 strip."""
    strip = np.full((16, width, 3), 40, np.uint8)
    mid = width // 2
    pos = int(mid + np.clip(value, -1, 1) * (mid - 2))
    lo, hi = (mid, pos) if pos >= mid else (pos, mid)
    strip[4:12, lo:hi + 1] = (60, 180, 75) if value >= 0 else (220, 50, 50)
    strip[:, mid - 1:mid + 1] = 255
    return strip


def hstack_pad(images: List[np.ndarray], pad: int = 2) -> np.ndarray:
    h = max(im.shape[0] for im in images)
    padded = []
    for im in images:
        extra = h - im.shape[0]
        im = np.pad(im, ((0, extra), (0, pad), (0, 0)), constant_values=255)
        padded.append(im)
    return np.concatenate(padded, axis=1)


def prepare_final_display_image(
    rgb_gt: np.ndarray,
    rgb_pred: np.ndarray,
    bev_gt: Optional[np.ndarray] = None,
    bev_pred: Optional[np.ndarray] = None,
    range_gt: Optional[np.ndarray] = None,
    range_pred: Optional[np.ndarray] = None,
    voxel_pred: Optional[np.ndarray] = None,
    actions: Optional[Dict[str, float]] = None,
    receptive_field: Optional[int] = None,
) -> np.ndarray:
    """Compose a GT-vs-prediction comparison strip for one frame."""
    rows = [hstack_pad([rgb_gt, rgb_pred])]
    if bev_gt is not None and bev_pred is not None:
        rows.append(hstack_pad([convert_bev_to_image(bev_gt),
                                convert_bev_to_image(bev_pred)]))
    if range_gt is not None and range_pred is not None:
        rows.append(hstack_pad([range_view_to_image(range_gt),
                                range_view_to_image(range_pred)]))
    if voxel_pred is not None:
        rows.append(voxel_to_bev_image(voxel_pred))
    if actions:
        width = rows[0].shape[1]
        for name, value in actions.items():
            rows.append(draw_action_gauge(width, value, name))
    w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 2), (0, w - r.shape[1]), (0, 0)),
                   constant_values=255) for r in rows]
    return np.concatenate(rows, axis=0)


def optical_flow_image(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """Colour-coded Farneback optical flow between two RGB frames.

    (reference: muvo/trainer.py:1009-1020 get_color_coded_flow)
    """
    import cv2

    g1 = cv2.cvtColor(img1, cv2.COLOR_RGB2GRAY)
    g2 = cv2.cvtColor(img2, cv2.COLOR_RGB2GRAY)
    flow = cv2.calcOpticalFlowFarneback(g1, g2, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    hsv = np.zeros((*flow.shape[:2], 3), np.uint8)
    hsv[..., 2] = 255
    mag, ang = cv2.cartToPolar(flow[..., 0], flow[..., 1])
    hsv[..., 0] = ang * (180 / np.pi / 2)
    hsv[..., 1] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def trajectory_plot(positions: np.ndarray, size: int = 256) -> np.ndarray:
    """Top-down trajectory polyline image from (T, 2/3) positions.

    (reference trainer.py:808-842 plots ICP-derived trajectories)
    """
    import cv2

    img = np.full((size, size, 3), 255, np.uint8)
    pts = np.asarray(positions, float)[:, :2]
    if len(pts) >= 2:
        lo = pts.min(axis=0)
        span = max(float((pts.max(axis=0) - lo).max()), 1e-3)
        px = ((pts - lo) / span * (size - 20) + 10).astype(np.int32)
        cv2.polylines(img, [px], False, (0, 83, 138), 2)
        cv2.circle(img, tuple(px[0]), 4, (50, 205, 50), -1)
        cv2.circle(img, tuple(px[-1]), 4, (220, 20, 60), -1)
    return img


def pcd_xy_image(points: np.ndarray, size: int = 192,
                 extent: float = 50.0) -> np.ndarray:
    """(N, >=3) point cloud -> top-down xy scatter image, depth-coloured.

    (reference: muvo/trainer.py:968-1007 pcd_xy_image)
    """
    img = np.zeros((size, size, 3), np.uint8)
    if len(points) == 0:
        return img
    xy = points[:, :2]
    z = points[:, 2]
    px = ((xy / extent) * (size // 2) + size // 2).astype(np.int32)
    keep = (px[:, 0] >= 0) & (px[:, 0] < size) & (px[:, 1] >= 0) & \
        (px[:, 1] < size)
    px, z = px[keep], z[keep]
    shade = np.clip((z + 3.0) / 6.0, 0, 1)
    img[px[:, 1], px[:, 0], 1] = (80 + 175 * shade).astype(np.uint8)
    img[px[:, 1], px[:, 0], 2] = (255 * (1 - shade)).astype(np.uint8)
    return img


def voxel_figure_image(voxel: np.ndarray,
                       colours: np.ndarray = VOXEL_COLOURS,
                       elev: float = 60.0, azim: float = 165.0,
                       figsize: int = 5, max_dim: int = 32) -> np.ndarray:
    """Matplotlib 3-D voxel render -> (H, W, 3) uint8.

    ax.voxels is O(occupied cells) in Python, so grids are strided down to
    max_dim per axis first — the reference renders full-resolution
    (muvo/trainer.py:959-966) at multi-second cost per figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stride = max(1, int(np.ceil(max(voxel.shape) / max_dim)))
    voxel = voxel[::stride, ::stride, ::stride]
    occupancy = voxel > 0
    facecolors = colours[np.clip(voxel, 0, len(colours) - 1)] / 255.0
    fig = plt.figure(figsize=(figsize, figsize))
    ax = fig.add_subplot(projection="3d")
    # ax.voxels adds one collection a voxel and rescales the view after
    # each, over every collection so far: quadratic in the voxels. The view
    # is rescaled once, over the same data limits, after the last.
    ax.autoscale_view = lambda *args, **kwargs: None
    ax.voxels(occupancy, facecolors=facecolors, shade=False)
    del ax.autoscale_view
    ax.autoscale_view()
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def action_bar(width: int, value: float, positive_colour=(0, 200, 0),
               negative_colour=(200, 0, 0), height: int = 24) -> np.ndarray:
    """Reference-style acc/steer bar with the numeric value printed
    (muvo/trainer.py:683-707): colour fill from the midline plus text."""
    import cv2

    bar = np.full((height, width, 3), 255, np.uint8)
    mid = width // 2
    v = float(np.clip(value, -1, 1))
    if v >= 0:
        bar[4:-4, mid: mid + int((width // 2 - 2) * v)] = positive_colour
        org = (max(2, mid - 70), height - 8)
    else:
        bar[4:-4, mid + int((width // 2 - 2) * v): mid] = negative_colour
        org = (mid + 6, height - 8)
    cv2.putText(bar, f"{value:.4f}", org, cv2.FONT_HERSHEY_DUPLEX, 0.4,
                (0, 0, 0), 1, cv2.LINE_AA)
    bar[:, mid - 1: mid + 1] = 0
    return bar


def sequence_strip(frames: List[np.ndarray], receptive_field: int,
                   separator_width: int = 4) -> np.ndarray:
    """Horizontally tile frames with a red separator after the RF frames."""
    h = frames[0].shape[0]
    sep = np.zeros((h, separator_width, 3), np.uint8)
    sep[..., 0] = 255
    tiles = []
    for i, f in enumerate(frames):
        if i == receptive_field:
            tiles.append(sep)
        tiles.append(f)
    return np.concatenate(tiles, axis=1)
