"""Panoptic centre / offset labels (counterpart of muvo_tpu/utils/instance.py).

Per frame, each instance id in 1..max_instances contributes a Gaussian bump
at its centre of mass, rounded half to even, to the centre heatmap, and
the displacement (xc - x, yc - y) to the offset map on its own pixels;
pixels no such instance owns hold ``ignore_index``. Ids above
max_instances are ignored, as in muvo_tpu, whose bound is static.
Channels-last: centre (..., h, w, 1), offset (..., h, w, 2).
"""

from __future__ import annotations

import torch


def center_offset_labels(instance_label: torch.Tensor, sigma,
                         max_instances: int = 32, ignore_index: int = 255):
    """instance_label: (b, s, h, w) int. Returns (center (b, s, h, w, 1),
    offset (b, s, h, w, 2)), both float32."""
    b, s, h, w = instance_label.shape
    dev = instance_label.device
    inst = instance_label.reshape(b * s, h, w)
    x = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    y = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)

    ids = torch.arange(1, max_instances + 1, device=dev)
    masks = inst[:, None] == ids[None, :, None, None]  # (f, M, h, w)
    fmasks = masks.float()
    counts = fmasks.sum((2, 3))
    present = counts > 0
    safe = counts.clamp_min(1.0)
    xc = torch.round((fmasks * x).sum((2, 3)) / safe)
    yc = torch.round((fmasks * y).sum((2, 3)) / safe)

    off_x = xc[..., None, None] - x  # (f, M, h, w)
    off_y = yc[..., None, None] - y
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    g = torch.exp(-(off_x ** 2 + off_y ** 2) / sig ** 2)
    g = torch.where(present[..., None, None], g, torch.zeros_like(g))
    center = g.amax(1).clamp_min(0.0)

    # the masks are disjoint, so a masked sum picks the owner's offset
    owned = masks.any(1)
    ignore = torch.full_like(center, float(ignore_index))
    offset_x = torch.where(owned, (fmasks * off_x).sum(1), ignore)
    offset_y = torch.where(owned, (fmasks * off_y).sum(1), ignore)
    center = center.reshape(b, s, h, w, 1)
    offset = torch.stack([offset_x, offset_y], -1).reshape(b, s, h, w, 2)
    return center, offset
