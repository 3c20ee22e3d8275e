"""Evaluation metrics, accumulated on the device (counterpart of
muvo_tpu/metrics.py).

Each metric is a pair (init, update(state, ...) -> state) plus a
compute(state) -> scalars. The states are tensors on the batch's device, so
an evaluation accumulates there across batches and the host reads them
once, in compute. Semantics match upstream MUVO's metrics (MonoScene's SSC
metrics, SSIM, Chamfer, PSNR) and its torchmetrics JaccardIndex usage, as
muvo_tpu's do.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from muvo_tpu_torch.losses import ssim as _ssim_fn


# ---------------------------------------------------------------------------
# Jaccard / IoU through a confusion matrix
# ---------------------------------------------------------------------------
def jaccard_init(n_classes: int, device=None):
    return torch.zeros((n_classes, n_classes), dtype=torch.int64,
                       device=device)


def jaccard_update(conf, pred, target, n_classes: int):
    """pred / target: int tensors of the same shape (any rank). A target
    outside [0, n_classes) is not counted."""
    p = pred.reshape(-1).long()
    t = target.reshape(-1).long()
    valid = (t >= 0) & (t < n_classes)
    idx = torch.where(valid, t * n_classes + p,
                      torch.full_like(t, n_classes * n_classes))
    counts = torch.bincount(idx, minlength=n_classes * n_classes + 1)
    counts = counts[:n_classes * n_classes]
    return conf + counts.reshape(n_classes, n_classes).to(conf.dtype)


def jaccard_compute(conf):
    """Per-class IoU (torchmetrics' 'none' average: absent classes -> 0)."""
    conf = conf.float()
    tp = conf.diagonal()
    fp = conf.sum(0) - tp
    fn = conf.sum(1) - tp
    denom = tp + fp + fn
    return torch.where(denom > 0, tp / denom.clamp_min(1), 0.0)


# ---------------------------------------------------------------------------
# SSC metrics (semantic scene completion)
# ---------------------------------------------------------------------------
def ssc_init(n_classes: int, device=None) -> Dict:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"completion_tp": zeros(), "completion_fp": zeros(),
            "completion_fn": zeros(), "tps": zeros(n_classes),
            "fps": zeros(n_classes), "fns": zeros(n_classes)}


def _class_counts(x, n_classes: int):
    """How often each class in [0, n_classes) occurs in ``x``."""
    keep = (x >= 0) & (x < n_classes)
    idx = torch.where(keep, x, torch.full_like(x, n_classes))
    return torch.bincount(idx, minlength=n_classes + 1)[:n_classes]


def ssc_update(state: Dict, y_pred, y_true, n_classes: int) -> Dict:
    """y_pred / y_true: (bs, X, Y, Z) int labels; 255 = ignore."""
    mask = y_true != 255
    pred = torch.where(mask, y_pred, 0).reshape(-1).long()
    true = torch.where(mask, y_true, 0).reshape(-1).long()

    # occupancy completion (occupied against empty)
    b_pred = pred > 0
    b_true = true > 0
    tp = (b_true & b_pred).sum()
    fp = (~b_true & b_pred).sum()
    fn = (b_true & ~b_pred).sum()

    # per-class semantic counts: tp where both agree on the class
    tps = _class_counts(torch.where(pred == true, true,
                                    torch.full_like(true, -1)), n_classes)
    fps = _class_counts(pred, n_classes) - tps
    fns = _class_counts(true, n_classes) - tps
    return {
        "completion_tp": state["completion_tp"] + tp,
        "completion_fp": state["completion_fp"] + fp,
        "completion_fn": state["completion_fn"] + fn,
        "tps": state["tps"] + tps,
        "fps": state["fps"] + fps,
        "fns": state["fns"] + fns,
    }


def ssc_compute(state: Dict) -> Dict:
    tp, fp, fn = (state["completion_tp"], state["completion_fp"],
                  state["completion_fn"])
    nonzero = tp != 0
    precision = torch.where(nonzero, tp / (tp + fp).clamp_min(1), 0.0)
    recall = torch.where(nonzero, tp / (tp + fn).clamp_min(1), 0.0)
    iou = torch.where(nonzero, tp / (tp + fp + fn).clamp_min(1), 0.0)
    iou_ssc = state["tps"] / (state["tps"] + state["fps"] + state["fns"]
                              + 1e-5)
    return {"precision": precision, "recall": recall, "iou": iou,
            "iou_ssc": iou_ssc, "iou_ssc_mean": iou_ssc[1:].mean()}


# ---------------------------------------------------------------------------
# Running means: SSIM / PSNR / Chamfer
# ---------------------------------------------------------------------------
def mean_init(device=None):
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"total": zero, "count": zero.clone()}


def mean_update(state, value):
    return {"total": state["total"] + value, "count": state["count"] + 1.0}


def mean_compute(state):
    return state["total"] / state["count"].clamp_min(1e-8)


def ssim_batch(prediction, target, channel: int = 3):
    """Mean SSIM of a (b, s, h, w, c) batch."""
    return _ssim_fn(prediction, target, channel=channel)


def psnr_batch(prediction, target, max_pixel_val: float = 1.0):
    """Mean PSNR over (b, s, h, w, c) images (per-image MSE)."""
    mse = ((prediction.float() - target.float()) ** 2).mean((2, 3, 4))
    psnr = 20 * torch.log10(max_pixel_val / mse.clamp_min(1e-12).sqrt())
    return psnr.mean()


@contextlib.contextmanager
def _ieee_fp32_matmul(device):
    """fp32 products in full fp32: no TF32, no autocast."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def chamfer_batch(prediction, target):
    """Symmetric Chamfer distance of (B, N, D) point sets, halved as
    upstream's CDMetric (torch.cdist, p=2).

    The Gram form, one sample at a time, as muvo_tpu's lax.map: the
    pairwise matrix is one (N, M) fp32 slab a sample, 400 MB at the 10,000
    columns the evaluator samples. ``p2 + t2 - 2g`` cancels where points
    are close, so ``g`` is computed with TF32 off: its 10-bit mantissa
    would move the distances far more than fp32 rounding does."""
    p = prediction.float()
    t = target.float()
    per_sample = []
    with _ieee_fp32_matmul(p.device):
        for pi, ti in zip(p, t):
            p2 = (pi ** 2).sum(-1)
            t2 = (ti ** 2).sum(-1)
            g = pi @ ti.T
            d2 = p2[:, None] + t2[None, :] - 2.0 * g
            # the clamp and the root are monotonic: taken after the minima,
            # on N + M values instead of N x M, they give the same values
            dl = d2.min(dim=0).values  # target -> nearest prediction
            dr = d2.min(dim=1).values  # prediction -> nearest target
            per_sample.append((dl.clamp_min(1e-12).sqrt().mean()
                               + dr.clamp_min(1e-12).sqrt().mean()) / 2)
    return torch.stack(per_sample).mean()
