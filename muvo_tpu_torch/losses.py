"""Loss functions (counterpart of muvo_tpu/losses.py), channels-last.

Every loss upcasts its inputs to fp32 at first use, as muvo_tpu's do, so a
bf16 model output feeds them directly. The data-dependent guards of
upstream MUVO (an empty mask, SemScal's per-class count guards) are masked
arithmetic with the same values, as in muvo_tpu. In a group of ranks
the terms that are ratios of sums over the batch (the masked regressions,
SemScal, GeoScal) take their sums over the global batch
(parallel/mesh.py), so that every rank holds the one-process value.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from muvo_tpu_torch.parallel.mesh import global_sum, global_term

_EPS = 1e-12


def _cross_entropy(logits, target, weights: Optional[torch.Tensor]):
    """Per-element CE of logits (..., C) against int target (...), with
    optional class weights (C,) applied like torch's weighted CE. A target
    outside [0, C) contributes 0, as a one-hot of it would."""
    n_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(target.long().clamp(0, n_classes - 1), n_classes)
    valid = ((target >= 0) & (target < n_classes)).float()
    onehot = onehot.float() * valid[..., None]
    loss = -(logp * onehot).sum(-1)
    if weights is not None:
        loss = loss * (onehot * weights.float()).sum(-1)
    return loss


def segmentation_loss(prediction, target, use_top_k: bool = False,
                      top_k_ratio: float = 1.0,
                      weights: Optional[torch.Tensor] = None,
                      poly_one: bool = False,
                      poly_one_coefficient: float = 0.0):
    """prediction (b, s, ..., c) logits; target (b, s, ...) int. Optional
    top-k hard-pixel mining over the flattened spatial dims and the
    PolyLoss-1 term ``+ eps * (1 - exp(-CE))``."""
    b, s = prediction.shape[:2]
    loss = _cross_entropy(prediction, target, weights)
    if poly_one:
        loss = loss + poly_one_coefficient * (1 - torch.exp(-loss))
    loss = loss.reshape(b, s, -1)
    if use_top_k:
        k = int(top_k_ratio * loss.shape[2])
        loss = torch.topk(loss, k, dim=-1).values
    return loss.mean()


def regression_loss(prediction, target, norm: int = 1, channel_dim: int = -1):
    """L1 / L2 summed over the channel dim, then the mean."""
    diff = prediction.float() - target.float()
    if norm == 1:
        loss = diff.abs()
    elif norm == 2:
        loss = diff ** 2
    else:
        raise ValueError(f"Expected norm 1 or 2, got {norm}")
    return loss.sum(channel_dim, keepdim=True).mean()


def spatial_regression_loss(prediction, target, norm: int = 1,
                            ignore_index: int = 255, instance_mask=None):
    """Masked L1 / L2 over (b, s, h, w, c). The mask: the first target
    channel != ignore_index, or an explicit instance mask."""
    if prediction.ndim != 5:
        raise ValueError("Must be a 5D tensor")
    mask = (instance_mask if instance_mask is not None
            else target[..., :1] != ignore_index)
    diff = prediction.float() - target.float()
    loss = (diff.abs() if norm == 1 else diff ** 2).sum(-1, keepdim=True)
    mask = mask.expand(loss.shape)
    total, count = global_sum(
        torch.where(mask, loss, torch.zeros_like(loss)).sum(), mask.sum())
    return global_term(total / count.clamp_min(1))


def probabilistic_loss(prior_mu, prior_sigma, posterior_mu, posterior_sigma):
    """KL(posterior || prior); the first step against N(0, 1).

    Upstream's quirk, kept as muvo_tpu keeps it: the first-step term reads
    the already-shifted log-sigma and variance, so it uses sigma from t=1
    while mu comes from t=0.
    """
    prior_mu, prior_sigma = prior_mu.float(), prior_sigma.float()
    posterior_mu, posterior_sigma = posterior_mu.float(), posterior_sigma.float()
    posterior_var = posterior_sigma[:, 1:] ** 2
    prior_var = prior_sigma[:, 1:] ** 2
    posterior_log_sigma = torch.log(posterior_sigma[:, 1:])
    prior_log_sigma = torch.log(prior_sigma[:, 1:])
    kl_div = (prior_log_sigma - posterior_log_sigma - 0.5
              + (posterior_var + (posterior_mu[:, 1:] - prior_mu[:, 1:]) ** 2)
              / (2 * prior_var))
    first_kl = (-posterior_log_sigma[:, :1] - 0.5
                + (posterior_var[:, :1] + posterior_mu[:, :1] ** 2) / 2)
    kl_div = torch.cat([first_kl, kl_div], dim=1)
    return kl_div.sum(-1).mean()


def kl_loss(prior, posterior, alpha: float = 0.75):
    """KL balancing (Dreamer-v2): each side trained against the other's
    detached statistics."""
    prior_loss = probabilistic_loss(prior["mu"], prior["sigma"],
                                    posterior["mu"].detach(),
                                    posterior["sigma"].detach())
    posterior_loss = probabilistic_loss(prior["mu"].detach(),
                                        prior["sigma"].detach(),
                                        posterior["mu"], posterior["sigma"])
    return alpha * prior_loss + (1 - alpha) * posterior_loss


def _bce_vs_one(p):
    """F.binary_cross_entropy(p, 1) == -log(p), clamped as torch does."""
    return torch.clamp(-torch.log(torch.clamp(p, min=_EPS)), max=100.0)


def _scal_terms(nominator, p_sum, target_sum, non_target_sum, spec_num):
    """SemScal's per-class precision, recall and specificity losses,
    averaged over the classes present in the target, from the sums over
    the global batch."""
    nominator, p_sum, target_sum, non_target_sum, spec_num = global_sum(
        nominator, p_sum, target_sum, non_target_sum, spec_num)
    precision = nominator / p_sum.clamp_min(_EPS)
    recall = nominator / target_sum.clamp_min(_EPS)
    specificity = spec_num / non_target_sum.clamp_min(_EPS)
    zero = torch.zeros_like(precision)
    loss_c = torch.where(p_sum > 0, _bce_vs_one(precision), zero)
    loss_c = loss_c + torch.where(target_sum > 0, _bce_vs_one(recall), zero)
    loss_c = loss_c + torch.where(non_target_sum > 0,
                                  _bce_vs_one(specificity), zero)
    present = target_sum > 0
    count = present.float().sum().clamp_min(1.0)
    return global_term(torch.where(present, loss_c, zero).sum() / count)


def sem_scal_loss(prediction, target, ignore_index: int = 255):
    """MonoScene scene-class affinity loss, semantic variant.
    prediction (b, s, X, Y, Z, C) logits; target (b, s, X, Y, Z) int."""
    c = prediction.shape[-1]
    p = F.softmax(prediction.float(), dim=-1)
    red = tuple(range(target.ndim))
    mask = (target != ignore_index)[..., None].float()
    onehot = F.one_hot(target.long().clamp(0, c - 1), c).float() * (
        (target >= 0) & (target < c)).float()[..., None] * mask
    p_masked = p * mask
    nominator = (p_masked * onehot).sum(red)
    p_sum = p_masked.sum(red)
    target_sum = onehot.sum(red)
    non_target_sum = mask.sum() - target_sum
    spec_num = ((1 - p_masked) * (1 - onehot) * mask).sum(red)
    return _scal_terms(nominator, p_sum, target_sum, non_target_sum,
                       spec_num)


def geo_scal_loss(prediction, target, ignore_index: int = 255):
    """MonoScene geometric (occupancy) affinity loss."""
    p = F.softmax(prediction.float(), dim=-1)
    empty = p[..., 0]
    nonempty = 1 - empty
    mask = (target != ignore_index).float()
    nonempty_target = ((target != 0) & (target != ignore_index)).float()
    return _geo_terms(nonempty_target * nonempty * mask, nonempty * mask,
                      nonempty_target, (mask - nonempty_target) * empty * mask,
                      mask - nonempty_target)


def _geo_terms(intersection, predicted, target, spec_num, spec_den):
    """GeoScal's precision, recall and specificity losses from the sums
    of its five maps over the global batch."""
    intersection, predicted, target, spec_num, spec_den = global_sum(
        intersection.sum(), predicted.sum(), target.sum(), spec_num.sum(),
        spec_den.sum())
    precision = intersection / predicted.clamp_min(_EPS)
    recall = intersection / target.clamp_min(_EPS)
    spec = spec_num / spec_den.clamp_min(_EPS)
    return global_term(_bce_vs_one(precision) + _bce_vs_one(recall)
                       + _bce_vs_one(spec))


def voxel_losses_fused(logits, target, weights: Optional[torch.Tensor] = None,
                       use_top_k: bool = False, top_k_ratio: float = 1.0,
                       ignore_index: int = 255):
    """(segmentation_loss, sem_scal_loss, geo_scal_loss) of voxel logits
    from one shared log-sum-exp: the same values as the three functions,
    with SemScal's specificity numerator written in the other sums
    (sum (1-p)(1-oh) m = sum m - p_sum - target_sum + nominator) and
    GeoScal reading only the empty-class probability."""
    c = logits.shape[-1]
    b, s = logits.shape[:2]
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1, keepdim=True)
    in_range = ((target >= 0) & (target < c)).float()
    oh = F.one_hot(target.long().clamp(0, c - 1), c).float() * in_range[..., None]
    red = tuple(range(target.ndim))

    pick = (lg * oh).sum(-1)
    ce = in_range * lse[..., 0] - pick
    if weights is not None:
        ce = ce * (oh * weights.float()).sum(-1)
    ce = ce.reshape(b, s, -1)
    if use_top_k:
        ce = torch.topk(ce, int(top_k_ratio * ce.shape[2]), dim=-1).values
    seg = ce.mean()

    mask = (target != ignore_index)[..., None].float()
    ohm = oh * mask
    p_m = torch.exp(lg - lse) * mask
    nominator = (p_m * ohm).sum(red)
    p_sum = p_m.sum(red)
    target_sum = ohm.sum(red)
    mask_sum = mask.sum()
    sem = _scal_terms(nominator, p_sum, target_sum, mask_sum - target_sum,
                      mask_sum - p_sum - target_sum + nominator)

    p0 = torch.exp(lg[..., 0] - lse[..., 0])
    m2 = mask[..., 0]
    nonempty_target = ((target != 0) & (target != ignore_index)).float()
    geo = _geo_terms(nonempty_target * (1 - p0) * m2, (1 - p0) * m2,
                     nonempty_target, (m2 - nonempty_target) * p0 * m2,
                     m2 - nonempty_target)
    return seg, sem, geo


# ---------------------------------------------------------------------------
def _gaussian_window(window_size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(window_size, dtype=torch.float32, device=device)
    g = torch.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] @ g[None, :]


def ssim(prediction, target, channel: int = 3, window_size: int = 11,
         sigma: float = 1.5, L: float = 1.0, non_negative: bool = False):
    """Mean SSIM of (b, s, h, w, c) images (VALID windows, as upstream)."""
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    pred = prediction.flatten(0, 1).float().movedim(-1, 1)
    targ = target.flatten(0, 1).float().movedim(-1, 1)
    win = _gaussian_window(window_size, sigma, pred.device)
    win = win[None, None].expand(channel, 1, window_size, window_size)

    def filt(x):
        return F.conv2d(x, win, groups=channel)

    mu1, mu2 = filt(targ), filt(pred)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(targ * targ) - mu1_sq
    sigma2_sq = filt(pred * pred) - mu2_sq
    sigma12 = filt(targ * pred) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    per_image = ssim_map.mean((1, 2, 3))
    if non_negative:
        per_image = per_image.clamp_min(0.0)
    return per_image.mean()


def chamfer_distance_loss(prediction, target):
    """Symmetric point-to-point Chamfer distance over (b, s, n, d), in the
    explicit difference form (b*s, n, n, d) of muvo_tpu's."""
    b, s, n, d = prediction.shape
    pred = prediction.reshape(b * s, n, d).float()
    targ = target.reshape(b * s, n, d).float()
    diff = pred[:, :, None, :] - targ[:, None, :, :]
    dist = (diff ** 2).sum(-1).clamp_min(_EPS).sqrt()
    dl = dist.min(dim=1).values
    dr = dist.min(dim=2).values
    return (dl.mean(dim=1) + dr.mean(dim=1)).mean()
