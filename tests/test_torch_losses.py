"""The port's losses (muvo_tpu_torch/losses.py) and compute_loss
(training/objectives.py) against muvo_tpu's on the same numpy-seeded
inputs, on the CPU in fp32.

Tolerance: 1e-5 relative (and 1e-6 absolute): both sides fp32, summation
order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu import losses as jl
from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.training.objectives import compute_loss as jax_compute_loss
from muvo_tpu_torch import losses as pl
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.training.objectives import compute_loss, reduce_loss


def _close(got, want, rtol=1e-5, atol=1e-6):
    if torch.is_tensor(got):
        got = got.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=atol)


def _both(fn_j, fn_p, *arrays, **kw):
    want = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    got = fn_p(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    return got, want


@pytest.mark.parametrize("top_k,weights,poly", [
    (False, False, False), (True, False, False), (True, True, False),
    (False, True, True),
])
def test_segmentation_loss(top_k, weights, poly):
    rs = np.random.RandomState(0)
    logits = rs.randn(2, 3, 6, 5, 4).astype(np.float32)
    target = rs.randint(0, 4, (2, 3, 6, 5)).astype(np.int64)
    target[0, 0, 0, :2] = 255  # out of range: contributes 0, as a one-hot
    w = np.array([1.0, 2.0, 0.5, 3.0], np.float32) if weights else None
    kw = dict(use_top_k=top_k, top_k_ratio=0.25, poly_one=poly,
              poly_one_coefficient=0.7)
    want = jl.segmentation_loss(jnp.asarray(logits), jnp.asarray(target),
                                weights=None if w is None else jnp.asarray(w),
                                **kw)
    got = pl.segmentation_loss(torch.from_numpy(logits),
                               torch.from_numpy(target),
                               weights=None if w is None else torch.from_numpy(w),
                               **kw)
    _close(got, want)


@pytest.mark.parametrize("norm", [1, 2])
def test_regression_losses(norm):
    rs = np.random.RandomState(1)
    p = rs.randn(2, 3, 4, 5, 3).astype(np.float32)
    t = rs.randn(2, 3, 4, 5, 3).astype(np.float32)
    t[0, 0, :2, :, 0] = 255  # ignored pixels
    _close(*_both(jl.regression_loss, pl.regression_loss, p, t, norm=norm))
    _close(*_both(jl.spatial_regression_loss, pl.spatial_regression_loss,
                  p, t, norm=norm))
    mask = rs.rand(2, 3, 4, 5, 1) > 0.5
    _close(*_both(jl.spatial_regression_loss, pl.spatial_regression_loss,
                  p, t, norm=norm, instance_mask=None), rtol=1e-5)
    want = jl.spatial_regression_loss(jnp.asarray(p), jnp.asarray(t),
                                      instance_mask=jnp.asarray(mask))
    got = pl.spatial_regression_loss(torch.from_numpy(p), torch.from_numpy(t),
                                     instance_mask=torch.from_numpy(mask))
    _close(got, want)


def _dist(rs, b=2, s=4, d=6):
    return {"mu": rs.randn(b, s, d).astype(np.float32),
            "sigma": rs.uniform(0.2, 2.0, (b, s, d)).astype(np.float32)}


def test_kl_loss_with_the_first_step_quirk():
    """probabilistic_loss's first step reads sigma from t=1 (upstream's
    quirk); kl_loss balances the detached sides."""
    rs = np.random.RandomState(2)
    prior, post = _dist(rs), _dist(rs)
    want = jl.probabilistic_loss(*(jnp.asarray(prior[k]) for k in ("mu", "sigma")),
                                 *(jnp.asarray(post[k]) for k in ("mu", "sigma")))
    got = pl.probabilistic_loss(*(torch.from_numpy(prior[k]) for k in ("mu", "sigma")),
                                *(torch.from_numpy(post[k]) for k in ("mu", "sigma")))
    _close(got, want)
    # the quirk: changing sigma at t=0 alone changes nothing
    post2 = {k: v.copy() for k, v in post.items()}
    post2["sigma"][:, 0] *= 3.0
    again = pl.probabilistic_loss(*(torch.from_numpy(prior[k]) for k in ("mu", "sigma")),
                                  *(torch.from_numpy(post2[k]) for k in ("mu", "sigma")))
    _close(again, got, rtol=0, atol=0)

    want = jl.kl_loss({k: jnp.asarray(v) for k, v in prior.items()},
                      {k: jnp.asarray(v) for k, v in post.items()}, alpha=0.75)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in prior.items()}
    tq = {k: torch.from_numpy(v).requires_grad_() for k, v in post.items()}
    got = pl.kl_loss(tp, tq, alpha=0.75)
    _close(got, want)
    got.backward()
    # stop_gradient: the prior's grads carry alpha, the posterior's 1-alpha
    gp = np.asarray(jax.grad(
        lambda m: jl.kl_loss({"mu": m, "sigma": jnp.asarray(prior["sigma"])},
                             {k: jnp.asarray(v) for k, v in post.items()}))(
        jnp.asarray(prior["mu"])))
    np.testing.assert_allclose(tp["mu"].grad.numpy(), gp, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_classes,top_k,weights", [
    (2, False, False), (3, True, True), (9, False, True),
])
def test_voxel_losses_fused_and_scal_losses(n_classes, top_k, weights):
    rs = np.random.RandomState(3)
    logits = rs.randn(2, 2, 6, 5, 4, n_classes).astype(np.float32)
    target = rs.randint(0, n_classes, (2, 2, 6, 5, 4)).astype(np.uint8)
    target[0, 0, 0] = 255  # ignore_index voxels
    w = (np.linspace(0.5, 2.0, n_classes).astype(np.float32)
         if weights else None)
    want = jl.voxel_losses_fused(jnp.asarray(logits), jnp.asarray(target),
                                 weights=None if w is None else jnp.asarray(w),
                                 use_top_k=top_k, top_k_ratio=0.5)
    got = pl.voxel_losses_fused(torch.from_numpy(logits),
                                torch.from_numpy(target),
                                weights=None if w is None else torch.from_numpy(w),
                                use_top_k=top_k, top_k_ratio=0.5)
    for g, v in zip(got, want):
        _close(g, v)
    _close(*_both(jl.sem_scal_loss, pl.sem_scal_loss, logits, target))
    _close(*_both(jl.geo_scal_loss, pl.geo_scal_loss, logits, target))
    # fused == CE + SemScal + GeoScal in the port too
    seg = pl.segmentation_loss(torch.from_numpy(logits),
                               torch.from_numpy(target),
                               weights=None if w is None else torch.from_numpy(w),
                               use_top_k=top_k, top_k_ratio=0.5)
    _close(got[0], seg)
    _close(got[1], pl.sem_scal_loss(torch.from_numpy(logits),
                                    torch.from_numpy(target)))


def test_ssim():
    rs = np.random.RandomState(4)
    a = rs.rand(2, 2, 24, 20, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rs.randn(*a.shape), 0, 1).astype(np.float32)
    _close(*_both(jl.ssim, pl.ssim, a, b))
    _close(*_both(jl.ssim, pl.ssim, a, b, non_negative=True))


def test_compute_loss_matches_term_for_term():
    """Every term of compute_loss on a tiny_test_cfg-shaped batch and
    output, with SSIM and the voxel class weights switched on."""
    rs = np.random.RandomState(5)
    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    for cfg in (jcfg, pcfg):
        cfg.LOSSES.SSIM = True
        cfg.VOXEL_SEG.USE_WEIGHTS = True
        cfg.VOXEL_SEG.N_CLASSES = 9
    b, s = 2, 3
    h, w = 64, 128
    batch = {"image": rs.randn(b, s, h, w, 3).astype(np.float32),
             "throttle_brake": rs.randn(b, s, 1).astype(np.float32),
             "steering": rs.randn(b, s, 1).astype(np.float32)}
    output = {"throttle_brake": rs.randn(b, s, 1).astype(np.float32),
              "steering": rs.randn(b, s, 1).astype(np.float32)}
    for k in (1, 2, 4):
        batch[f"rgb_label_{k}"] = rs.rand(b, s, h // k, w // k, 3).astype(
            np.float32)
        output[f"rgb_{k}"] = rs.rand(b, s, h // k, w // k, 3).astype(
            np.float32)
        batch[f"range_view_label_{k}"] = rs.randn(b, s, 16 // k, 32 // k,
                                                  4).astype(np.float32)
        output[f"lidar_reconstruction_{k}"] = rs.randn(
            b, s, 16 // k, 32 // k, 4).astype(np.float32)
        batch[f"voxel_label_{k}"] = rs.randint(
            0, 9, (b, s, 8 // k, 8 // k, 4 // k)).astype(np.uint8)
        output[f"voxel_{k}"] = rs.randn(b, s, 8 // k, 8 // k, 4 // k,
                                        9).astype(np.float32)
    dists = {part: _dist(rs, b, s, 5) for part in ("prior", "posterior")}
    jout = {k: jnp.asarray(v) for k, v in output.items()}
    jout.update({p: {k: jnp.asarray(v) for k, v in d.items()}
                 for p, d in dists.items()})
    pout = {k: torch.from_numpy(v) for k, v in output.items()}
    pout.update({p: {k: torch.from_numpy(v) for k, v in d.items()}
                 for p, d in dists.items()})
    want = jax_compute_loss(jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                            jout)
    got = compute_loss(pcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                       pout)
    assert set(got) == set(want)
    assert {"probabilistic", "ssim_1", "voxel_4", "sem_scal_2",
            "geo_scal_1", "lidar_depth_4"} <= set(got)
    for key, v in want.items():
        _close(got[key], v, rtol=1e-5, atol=1e-6)
    _close(reduce_loss(got), sum(float(v) for v in want.values()), rtol=1e-5)


def test_kl_of_a_one_step_sequence_is_not_logged():
    """A one-step sequence (the RF 1 observation of an eval step) has no
    t=1 for the first-step quirk to read: upstream's formula, as muvo_tpu
    and the port keep it, averages an empty tensor into NaN there, so
    compute_loss logs no probabilistic term for it, and logs the term of a
    two-step sequence as muvo_tpu's."""
    rs = np.random.RandomState(3)
    prior, post = _dist(rs), _dist(rs)
    one = {k: v[:, :1] for k, v in post.items()}
    with np.errstate(all="ignore"):
        want_nan = jl.probabilistic_loss(
            *(jnp.asarray(prior[k][:, :1]) for k in ("mu", "sigma")),
            *(jnp.asarray(one[k]) for k in ("mu", "sigma")))
        got_nan = pl.probabilistic_loss(
            *(torch.from_numpy(prior[k][:, :1]) for k in ("mu", "sigma")),
            *(torch.from_numpy(one[k]) for k in ("mu", "sigma")))
    assert np.isnan(float(want_nan)) and torch.isnan(got_nan)
    cfg = tiny_test_cfg()
    cfg.merge_from_dict({name: {"ENABLED": False} for name in (
        "SEMANTIC_SEG", "LIDAR_RE", "LIDAR_SEG", "SEMANTIC_IMAGE", "DEPTH",
        "VOXEL_SEG")})
    cfg.merge_from_dict({"EVAL": {"RGB_SUPERVISION": False}})
    batch = {"image": torch.zeros(1)}
    for steps in (1, 2):
        out = {name: {k: torch.from_numpy(v[:, :steps]) for k, v in d.items()}
               for name, d in (("prior", prior), ("posterior", post))}
        losses = compute_loss(cfg, batch, out)
        assert ("probabilistic" in losses) == (steps > 1)
        if steps > 1:
            want = jl.kl_loss(
                *({k: jnp.asarray(v) for k, v in o.items()} for o in (
                    {k: v[:, :steps] for k, v in prior.items()},
                    {k: v[:, :steps] for k, v in post.items()})),
                alpha=cfg.LOSSES.KL_BALANCING_ALPHA)
            _close(losses["probabilistic"],
                   cfg.LOSSES.WEIGHT_PROBABILISTIC * float(want), rtol=1e-5)
