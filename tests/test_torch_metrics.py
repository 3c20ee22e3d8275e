"""The port's metrics (muvo_tpu_torch/metrics.py), MetricSuite
(training/evaluator.py) and chamfer_distance_loss against muvo_tpu's, on
the same numpy-seeded arrays, on the CPU.

Confusion matrices and SSC counts must be equal (255 is the ignore label,
absent classes score 0); SSIM, PSNR and the Chamfer distances agree within
1e-5 relative (fp32, summation order). MetricSuite is held to muvo_tpu's
after two updates with seeded outputs and labels in tiny_test_cfg's output
shapes (with every metric switched on), both sides on the same LiDAR
columns: the port draws them from its generator, and muvo_tpu's
``jax.random.randint`` returns the same indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu import losses as jl
from muvo_tpu import metrics as JM
from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.training.evaluator import MetricSuite as JaxMetricSuite
from muvo_tpu_torch import losses as pl
from muvo_tpu_torch import metrics as M
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.training.evaluator import CHAMFER_COLUMNS, MetricSuite

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _labels(rs, n_classes, shape, absent=(), ignore=0.0):
    """int labels in [0, n_classes) without the ``absent`` classes, and a
    share ``ignore`` of 255."""
    present = [c for c in range(n_classes) if c not in absent]
    x = rs.choice(present, shape).astype(np.int64)
    x[rs.uniform(size=shape) < ignore] = 255
    return x


@pytest.mark.parametrize("n_classes,absent", [(2, ()), (8, (3, 6))])
def test_jaccard_matches(n_classes, absent):
    rs = np.random.RandomState(n_classes)
    want_conf, got_conf = (JM.jaccard_init(n_classes),
                           M.jaccard_init(n_classes))
    counted = 0
    for _ in range(2):
        pred = _labels(rs, n_classes, (2, 3, 16, 12), absent)
        target = _labels(rs, n_classes, (2, 3, 16, 12), absent, ignore=0.1)
        want_conf = JM.jaccard_update(want_conf, jnp.asarray(pred),
                                      jnp.asarray(target), n_classes)
        got_conf = M.jaccard_update(got_conf, _t(pred), _t(target),
                                    n_classes)
        counted += int((target != 255).sum())
    np.testing.assert_array_equal(got_conf.numpy(), np.asarray(want_conf))
    assert got_conf.sum().item() == counted  # 255 is not counted
    got = M.jaccard_compute(got_conf).numpy()
    np.testing.assert_allclose(got, np.asarray(JM.jaccard_compute(want_conf)),
                               rtol=RTOL)
    assert all(got[c] == 0 for c in absent)


@pytest.mark.parametrize("n_classes", [2, 5])
def test_ssc_matches(n_classes):
    rs = np.random.RandomState(10 + n_classes)
    want, got = JM.ssc_init(n_classes), M.ssc_init(n_classes)
    for _ in range(2):
        pred = _labels(rs, n_classes, (3, 8, 8, 6))
        true = _labels(rs, n_classes, (3, 8, 8, 6), absent=(1,), ignore=0.2)
        want = JM.ssc_update(want, jnp.asarray(pred), jnp.asarray(true),
                             n_classes)
        got = M.ssc_update(got, _t(pred), _t(true), n_classes)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w),
                                      err_msg=key)
    want_stats, got_stats = JM.ssc_compute(want), M.ssc_compute(got)
    assert set(got_stats) == set(want_stats)
    for key, w in want_stats.items():
        np.testing.assert_allclose(got_stats[key].numpy(), np.asarray(w),
                                   rtol=RTOL, err_msg=key)


def test_ssim_and_psnr_match():
    rs = np.random.RandomState(3)
    target = rs.uniform(size=(2, 2, 24, 20, 3)).astype(np.float32)
    pred = np.clip(target + 0.1 * rs.randn(*target.shape), 0, 1).astype(
        np.float32)
    for jfn, pfn in ((JM.ssim_batch, M.ssim_batch),
                     (JM.psnr_batch, M.psnr_batch)):
        want = float(jfn(jnp.asarray(pred), jnp.asarray(target)))
        got = pfn(_t(pred), _t(target)).item()
        np.testing.assert_allclose(got, want, rtol=RTOL)
    state, jstate = M.mean_init(), JM.mean_init()
    for v in (1.5, 2.5):
        state, jstate = M.mean_update(state, v), JM.mean_update(jstate, v)
    assert M.mean_compute(state).item() == float(JM.mean_compute(jstate)) == 2


def test_chamfer_batch_and_loss_match():
    rs = np.random.RandomState(4)
    pred = (50 * rs.uniform(-1, 1, (3, 700, 3))).astype(np.float32)
    target = (pred + rs.randn(*pred.shape)).astype(np.float32)
    want = float(JM.chamfer_batch(jnp.asarray(pred), jnp.asarray(target)))
    got = M.chamfer_batch(_t(pred), _t(target)).item()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the loss: (b, s, n, d), the explicit difference form
    pred4, target4 = pred[:, :60].reshape(3, 1, 60, 3), target[:, :60].reshape(
        3, 1, 60, 3)
    want = float(jl.chamfer_distance_loss(jnp.asarray(pred4),
                                          jnp.asarray(target4)))
    got = pl.chamfer_distance_loss(_t(pred4), _t(target4)).item()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _suite_cfgs():
    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    for cfg in (jcfg, pcfg):
        cfg.SEMANTIC_SEG.ENABLED = True
        cfg.LIDAR_SEG.ENABLED = True
        cfg.SEMANTIC_IMAGE.ENABLED = True
    return jcfg, pcfg


def _step(rs, cfg, b=1, s=1):
    """Seeded labels and outputs in tiny_test_cfg's output shapes."""
    h, w = cfg.POINTS.CHANNELS, cfg.POINTS.HORIZON_RESOLUTION
    ih = cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1]
    iw = cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0]
    bev, vox = tuple(cfg.BEV.SIZE), tuple(cfg.VOXEL.SIZE)
    n_bev, n_lidar, n_img, n_vox = (cfg.SEMANTIC_SEG.N_CHANNELS,
                                    cfg.LIDAR_SEG.N_CLASSES,
                                    cfg.SEMANTIC_IMAGE.N_CLASSES,
                                    cfg.VOXEL_SEG.N_CLASSES)
    f32 = np.float32
    rgb = rs.uniform(size=(b, s, ih, iw, 3)).astype(f32)
    rv = (rs.uniform(-1, 1, (b, s, h, w, 4))).astype(f32)
    batch = {
        "birdview_label": _labels(rs, n_bev, (b, s, *bev, 1), absent=(4,)),
        "rgb_label_1": rgb,
        "range_view_label_1": rv,
        "range_view_seg_label_1": _labels(rs, n_lidar, (b, s, h, w, 1)),
        "semantic_image_label_1": _labels(rs, n_img, (b, s, ih, iw, 1),
                                          ignore=0.05),
        "voxel_label_1": _labels(rs, n_vox, (b, s, *vox), ignore=0.1),
    }
    output = {
        "bev_segmentation_1": rs.randn(b, s, *bev, n_bev).astype(f32),
        "rgb_1": np.clip(rgb + 0.1 * rs.randn(*rgb.shape), 0, 1).astype(f32),
        "lidar_reconstruction_1": (rv + 0.05 * rs.randn(*rv.shape)).astype(
            f32),
        "lidar_segmentation_1": rs.randn(b, s, h, w, n_lidar).astype(f32),
        "semantic_image_1": rs.randn(b, s, ih, iw, n_img).astype(f32),
        "voxel_1": rs.randn(b, s, *vox, n_vox).astype(f32),
    }
    return batch, output


def test_metric_suite_matches_after_two_updates(monkeypatch):
    jcfg, pcfg = _suite_cfgs()
    rs = np.random.RandomState(5)
    got, want = MetricSuite(pcfg, "cpu"), JaxMetricSuite(jcfg)
    h, w = pcfg.POINTS.CHANNELS, pcfg.POINTS.HORIZON_RESOLUTION
    for seed in (11, 12):
        batch, output = _step(rs, pcfg)
        columns = torch.randint(0, h * w, (CHAMFER_COLUMNS,),
                                generator=torch.Generator().manual_seed(seed))
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(columns.numpy()))
        want.update({k: jnp.asarray(v) for k, v in batch.items()},
                    {k: jnp.asarray(v) for k, v in output.items()})
        got.update({k: _t(v) for k, v in batch.items()},
                   {k: _t(v) for k, v in output.items()},
                   torch.Generator().manual_seed(seed))
    assert set(got.state) == set(want.state)
    for key in ("iou", "pcd_iou", "image_iou"):
        np.testing.assert_array_equal(got.state[key].numpy(),
                                      np.asarray(want.state[key]), key)
    for key, w in want.state["ssc"].items():
        np.testing.assert_array_equal(got.state["ssc"][key].numpy(),
                                      np.asarray(w), key)
    got_scores, want_scores = got.compute(), want.compute()
    assert set(got_scores) == set(want_scores)
    assert len(got_scores) == 18
    for key, w in want_scores.items():
        assert np.isfinite(got_scores[key]), key
        np.testing.assert_allclose(got_scores[key], w, rtol=RTOL, atol=1e-7,
                                   err_msg=key)
    assert got_scores["bev_iou_Pedestrian"] == 0.0  # absent class
