"""The training part of the port's preprocessing
(muvo_tpu_torch/models/preprocess.py) against muvo_tpu's PreProcess, on
the CPU: the label pyramids, and the augmentation helpers with fixed
parameters (torch and JAX draw different random streams; the parameters
muvo_tpu would draw from a key are drawn here from the same key and handed
to the port). The random augmentation itself is checked by shape and range.

Tolerances: nearest pyramids exact; the antialiased bilinear pyramid and
every image op 1e-6 absolute (fp32 on values in [0, 1]) unless noted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.models import preprocess as jp
from muvo_tpu_torch.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu_torch.models import preprocess as pp

ATOL = 1e-6


def _img(seed=0, h=20, w=24):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


@pytest.mark.parametrize("n_in,n_out", [(64, 32), (32, 16), (10, 4),
                                        (6, 12)])
def test_linear_resize_matrix_is_jax_image_resize(n_in, n_out):
    """A 2x step weighs four inputs 1/8, 3/8, 3/8, 1/8 (antialiased);
    plain bilinear (two inputs, 1/2 each) would not match."""
    want = np.asarray(jax.image.resize(jnp.eye(n_in), (n_out, n_in),
                                       method="linear"))
    got = pp.linear_resize_matrix(n_in, n_out)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if n_in == 2 * n_out:
        np.testing.assert_allclose(got[3, 5:9], [1 / 8, 3 / 8, 3 / 8, 1 / 8],
                                   atol=ATOL)


def test_label_pyramids_match_prepare_labels():
    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    batch = synthetic_batch(pcfg, 2, 2, seed=1)
    want = jp.PreProcess(jcfg)({k: jnp.asarray(v) for k, v in batch.items()},
                               training=False)
    got = pp.PreProcess(pcfg)({k: torch.from_numpy(v)
                               for k, v in batch.items()}, training=False)
    keys = [f"{n}_{k}" for n in ("rgb_label", "range_view_label",
                                 "voxel_label") for k in (1, 2, 4)]
    assert set(keys) <= set(got)
    for key in keys + ["image", "route_map", "range_view_pcd_xyzd",
                       "intrinsics"]:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if key.startswith(("voxel_label", "range_view_label",
                           "range_view_pcd")):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=5 * ATOL, err_msg=key)
    # rgb_label_1 is the cropped image in [0, 1], before normalisation
    assert 0.0 <= got["rgb_label_1"].min() and got["rgb_label_1"].max() <= 1.0


def test_unported_label_branches_raise():
    """None is left: POINTS.DEVICE_PROJECTION and EVAL.RESOLUTION, the
    last two, run (tests/test_torch_range_projection.py and
    tests/test_torch_eval_resolution.py hold them against muvo_tpu)."""
    cfg = tiny_test_cfg()
    cfg.POINTS.DEVICE_PROJECTION = True
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 1, 2, seed=0).items()}
    out = pp.PreProcess(cfg)(batch)
    assert out["range_view_pcd_xyzd"].shape == (1, 2, 64, 128, 4)
    assert "range_view_label_4" in out
    cfg = tiny_test_cfg()
    cfg.EVAL.RESOLUTION.ENABLED = True
    cfg.EVAL.RESOLUTION.FACTOR = 2
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 1, 2, seed=0).items()}
    assert pp.PreProcess(cfg)(batch)["image"].shape == (1, 2, 32, 64, 3)


@pytest.mark.parametrize("std", [0.1, 1.7])
def test_gaussian_blur(std):
    img = _img(0)
    want = jp._gaussian_blur(jnp.asarray(img), 5, std)
    got = pp._gaussian_blur(torch.from_numpy(img), 5, torch.tensor(std))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("factor", [1.0, 3.3])
def test_adjust_sharpness(factor):
    img = _img(1)
    want = jp._adjust_sharpness(jnp.asarray(img), factor)
    got = pp._adjust_sharpness(torch.from_numpy(img), torch.tensor(factor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("hue", [-0.1, 0.04])
def test_adjust_hue(hue):
    img = _img(2)
    want = jp._adjust_hue(jnp.asarray(img), hue)
    got = pp._adjust_hue(torch.from_numpy(img), torch.tensor(hue))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_color_jitter_pieces(seed):
    """muvo_tpu's _color_jitter with its factors drawn from ``key``, against
    the port's with the same factors."""
    img = _img(3)
    key = jax.random.PRNGKey(seed)
    prob, b, c, s, h = 0.9, 0.3, 0.3, 0.3, 0.1
    want = jp._color_jitter(jnp.asarray(img), key, prob, b, c, s, h)
    k_apply, kb, kc, ks, kh = jax.random.split(key, 5)
    fb = jax.random.uniform(kb, minval=1 - b, maxval=1 + b)
    fc = jax.random.uniform(kc, minval=1 - c, maxval=1 + c)
    fs = jax.random.uniform(ks, minval=1 - s, maxval=1 + s)
    fh = jax.random.uniform(kh, minval=-h, maxval=h)
    apply = jax.random.uniform(k_apply) < prob
    t = lambda v: torch.tensor(np.asarray(v))  # noqa: E731
    got = pp._color_jitter(torch.from_numpy(img), t(fb), t(fc), t(fs), t(fh),
                           t(apply))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("degrees", [8.0, 180.0])
def test_random_affine_with_muvo_tpus_draws(degrees):
    rs = np.random.RandomState(4)
    maps = rs.rand(2, 16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    tr, sc, sh = (0.1, 0.1), (0.95, 1.05), (0.1, 0.1)
    want = jp._random_affine(jnp.asarray(maps), key, degrees, tr, sc, sh)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = lambda k, lo, hi: torch.tensor(float(  # noqa: E731
        jax.random.uniform(k, minval=lo, maxval=hi)))
    got = pp._affine(torch.from_numpy(maps),
                     u(k1, -degrees, degrees) * np.pi / 180,
                     u(k2, -tr[0], tr[0]) * 16, u(k3, -tr[1], tr[1]) * 16,
                     u(k4, sc[0], sc[1]), u(k5, -sh[0], sh[0]) * np.pi / 180)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_random_augmentation_shape_and_range():
    """Every augmentation branch taken at least once: the images stay in
    [0, 1] with their shape, the route maps keep theirs, and the same
    generator seed gives the same batch."""
    cfg = tiny_test_cfg()
    aug = cfg.IMAGE.AUGMENTATION
    aug.BLUR_PROB, aug.SHARPEN_PROB, aug.COLOR_PROB = 0.4, 0.4, 0.5
    for name in ("DROPOUT", "END_OF_ROUTE", "SMALL_ROTATION",
                 "LARGE_ROTATION"):
        setattr(cfg.ROUTE, f"AUGMENTATION_{name}", 0.2)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 4, 3, seed=2).items()}
    pre = pp.PreProcess(cfg)
    # the augmentation sees [0, 1] images and route maps
    base = {"image": pre(batch)["rgb_label_1"],
            "route_map": pp._nearest_resize(batch["route_map"].float() / 255,
                                            cfg.ROUTE.SIZE, cfg.ROUTE.SIZE)}
    outs = [pre.augmentation(dict(base), torch.Generator().manual_seed(5))
            for _ in range(2)]
    for out in outs:
        assert out["image"].shape == base["image"].shape
        assert out["route_map"].shape == base["route_map"].shape
        assert float(out["image"].min()) >= 0.0
        assert float(out["image"].max()) <= 1.0
    assert torch.equal(outs[0]["image"], outs[1]["image"])
    assert not torch.equal(outs[0]["image"], base["image"])
    full = pre(batch, training=True, generator=torch.Generator().manual_seed(5))
    assert torch.isfinite(full["image"]).all()
