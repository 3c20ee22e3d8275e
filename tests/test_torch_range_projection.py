"""POINTS.DEVICE_PROJECTION in the port against muvo_tpu:
``RangeProjector.project_torch`` against ``project_jax`` vmapped over the
frames inside jit (as muvo_tpu's PreProcess runs it), then the port's
PreProcess against muvo_tpu's, and a recorded drive's raw points carried
by the port's dataset, loader and device_prefetch into the range view.

Both sides compute in float32. XLA's compiled graph rounds some steps
otherwise than torch (a fused multiply-add in the column, its own atan2 in
arcsin's expansion: up to 2 ulp of pitch), so a point within a rounding of
a bin edge can land in the neighbouring pixel. Hence the tolerances:
- a cloud with no point within 1e-5 rad of a bin edge: equal bit for bit;
- a dense seeded cloud (60,000 points a frame at 64 x 1024): at most 0.1%
  of pixels differ, and each differing pixel is won, on one side, by a
  point within 1e-6 rad of a bin edge or by a depth within 2 ulp of the
  other side's winner;
- against the host projection (float64) of the dataset: under 1% of
  pixels, muvo_tpu's own limit (tests/test_device_projection.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.geometry.range_view import RangeProjector as JaxProjector
from muvo_tpu.models.preprocess import PreProcess as JaxPreProcess
from muvo_tpu_torch.data import dataset, loader
from muvo_tpu_torch.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu_torch.geometry.range_view import RangeProjector
from muvo_tpu_torch.models.preprocess import PreProcess
from torch_port_common import write_recorded_run

H, W, FOV, LIDAR = 64, 1024, (-30.0, 10.0), (1.0, 0.0, 2.0)
PORT = RangeProjector(H, W, *FOV, LIDAR)
EDGE_RAD, ULPS = 1e-6, 2


def _jax_projection(proj, points, sem, valid):
    """muvo_tpu's projection as its PreProcess runs it: vmapped, jitted."""
    fn = jax.jit(jax.vmap(lambda p, s, v: proj.project_jax(p, s, valid=v)))
    return tuple(np.asarray(a) for a in jax.device_get(
        fn(jnp.asarray(points), jnp.asarray(sem), jnp.asarray(valid))))


def _both(points, sem, valid, h=H, w=W):
    proj = RangeProjector(h, w, *FOV, LIDAR)
    got = proj.project_torch(torch.from_numpy(points), torch.from_numpy(sem),
                             torch.from_numpy(valid))
    want = _jax_projection(JaxProjector(h, w, *FOV, LIDAR), points, sem,
                           valid)
    return tuple(g.numpy() for g in got), want


def _cloud(seed, n_frames, n, lo=-3.0, hi=6.0):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-40, 40, (n_frames, n, 3)).astype(np.float32)
    pts[..., 2] = rs.uniform(lo, hi, (n_frames, n))
    sem = rs.randint(0, 23, (n_frames, n)).astype(np.int32)
    return pts, sem


def edge_distance(points, h=H, w=W):
    """Each point's distance in rad (float64, from its float32
    coordinates) to the nearest yaw or pitch bin edge."""
    c = points.astype(np.float64) * np.array([1.0, -1.0, 1.0]) - LIDAR
    depth = np.linalg.norm(c, axis=-1)
    yaw = np.arctan2(-c[..., 1], c[..., 0])
    with np.errstate(invalid="ignore", divide="ignore"):
        pitch = np.arcsin(np.where(depth > 0, c[..., 2] / np.maximum(
            depth, 1e-12), 0.0))
    fov_down, fov = np.deg2rad(FOV[0]), np.deg2rad(FOV[1] - FOV[0])
    tw = 0.5 * (1.0 - yaw / np.pi) * w
    th = (1.0 - (pitch + abs(fov_down)) / fov) * h
    return np.minimum(np.abs(tw - np.round(tw)) * 2 * np.pi / w,
                      np.abs(th - np.round(th)) * fov / h)


def _differing(got, want, ids=False):
    """Pixels whose (depth, xyz, semantics) differ, or with ``ids`` (the
    semantics are point indices) whose winner or hit differs."""
    if ids:
        return (got[2] != want[2]) | ((got[0] < 0) != (want[0] < 0))
    return ((got[0] != want[0]) | (got[1] != want[1]).any(-1)
            | (got[2] != want[2]))


def assert_explained(got, want, points, valid, h=H, w=W, max_share=1e-3,
                     ids=False):
    """At most ``max_share`` of the pixels differ, and each differing
    pixel's winner on one side is within EDGE_RAD of a bin edge, or the
    two winners' depths are within ULPS float32 ulp. The winners are the
    valid points at the pixel's xyz, or with ``ids`` the points whose index
    is the pixel's semantics."""
    bad = _differing(got, want, ids)
    assert bad.mean() <= max_share, bad.mean()
    near = edge_distance(points, h, w) < EDGE_RAD
    for f, i, j in np.argwhere(bad):
        winners, depths = [], []
        for depth, xyz, sem in (got, want):
            if depth[f, i, j] < 0:
                continue
            depths.append(np.float32(depth[f, i, j]))
            winners += ([sem[f, i, j]] if ids else list(np.flatnonzero(
                (points[f] == xyz[f, i, j]).all(-1) & valid[f])))
        tie = (len(depths) == 2 and abs(depths[0] - depths[1])
               <= ULPS * np.spacing(max(depths)))
        assert tie or near[f, winners].any(), (f, i, j, depths)
    return int(bad.sum())


def test_a_cloud_away_from_the_bin_edges_projects_bit_for_bit():
    pts, sem = _cloud(0, 2, 20000)
    keep = edge_distance(pts).min(0) > 1e-5  # the same rows in each frame
    pts, sem = pts[:, keep], sem[:, keep]
    valid = np.ones(sem.shape, bool)
    valid[1, -300:] = False
    got, want = _both(pts, sem, valid)
    assert not _differing(got, want).any()
    assert got[2].dtype == want[2].dtype == np.int32
    assert (got[0] >= 0).sum() > 20000  # pixels hit


def test_a_dense_cloud_differs_only_at_edges_and_ties():
    """60,000 points a frame, frame 1 padded after 52,000 points."""
    pts, sem = _cloud(1, 2, 60000)
    valid = np.ones(sem.shape, bool)
    valid[1, 52000:] = False
    got, want = _both(pts, sem, valid)
    assert_explained(got, want, pts, valid)


def test_padding_ties_zero_depth_and_bin_edges():
    pts, sem = _cloud(2, 1, 3000)
    valid = np.ones(sem.shape, bool)
    # padding: copies of the first 200 points halfway to the sensor, which
    # would win their pixels were they valid
    lidar = np.array(LIDAR, np.float32) * np.array([1, -1, 1], np.float32)
    pad = ((pts[:, :200] + lidar) * 0.5).astype(np.float32)
    pts = np.concatenate([pts, pad], 1)
    sem = np.concatenate([sem, np.full((1, 200), 99, np.int32)], 1)
    valid = np.concatenate([valid, np.zeros((1, 200), bool)], 1)
    # exact depth ties: points 300..399 repeated at 3000..3099 (after the
    # padding in the cloud), other semantics; the lower index must win
    ties = pts[:, 300:400].copy()
    pts = np.concatenate([pts, ties], 1)
    sem = np.concatenate([sem, np.full((1, 100), 77, np.int32)], 1)
    valid = np.concatenate([valid, np.ones((1, 100), bool)], 1)
    # a point at the sensor (depth 0: the nearest possible) and points on
    # yaw and pitch bin edges, placed in float64
    yaw = np.pi * (1 - 2 * np.arange(1, W, 97) / W)
    fov_down, fov = np.deg2rad(FOV[0]), np.deg2rad(FOV[1] - FOV[0])
    pitch = (1 - np.arange(1, H, 7) / H) * fov - abs(fov_down)
    yy, pp = np.meshgrid(yaw, pitch)
    r = 20.0
    carla = np.stack([r * np.cos(pp) * np.cos(yy), -r * np.cos(pp)
                      * np.sin(yy), r * np.sin(pp)], -1).reshape(-1, 3)
    edge = (carla + LIDAR) * np.array([1.0, -1.0, 1.0])
    extra = np.concatenate([lidar[None], edge]).astype(np.float32)
    pts = np.concatenate([pts, extra[None]], 1)
    sem = np.concatenate([sem, np.arange(len(extra), dtype=np.int32)[None]
                          + 1000], 1)
    valid = np.concatenate([valid, np.ones((1, len(extra)), bool)], 1)

    got, want = _both(pts, sem, valid)
    assert_explained(got, want, pts, valid)
    depth, _, s = got
    # the sensor's point: yaw 0 (column 512), pitch 0 (row 16 less a
    # float32 rounding: 15), depth 0
    assert (s == 1000).sum() == 1 and s[0, 15, 512] == 1000
    assert depth[0, 15, 512] == 0.0
    assert not (s == 99).any()  # no padded point wins
    assert not (s == 77).any()  # ties go to the lower index
    assert (np.isin(s, 1000 + np.arange(1, len(extra)))).sum() > 0
    # the padded points change nothing: the cloud without them
    cut = np.concatenate([np.arange(3000), np.arange(3200, pts.shape[1])])
    alone = PORT.project_torch(torch.from_numpy(pts[:, cut]),
                               torch.from_numpy(sem[:, cut]),
                               torch.ones((1, len(cut)), dtype=torch.bool))
    for a, b in zip(alone, got):
        np.testing.assert_array_equal(a.numpy(), b)


def _cfgs():
    out = []
    for make in (tiny_test_cfg, jax_tiny_cfg):
        cfg = make()
        cfg.POINTS.DEVICE_PROJECTION = True
        cfg.LIDAR_SEG.ENABLED = True
        out.append(cfg)
    return out


def test_preprocess_projects_as_muvo_tpu():
    pcfg, jcfg = _cfgs()
    batch = synthetic_batch(pcfg, 1, 2, seed=4)
    assert "range_view_pcd_xyzd" not in batch
    p = batch["points_raw"].shape[2]
    batch["num_points"][0, 1] = 3000  # the second frame padded
    # each point's index as its semantics: the winners can be told apart
    batch["points_sem"][:] = np.arange(p, dtype=np.int32)
    pre = JaxPreProcess(jcfg)
    want = jax.device_get(jax.jit(lambda b: pre(b, training=False))(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    raw = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = PreProcess(pcfg)(raw, training=False)
    served = PreProcess(pcfg)(raw, labels=False)
    keys = [k for k in want if k.startswith("range_view")]
    assert set(keys) == {k for k in got if k.startswith("range_view")}
    assert len(keys) == 8
    for key in keys:
        assert got[key].dtype == getattr(torch, str(want[key].dtype)), key
        assert tuple(got[key].shape) == want[key].shape, key
    np.testing.assert_array_equal(served["range_view_pcd_xyzd"].numpy(),
                                  got["range_view_pcd_xyzd"].numpy())
    # (depth, xyz, semantics) of each frame, both divided by LIDAR_RE.SCALE
    sides = []
    for out in (got, want):
        rv = np.asarray(out["range_view_pcd_xyzd"])[0]
        sides.append((rv[..., 3], rv[..., :3],
                      np.asarray(out["range_view_pcd_seg"])[0, ..., 0]))
    valid = np.arange(p)[None] < batch["num_points"][0][:, None]
    n = assert_explained(*sides, batch["points_raw"][0], valid,
                         pcfg.POINTS.CHANNELS,
                         pcfg.POINTS.HORIZON_RESOLUTION, ids=True)
    # where the winners agree, the values agree up to the division's
    # rounding (XLA multiplies by the reciprocal of LIDAR_RE.SCALE)
    same = ~_differing(*sides, ids=True)
    for a, b in zip(*sides):
        np.testing.assert_allclose(a[same], b[same], rtol=2e-7, atol=0)
    if n == 0:  # then every pyramid level is equal too
        for key in keys:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       rtol=2e-7, atol=0, err_msg=key)


def test_recorded_drive_points_reach_the_range_view(tmp_path):
    """A drive's raw points through the port's dataset, DataLoader and
    device_prefetch, projected in PreProcess, against the dataset's host
    projection of the same frames (the native float64 kernel)."""
    root = tmp_path / "carla"
    write_recorded_run(root / "trainval" / "train" / "Town01" / "0000", 10,
                       seed=5, n_points=3000)
    cfg, host_cfg = tiny_test_cfg(), tiny_test_cfg()
    for c in (cfg, host_cfg):
        c.DATASET.FILTER_BEGINNING_OF_RUN_SEC = 0.0
        c.LIDAR_SEG.ENABLED = True
    cfg.POINTS.DEVICE_PROJECTION = True
    batches = [next(iter(loader.device_prefetch(iter(loader.DataLoader(
        dataset.CarlaDataset(c, "train", 3, dataset_root=str(root)),
        batch_size=2, shuffle=False, num_workers=0)), "cpu")))
        for c in (cfg, host_cfg)]
    device, host = batches
    assert {"points_raw", "points_sem", "num_points"} <= set(device)
    assert device["points_raw"].shape[:2] == (2, 3)
    got = PreProcess(cfg)({k: torch.as_tensor(v) for k, v in device.items()})
    want = PreProcess(host_cfg)({k: torch.as_tensor(v)
                                 for k, v in host.items()})
    for key, share in (("range_view_pcd_xyzd", 0.01),
                       ("range_view_pcd_seg", 0.01)):
        g, w = got[key].numpy(), want[key].numpy()
        assert g.shape == w.shape, key
        differ = (np.abs(g - w) > 1e-3).any(-1)
        assert differ.mean() < share, (key, differ.mean())
