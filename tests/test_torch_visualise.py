"""The port's validation panels (muvo_tpu_torch/training/visualise.py,
visualisation.py) and ICP registration (geometry/icp.py) against
muvo_tpu's, on the CPU.

visualise_step draws the same panels from the same numpy batch and
outputs, byte for byte: the port's from tensors, muvo_tpu's from arrays.
The batch is tiny_test_cfg's with a 40 x 40 x 16 voxel grid (strided by 2
for the 3-D renders), preprocessed, with seeded voxel labels and range
views; the outputs are seeded. About 2% of the voxels are occupied and 3%
of the range view's points valid, in the labels and the outputs, which
keeps matplotlib's 3-D renders and the ICP short.
compute_pcd_transformation's transform and accumulated pose agree within
1e-6.
"""

import numpy as np
import pytest
import torch

from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.geometry.icp import compute_pcd_transformation as jax_icp
from muvo_tpu.training.visualise import visualise_step as jax_visualise_step
from muvo_tpu_torch.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu_torch.geometry.icp import compute_pcd_transformation
from muvo_tpu_torch.models.preprocess import PreProcess
from muvo_tpu_torch.training import visualise

PANELS = {"rgb", "flow", "range_view", "video/lidar", "pcd_xy", "trajectory",
          "voxel_topdown", "voxel_3d", "voxel_3d_imagine", "input_route_map"}


def _outputs(rs, cfg, frames):
    """Seeded decoder outputs of ``frames`` frames in tiny_test_cfg's
    shapes, rgb_1 first (muvo_tpu reads the frame count from the first)."""
    ih = cfg.IMAGE.CROP[3] - cfg.IMAGE.CROP[1]
    iw = cfg.IMAGE.CROP[2] - cfg.IMAGE.CROP[0]
    h, w = cfg.POINTS.CHANNELS, cfg.POINTS.HORIZON_RESOLUTION
    voxel = rs.randn(1, frames, *cfg.VOXEL.SIZE, 2).astype(np.float32)
    voxel[..., 1] -= 4.0  # about 2% of the cells occupied
    return {"rgb_1": rs.uniform(size=(1, frames, ih, iw, 3)).astype(
                np.float32),
            "lidar_reconstruction_1": _range_view(rs, (1, frames, h, w, 4)),
            "voxel_1": voxel}


def _range_view(rs, shape):
    """xyz in [-1, 1] and a depth above 0.1 (a valid point) at 3% of the
    pixels."""
    range_view = rs.uniform(-1, 1, shape).astype(np.float32)
    range_view[..., 3] = np.where(rs.uniform(size=shape[:-1]) < 0.03,
                                  np.abs(range_view[..., 3]) + 0.1, 0.0)
    return range_view


@pytest.fixture(scope="module")
def panels():
    pcfg, jcfg = tiny_test_cfg(), jax_tiny_cfg()
    pcfg.VOXEL.SIZE = jcfg.VOXEL.SIZE = [40, 40, 16]
    rf, fh = pcfg.RECEPTIVE_FIELD, pcfg.FUTURE_HORIZON
    raw = synthetic_batch(pcfg, 1, rf + fh, seed=2)
    pb = PreProcess(pcfg)({k: torch.as_tensor(v) for k, v in raw.items()},
                          training=False)
    rs = np.random.RandomState(3)
    labels = pb["voxel_label_1"]
    pb["voxel_label_1"] = torch.from_numpy(
        (rs.uniform(size=labels.shape) < 0.02).astype(np.uint8))
    pb["range_view_label_1"] = torch.from_numpy(
        _range_view(rs, pb["range_view_label_1"].shape))
    output, imagine = _outputs(rs, pcfg, rf), _outputs(rs, pcfg, fh)
    got = visualise.visualise_step(
        pcfg, pb, {k: torch.from_numpy(v) for k, v in output.items()},
        {k: torch.from_numpy(v) for k, v in imagine.items()})
    want = jax_visualise_step(jcfg, {k: v.numpy() for k, v in pb.items()},
                              output, imagine)
    return got, want


def test_every_panel_is_drawn(panels):
    got, want = panels
    assert visualise.undrawable_panels() == []  # cv2 and matplotlib here
    assert set(got) == set(want) == PANELS


@pytest.mark.parametrize("name", sorted(PANELS))
def test_panel_equals_muvo_tpus(panels, name):
    got, want = panels
    assert got[name].dtype == want[name].dtype == np.uint8
    np.testing.assert_array_equal(got[name], want[name])


HEAD_PANELS = {"bev", "lidar_seg", "sem_image", "video/depth"}


@pytest.fixture(scope="module")
def head_panels():
    """The heads' panels: BEV segmentation (labels out of view zeroed and
    rotated by the preprocess), LiDAR and image segmentation and the depth
    video, on seeded logits and depths."""
    pcfg, jcfg = tiny_test_cfg(), jax_tiny_cfg()
    for cfg in (pcfg, jcfg):
        cfg.SEMANTIC_SEG.ENABLED = cfg.LIDAR_SEG.ENABLED = True
        cfg.SEMANTIC_IMAGE.ENABLED = cfg.DEPTH.ENABLED = True
        cfg.EVAL.MASK_VIEW = True
        cfg.BEV.OFFSET_FORWARD = -16
        cfg.VOXEL_SEG.ENABLED = cfg.LIDAR_RE.ENABLED = False
        cfg.EVAL.RGB_SUPERVISION = False
    rf, fh = pcfg.RECEPTIVE_FIELD, pcfg.FUTURE_HORIZON
    raw = synthetic_batch(pcfg, 1, rf + fh, seed=4)
    raw["depth"] = np.random.RandomState(6).uniform(
        -0.2, 1.2, raw["depth"].shape).astype(np.float32)
    pb = PreProcess(pcfg)({k: torch.as_tensor(v) for k, v in raw.items()},
                          training=False)
    rs = np.random.RandomState(7)
    ih = pcfg.IMAGE.CROP[3] - pcfg.IMAGE.CROP[1]
    iw = pcfg.IMAGE.CROP[2] - pcfg.IMAGE.CROP[0]
    lh, lw = pcfg.POINTS.CHANNELS, pcfg.POINTS.HORIZON_RESOLUTION

    def outputs(frames):
        return {"bev_segmentation_1": rs.randn(
                    1, frames, *pcfg.BEV.SIZE, 8).astype(np.float32),
                "lidar_segmentation_1": rs.randn(
                    1, frames, lh, lw, 9).astype(np.float32),
                "semantic_image_1": rs.randn(
                    1, frames, ih, iw, 9).astype(np.float32),
                "depth_1": rs.uniform(-0.2, 1.2, (1, frames, ih, iw, 1)
                                      ).astype(np.float32)}

    output, imagine = outputs(rf), outputs(fh)
    got = visualise.visualise_step(
        pcfg, pb, {k: torch.from_numpy(v) for k, v in output.items()},
        {k: torch.from_numpy(v) for k, v in imagine.items()})
    want = jax_visualise_step(jcfg, {k: v.numpy() for k, v in pb.items()},
                              output, imagine)
    return got, want


@pytest.mark.parametrize("name", sorted(HEAD_PANELS))
def test_head_panel_equals_muvo_tpus(head_panels, name):
    got, want = head_panels
    assert HEAD_PANELS <= set(got) and set(got) == set(want)
    assert got[name].dtype == want[name].dtype == np.uint8
    np.testing.assert_array_equal(got[name], want[name])


def test_panels_of_missing_packages_are_not_drawn(monkeypatch):
    """Without cv2 the action bars, flow and trajectory are not drawn;
    the others still are."""
    find_spec = visualise.importlib.util.find_spec
    monkeypatch.setattr(visualise.importlib.util, "find_spec",
                        lambda name: None if name == "cv2"
                        else find_spec(name))
    assert visualise.undrawable_panels() == ["flow", "rgb", "trajectory"]


@pytest.mark.parametrize("seed", [0, 1])
def test_icp_matches_muvo_tpus(seed):
    rs = np.random.RandomState(seed)
    pcd1 = rs.uniform(-20, 20, (300, 3))
    angle = 0.05 * (seed + 1)
    rot = np.array([[np.cos(angle), -np.sin(angle), 0],
                    [np.sin(angle), np.cos(angle), 0], [0, 0, 1]])
    pcd2 = pcd1 @ rot.T + np.array([0.5, -0.3, 0.1]) + 0.01 * rs.randn(300, 3)
    pose = {"Rot": np.eye(3), "pos": np.zeros((3, 1))}
    want_t, want_pose = jax_icp(pcd1, pcd2, pose, threshold=5)
    got_t, got_pose = compute_pcd_transformation(pcd1, pcd2, pose,
                                                 threshold=5)
    np.testing.assert_allclose(got_t, want_t, atol=1e-6)
    for key in ("Rot", "pos"):
        np.testing.assert_allclose(got_pose[key], want_pose[key], atol=1e-6)
    assert not np.allclose(got_t, np.eye(4))  # it registered something
