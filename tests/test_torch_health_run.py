"""``muvo_tpu_torch.tools.health_run`` against muvo_tpu's
tools/health_run_r4.py, and the health run end to end, on the CPU.

- Collection: one episode of 6 steps at seed 100, at the tools' 600 x 960
  frames and 30,000 LiDAR points, collected by each package: the same
  files, the same decoded images and point clouds, the same dataframe
  (measurements and the scripted driver's supervision).
- The scripted driver: the same control from the same observation and
  random generator, over the steps of a driven episode.
- End to end at tiny_test_cfg's sizes: collect (small frames), voxelise,
  ``evaluate`` on the random-init weights (twice: the floor repeats bit
  for bit), ``train.main`` for 2 steps with a checkpoint, ``evaluate`` on
  the checkpoint: the restored step, finite metrics, and the keys of
  muvo_tpu's runs/health_r4/eval_trained_run2.json. tiny_test_cfg's
  checkpoints are 0.4-1.5 GB, so the test removes its run.
- Episodes collected an episode a process: the same files, byte for byte,
  as in one process.
- The constant floor: every kept voxel marked occupied (recall 1, IoU and
  precision the occupied share of the kept voxels), finite metrics.
- tools/torch_health_run.py removes nothing: it refuses to start when its
  output or data directory exists.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv
from muvo_tpu_torch.tools import health_run
from torch_port_common import tiny_argv

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import tools.health_run_r4 as jax_health  # noqa: E402
from muvo_tpu.sim.kinematic_env import (  # noqa: E402
    KinematicDrivingEnv as JaxKinematicDrivingEnv)

COLLECT_STEPS = 6


def _files(run):
    return sorted(p.relative_to(run) for p in run.rglob("*") if p.is_file())


def test_collected_episode_is_muvo_tpus(tmp_path):
    import pandas as pd
    from PIL import Image

    runs = {}
    for name, collect in (("jax", jax_health.collect),
                          ("port", health_run.collect)):
        collect(str(tmp_path / name), "train", 1, COLLECT_STEPS,
                seed0=health_run.TRAIN_SEED0)
        runs[name] = tmp_path / name / "trainval/train/Town01/0100"
    want_run, got_run = runs["jax"], runs["port"]
    files = _files(want_run)
    assert files == _files(got_run)
    assert sum(p.suffix == ".png" for p in files) == 4 * COLLECT_STEPS
    for path in files:
        if path.suffix == ".png":
            got = np.asarray(Image.open(got_run / path))
            want = np.asarray(Image.open(want_run / path))
            assert got.dtype == want.dtype and np.array_equal(got, want), path
            if path.parts[0] == "image":
                assert want.shape == (*health_run.IMAGE_HW, 3)
        elif path.suffix == ".npy":  # the LiDAR frames: dicts of arrays
            got = np.load(got_run / path, allow_pickle=True).item()
            want = np.load(want_run / path, allow_pickle=True).item()
            assert set(got) == set(want)
            assert len(want["points_xyz"]) == health_run.LIDAR_POINTS
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    got = pd.read_pickle(got_run / "pd_dataframe.pkl")
    want = pd.read_pickle(want_run / "pd_dataframe.pkl")
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == COLLECT_STEPS
    for column in want.columns:
        for g, w in zip(got[column], want[column]):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), column
    actions = np.stack(got["action"])
    assert actions.shape == (COLLECT_STEPS, 3) and actions[:, 0].max() > 0


@pytest.mark.parametrize("seed", [100, 901])
def test_scripted_control_is_muvo_tpus(seed):
    envs = [cls(seed=seed, episode_steps=20, image_hw=(24, 40),
                lidar_points=100)
            for cls in (JaxKinematicDrivingEnv, KinematicDrivingEnv)]
    obs = [env.reset() for env in envs]
    rngs = [np.random.default_rng(seed) for _ in envs]
    target = float(np.random.default_rng(seed).uniform(3.5, 6.5))
    for _ in range(12):
        want = jax_health._scripted_control(envs[0], obs[0]["hero"], rngs[0],
                                            target)
        got = health_run._scripted_control(envs[1], obs[1]["hero"], rngs[1],
                                           target)
        assert got == want
        obs = [env.step({"hero": got})[0] for env in envs]
    assert envs[1]._ego.speed > 0.5  # the driver moves the car


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """A training and a held-out episode at tiny_test_cfg's frames,
    voxelised; and the random-init floor evaluated on it."""
    data = tmp_path_factory.mktemp("health") / "data"
    cfg = health_run.flagship_cfg(str(data), tiny_test_cfg())
    small = dict(image_hw=tuple(cfg.IMAGE.SIZE), lidar_points=2000)
    health_run.collect(str(data), "train", 1, 14, seed0=100, **small)
    health_run.collect(str(data), "val", 1, 10, seed0=900, **small)
    assert len(health_run.voxelize(str(data), cfg, workers=1)) == 2
    return data, _evaluate(data, "floor", "", True)


def _evaluate(data, label, ckpt, random_init):
    out = data.parent / f"eval_{label}.json"
    result = health_run.evaluate(
        str(data), ckpt, random_init, batches=1, out_json=str(out),
        batch_size=1, cfg=health_run.flagship_cfg(str(data), tiny_test_cfg()),
        device="cpu")
    assert json.loads(out.read_text()) == result
    return result


def _check_keys(result):
    want = json.loads(
        (ROOT / "runs/health_r4/eval_trained_run2.json").read_text())
    assert set(result) == set(want)
    for part in ("recon", "imagine"):
        assert set(result[part]) == set(want[part])
        assert all(np.isfinite(v) for v in result[part].values())


def test_random_init_floor_repeats_bit_for_bit(drive):
    data, floor = drive
    assert (floor["step"], floor["random_init"]) == (0, True)
    _check_keys(floor)
    assert _evaluate(data, "again", "", True) == floor


def test_health_run_end_to_end_at_tiny_sizes(drive):
    from muvo_tpu_torch.train import main as train_main

    data, floor = drive
    work = data.parent / "work"
    try:
        run = train_main(tiny_argv(**{
            "DATASET.DATAROOT": str(data),
            "DATASET.FILTER_BEGINNING_OF_RUN_SEC": 0.0,
            "DATASET.FILTER_NORM_REWARD": -1000.0, "LOG_DIR": str(work),
            "STEPS": 2, "LOGGING_INTERVAL": 1, "VAL_CHECK_INTERVAL": 2,
            "OPTIMIZER.ACCUMULATE_GRAD_BATCHES": 1}), device="cpu")
        assert run.step == 2
        trained = _evaluate(data, "trained",
                            str(Path(run.log_dir) / "checkpoints"), False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert (trained["step"], trained["random_init"]) == (2, False)
    _check_keys(trained)
    assert trained["recon"] != floor["recon"]


def test_collect_in_processes_writes_what_one_process_writes(tmp_path):
    small = dict(image_hw=(64, 128), lidar_points=2000)
    runs = {workers: health_run.collect(
        str(tmp_path / str(workers)), "val", 2, 5,
        seed0=health_run.VAL_SEED0, workers=workers, **small)
        for workers in (1, 2)}
    assert [Path(r).relative_to(tmp_path / "2") for r in runs[2]] == [
        Path(r).relative_to(tmp_path / "1") for r in runs[1]]
    for one, two in zip(map(Path, runs[1]), map(Path, runs[2])):
        assert _files(one) == _files(two) and _files(one)
        for path in _files(one):
            assert (one / path).read_bytes() == (two / path).read_bytes(), path


def test_constant_floor_marks_every_kept_voxel_occupied(drive):
    import torch

    from muvo_tpu_torch.data.dataset import CarlaDataset
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    data, _ = drive
    out = data.parent / "eval_constant.json"
    cfg = health_run.flagship_cfg(str(data), tiny_test_cfg())
    result = health_run.evaluate(str(data), "", False, batches=1,
                                 out_json=str(out), batch_size=1, cfg=cfg,
                                 device="cpu", constant=True)
    assert json.loads(out.read_text()) == result
    assert result["constant"] is True
    assert all(np.isfinite(v) for part in ("recon", "imagine")
               for v in result[part].values())
    # the occupied share of the kept voxels of the one scored sequence
    cfg.BATCHSIZE = 1
    trainer = WorldModelTrainer(cfg, device="cpu")
    ds = CarlaDataset(cfg, mode="val", sequence_length=(
        cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON), dataset_root=str(data))
    batch = {k: torch.as_tensor(np.asarray(v))[None]
             for k, v in ds[0].items()}
    labels = trainer.preprocess(batch, training=False)["voxel_label_1"]
    for part, frames in (("recon", labels[:, :cfg.RECEPTIVE_FIELD]),
                         ("imagine", labels[:, cfg.RECEPTIVE_FIELD:])):
        kept = frames.numpy() != 255
        share = (frames.numpy()[kept] > 0).mean()
        got = result[part]
        assert got["voxel_recall"] == 1.0
        assert got["voxel_precision"] == pytest.approx(share, rel=1e-6)
        assert got["voxel_iou"] == pytest.approx(share, rel=1e-6)


@pytest.mark.parametrize("existing", ["OUT", "DATA"])
def test_health_tool_removes_nothing(existing, tmp_path, monkeypatch):
    import tools.torch_health_run as tool

    for name in ("OUT", "DATA"):
        monkeypatch.setattr(tool, name, tmp_path / name.lower())
    there = getattr(tool, existing)
    there.mkdir()
    (there / "keep").write_text("x")
    monkeypatch.setattr(sys, "argv", ["torch_health_run.py"])
    assert tool.main() == 2
    assert (there / "keep").read_text() == "x"
    assert [p.name for p in tmp_path.iterdir()] == [there.name]
