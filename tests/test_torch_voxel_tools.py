"""The port's offline tools (muvo_tpu_torch/tools/generate_voxels.py and
preprocess_pcd.py, on the port's geometry/voxel.py) against muvo_tpu's
tools/ on one small recorded run, copied once for each: every file they
write, and the dataframe they rewrite, byte for byte."""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from muvo_tpu_torch.config import get_cfg
from muvo_tpu_torch.tools import generate_voxels, preprocess_pcd
from torch_port_common import write_recorded_run

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import tools.generate_voxels as jax_generate_voxels  # noqa: E402
import tools.preprocess_pcd as jax_preprocess_pcd  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One recorded run (muvo_tpu's DataWriter, 6 frames of 48 x 80 depth
    and 400 LiDAR points) with an episode-level point_clouds_semantic.npy,
    copied for each package's tools."""
    base = tmp_path_factory.mktemp("tools")
    run = base / "jax" / "trainval" / "train" / "Town01" / "0000"
    df = write_recorded_run(run, 6, seed=3, image_hw=(48, 80), n_points=400)
    rs = np.random.RandomState(4)
    frames = np.empty(len(df), dtype=object)
    for i in range(len(df)):
        n = int(rs.randint(50, 80))
        frames[i] = {"points_xyz": rs.uniform(-20, 20, (n, 3)).astype(
                         np.float32),
                     "ObjTag": rs.randint(0, 23, n).astype(np.uint8),
                     "ObjIdx": rs.randint(0, 9, n).astype(np.uint32),
                     "CosAngel": rs.uniform(-1, 1, n).astype(np.float32)}
    np.save(run / "point_clouds_semantic.npy", frames, allow_pickle=True)
    port = base / "port" / "trainval" / "train" / "Town01" / "0000"
    shutil.copytree(run, port)
    return run, port


def _files(run):
    return {p.relative_to(run): p.read_bytes()
            for p in sorted(run.rglob("*")) if p.is_file()}


def _assert_same_files(got_run, want_run, sub):
    got, want = _files(got_run), _files(want_run)
    assert set(got) == set(want)
    written = [p for p in want if p.parts[0] == sub]
    assert written, sub
    for path in want:
        assert got[path] == want[path], path


def test_voxel_offset_equals_muvo_tpus():
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "muvo_tpu_torch/configs/muvo.yml"))
    assert generate_voxels.voxel_offset_from_cfg(cfg.VOXEL) == (
        jax_generate_voxels.voxel_offset_from_cfg(cfg.VOXEL))


def test_preprocess_pcd_writes_muvo_tpus_files(runs):
    jax_run, port_run = runs
    jax_preprocess_pcd.process_run(str(jax_run), workers=1)
    preprocess_pcd.process_run(str(port_run), workers=1)
    _assert_same_files(port_run, jax_run, "points_semantic")


@pytest.mark.parametrize("size", [(64, 64, 32), (192, 192, 64)])
def test_generate_voxels_writes_muvo_tpus_files(runs, size):
    jax_run, port_run = runs
    args = dict(fov=110, resolution=0.2, size=list(size),
                offset=[-12.8, -6.4 * size[1] / 64, -4.0], workers=1)
    jax_generate_voxels.process_run(str(jax_run), **args)
    generate_voxels.process_run(str(port_run), **args)
    _assert_same_files(port_run, jax_run, "voxel")
    rows = np.load(port_run / "voxel" / "voxel_000000000.npy")
    assert rows.dtype == np.uint16 and rows.shape[1] == 4 and len(rows)
    assert (rows[:, :3] < np.array(size)).all()
