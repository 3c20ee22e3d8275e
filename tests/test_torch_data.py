"""The port's data pipeline against muvo_tpu's, on the CPU.

A recording in the CARLA dataset's layout, written by muvo_tpu's
DataWriter at tiny_test_cfg's sizes (96x160 images, 500 points a frame,
64^3 voxel rows; tests/torch_port_common.py:write_recorded_run): two
training runs (one with a corrupted image PNG), a third whose mean reward
fails the filter, and a val0 run. Every comparison is exact: the same
keys, the same dtypes, the same bits.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from muvo_tpu import native as jax_native
from muvo_tpu.data import datamodule as jax_datamodule
from muvo_tpu.data import dataset as jax_dataset
from muvo_tpu.data import dataset_utils as jax_utils
from muvo_tpu.data import frame_cache as jax_frame_cache
from muvo_tpu.data import loader as jax_loader
from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.geometry import camera as jax_camera
from muvo_tpu.geometry import voxel as jax_voxel
from muvo_tpu.geometry.range_view import RangeProjector as JaxProjector
from muvo_tpu_torch import native
from muvo_tpu_torch.data import datamodule, dataset, dataset_utils, frame_cache
from muvo_tpu_torch.data import loader
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.geometry import camera, voxel
from muvo_tpu_torch.geometry.range_view import RangeProjector
from torch_port_common import write_recorded_run

SEQ = 3  # tiny_test_cfg: RECEPTIVE_FIELD 2 + FUTURE_HORIZON 1
BAD_RUN, BAD_FRAME = "Town02/0001", 5  # its image PNG is cut short
# decode branches: tiny_test_cfg's (range view, voxels), every other branch
# of _load_frame, and the raw points of POINTS.DEVICE_PROJECTION
VARIANTS = {
    "tiny": {},
    "all_branches": {"SEMANTIC_SEG.ENABLED": True, "LIDAR_SEG.ENABLED": True,
                     "DEPTH.ENABLED": True, "SEMANTIC_IMAGE.ENABLED": True,
                     "LOSSES.RGB_INSTANCE": True,
                     "MODEL.LIDAR.POINT_PILLAR.ENABLED": True},
    "device_projection": {"POINTS.DEVICE_PROJECTION": True},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("carla")
    train = root / "trainval" / "train"
    write_recorded_run(train / "Town01" / "0000", 16, seed=0)
    write_recorded_run(train / BAD_RUN, 12, seed=1)
    write_recorded_run(train / "Town02" / "0002", 8, seed=2, reward=0.3)
    write_recorded_run(root / "trainval" / "val0" / "Town01" / "0000", 10,
                       seed=3)
    png = train / BAD_RUN / "image" / f"image_{BAD_FRAME:09d}.png"
    png.write_bytes(png.read_bytes()[:200])
    return str(root)


def _cfgs(variant="tiny"):
    """(the port's, muvo_tpu's) tiny_test_cfg with ``variant``'s changes."""
    overrides = {"DATASET.FILTER_BEGINNING_OF_RUN_SEC": 0.0,
                 **VARIANTS[variant]}
    out = []
    for make in (tiny_test_cfg, jax_tiny_cfg):
        cfg = make()
        for key, value in overrides.items():
            node = cfg
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = value
        out.append(cfg)
    return out


def _datasets(root, variant="tiny", mode="train"):
    pcfg, jcfg = _cfgs(variant)
    return (dataset.CarlaDataset(pcfg, mode, SEQ, dataset_root=root),
            jax_dataset.CarlaDataset(jcfg, mode, SEQ, dataset_root=root))


def assert_items_equal(got, want, what=""):
    assert set(got) == set(want), what
    for key, w in want.items():
        g = np.asarray(got[key])
        w = np.asarray(w)
        assert g.dtype == w.dtype, (what, key, g.dtype, w.dtype)
        assert g.shape == w.shape, (what, key)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


# -- geometry, native code, label helpers -----------------------------------
def _points(seed=0, n=4000):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-40, 40, (n, 3))
    pts[:, 2] = rs.uniform(-3, 6, n)
    pts[n // 2:] = pts[: n - n // 2] * 1.5  # shared pixels, other depths
    return pts, rs.randint(0, 23, n).astype(np.uint8)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_range_projection_equals_muvo_tpu(path):
    args = (64, 128, -30.0, 10.0, (1.0, 0.0, 2.0))
    port, ref = RangeProjector(*args), JaxProjector(*args)
    pts, sem = _points()
    if path == "native":
        assert native.available() and jax_native.available()
        got, want = port.project(pts, sem), ref.project(pts, sem)
    else:
        got, want = port.project_numpy(pts, sem), ref.project_numpy(pts, sem)
    assert (got[0] > 0).sum() > 1000  # most pixels hit
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_voxel_functions_equal_muvo_tpu():
    rs = np.random.RandomState(1)
    coords = rs.randint(0, 32, (500, 3)).astype(np.uint16)
    sems = rs.randint(0, 23, 500).astype(np.uint8)
    for k in (500, 0):
        got = voxel.densify_voxels(coords[:k], sems[:k], (32, 32, 32))
        want = jax_voxel.densify_voxels(coords[:k], sems[:k], (32, 32, 32))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    pts, sem = _points(2)
    for g, w in zip(voxel.voxel_filter(pts, sem, 0.5, (64, 64, 32),
                                       (0.0, 0.0, 0.0)),
                    jax_voxel.voxel_filter(pts, sem, 0.5, (64, 64, 32),
                                           (0.0, 0.0, 0.0))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    rgb = rs.randint(0, 255, (8, 12, 3), dtype=np.uint8)
    np.testing.assert_array_equal(voxel.decode_depth(rgb),
                                  jax_voxel.decode_depth(rgb))
    np.testing.assert_array_equal(
        voxel.mask_ego_box(pts, sem)[0], jax_voxel.mask_ego_box(pts, sem)[0])


def test_dataset_utils_equal_muvo_tpu():
    rs = np.random.RandomState(2)
    bits = rs.randint(0, 2, (300, 8)).astype(np.float32)
    ints = rs.randint(0, 256, 300)
    masks = rs.choice(np.array([0, 80, 170, 255], np.uint8), (2, 15, 16, 16))
    pairs = [
        (dataset_utils.binary_to_integer(bits, 8),
         jax_utils.binary_to_integer(bits, 8)),
        (dataset_utils.integer_to_binary(ints, 8),
         jax_utils.integer_to_binary(ints, 8)),
        (dataset_utils.calculate_birdview_labels(bits.T.reshape(8, 15, 20), 8),
         jax_utils.calculate_birdview_labels(bits.T.reshape(8, 15, 20), 8)),
        (dataset_utils.calculate_birdview_labels(
            bits.T.reshape(1, 8, 15, 20), 8, True),
         jax_utils.calculate_birdview_labels(
             bits.T.reshape(1, 8, 15, 20), 8, True)),
        *zip(dataset_utils.preprocess_birdview_and_routemap(masks),
             jax_utils.preprocess_birdview_and_routemap(masks)),
        *zip(dataset_utils.preprocess_birdview_and_routemap(masks[0]),
             jax_utils.preprocess_birdview_and_routemap(masks[0])),
        (dataset_utils.calculate_instance_mask(ints % 12, 10, 4),
         jax_utils.calculate_instance_mask(ints % 12, 10, 4)),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["tiny", "muvo.yml"])
def test_camera_geometry_equals_muvo_tpu(variant):
    pcfg, jcfg = _cfgs()
    if variant == "muvo.yml":
        for cfg in (pcfg, jcfg):
            cfg.merge_from_file("muvo_tpu/configs/muvo.yml")
    for g, w in zip(camera.calculate_geometry_from_config(pcfg),
                    jax_camera.calculate_geometry_from_config(jcfg)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    args = ((200, 200), 0.2, 12)
    np.testing.assert_array_equal(camera.bev_params_to_intrinsics(*args),
                                  jax_camera.bev_params_to_intrinsics(*args))
    with pytest.raises(ValueError, match="zero-rotation"):
        camera.get_extrinsics(1.0, 0.0, 2.0, 5.0, 0.0, 0.0)


# -- datasets -----------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_carla_dataset_equals_muvo_tpu(root, variant):
    port, ref = _datasets(root, variant)
    assert port.data_pointers == ref.data_pointers
    assert len(port) == 10 + 6  # the low-reward run is filtered
    for i in range(len(ref)):
        assert_items_equal(port[i], ref[i], f"{variant} item {i}")


def test_bad_frame_falls_back_to_the_same_neighbour(root):
    port, ref = _datasets(root)
    bad = [i for i, (run, idx) in enumerate(port.data_pointers)
           if run == BAD_RUN and BAD_FRAME in idx]
    assert bad
    n = len(port)
    for i in bad:  # the next sample without the frame, wrapping around
        j = next((i + a) % n for a in range(n)
                 if (i + a) % n not in bad)
        got = port[i]
        assert_items_equal(got, ref[i], f"item {i}")
        assert_items_equal(got, port[j], f"item {i} is item {j}")


def test_frame_cache_equals_muvo_tpu_and_is_shared(root, tmp_path):
    pcfg, jcfg = _cfgs()
    plain = dataset.CarlaDataset(pcfg, "train", SEQ, dataset_root=root)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    port = frame_cache.CachedCarlaDataset(pcfg, "train", SEQ,
                                          dataset_root=root,
                                          cache_dir=port_dir)
    ref = jax_frame_cache.CachedCarlaDataset(jcfg, "train", SEQ,
                                             dataset_root=root,
                                             cache_dir=jax_dir)
    assert frame_cache.decode_fingerprint(port) == (
        jax_frame_cache.decode_fingerprint(ref))
    for i in range(len(ref)):
        assert_items_equal(port[i], ref[i], f"item {i}")
        assert_items_equal(port[i], plain[i], f"item {i} decoded")

    # each package reads the other's cache without building its own
    def no_build(*args, **kwargs):
        raise AssertionError("a cache that the other package built was "
                             "rebuilt")

    mp = pytest.MonkeyPatch()
    mp.setattr(frame_cache, "build_run_cache", no_build)
    mp.setattr(jax_frame_cache, "build_run_cache", no_build)
    try:
        cross = (frame_cache.CachedCarlaDataset(
                     pcfg, "train", SEQ, dataset_root=root,
                     cache_dir=jax_dir),
                 jax_frame_cache.CachedCarlaDataset(
                     jcfg, "train", SEQ, dataset_root=root,
                     cache_dir=port_dir))
        for i in range(len(ref)):
            for ds in cross:
                assert_items_equal(ds[i], ref[i], f"cross item {i}")
    finally:
        mp.undo()


def test_make_dataset_picks_the_same_class(root, tmp_path):
    pcfg, jcfg = _cfgs()
    for cfg in (pcfg, jcfg):
        cfg.DATASET.DATAROOT = root
    assert type(dataset.make_dataset(pcfg, "val0", SEQ)).__name__ == (
        type(jax_dataset.make_dataset(jcfg, "val0", SEQ)).__name__)
    for cfg in (pcfg, jcfg):
        cfg.DATASET.FRAME_CACHE = str(tmp_path)
    got = dataset.make_dataset(pcfg, "val0", SEQ)
    assert isinstance(got, frame_cache.CachedCarlaDataset)
    assert got.cache_dir == os.path.join(str(tmp_path), "val0")
    for cfg in (pcfg, jcfg):
        cfg.DATASET.DATAROOT = "synthetic"
    got = dataset.make_dataset(pcfg, "train", SEQ)
    want = jax_dataset.make_dataset(jcfg, "train", SEQ)
    assert len(got) == len(want)
    assert_items_equal(got[3], want[3], "synthetic item 3")


# -- the loader ---------------------------------------------------------------
def _loaders(ds_pair, **kwargs):
    return (loader.DataLoader(ds_pair[0], **kwargs),
            jax_loader.DataLoader(ds_pair[1], **kwargs))


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (5, 3)])
def test_loader_batch_order_equals_muvo_tpu(root, seed, epoch):
    port, ref = _loaders(_datasets(root), batch_size=2, seed=seed)
    for lo in (port, ref):
        lo.set_epoch(epoch)
    assert port._indices() == ref._indices()
    assert len(port) == len(ref) == 8
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 8
    for b, (g, w) in enumerate(zip(got, want)):
        assert_items_equal(g, w, f"batch {b}")


def test_loader_resume_threads_and_process_slices(root):
    ds = _datasets(root)[0]
    full = list(loader.DataLoader(ds, 3, seed=1))
    assert len(full) == 5
    for k in (0, 2, 4, 5):
        tail = list(loader.DataLoader(ds, 3, seed=1).iter_from(k))
        assert len(tail) == len(full) - k
        for g, w in zip(tail, full[k:]):
            assert_items_equal(g, w)
    threaded = list(loader.DataLoader(ds, 3, seed=1, num_workers=2))
    assert len(threaded) == len(full)
    for g, w in zip(threaded, full):
        assert_items_equal(g, w)
    # process p of P loads the p-th contiguous slice of each global batch
    indices = loader.DataLoader(ds, 4, seed=1)._indices()
    for pi in range(2):
        kwargs = dict(seed=1, process_index=pi, process_count=2,
                      drop_last=False)
        port = loader.DataLoader(ds, 4, **kwargs)
        ref = jax_loader.DataLoader(ds, 4, **kwargs)
        assert len(port) == len(ref) == 4
        for b in range(5):
            assert port._local_chunk(indices, b) == (
                ref._local_chunk(indices, b))


class _CountingDataset:
    """Small items that take a moment to decode, counted as decoded."""

    def __init__(self, n, delay=0.002):
        self.n, self.delay = n, delay
        self.decoded = 0
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        with self.lock:
            self.decoded += 1
        return {"x": np.full((4,), i, np.int64)}


@pytest.mark.parametrize("workers", [1, 3])
def test_abandoned_iterator_stops_its_workers(workers):
    ds = _CountingDataset(200)
    it = loader.DataLoader(ds, 1, num_workers=workers).iter_from(0)
    next(it)
    time.sleep(0.2)  # the workers run ahead as far as they may
    it.close()
    last, settled = -1, time.monotonic()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:  # until no worker decodes for 1.5 s
        if ds.decoded != last:
            last, settled = ds.decoded, time.monotonic()
        elif time.monotonic() - settled > 1.5:
            break
        time.sleep(0.05)
    assert time.monotonic() < deadline
    assert ds.decoded - 1 <= 2 * workers + 2, ds.decoded


def test_threaded_loader_order_under_many_switching_workers():
    ds = _CountingDataset(96, delay=0.0)
    want = [b["x"].copy() for b in loader.DataLoader(ds, 4, seed=2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(loader.DataLoader(ds, 4, seed=2, num_workers=12))
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"], w)


def test_device_prefetch_moves_nothing_on_the_cpu():
    batches = [{"x": np.arange(3)}, {"x": np.arange(4)}]
    got = list(loader.device_prefetch(iter(batches), "cpu"))
    assert len(got) == 2 and all(g is w for g, w in zip(got, batches))


def test_process_info_reads_torch_distributed(monkeypatch):
    import torch.distributed as dist

    assert loader._process_info() == (0, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert loader._process_info() == (1, 4)
    assert loader.DataLoader(_CountingDataset(8), 4).process_index == 1


# -- samplers -----------------------------------------------------------------
@pytest.mark.parametrize("lengths", [[0, 0, 0], [10, 1600, 3100],
                                     [60, 1501, 2999], [5000, 5000, 5000]])
def test_samplers_equal_muvo_tpu(lengths):
    assert datamodule.make_val_samplers(lengths) == (
        jax_datamodule.make_val_samplers(lengths))
    for n in lengths:
        assert datamodule.make_test_samplers(n) == (
            jax_datamodule.make_test_samplers(n))


def test_datamodule_loaders_equal_muvo_tpu(root):
    pcfg, jcfg = _cfgs()
    port = datamodule.DataModule(pcfg, dataset_root=root)
    ref = jax_datamodule.DataModule(jcfg, dataset_root=root)
    for cfg in (pcfg, jcfg):
        cfg.DATASET.DATAROOT = root
    port.setup()
    ref.setup()
    assert port.val_samplers == ref.val_samplers
    assert port.test_samplers == ref.test_samplers
    for got, want in zip(port.val_dataloaders(), ref.val_dataloaders()):
        assert got.sampler == want.sampler and len(got) == len(want)
        for g, w in zip(got, want):
            assert_items_equal(g, w)
