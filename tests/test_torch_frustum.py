"""The port's frustum pooling (muvo_tpu_torch/models/frustum.py), the
closed-form inverse of the intrinsics and BevDownSample4 against
muvo_tpu's, on inputs from numpy seeds.

The ego-frame geometry of the frustum must be muvo_tpu's bit for bit
(the port rounds its float64 arithmetic where muvo_tpu's compiled graph
rounds), and the cell of every frustum point muvo_tpu's exactly, on
random camera poses whose points include some within 1e-4 of a cell edge
and some with a coordinate in (-1, 0), which both truncate to cell 0.
muvo_tpu's cells are read from its own module: the index array it hands
``jax.vmap`` for the segment sum. Tolerances, fp32: the pooled BEV and its
gradients within 1e-5 * max(1, max |jax|) (the order of the sums
differs), get_depth_map within 1e-5, BevDownSample4 within 1e-4 (two 5x5
convs), the inverse of the intrinsics bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muvo_tpu.models.frustum as jax_frustum
from muvo_tpu.geometry.camera import intrinsics_inverse as jax_inverse
from muvo_tpu.models.common import BevDownSample4 as JBevDownSample4
from muvo_tpu_torch import weights
from muvo_tpu_torch.geometry.camera import intrinsics_inverse
from muvo_tpu_torch.models.common import BevDownSample4
from muvo_tpu_torch.models.frustum import FrustumPooling
from torch_port_common import close, flax_apply, flax_init, randn, to_torch

# muvo.yml's lifting: a 48 x 48 grid of 0.8 m cells (BEV.SIZE 192 / 4),
# 37 depth bins over 40 x 104 stride-8 features of the 320 x 832 crop
GRID = dict(size=(48, 48), scale=0.8, offsetx=-16.0,
            dbound=[1.0, 38.0, 1.0], downsample=8)
FH, FW = 40, 104


def _modules(sparse=True):
    return (jax_frustum.FrustumPooling(**GRID, sparse=sparse),
            FrustumPooling(**GRID, sparse=sparse))


def _rotation(rs, scale):
    """A camera -> ego rotation: the camera's (right, down, forward) to
    (forward, left, up), turned by small random angles."""
    a, b, c = rs.uniform(-scale, scale, 3)
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0],
                   [0, 0, 1]])
    base = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    return rz @ ry @ rx @ base


def _cameras(seed, b=6):
    """Intrinsics of the 320 x 832 crop with jittered focal lengths and
    centres, and camera -> ego poses: muvo.yml's rig, then random ones."""
    rs = np.random.RandomState(seed)
    k = np.zeros((b, 3, 3), np.float32)
    f = 960 / (2 * np.tan(100 * np.pi / 360))
    k[:, 0, 0] = f + rs.uniform(-40, 40, b)
    k[:, 1, 1] = f + rs.uniform(-40, 40, b)
    k[:, 0, 2] = 416 + rs.uniform(-20, 20, b)
    k[:, 1, 2] = 162 + rs.uniform(-20, 20, b)
    k[:, 2, 2] = 1
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    for i in range(b):
        pose[i, :3, :3] = _rotation(rs, 0.0 if i == 0 else 0.3)
        pose[i, :3, 3] = (1.0, 0.0, 2.0) if i == 0 else rs.uniform(-3, 3, 3)
    return k, pose


def _depth(rs, b, ties=False):
    """A softmax over the depth bins; with ``ties`` the logits take a few
    values, so that bins tie at the k-th largest."""
    logits = rs.randn(b, FH, FW, 37).astype(np.float32) * 2
    if ties:
        logits = np.round(logits)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _jax_cells(jfp, x, depth, k, pose):
    """muvo_tpu's pooled BEV and the flat cell index of every frustum
    point (n_vox for the points outside the grid), as its module computes
    them under jit: the index array it passes to ``jax.vmap``."""

    class Recorder:
        idx = None

        def __getattr__(self, name):
            return getattr(jax, name)

        def vmap(self, fn):
            def run(idx, feat):
                Recorder.idx = idx
                return jax.vmap(fn)(idx, feat)
            return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_frustum, "jax", Recorder())
    try:
        bev, idx = jax.jit(lambda *a: (jfp(*a), Recorder.idx))(
            x, depth, k, pose)
    finally:
        mp.undo()
    return np.asarray(bev), np.asarray(idx).reshape(len(x), -1)


def test_intrinsics_inverse():
    k, _ = _cameras(0)
    got = intrinsics_inverse(torch.from_numpy(k)).numpy()
    want = np.asarray(jax.jit(jax_inverse)(k))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got @ k, np.broadcast_to(np.eye(3), k.shape),
                               atol=1e-6)


@pytest.mark.parametrize("fh,fw", [(FH, FW), (8, 16), (13, 26), (5, 7)])
def test_frustum_grid(fh, fw):
    jfp, pfp = _modules()
    got = pfp.frustum(fh, fw).numpy()
    want = np.asarray(jax.jit(jfp.frustum, static_argnums=(0, 1))(fh, fw))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_geometry_equals_muvo_tpu_bit_for_bit():
    """The ego-frame xyz of every frustum point, as muvo_tpu's compiled
    get_geometry rounds it (fused multiply-adds): the same float32 bits."""
    jfp, pfp = _modules()
    k, pose = _cameras(2)
    want = np.asarray(jax.jit(jfp.get_geometry)(
        jfp.frustum(FH, FW), pose[:, :3, :3], pose[:, :3, 3], k))
    got = pfp.get_geometry(pfp.frustum(FH, FW),
                           torch.from_numpy(pose[:, :3, :3]),
                           torch.from_numpy(pose[:, :3, 3]),
                           torch.from_numpy(k)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_indices_equal(seed):
    jfp, pfp = _modules()
    k, pose = _cameras(seed)
    rs = np.random.RandomState(seed)
    x = randn(rs, len(k), FH, FW, 4)
    _, want = _jax_cells(jfp, x, _depth(rs, len(k)), k, pose)
    flat, valid = pfp.cells(FH, FW, torch.from_numpy(k),
                            torch.from_numpy(pose))
    n_vox = 48 * 48
    got = torch.where(valid, flat, n_vox).numpy()
    np.testing.assert_array_equal(got, want)
    # the poses reach the cases the truncation decides: points within 1e-4
    # of a cell edge, and points with x or y in (-1, 0) kept in cell 0
    geom = pfp.get_geometry(pfp.frustum(FH, FW),
                            torch.from_numpy(pose[:, :3, :3]),
                            torch.from_numpy(pose[:, :3, 3]),
                            torch.from_numpy(k)).reshape(len(k), -1, 3)
    a = pfp.bev_affine
    g = torch.stack([geom[..., 0] * a[0] + a[1],
                     geom[..., 1] * a[2] + a[3]], -1).numpy()
    inside = valid.numpy()[..., None]
    assert (inside & (np.abs(g - np.round(g)) < 1e-4)).sum() > 0
    assert (inside & (g > -1) & (g < 0)).sum() > 0
    assert 0.05 < valid.numpy().mean() < 0.95


@pytest.mark.parametrize("sparse,ties", [(True, False), (True, True),
                                         (False, False)])
def test_pooled_bev(sparse, ties):
    jfp, pfp = _modules(sparse)
    k, pose = _cameras(3, b=3)
    rs = np.random.RandomState(4)
    x = randn(rs, 3, FH, FW, 8)
    depth = _depth(rs, 3, ties)
    if ties:  # bins tying at the 10th largest
        kth = np.sort(depth, -1)[..., -10:-9]
        assert ((depth == kth).sum(-1) > 1).mean() > 0.1
    want = np.asarray(jax.jit(jfp.__call__)(x, depth, k, pose))
    got = pfp(*(torch.from_numpy(a) for a in (x, depth, k, pose)))
    assert got.shape == want.shape == (3, 48, 48, 8)
    assert got.dtype == torch.float32
    close(got, want, 1e-5)
    assert np.abs(want).max() > 0


def test_pooled_bev_gradients():
    jfp, pfp = _modules()
    k, pose = _cameras(5, b=2)
    rs = np.random.RandomState(6)
    x, depth = randn(rs, 2, FH, FW, 4), _depth(rs, 2)
    cot = randn(rs, 2, 48, 48, 4)

    def loss(x, depth):
        return jnp.sum(jfp(x, depth, k, pose) * cot)

    want_x, want_d = jax.jit(jax.grad(loss, (0, 1)))(x, depth)
    tx = torch.from_numpy(x).requires_grad_()
    td = torch.from_numpy(depth).requires_grad_()
    (pfp(tx, td, torch.from_numpy(k), torch.from_numpy(pose))
     * torch.from_numpy(cot)).sum().backward()
    close(tx.grad, want_x, 1e-5)
    close(td.grad, want_d, 1e-5)
    assert np.abs(np.asarray(want_d)).max() > 0


def test_geometry_stays_fp32_under_bf16_autocast():
    _, pfp = _modules()
    k, pose = _cameras(7, b=2)
    rs = np.random.RandomState(8)
    x = torch.from_numpy(randn(rs, 2, FH, FW, 4))
    depth = torch.from_numpy(_depth(rs, 2))
    args = (torch.from_numpy(k), torch.from_numpy(pose))
    want = pfp(x, depth, *args)
    with torch.autocast("cpu", torch.bfloat16):
        got = pfp(x.bfloat16(), depth, *args)
        cells = pfp.cells(FH, FW, *args)
    assert got.dtype == torch.bfloat16
    for a, b in zip(cells, pfp.cells(FH, FW, *args)):
        assert torch.equal(a, b)
    close(got.float(), want.numpy(), 1e-2)


def test_get_depth_map():
    jfp, pfp = _modules()
    depth = _depth(np.random.RandomState(9), 2)[:, :10, :12]
    want = np.asarray(jax.jit(jfp.get_depth_map)(depth))
    got = pfp.get_depth_map(torch.from_numpy(depth))
    assert got.shape == want.shape == (2, 80, 96, 1)
    close(got, want, 1e-5)


def test_bev_down_sample_4():
    x = randn(np.random.RandomState(10), 2, 48, 48, 32)
    jm = JBevDownSample4(24)
    v = flax_init(jm, x)
    sd = {}
    for i, key in enumerate(("0", "2")):
        weights.conv_bias_entries(sd, f"{key}.", v["params"][f"Conv_{i}"])
    pm = BevDownSample4(32, 24)
    pm.load_state_dict(weights.to_tensors(sd), strict=True)
    want = flax_apply(jm, v, x)
    with torch.no_grad():
        got = pm(to_torch(x))
    assert got.shape == want.shape == (2, 12, 12, 24)
    close(got, want, 1e-4)
