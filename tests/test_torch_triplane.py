"""The tri-plane voxel decoder (VoxelDecoderScale, TriPlaneVoxelDecoder)
in the port against muvo_tpu's. No model path builds it, in either
package, so it is held as a module: seeded xy, xz and yz planes at three
scales, weights through muvo_tpu_torch/weights.py, channels-last in and
out. Tolerance: fp32 on both sides, only the summation order differs:
within 1e-5 norm-relative.
"""

import numpy as np
import torch

from muvo_tpu.models.stylegan import TriPlaneVoxelDecoder as JTriPlane
from muvo_tpu.models.stylegan import VoxelDecoderScale as JScale
from muvo_tpu_torch import weights
from muvo_tpu_torch.models.stylegan import (TriPlaneVoxelDecoder,
                                            VoxelDecoderScale)
from torch_port_common import (
    assert_norm_rel,
    flax_apply,
    flax_init,
    load_entries,
    randn,
    to_torch,
)


def _planes(rs, b, c, x, y, z):
    return (randn(rs, b, x, y, c), randn(rs, b, x, z, c),
            randn(rs, b, y, z, c))


def test_voxel_decoder_scale():
    rs = np.random.RandomState(0)
    planes = _planes(rs, 2, 6, 7, 5, 4)
    jm = JScale(3, feature_channels=10)
    v = flax_init(jm, planes)
    pm = load_entries(VoxelDecoderScale(6, 3, 10),
                      weights.voxel_decoder_scale_entries, v)
    with torch.no_grad():
        got = pm(tuple(to_torch(p) for p in planes))
    assert got.shape == (2, 7, 5, 4, 3)
    assert_norm_rel(got, flax_apply(jm, v, planes))


def test_voxel_decoder_scale_softmax_is_max_subtracted():
    """Plane weights far past exp's range: the max-subtracted two-way
    softmax stays finite and still matches muvo_tpu."""
    rs = np.random.RandomState(1)
    planes = tuple(200.0 * p for p in _planes(rs, 1, 4, 3, 3, 2))
    jm = JScale(2, feature_channels=4)
    v = flax_init(jm, planes)
    pm = load_entries(VoxelDecoderScale(4, 2, 4),
                      weights.voxel_decoder_scale_entries, v)
    with torch.no_grad():
        got = pm(tuple(to_torch(p) for p in planes))
    assert torch.isfinite(got).all()
    assert_norm_rel(got, flax_apply(jm, v, planes))


def test_triplane_voxel_decoder():
    rs = np.random.RandomState(2)
    xy, xz, yz = {}, {}, {}
    for s, (x, y, z) in {1: (8, 6, 4), 2: (4, 3, 2), 4: (2, 2, 1)}.items():
        xy[f"rgb_{s}"], xz[f"rgb_{s}"], yz[f"rgb_{s}"] = _planes(
            rs, 2, 8, x, y, z)
    jm = JTriPlane(3, feature_channels=12)
    v = flax_init(jm, xy, xz, yz)
    pm = load_entries(TriPlaneVoxelDecoder(8, 3, 12),
                      weights.triplane_entries, v)
    with torch.no_grad():
        got = pm(*({k: to_torch(a) for k, a in d.items()}
                   for d in (xy, xz, yz)))
    want = flax_apply(jm, v, xy, xz, yz)
    assert set(got) == set(want) == {"voxel_1", "voxel_2", "voxel_4"}
    for key in want:
        assert_norm_rel(got[key], want[key])
    assert "decoder_4.classifier.2.bias" in pm.state_dict()
