"""The port's VoxelDecoder against muvo_tpu's z-folded Pallas trunk
(MUVO_CONV3D=pallas, interpret mode off-TPU, as in
tests/test_pallas_zconv.py), at feature_channels=16 and constant_size
(1, 1, 1): the conv2 and conv3 stages (z 32 and 64) take the kernel path
on both sides.

Tolerance: norm-relative 2e-3, as muvo_tpu's own folded-vs-XLA voxel test:
the normal(1.0) constant and eps-1e-8 instance norms amplify fp32
summation-order noise through nine conv stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from muvo_tpu.models.stylegan import VoxelDecoder as JaxVoxelDecoder
from muvo_tpu_torch.models import stylegan
from muvo_tpu_torch.weights import to_tensors, voxel_decoder_entries
from torch_port_common import randomise


def _pair(monkeypatch):
    monkeypatch.setenv("MUVO_CONV3D", "pallas")
    jm = JaxVoxelDecoder(latent_n_channels=8, semantic_n_channels=2,
                         feature_channels=16, constant_size=(1, 1, 1))
    w = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    params = randomise(jax.device_get(
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(w))))
    pm = stylegan.VoxelDecoder(8, 2, 16, (1, 1, 1))
    sd = {}
    voxel_decoder_entries(sd, "", params["params"])
    pm.load_state_dict(to_tensors(sd), strict=True)
    return jm, params, pm.eval(), w


def test_voxel_decoder_matches_pallas_trunk(monkeypatch):
    jm, params, pm, w = _pair(monkeypatch)
    want = jax.jit(jm.apply)(params, jnp.asarray(w))
    with torch.no_grad():
        got = pm(torch.from_numpy(w))
    assert set(got) == set(want) == {"voxel_1", "voxel_2", "voxel_4"}
    assert got["voxel_1"].shape == (2, 64, 64, 64, 2)
    for key in want:
        g, v = got[key].numpy(), np.asarray(want[key])
        assert g.shape == v.shape
        rel = np.abs(g - v).max() / max(1.0, np.abs(v).max())
        assert rel < 2e-3, (key, rel)


def test_kernel_stages_route_through_k1_and_k2(monkeypatch):
    """conv2 and conv3 (z 32, 64) call K2 then K1; the earlier stages
    (z <= 16) use F.conv3d, as muvo_tpu keeps them off its Pallas path."""
    _, _, pm, w = _pair(monkeypatch)
    calls = []

    def spy(name, fn):
        def wrapped(x, weight, bias, slope):
            calls.append((name, tuple(x.shape)))
            return fn(x, weight, bias, slope)
        return wrapped

    monkeypatch.setattr(stylegan, "zconv3d_leaky",
                        spy("K1", stylegan.zconv3d_leaky))
    monkeypatch.setattr(stylegan, "upzconv3d_leaky",
                        spy("K2", stylegan.upzconv3d_leaky))
    with torch.no_grad():
        pm(torch.from_numpy(w))
    assert calls == [
        ("K2", (2, 32, 32, 16, 8)), ("K1", (2, 32, 32, 32, 4)),
        ("K2", (2, 64, 64, 32, 4)), ("K1", (2, 64, 64, 64, 2)),
    ]
