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
import pytest
import torch

from muvo_tpu.models.stylegan import VoxelDecoder as JaxVoxelDecoder
from muvo_tpu_torch.models import stylegan
from muvo_tpu_torch.weights import style_decoder_entries, to_tensors
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
    style_decoder_entries(sd, "", params["params"], "voxel")
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


@pytest.mark.parametrize("n,stages", [(64, ("conv2", "conv3")),
                                      (256, ("conv3",))])
def test_kernel_stages_are_pallas_stages_that_fit_the_kernels(n, stages):
    """stylegan.kernel_stage puts a voxel block on K2 and K1 where its
    upsampled z exceeds 18 and its channels fit the bf16 tensor-core tile:
    conv2 and conv3 at muvo.yml's 64 feature channels, conv3 alone at the
    default config's 256 (conv2's 128 input channels do not fit). Each is
    a stage that muvo_tpu too runs on its Pallas kernels, the z-upsample
    fused (pallas_zconv_available, pallas_upzconv_available)."""
    from muvo_tpu.ops.pallas_zconv import (pallas_upzconv_available,
                                           pallas_zconv_available)

    # (small z, in, out channels) of conv1, conv2, conv3 at voxel z 64
    blocks = {"conv1": (8, n, n // 2), "conv2": (16, n // 2, n // 4),
              "conv3": (32, n // 4, n // 8)}
    got = tuple(name for name, shape in blocks.items()
                if stylegan.kernel_stage(*shape))
    assert got == stages
    for name in stages:
        zs, c, cout = blocks[name]
        assert pallas_zconv_available(2 * zs, c, cout, 8)
        assert pallas_zconv_available(2 * zs, cout, cout, 8)
        assert pallas_upzconv_available(zs, c, cout, 8)
    assert not stylegan.kernel_stage(9, 8, 8)  # z 18
    assert stylegan.kernel_stage(10, 64, 64)
    assert not stylegan.kernel_stage(10, 65, 8)
