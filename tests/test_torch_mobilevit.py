"""The port's MobileViTV2 trunk against muvo_tpu's, and the whole tiny
model with MobileViTV2 camera and LiDAR encoders (test_mobilevit_2d.yml's
swap at tiny_test_cfg's sizes, the voxel decoder off).

Weights go through muvo_tpu_torch/weights.py; inputs come from numpy
seeds. Tolerance: fp32 on both sides, differing only in summation order:
the trunk within 1e-4 * max(1, max |jax|), its running statistics after a
training pass within 1e-5; the whole graph's outputs 1e-3 norm-relative
and each loss term 1e-4 relative, as the port's other whole-graph tests.
"""

import jax
import numpy as np
import pytest
import torch

from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.models.backbones.mobilevit import (
    MobileViTV2Features as JMobileViT,
)
from muvo_tpu_torch import weights
from muvo_tpu_torch.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu_torch.models.backbones.mobilevit import MobileViTV2Features
from muvo_tpu_torch.models.backbones.resnet import build_backbone
from torch_port_common import (
    assert_whole_graph,
    close,
    flax_apply,
    flax_init,
    load_entries,
    randn,
    to_torch,
    whole_graph,
)


@pytest.mark.parametrize("shape", [
    (2, 64, 128, 3),  # every map even
    (1, 72, 40, 3),   # 9 x 5 at stride 8: each MobileViT block resizes up
])
def test_mobilevit_features(shape):
    x = randn(np.random.RandomState(0), *shape)
    jm = JMobileViT(out_indices=(0, 1, 2, 3, 4))
    v = flax_init(jm, x)
    pm = load_entries(MobileViTV2Features((0, 1, 2, 3, 4), shape[-1]),
                      weights.mobilevit_entries, v)
    with torch.no_grad():
        got = pm(to_torch(x))
    want = flax_apply(jm, v, x)
    assert [g.shape[-1] for g in got] == [64, 128, 256, 384, 512]
    for g, w in zip(got, want):
        close(g, w)
    if shape[1] == 72:  # odd maps resized up in each block, and kept
        assert [tuple(g.shape[1:3]) for g in got[2:]] == [(10, 6), (6, 4),
                                                          (4, 2)]


def test_mobilevit_training_pass_and_running_statistics():
    """BatchNorm on batch statistics and flax's running update, on the
    range view's four channels."""
    x = randn(np.random.RandomState(3), 2, 32, 64, 4)
    jm = JMobileViT()
    v = flax_init(jm, x)
    pm = load_entries(MobileViTV2Features(in_channels=4),
                      weights.mobilevit_entries, v)
    want, updated = jax.jit(lambda v, x: jm.apply(
        v, x, True, mutable=["batch_stats"]))(v, x)
    got = pm.train()(to_torch(x))
    for g, w in zip(got, want):
        close(g, w)
    sd = {}
    weights.mobilevit_entries(sd, "", v["params"],
                              jax.device_get(updated["batch_stats"]))
    state = pm.state_dict()
    for key, w in weights.running_stats(weights.to_tensors(sd)).items():
        close(state[key], w.numpy(), 1e-5)


def test_build_backbone_dispatches_mobilevit():
    trunk, channels = build_backbone("mobilevitv2_100", (2, 3, 4), 32)
    assert isinstance(trunk, MobileViTV2Features)
    assert channels == [256, 384, 512]
    assert trunk.stem.conv.in_channels == 32
    keys = set(trunk.state_dict())
    for key in ("stem.conv.weight", "stem.bn.running_var",
                "stages.1.1.conv2_kxk.conv.weight",
                "stages.2.1.transformer.1.attn.qkv_proj.weight",
                "stages.3.1.transformer.3.mlp.fc2.bias",
                "stages.4.1.norm.weight", "stages.4.1.conv_proj.bn.bias"):
        assert key in keys, key
    # resnet34 is a resnet trunk now; a name muvo_tpu does not know raises
    assert not isinstance(build_backbone("resnet34")[0], MobileViTV2Features)
    with pytest.raises(ValueError, match="resnet50"):
        build_backbone("resnet50")


def _mobilevit_cfgs():
    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    for cfg in (jcfg, pcfg):
        cfg.PRECISION = "32"
        cfg.MODEL.TRANSITION.USE_DROPOUT = False
        cfg.MODEL.ENCODER.NAME = "mobilevitv2_100"
        cfg.MODEL.LIDAR.ENCODER = "mobilevitv2_100"
        cfg.MODEL.DECODER_BASE_CHANNELS = 64
        cfg.VOXEL_SEG.ENABLED = False
    return jcfg, pcfg


def test_whole_graph_with_mobilevit_encoders():
    jcfg, pcfg = _mobilevit_cfgs()
    batch = synthetic_batch(pcfg, 1, 2, seed=2)
    got, losses, want, want_losses, on_jax = whole_graph(jcfg, pcfg, batch)
    assert_whole_graph(got, losses, want, want_losses, on_jax)
    assert {"rgb_1", "lidar_re_4", "probabilistic"} <= set(losses)
