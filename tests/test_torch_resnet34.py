"""The port's resnet34 trunk against muvo_tpu's: build_backbone("resnet34")
with BasicBlocks (3, 4, 6, 3) and resnet18's channels, at every stride,
on RGB (3 channels) and the range view (4), in eval mode and after a
training pass (its BatchNorm running statistics), and in each backbone
slot muvo_tpu builds it in.

Weights go through muvo_tpu_torch/weights.py; inputs come from numpy
seeds. Tolerance: fp32 on both sides, only the summation order differs:
every feature map within 1e-5 norm-relative in eval mode; in a training
pass (BatchNorm on the batch's statistics, which at layer4 cover 12
positions a channel and scale rounding up) within 1e-4, and the running
statistics after it within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from muvo_tpu.models.backbones.resnet import build_backbone as jax_backbone
from muvo_tpu_torch import weights
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.models.backbones.resnet import build_backbone
from muvo_tpu_torch.models.world_model import MuvoWorldModel
from torch_port_common import (
    assert_norm_rel,
    flax_apply,
    flax_init,
    load_entries,
    randn,
    to_torch,
)

ALL = (0, 1, 2, 3, 4)


@pytest.mark.parametrize("in_channels", [3, 4])
def test_resnet34_features(in_channels):
    x = randn(np.random.RandomState(in_channels), 2, 64, 96, in_channels)
    jm, info = jax_backbone("resnet34", out_indices=ALL)
    v = flax_init(jm, x)
    module, channels = build_backbone("resnet34", ALL, in_channels)
    pm = load_entries(module, weights.resnet_entries, v)
    assert channels == [i["num_chs"] for i in info] == [64, 64, 128, 256,
                                                        512]
    assert [len(getattr(pm, f"layer{i}")) for i in (1, 2, 3, 4)] == [3, 4,
                                                                      6, 3]
    with torch.no_grad():
        got = pm(to_torch(x))
    for g, w in zip(got, flax_apply(jm, v, x)):
        assert_norm_rel(g, w)


def test_resnet34_running_statistics_after_a_training_pass():
    x = randn(np.random.RandomState(5), 2, 64, 96, 3)
    jm, _ = jax_backbone("resnet34", out_indices=(4,))
    v = flax_init(jm, x)
    pm = load_entries(build_backbone("resnet34", (4,))[0],
                      weights.resnet_entries, v).train()
    with torch.no_grad():
        got = pm(to_torch(x))[0]
    want, moved = jax.jit(lambda v, x: jm.apply(
        v, x, True, mutable=["batch_stats"]))(v, x)
    # on batch statistics, over 2 x 2 x 3 positions at layer4
    assert_norm_rel(got, want[0], 1e-4)
    sd = {}
    weights.resnet_entries(sd, "", v["params"], moved["batch_stats"])
    for key, value in weights.running_stats(weights.to_tensors(sd)).items():
        assert_norm_rel(pm.state_dict()[key], value.numpy())


def test_resnet34_in_every_backbone_slot():
    """MODEL.ENCODER.NAME, MODEL.LIDAR.ENCODER, MODEL.ROUTE.BACKBONE and
    MODEL.BEV.BACKBONE: each builds the 34-layer trunk."""
    for branch in (True, False):
        cfg = tiny_test_cfg({"MODEL": {
            "ENCODER": {"NAME": "resnet34"}, "LIDAR": {"ENCODER": "resnet34"},
            "ROUTE": {"BACKBONE": "resnet34"}, "BEV": {"BACKBONE": "resnet34"},
            "TRANSFORMER": {"ENABLED": branch}}})
        with torch.device("meta"):
            model = MuvoWorldModel(cfg)
        trunks = [model.encoder, model.range_view_encoder,
                  model.backbone_route.backbone]
        if not branch:
            trunks.append(model.backbone_bev)
        for trunk in trunks:
            assert len(trunk.layer3) == 6 and len(trunk.layer4) == 3
