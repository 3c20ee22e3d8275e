"""The measurement encoders (MODEL.MEASUREMENTS: the route command, the
next route command and the GPS vectors) in the port against muvo_tpu:
CommandEncoder and GpsEncoder alone, and two tiny whole graphs with
measurements, the transformer branch and the MILE branch.

Weights go through muvo_tpu_torch/weights.py; inputs come from numpy
seeds (the measurement keys as muvo_tpu's synthetic batch makes them: int32
command ids, float32 GPS vectors). Tolerances: the encoders fp32 within
1e-5 norm-relative; the whole graphs (narrow decoders, no voxel decoder,
2 frames) as the port's other whole-graph tests: every output 1e-3
norm-relative, every loss term 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from muvo_tpu.models.common import CommandEncoder as JCommandEncoder
from muvo_tpu.models.common import GpsEncoder as JGpsEncoder
from muvo_tpu_torch import weights
from muvo_tpu_torch.data.synthetic import synthetic_batch
from muvo_tpu_torch.models.common import CommandEncoder, GpsEncoder
from muvo_tpu_torch.models.world_model import MuvoWorldModel
from torch_port_common import (
    assert_norm_rel,
    assert_whole_graph,
    flax_apply,
    flax_init,
    fp32_cfgs,
    load_entries,
    randn,
    to_torch,
    whole_graph,
)


def test_command_encoder():
    ids = np.random.RandomState(0).randint(0, 6, (12,)).astype(np.int32)
    jm = JCommandEncoder(8)
    v = flax_init(jm, ids)
    pm = load_entries(CommandEncoder(8), weights.command_entries, v)
    with torch.no_grad():
        got = pm(to_torch(ids))
    assert_norm_rel(got, flax_apply(jm, v, ids))
    assert set(pm.state_dict()) == {"0.weight", "1.weight", "1.bias",
                                    "3.weight", "3.bias"}
    assert pm[0].weight.shape == (6, 8)


def test_gps_encoder():
    gps = randn(np.random.RandomState(1), 12, 4)
    jm = JGpsEncoder(16)
    v = flax_init(jm, gps)
    pm = load_entries(GpsEncoder(16), weights.speed_entries, v)
    with torch.no_grad():
        got = pm(to_torch(gps))
    assert_norm_rel(got, flax_apply(jm, v, gps))
    assert set(pm.state_dict()) == {"0.weight", "0.bias", "2.weight",
                                    "2.bias"}


BRANCHES = {"transformer": {},
            "mile": {"MODEL": {"TRANSFORMER": {"ENABLED": False}}}}


def _cfgs(branch):
    jcfg, pcfg = fp32_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_dict(BRANCHES[branch])
        cfg.MODEL.MEASUREMENTS.ENABLED = True
        cfg.MODEL.DECODER_BASE_CHANNELS = 64
        cfg.VOXEL_SEG.ENABLED = False
    return jcfg, pcfg


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_whole_graph_with_measurements_matches_muvo_tpu(branch):
    jcfg, pcfg = _cfgs(branch)
    batch = synthetic_batch(pcfg, 1, 2, seed=13)
    assert batch["route_command"].dtype == np.int32
    got, losses, want, want_losses, on_jax = whole_graph(jcfg, pcfg, batch)
    assert_whole_graph(got, losses, want, want_losses, on_jax)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_measurements_widen_the_fusion_and_move_the_embedding(branch):
    """The three encoders' 2 * COMMAND_CHANNELS + GPS_CHANNELS features
    join features_combine (transformer) or backbone_bev's input (MILE),
    and another route command gives another embedding."""
    from muvo_tpu_torch.models.preprocess import PreProcess

    _, cfg = _cfgs(branch)
    m = cfg.MODEL
    torch.manual_seed(0)
    model = MuvoWorldModel(cfg).eval()
    extra = 2 * m.MEASUREMENTS.COMMAND_CHANNELS + m.MEASUREMENTS.GPS_CHANNELS
    vector = m.ROUTE.CHANNELS + m.SPEED.CHANNELS + extra
    if branch == "transformer":
        assert model.features_combine.in_features == (
            2 * m.EMBEDDING_DIM + vector)
    else:
        assert model.backbone_bev.conv1.in_channels == (
            model.frustum_pooling.nx[2] * m.ENCODER.OUT_CHANNELS + vector)
    batch = synthetic_batch(cfg, 1, 2, seed=3)
    pre = PreProcess(cfg)
    other = dict(batch, route_command=(batch["route_command"] + 1) % 6)
    with torch.no_grad():
        a, b = (model.encode(pre({k: torch.from_numpy(v)
                                  for k, v in raw.items()}))
                for raw in (batch, other))
    assert not torch.allclose(a, b)
