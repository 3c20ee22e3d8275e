"""Weight carry between muvo_tpu and the PyTorch port, at tiny_test_cfg()
with the voxel decoder on, with MODEL.TRANSFORMER.LARGE (the top-down
Decoder FPNs, upstream's ``upsample_skip_convs``), with PointPillars LiDAR
and every head (the BEV decoder; the LiDAR segmentation, semantic-image
and depth decoders), with MobileViTV2 camera and LiDAR encoders, and with
camera lifting: MODEL.TRANSFORMER.BEV, the MILE branch with LiDAR and the
RSSM, and the MILE branch camera-only without lifting or the RSSM.

muvo_tpu_torch/weights.py maps muvo_tpu's variables onto the port's
state_dict (upstream MUVO's keys); muvo_tpu/training/weight_convert.py maps
upstream's state_dict onto muvo_tpu's variables. Going there and back must
return every muvo_tpu leaf bit for bit, with no leaf left over on either
side: the port's keys are upstream's, and the two maps are inverses.
"""

import jax
import numpy as np
import pytest

from muvo_tpu.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu.training.weight_convert import (
    _merge_into,
    convert_reference_state_dict,
)
from muvo_tpu_torch.data.synthetic import tiny_test_cfg as port_tiny_cfg
from torch_port_common import jax_trainer_and_state, port_model


def _carry(large: bool, **overrides):
    cfg, port_cfg = tiny_test_cfg(), port_tiny_cfg()
    cfg.MODEL.TRANSFORMER.LARGE = port_cfg.MODEL.TRANSFORMER.LARGE = large
    for c in (cfg, port_cfg):
        c.merge_from_dict(overrides)
    batch = synthetic_batch(cfg, 1, cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    _, state = jax_trainer_and_state(cfg, batch)
    # port_model loads with load_state_dict(strict=True): no missing and no
    # unexpected key
    model = port_model(state, port_cfg)
    return cfg, state, model


@pytest.fixture(scope="module")
def carried():
    return _carry(large=False)


@pytest.fixture(scope="module")
def carried_large():
    return _carry(large=True)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_round_trip(cfg, state, model):
    upstream = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_reference_state_dict(upstream, cfg)
    for template, converted in ((state.params, params),
                                (state.batch_stats, stats)):
        template = jax.device_get(template)
        merged, missing = _merge_into(template, converted)
        assert not missing, f"unconverted leaves: {missing[:10]}"
        want, got = _leaves(template), _leaves(merged)
        assert set(got) == set(want)
        for key, w in want.items():
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_state_dict_round_trips_through_weight_convert(carried):
    _assert_round_trip(*carried)


def test_large_state_dict_round_trips_through_weight_convert(carried_large):
    _assert_round_trip(*carried_large)
    keys = set(carried_large[2].state_dict())
    for prefix in ("feat_decoder", "range_view_decoder"):
        assert f"{prefix}.upsample_skip_convs.1.0.weight" in keys
        assert not any(k.startswith(f"{prefix}.downsample") for k in keys)


def test_port_keys_are_upstream_names(carried):
    _, _, model = carried
    keys = set(model.state_dict())
    for key in (
        "voxel_decoder.conv3.conv2.conv_act.0.weight",
        "voxel_decoder.conv2.conv1.adaptive_norm.latent_affine.weight",
        "transformer_encoder.layers.0.self_attn.in_proj_weight",
        "rssm.recurrent_model.weight_ih",
        "encoder.layer1.0.bn1.running_var",
        "rgb_decoder.head_1.rgb_head.0.weight",
        "lidar_re.pre_transpose_conv.0.weight",
    ):
        assert key in keys, key


# PointPillars and every head; test_mobilevit_2d.yml's encoders (narrow
# decoders and no voxel decoder, which the cases above carry)
SMALL = {"VOXEL_SEG": {"ENABLED": False}}
HEADS = {"MODEL": {"LIDAR": {"POINT_PILLAR": {"ENABLED": True}},
                   "DECODER_BASE_CHANNELS": 64},
         "SEMANTIC_SEG": {"ENABLED": True}, "LIDAR_SEG": {"ENABLED": True},
         "SEMANTIC_IMAGE": {"ENABLED": True}, "DEPTH": {"ENABLED": True},
         "POINTS": {"N_PER_SECOND": 20000}, **SMALL}
MOBILEVIT = {"MODEL": {"ENCODER": {"NAME": "mobilevitv2_100"},
                       "LIDAR": {"ENCODER": "mobilevitv2_100"},
                       "DECODER_BASE_CHANNELS": 64}, **SMALL}


def test_point_pillars_and_heads_state_dict_round_trips():
    cfg, state, model = _carry(False, **HEADS)
    _assert_round_trip(cfg, state, model)
    keys = set(model.state_dict())
    for key in (
        "point_pillars.point_net.net.0.weight",
        "point_pillars.point_net.net.4.running_var",
        "point_pillar_encoder.conv1.weight",
        "point_pillar_decoder.conv1.0.weight",
        "bev_decoder.constant_tensor",
        "bev_decoder.first_norm.latent_affine.weight",
        "bev_decoder.middle_conv.2.conv2.conv_act.0.weight",
        "bev_decoder.head_4.segmentation_head.0.weight",
        "bev_decoder.head_2.instance_offset_head.0.bias",
        "bev_decoder.head_1.instance_center_head.0.weight",
        "lidar_segmentation.head_1.seg_head.0.weight",
        "sem_image_decoder.head_2.sem_head.0.bias",
        "depth_image_decoder.head_4.depth_head.0.weight",
    ):
        assert key in keys, key
    assert model.point_pillar_encoder.conv1.in_channels == 32
    assert not any(k.startswith("range_view") for k in keys)


def test_mobilevit_state_dict_round_trips():
    cfg, state, model = _carry(False, **MOBILEVIT)
    _assert_round_trip(cfg, state, model)
    keys = set(model.state_dict())
    for prefix in ("encoder", "range_view_encoder"):
        for key in ("stem.conv.weight",
                    "stages.2.1.transformer.1.attn.out_proj.weight",
                    "stages.4.1.conv_proj.bn.running_mean"):
            assert f"{prefix}.{key}" in keys
    assert model.range_view_encoder.stem.conv.in_channels == 4


# camera lifting: the frustum-BEV transformer branch and the MILE branch
# (MODEL.TRANSFORMER.ENABLED False), with and without LiDAR and the RSSM
LIFTING = {
    "transformer_bev": ({"MODEL": {"TRANSFORMER": {"BEV": True},
                                   "DECODER_BASE_CHANNELS": 64}, **SMALL},
                        ("depth_decoder.upsample_skip_convs.1.0.weight",
                         "depth.weight", "bev_down_sample_4.0.weight",
                         "bev_down_sample_4.2.bias",
                         "feat_decoder.upsample_skip_convs.0.1.running_mean",
                         "range_view_decoder.downsample_skip_convs.0.0.weight",
                         "transformer_encoder.layers.0.linear1.weight")),
    "mile": ({"MODEL": {"TRANSFORMER": {"ENABLED": False},
                        "DECODER_BASE_CHANNELS": 64}, **SMALL},
             ("depth.bias", "backbone_bev.layer3.0.downsample.1.running_var",
              "backbone_bev.conv1.weight", "final_state_conv.1.bn2.weight",
              "lidar_state_conv.1.downsample.0.weight",
              "embedding_combine.weight",
              "range_view_decoder.upsample_skip_convs.1.1.weight",
              "rssm.recurrent_model.weight_hh")),
    "mile_camera_only": ({"MODEL": {"TRANSFORMER": {"ENABLED": False},
                                    "LIDAR": {"ENABLED": False},
                                    "TRANSITION": {"ENABLED": False},
                                    "DECODER_BASE_CHANNELS": 64},
                          "EVAL": {"NO_LIFTING": True}, **SMALL},
                         ("backbone_bev.conv1.weight",
                          "final_state_conv.0.conv1.weight",
                          "policy.fc.0.weight")),
}


@pytest.mark.parametrize("variant", sorted(LIFTING))
def test_lifting_state_dict_round_trips(variant):
    overrides, want_keys = LIFTING[variant]
    cfg, state, model = _carry(False, **overrides)
    _assert_round_trip(cfg, state, model)
    keys = set(model.state_dict())
    for key in want_keys:
        assert key in keys, key
    m = cfg.MODEL
    emb, route, speed = m.EMBEDDING_DIM, m.ROUTE.CHANNELS, m.SPEED.CHANNELS
    if variant == "transformer_bev":
        assert model.depth.out_channels == model.frustum_pooling.D == 37
        assert not any(k.startswith(("backbone_bev", "embedding_combine"))
                       for k in keys)
        return
    assert not any(k.startswith(("transformer_encoder", "type_embedding",
                                 "features_combine", "image_feature_conv"))
                   for k in keys)
    # OUT_CHANNELS x nz + route + speed channels into backbone_bev
    assert model.backbone_bev.conv1.in_channels == (
        m.ENCODER.OUT_CHANNELS + route + speed)
    assert model.final_state_conv[0].conv1.out_channels == emb
    if variant == "mile_camera_only":
        assert not any(k.startswith(("rssm", "depth", "range_view",
                                     "lidar_state_conv")) for k in keys)
        assert model.policy.fc[0].in_features == emb
