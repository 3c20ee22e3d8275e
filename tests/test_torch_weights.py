"""Weight carry between muvo_tpu and the PyTorch port, at tiny_test_cfg()
with the voxel decoder on, with MODEL.TRANSFORMER.LARGE (the top-down
Decoder FPNs, upstream's ``upsample_skip_convs``), with PointPillars LiDAR
and every head (the BEV decoder; the LiDAR segmentation, semantic-image
and depth decoders), with MobileViTV2 camera and LiDAR encoders, and with
camera lifting: MODEL.TRANSFORMER.BEV, the MILE branch with LiDAR and the
RSSM, and the MILE branch camera-only without lifting or the RSSM; with
MODEL.MEASUREMENTS, with resnet34 in every backbone slot, and the
tri-plane voxel decoder alone.

muvo_tpu_torch/weights.py maps muvo_tpu's variables onto the port's
state_dict (upstream MUVO's keys); muvo_tpu/training/weight_convert.py maps
upstream's state_dict onto muvo_tpu's variables. Going there and back must
return every muvo_tpu leaf bit for bit, with no leaf left over on either
side: the port's keys are upstream's, and the two maps are inverses.

Three families of leaves muvo_tpu's converter does not map: the
measurement encoders (no entry for command_encoder, command_next_encoder
or gps_encoder), resnet34's layer3 blocks 4 and 5 (it walks blocks 0-3 of
each stage) and the tri-plane decoder (no entry). Their cases name
exactly the leaves left out, so that a change to the converter shows, and
check each of them against the port's state_dict by hand.
"""

import jax
import numpy as np
import pytest

from muvo_tpu.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu.training.weight_convert import (
    _conv,
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


def _assert_round_trip(cfg, state, model, left_out=((), ())):
    """Every leaf of (params, batch_stats) back bit for bit; the paths
    ``left_out`` (of each tree) are the only ones the converter misses,
    and each of them is checked against the port's state_dict by hand."""
    upstream = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_reference_state_dict(upstream, cfg)
    for template, converted, expected in ((state.params, params,
                                           left_out[0]),
                                          (state.batch_stats, stats,
                                           left_out[1])):
        template = jax.device_get(template)
        merged, missing = _merge_into(template, converted)
        assert sorted(missing) == sorted(expected), (
            f"unconverted leaves: {sorted(set(missing) ^ set(expected))}")
        for path in missing:
            _assert_carried_by_hand(upstream, path, template)
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


def _lookup(tree, path):
    for part in path.strip("/").split("/"):
        tree = tree[part]
    return np.asarray(tree)


# muvo_tpu's trunk names -> the port's (upstream's) prefixes
TRUNKS = {"encoder": "encoder", "lidar_encoder": "range_view_encoder",
          "backbone_route/ResNetFeatures_0": "backbone_route.backbone",
          "backbone_bev": "backbone_bev"}
LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
        "mean": "running_mean", "var": "running_var",
        "embedding": "weight"}
# a measurement encoder's flax submodule -> its nn.Sequential index
ENCODER_LAYERS = {"command_encoder": {"Embed_0": "0", "Dense_0": "1",
                                      "Dense_1": "3"},
                  "gps_encoder": {"Dense_0": "0", "Dense_1": "2"}}
ENCODER_LAYERS["command_next_encoder"] = ENCODER_LAYERS["command_encoder"]


def _port_key(path):
    """The port's state_dict key of a muvo_tpu leaf the converter misses."""
    parts = path.strip("/").split("/")
    if parts[0] in ENCODER_LAYERS:
        layer = ENCODER_LAYERS[parts[0]][parts[1]]
        return f"{parts[0]}.{layer}.{LEAF[parts[2]]}"
    for trunk, prefix in TRUNKS.items():
        if path.strip("/").startswith(trunk + "/layer"):
            block, *rest = path.strip("/")[len(trunk) + 1:].split("/")
            stage, index = block[len("layer"):].split("_")
            return ".".join([prefix, f"layer{stage}", index, *rest[:-1],
                             LEAF[rest[-1]]])
    raise KeyError(path)


def _assert_carried_by_hand(upstream, path, template):
    """A leaf the converter misses, against the port's entry: Dense
    kernels transposed, conv kernels through muvo_tpu's own layout map,
    the rest as they are."""
    want = _lookup(template, path)
    got = upstream[_port_key(path)]
    if path.endswith("kernel"):
        got = _conv(got) if want.ndim > 2 else got.T
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_measurements_state_dict_round_trips():
    """MODEL.MEASUREMENTS in the transformer branch: the three encoders
    are the converter's only misses."""
    cfg, state, model = _carry(False, **{
        "MODEL": {"MEASUREMENTS": {"ENABLED": True}}, **SMALL})
    left_out = [f"/{enc}/{layer}/{leaf}"
                for enc, layers in ENCODER_LAYERS.items()
                for layer in layers
                for leaf in (("embedding",) if layer == "Embed_0"
                             else ("kernel", "bias"))]
    assert len(left_out) == 14
    _assert_round_trip(cfg, state, model, (left_out, ()))
    m = cfg.MODEL.MEASUREMENTS
    assert model.command_encoder[0].weight.shape == (6, m.COMMAND_CHANNELS)
    assert model.gps_encoder[0].in_features == 4


def test_resnet34_state_dict_round_trips():
    """resnet34 in every slot muvo_tpu builds it in (the MILE branch:
    camera, range view, route and BEV trunks): each trunk's layer3.4 and
    layer3.5 are the converter's only misses."""
    cfg, state, model = _carry(False, **{
        "MODEL": {"TRANSFORMER": {"ENABLED": False},
                  "ENCODER": {"NAME": "resnet34"},
                  "LIDAR": {"ENCODER": "resnet34"},
                  "ROUTE": {"BACKBONE": "resnet34"},
                  "BEV": {"BACKBONE": "resnet34"},
                  "DECODER_BASE_CHANNELS": 64}, **SMALL})
    params, stats = [], []
    for trunk in TRUNKS:
        for block in ("layer3_4", "layer3_5"):
            for bn in ("bn1", "bn2"):
                params += [f"/{trunk}/{block}/{bn}/scale",
                           f"/{trunk}/{block}/{bn}/bias"]
                stats += [f"/{trunk}/{block}/{bn}/mean",
                          f"/{trunk}/{block}/{bn}/var"]
            params += [f"/{trunk}/{block}/conv1/kernel",
                       f"/{trunk}/{block}/conv2/kernel"]
    _assert_round_trip(cfg, state, model, (params, stats))
    for key in ("encoder.layer3.5.bn2.running_var",
                "backbone_route.backbone.layer4.2.conv2.weight",
                "backbone_bev.layer2.3.bn1.weight",
                "range_view_encoder.layer3.4.conv1.weight"):
        assert key in model.state_dict(), key


def test_triplane_state_dict_round_trips():
    """The tri-plane decoder, which no model path builds: its state_dict
    keys are upstream's (VoxelDecoder0), the converter maps none of them,
    and each leaf is carried by hand."""
    import torch

    from muvo_tpu.models.stylegan import TriPlaneVoxelDecoder as JTriPlane
    from muvo_tpu_torch import weights
    from muvo_tpu_torch.models.stylegan import TriPlaneVoxelDecoder

    # xy (1, X, Y, 8), xz (1, X, Z, 8), yz (1, Y, Z, 8) at each scale
    sizes = {1: (4, 4, 2), 2: (2, 2, 1), 4: (1, 1, 1)}
    planes = [{f"rgb_{s}": np.zeros((1, xyz[i], xyz[j], 8), np.float32)
               for s, xyz in sizes.items()}
              for i, j in ((0, 1), (0, 2), (1, 2))]
    params = jax.device_get(jax.jit(JTriPlane(3, feature_channels=6).init)(
        jax.random.PRNGKey(0), *planes)["params"])
    sd = {}
    weights.triplane_entries(sd, "", params)
    model = TriPlaneVoxelDecoder(8, 3, 6)
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    upstream = {k: v.numpy() for k, v in model.state_dict().items()}
    assert "decoder_2.weight_xz_decoder.weight" in upstream
    assert "decoder_4.classifier.2.bias" in upstream
    converted, stats = convert_reference_state_dict(
        upstream, tiny_test_cfg())
    assert converted == {} and stats == {}
    leaves = _leaves(params)
    assert len(leaves) == len(upstream) == 30
    for scale in (1, 2, 4):
        for jax_name, port_name in (("weight_xy", "weight_xy_decoder"),
                                    ("weight_xz", "weight_xz_decoder"),
                                    ("weight_yz", "weight_yz_decoder"),
                                    ("cls1", "classifier.0"),
                                    ("cls2", "classifier.2")):
            p = params[f"decoder_{scale}"][jax_name]
            key = f"decoder_{scale}.{port_name}"
            np.testing.assert_array_equal(_conv(upstream[key + ".weight"]),
                                          p["kernel"])
            np.testing.assert_array_equal(upstream[key + ".bias"],
                                          p["bias"])
    assert isinstance(model.decoder_1.classifier[1], torch.nn.Softplus)
