"""Weight carry between muvo_tpu and the PyTorch port, at tiny_test_cfg()
with the voxel decoder on, and with MODEL.TRANSFORMER.LARGE (the top-down
Decoder FPNs, upstream's ``upsample_skip_convs``).

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


def _carry(large: bool):
    cfg, port_cfg = tiny_test_cfg(), port_tiny_cfg()
    cfg.MODEL.TRANSFORMER.LARGE = port_cfg.MODEL.TRANSFORMER.LARGE = large
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
