"""The BEV decoder, its SegmentationHead and the label branches of the
port's PreProcess against muvo_tpu's, and the whole tiny model with
PointPillars LiDAR and every head (BEV, rgb, LiDAR reconstruction and
segmentation, semantic image, depth; the voxel decoder off).

Inputs come from numpy seeds, weights through muvo_tpu_torch/weights.py.
Tolerances: the labels are equal (nearest pyramids, integer ids, the
centres and offsets of instances), the bilinear depth pyramid within
1e-5 absolute; the decoders fp32 within 1e-4 * max(1, max |jax|); the
whole graph's outputs 1e-3 norm-relative and its loss terms 1e-4
relative, as the port's other whole-graph tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.config import get_cfg as jax_get_cfg
from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.geometry.camera import get_out_of_view_mask as jax_view_mask
from muvo_tpu.models import preprocess as jp
from muvo_tpu.models.stylegan import BevDecoder as JBevDecoder
from muvo_tpu.models.stylegan import SegmentationHead as JSegmentationHead
from muvo_tpu.utils.instance import center_offset_labels as jax_labels
from muvo_tpu_torch import weights
from muvo_tpu_torch.config import get_cfg
from muvo_tpu_torch.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu_torch.geometry.camera import get_out_of_view_mask
from muvo_tpu_torch.models import preprocess as pp
from muvo_tpu_torch.models.stylegan import BevDecoder, SegmentationHead
from muvo_tpu_torch.utils.instance import center_offset_labels
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

HEAD_KEYS = ("bev_segmentation", "bev_instance_offset", "bev_instance_center")


def test_segmentation_head():
    x = randn(np.random.RandomState(0), 2, 3, 6, 8, 16)
    jm = JSegmentationHead(5, 2)
    v = flax_init(jm, x)
    pm = SegmentationHead(16, 5, 2)
    sd = {}
    for name, head in (("seg", "segmentation_head"),
                       ("offset", "instance_offset_head"),
                       ("center", "instance_center_head")):
        weights.conv_bias_entries(sd, f"{head}.0.", v["params"][name])
    pm.load_state_dict(weights.to_tensors(sd), strict=True)
    want = flax_apply(jm, v, x)
    got = pm(to_torch(x))
    assert set(got) == {f"{k}_2" for k in HEAD_KEYS}
    for key, w in want.items():
        close(got[key], w)


def test_bev_decoder():
    constant_size, base = (1, 2), 16  # h 64, w 128: the axes apart
    w = randn(np.random.RandomState(1), 2, 8)
    jm = JBevDecoder(latent_n_channels=8, semantic_n_channels=4,
                     constant_size=constant_size, head="bev",
                     base_channels=base)
    v = flax_init(jm, w)
    pm = load_entries(BevDecoder(8, 4, constant_size, base),
                      weights.style_decoder_entries, v, "bev")
    want = flax_apply(jm, v, w)
    with torch.no_grad():
        got = pm(to_torch(w))
    assert set(got) == set(want)
    for key, value in want.items():
        close(got[key], value)
    h, wd = (64 * c for c in constant_size)
    assert got["bev_segmentation_1"].shape == (2, h, wd, 4)
    assert got["bev_instance_center_4"].shape == (2, h // 4, wd // 4, 1)


def _instances(seed, b=2, s=2, h=48, w=40, n_ids=41):
    """Blocks of ids 0..n_ids-1 (ids past 32 too), some ids in several
    blocks, and one frame with no instance at all."""
    rs = np.random.RandomState(seed)
    blocks = rs.randint(0, n_ids, (b, s, h // 8, w // 8))
    inst = np.kron(blocks, np.ones((8, 8), np.int64)).astype(np.int32)
    inst[-1, -1] = 0
    return inst


@pytest.mark.parametrize("sigma", [4.0, 2.0, 4.0 / 3])
def test_center_offset_labels(sigma):
    inst = _instances(0)
    want_c, want_o = jax_labels(jnp.asarray(inst), sigma=sigma,
                                ignore_index=255)
    got_c, got_o = center_offset_labels(torch.from_numpy(inst), sigma,
                                        ignore_index=255)
    assert got_c.shape == (2, 2, 48, 40, 1) and got_o.shape == (2, 2, 48,
                                                                40, 2)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    # ids past max_instances own no pixel: their offsets are ignored
    past = inst > 32
    assert past.any() and (got_o.numpy()[past] == 255).all()
    assert not got_c[-1, -1].any()


@pytest.mark.parametrize("config", ["tiny", "muvo.yml"])
def test_out_of_view_mask(config):
    if config == "tiny":
        cfg, jcfg = tiny_test_cfg(), jax_tiny_cfg()
        cfg.BEV.OFFSET_FORWARD = jcfg.BEV.OFFSET_FORWARD = -16
    else:
        cfg, jcfg = get_cfg(), jax_get_cfg()
        cfg.merge_from_file("muvo_tpu_torch/configs/muvo.yml")
        jcfg.merge_from_file("muvo_tpu/configs/muvo.yml")
    got, want = get_out_of_view_mask(cfg), jax_view_mask(jcfg)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got.shape == tuple(cfg.BEV.SIZE[::-1])
    assert 0 < got.mean() < 1


def _label_cfgs(mask_view: bool):
    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    for cfg in (jcfg, pcfg):
        cfg.SEMANTIC_SEG.ENABLED = True
        cfg.LIDAR_SEG.ENABLED = True
        cfg.SEMANTIC_IMAGE.ENABLED = True
        cfg.DEPTH.ENABLED = True
        cfg.LOSSES.RGB_INSTANCE = True
        cfg.EVAL.MASK_VIEW = mask_view
        cfg.BEV.OFFSET_FORWARD = -16  # the view mask fits the 64 x 64 BEV
    return jcfg, pcfg


def _label_batch(cfg, seed):
    batch = synthetic_batch(cfg, 2, 2, seed=seed)
    rs = np.random.RandomState(seed)
    h, w = cfg.IMAGE.SIZE
    batch["instance_label"] = _instances(seed, 2, 2, 64, 64)[..., None]
    batch["image_instance_mask"] = rs.uniform(size=(2, 2, h, w, 1)) < 0.3
    batch["depth_color"] = rs.uniform(size=(2, 2, h, w, 3)).astype(
        np.float32)
    batch["depth"][..., :8, :] = -1.0  # sky
    return batch


@pytest.mark.parametrize("mask_view", [False, True])
def test_label_branches_match_prepare_labels(mask_view):
    jcfg, pcfg = _label_cfgs(mask_view)
    batch = _label_batch(pcfg, 3)
    want = jax.device_get(jax.jit(lambda b: jp.PreProcess(jcfg)(
        b, training=False))({k: jnp.asarray(v) for k, v in batch.items()}))
    got = pp.PreProcess(pcfg)({k: torch.from_numpy(v)
                               for k, v in batch.items()}, training=False)
    assert set(got) == set(want)
    exact = [f"{n}_{k}" for n in ("birdview_label", "instance_label",
                                  "offset_label", "semantic_image_label",
                                  "image_instance_mask")
             for k in (1, 2, 4)]
    exact += ["birdview_label", "instance_label", "offset_label",
              "depth_mask", "depth_color", "semantic_image"]
    for key in exact:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    for key in [f"{n}_{k}" for n in ("center_label", "depth_label")
                for k in (1, 2, 4)] + ["center_label", "depth"]:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-5, err_msg=key)
    assert got["birdview_label_4"].shape == (2, 2, 16, 16, 1)
    assert got["depth_mask"].any() and not got["depth_mask"].all()
    if mask_view:  # out-of-view pixels are class 0 after the rotation
        assert (got["birdview_label"][..., 0] == 0).float().mean() > 0.3


def _heads_cfgs():
    jcfg, pcfg = _label_cfgs(mask_view=True)
    for cfg in (jcfg, pcfg):
        cfg.PRECISION = "32"
        cfg.MODEL.TRANSITION.USE_DROPOUT = False
        cfg.MODEL.LIDAR.POINT_PILLAR.ENABLED = True
        cfg.POINTS.N_PER_SECOND = 20000  # 2,000 points a frame
        cfg.MODEL.DECODER_BASE_CHANNELS = 64
        cfg.VOXEL_SEG.ENABLED = False
    return jcfg, pcfg


def test_whole_graph_with_point_pillars_and_every_head():
    jcfg, pcfg = _heads_cfgs()
    batch = _label_batch(pcfg, 5)
    batch = {k: v[:1] for k, v in batch.items()}
    got, losses, want, want_losses, on_jax = whole_graph(jcfg, pcfg, batch)
    assert_whole_graph(got, losses, want, want_losses, on_jax)
    for k in (1, 2, 4):
        for term in ("bev_segmentation", "bev_center", "bev_offset",
                     "lidar_seg", "semantic_image", "depth", "rgb"):
            assert f"{term}_{k}" in losses, (term, k)


def test_deployment_session_carries_the_raw_points():
    """DeploymentSession hands a PointPillars model its frame's points_raw
    and num_points: the observed state follows the points, and equals the
    model's own observe_step on its encode of that frame."""
    from muvo_tpu_torch.inference import DeploymentSession
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.utils.network import remove_past

    _, cfg = _heads_cfgs()
    torch.manual_seed(0)
    session = DeploymentSession(MuvoWorldModel(cfg), cfg, device="cpu")
    batch = synthetic_batch(cfg, 1, 3, seed=6)
    flipped = {**batch, "points_raw": batch["points_raw"][..., ::-1].copy()}
    states = []
    for frames in (batch, flipped):
        session.reset()
        # the posterior sample (its mean here) reads the embedding
        states.append(session.deployment_forward(
            frames, is_dreaming=False)["sample"])
    assert (states[0] - states[1]).abs().max() > 0

    one = session._tensors(remove_past(flipped, 3))
    action = torch.from_numpy(np.concatenate(
        [batch["throttle_brake"], batch["steering"]], -1)[:, -2])
    with torch.inference_mode():
        embedding = session.model.encode_frame(
            session.preprocess(one, labels=False))
        h = torch.zeros(1, cfg.MODEL.TRANSITION.HIDDEN_STATE_DIM)
        sample = torch.zeros_like(states[1])
        want = session.model.observe_step(h, sample, action, embedding,
                                          False)["posterior"]
    close(states[1], want["sample"].numpy(), 1e-6)
