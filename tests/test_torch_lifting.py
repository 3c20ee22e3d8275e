"""Camera lifting in the whole port against muvo_tpu: three tiny graphs
with frustum pooling or without it, each forward and its loss terms on
seeded weights (carried through muvo_tpu_torch/weights.py) and a seeded
batch, and the entry points of the configurations that need them.

- MODEL.TRANSFORMER.BEV: the lifted camera features shrunk 4x into the
  transformer's image tokens;
- the MILE branch (MODEL.TRANSFORMER.ENABLED False) with lifting, LiDAR
  and the RSSM;
- the MILE branch camera-only (MODEL.LIDAR.ENABLED False) with
  EVAL.NO_LIFTING and MODEL.TRANSITION.ENABLED False.

Narrow decoders and no voxel decoder, 2 frames, fp32. Tolerances as the
port's other whole-graph tests: every output within 1e-3 norm-relative,
every loss term within 1e-4 relative (tests/torch_port_common.py).
"""

import numpy as np
import pytest
import torch

from muvo_tpu_torch.config import get_cfg
from muvo_tpu_torch.data.synthetic import synthetic_batch
from muvo_tpu_torch.models.world_model import MuvoWorldModel
from torch_port_common import (assert_whole_graph, close, fp32_cfgs,
                               whole_graph)

VARIANTS = {
    "transformer_bev": {"MODEL": {"TRANSFORMER": {"BEV": True}}},
    "mile": {"MODEL": {"TRANSFORMER": {"ENABLED": False}}},
    "mile_camera_only": {"MODEL": {"TRANSFORMER": {"ENABLED": False},
                                   "LIDAR": {"ENABLED": False},
                                   "TRANSITION": {"ENABLED": False}},
                         "EVAL": {"NO_LIFTING": True}},
}


def _cfgs(variant):
    jcfg, pcfg = fp32_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_dict(VARIANTS[variant])
        cfg.MODEL.DECODER_BASE_CHANNELS = 64
        cfg.VOXEL_SEG.ENABLED = False
    return jcfg, pcfg


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_whole_graph_matches_muvo_tpu(variant):
    jcfg, pcfg = _cfgs(variant)
    batch = synthetic_batch(pcfg, 1, 2, seed=11)
    got, losses, want, want_losses, on_jax = whole_graph(jcfg, pcfg, batch)
    assert_whole_graph(got, losses, want, want_losses, on_jax)
    assert ("probabilistic" in losses) == pcfg.MODEL.TRANSITION.ENABLED
    assert got["rgb_1"].shape == (1, 2, 64, 128, 3)
    assert np.linalg.norm(got["rgb_1"].numpy()) > 0


def _frames(cfg, model, seed):
    """A preprocessed 2-frame batch and the model's BEV features of it
    (before the route and speed features join them)."""
    from muvo_tpu_torch.models.preprocess import PreProcess
    from muvo_tpu_torch.utils.network import pack_sequence_dim

    pb = PreProcess(cfg)({k: torch.from_numpy(v) for k, v in
                          synthetic_batch(cfg, 1, 2, seed=seed).items()},
                         training=False)
    with torch.no_grad():
        xs = model.encoder(pack_sequence_dim(pb["image"]))
        bev = model._lift(xs, model.feat_decoder(xs), pb)
    return pb, bev


def test_lifted_bev_reaches_the_tokens():
    """Under MODEL.TRANSFORMER.BEV the 16 x 16 grid of the tiny BEV
    (64 px / FEATURE_DOWNSAMPLE 4) shrinks to 4 x 4 image tokens, and the
    embedding follows the camera pose through the frustum."""
    _, cfg = _cfgs("transformer_bev")
    torch.manual_seed(0)
    model = MuvoWorldModel(cfg).eval()
    pb, bev = _frames(cfg, model, 12)
    assert bev.shape == (2, 16, 16, cfg.MODEL.TRANSFORMER.CHANNELS)
    assert (bev != 0).any(-1).float().mean() > 0.05
    with torch.no_grad():
        assert model.bev_down_sample_4(bev).shape[1:3] == (4, 4)
        moved = dict(pb, extrinsics=pb["extrinsics"].clone())
        moved["extrinsics"][..., 1, 3] += 2.0  # the camera 2 m left
        a, b = model.encode(pb), model.encode(moved)
    assert (a - b).abs().max() > 1e-4


def test_one_frame_yml_trains_a_step():
    """one_frame.yml (no RSSM, 1 frame, no horizon) at tiny sizes: one CPU
    train step with every loss finite and no KL term, and an eval step
    that observes without imagining."""
    from muvo_tpu_torch.data.synthetic import tiny_test_cfg
    from muvo_tpu_torch.training.trainer import WorldModelTrainer

    full = get_cfg()
    full.merge_from_file("muvo_tpu_torch/configs/one_frame.yml")
    assert not full.MODEL.TRANSITION.ENABLED
    assert full.RECEPTIVE_FIELD == 1 and full.FUTURE_HORIZON == 0
    assert not full.MODEL.TRANSFORMER.ENABLED  # the MILE branch
    cfg = tiny_test_cfg()
    cfg.merge_from_file("muvo_tpu_torch/configs/one_frame.yml")
    cfg.MODEL.TRANSFORMER.ENABLED = False  # tiny_test_cfg's own is True
    cfg.merge_from_dict({"BATCHSIZE": 2, "PRECISION": "32",
                         "VOXEL_SEG": {"ENABLED": False},
                         "MODEL": {"DECODER_BASE_CHANNELS": 64}})
    trainer = WorldModelTrainer(cfg, device="cpu")
    trainer.init_state(0)
    model = trainer.state.model
    assert model.rssm is None and model.policy.fc[0].in_features == 64
    batch = synthetic_batch(cfg, 2, 1, seed=13)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = trainer.train_step(batch)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert not any("probabilistic" in k for k in metrics)
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])]
    assert any(n.startswith("depth_decoder") for n in moved)
    assert any(n.startswith("backbone_bev") for n in moved)
    out = trainer.eval_step(batch)
    assert "output_imagine" not in out and set(out["losses"])


def test_deployment_session_serves_mile_and_refuses_no_rssm():
    """DeploymentSession carries the tiny MILE model's state: the state it
    observes is the model's own observe_step on its encode of the frame;
    a model without the RSSM is refused by name."""
    from muvo_tpu_torch.inference import DeploymentSession
    from muvo_tpu_torch.utils.network import remove_past

    _, cfg = _cfgs("mile")
    torch.manual_seed(1)
    session = DeploymentSession(MuvoWorldModel(cfg), cfg, device="cpu")
    batch = synthetic_batch(cfg, 1, 3, seed=14)
    out = session.deployment_forward(batch, is_dreaming=False)
    assert out["rgb_1"].shape == (1, 1, 64, 128, 3)
    assert all(torch.isfinite(v).all() for v in out.values())
    one = session._tensors(remove_past(batch, 3))
    action = torch.from_numpy(np.concatenate(
        [batch["throttle_brake"], batch["steering"]], -1)[:, -2])
    with torch.inference_mode():
        embedding = session.model.encode_frame(
            session.preprocess(one, labels=False))
        h = torch.zeros(1, cfg.MODEL.TRANSITION.HIDDEN_STATE_DIM)
        sample = torch.zeros(1, cfg.MODEL.TRANSITION.STATE_DIM)
        want = session.model.observe_step(h, sample, action, embedding,
                                          False)["posterior"]
    close(out["sample"][:, 0] if out["sample"].ndim == 3 else out["sample"],
          want["sample"].numpy(), 1e-6)
    sim_out, imagined = session.sim_forward(batch, is_dreaming=False)
    assert imagined["rgb_1"].shape == (1, 2, 64, 128, 3)

    _, no_rssm = _cfgs("mile_camera_only")
    with pytest.raises(ValueError, match="TRANSITION.ENABLED"):
        DeploymentSession(MuvoWorldModel(no_rssm), no_rssm, device="cpu")
