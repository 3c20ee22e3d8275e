"""The port's closed-loop world-model agent (agents/muvo_agent.py) against
muvo_tpu's on the CARLA-free kinematic env, at tests/test_evaluate.py's
size (tiny_test_cfg in fp32, one transformer layer, 32 decoder channels,
the voxel decoder on: its conv2 and conv3 take the K2/K1 path, here the
plain versions on the CPU).

Both agents hold the same seeded weights (muvo_tpu's variables carried
across by weights.state_dict_from_jax) and see the same observations: the
env is stepped with muvo_tpu's controls, so that differences do not
compound. The frames are equal bit for bit (the same host numpy and cv2);
controls and the supervision dict within tests/test_torch_inference.py's
rule, max |port - jax| <= 2e-4 * max(1, max |jax|).
"""

import numpy as np
import pytest
import torch

from muvo_tpu.agents.muvo_agent import MuvoAgent as JaxAgent
from muvo_tpu.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu_torch.agents.muvo_agent import MuvoAgent
from muvo_tpu_torch.data.synthetic import tiny_test_cfg as port_tiny_cfg
from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv
from torch_port_common import jax_trainer_and_state, port_model

TOL = 2e-4
TICKS = 6


def _small(cfg):
    cfg.PRECISION = "32"
    cfg.MODEL.TRANSFORMER.N_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DIM_FEEDFORWARD = 64
    cfg.MODEL.DECODER_BASE_CHANNELS = 32
    return cfg


@pytest.fixture(scope="module")
def agents():
    cfg, port_cfg = _small(tiny_test_cfg()), _small(port_tiny_cfg())
    assert cfg.VOXEL_SEG.ENABLED and cfg.MODEL.LIDAR.ENABLED
    batch = synthetic_batch(cfg, 1, cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    trainer, state = jax_trainer_and_state(cfg, batch)
    port = MuvoAgent(port_cfg, port_model(state, port_cfg), device="cpu")
    return JaxAgent(cfg, trainer, state), port


def _observations(seed, image_hw=(120, 200), n=3):
    """Kinematic observations at an image size other than IMAGE.SIZE (so
    the frame resizes), stepped with a fixed control."""
    env = KinematicDrivingEnv(seed=seed, episode_steps=40, image_hw=image_hw,
                              lidar_points=3000)
    obs = [env.reset()["hero"]]
    for _ in range(n - 1):
        obs.append(env.step({"hero": {"throttle": 0.6, "steer": 0.1,
                                      "brake": 0.0}})[0]["hero"])
    return obs


def _assert_frames_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.parametrize("variant", ["lidar", "lidar_seg", "no_lidar_obs",
                                     "lidar_disabled", "hwc_masks"])
def test_obs_to_frame_equals_muvo_tpus(agents, variant):
    jax_agent, port = agents
    jax_cfg, port_cfg = jax_agent.cfg, port.cfg
    try:
        if variant in ("lidar_seg", "lidar_disabled"):
            jax_agent.cfg, port.cfg = jax_cfg.clone(), port_cfg.clone()
            for cfg in (jax_agent.cfg, port.cfg):
                cfg.defrost()
                if variant == "lidar_seg":
                    cfg.LIDAR_SEG.ENABLED = True
                else:
                    cfg.MODEL.LIDAR.ENABLED = False
        for obs in _observations(seed=1):
            if variant == "no_lidar_obs":
                obs = {k: v for k, v in obs.items()
                       if k != "lidar_points_semantic"}
            if variant == "hwc_masks":  # the route channel read from (h, w, c)
                obs = dict(obs, birdview={"masks": np.moveaxis(
                    obs["birdview"]["masks"], 0, -1)})
            jax_agent._prev_action = port._prev_action = np.array(
                [0.25, -0.5], np.float32)
            got, want = port._obs_to_frame(obs), jax_agent._obs_to_frame(obs)
            _assert_frames_equal(got, want)
            lidar = variant in ("lidar", "lidar_seg", "hwc_masks")
            assert ("range_view_pcd_xyzd" in got) == lidar
            assert ("range_view_pcd_seg" in got) == (variant == "lidar_seg")
            assert got["image"].shape == (*port.cfg.IMAGE.SIZE, 3)
            assert got["route_map"].shape == (port.cfg.ROUTE.SIZE * 3,) * 2 + (3,)
    finally:
        jax_agent.cfg, port.cfg = jax_cfg, port_cfg


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= TOL * max(1.0, np.abs(want).max() if want.size else 0.0), (
        what, err)


@pytest.mark.parametrize("is_dreaming", [False, True])
def test_run_step_matches_muvo_tpus_agent(agents, is_dreaming):
    jax_agent, port = agents
    jax_agent.is_dreaming = port.is_dreaming = is_dreaming
    jax_agent.reset()
    port.reset()
    env = KinematicDrivingEnv(seed=5, episode_steps=8, image_hw=(96, 160))
    obs = env.reset()
    hidden = []
    for tick in range(TICKS):
        previous = port._prev_action.copy()
        want = jax_agent.run_step(obs["hero"], env.timestamp)
        got = port.run_step(obs["hero"], env.timestamp)
        # the frame carries the previous tick's (acceleration, steering)
        np.testing.assert_array_equal(port._frames[-1]["throttle_brake"],
                                      previous[:1])
        np.testing.assert_array_equal(port._frames[-1]["steering"],
                                      previous[1:])
        assert isinstance(got, dict) and set(got) == set(want)
        for key in ("throttle", "steer", "brake"):
            _close(got[key], want[key], (tick, key))
        assert 0.0 <= got["throttle"] <= 1.0 and 0.0 <= got["brake"] <= 1.0
        assert -1.0 <= got["steer"] <= 1.0
        sup, jsup = port.supervision_dict, jax_agent.supervision_dict
        assert set(sup) == set(jsup)
        for key, w in jsup.items():
            _close(sup[key], w, (tick, key))
        assert port.session.count == jax_agent.session.count
        hidden.append(port.session.carry.h.clone())
        obs, _, done, _ = env.step({"hero": want})  # muvo_tpu's control
        assert not done["hero"]
    # the latent advances on the stride (every 2 ticks at 10 FPS, 0.2 s)
    assert torch.equal(hidden[1], hidden[0])
    assert not torch.equal(hidden[2], hidden[1])
