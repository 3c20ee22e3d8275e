"""DeploymentSession of the PyTorch port against muvo_tpu's, at
tiny_test_cfg() with the voxel decoder on (its conv2 and conv3 stages take
the K2/K1 path, here through the plain versions on the CPU), and a tick
with MODEL.TRANSFORMER.LARGE (stride-8 features through the top-down
Decoder, served by the unchanged session).

Both sessions hold the same seeded weights and see the same numpy batch.
Tolerance: norm-relative 2e-4 (max |port - jax| <= 2e-4 * max(1, max |jax|)),
fp32 on both sides, XLA and torch's CPU kernels summing in different orders
through some forty layers. The sampled imagination rollout is checked by
shape and finiteness only, since torch and JAX draw different noise; the
mean rollout (use_sample=False) is compared in full.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.data.synthetic import synthetic_batch, tiny_test_cfg
from muvo_tpu.inference import DeploymentSession as JaxSession
from muvo_tpu_torch.data.synthetic import tiny_test_cfg as port_tiny_cfg
from muvo_tpu_torch.inference import DeploymentSession
from torch_port_common import assert_same, jax_trainer_and_state, port_model

TOL = 2e-4


def _sessions(large: bool):
    cfg, port_cfg = tiny_test_cfg(), port_tiny_cfg()
    assert cfg.VOXEL_SEG.ENABLED
    cfg.MODEL.TRANSFORMER.LARGE = port_cfg.MODEL.TRANSFORMER.LARGE = large
    batch = synthetic_batch(cfg, 1, cfg.RECEPTIVE_FIELD + cfg.FUTURE_HORIZON)
    trainer, state = jax_trainer_and_state(cfg, batch)
    port = DeploymentSession(port_model(state, port_cfg), port_cfg,
                             device="cpu")
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    return batch, jax_batch, JaxSession(trainer, state), port


@pytest.fixture(scope="module")
def sessions():
    return _sessions(large=False)


def _assert_close(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.shape == w.shape, (key, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= TOL * max(1.0, np.abs(w).max()), (key, err)


def test_deployment_forward_stride_caching(sessions):
    batch, jax_batch, js, ps = sessions
    js.reset()
    ps.reset()
    hidden = []
    for tick in range(3):
        want = js.deployment_forward(jax_batch, is_dreaming=False)
        got = ps.deployment_forward(batch, is_dreaming=False)
        # CARLA 10 FPS, stride 0.2 s: act every 2 frames
        assert ps.count == js.count == (0 if tick == 1 else 1)
        _assert_close(got, want)
        hidden.append(got["hidden_state"])
    assert_same(hidden[1], hidden[0])  # cached latent
    assert (hidden[2] - hidden[0]).abs().max() > 0  # advanced on the stride
    assert got["throttle_brake"].shape == (1, 1, 1)
    assert got["voxel_1"].shape == (1, 1, 64, 64, 64, 2)


def test_deployment_dreaming(sessions):
    batch, jax_batch, js, ps = sessions
    js.reset()
    ps.reset()
    js.deployment_forward(jax_batch, is_dreaming=False)
    ps.deployment_forward(batch, is_dreaming=False)
    js.count = ps.count = 0  # force an update tick
    _assert_close(ps.deployment_forward(batch, is_dreaming=True),
                  js.deployment_forward(jax_batch, is_dreaming=True))


def test_sim_forward_and_imagination(sessions):
    batch, jax_batch, js, ps = sessions
    js.reset()
    ps.reset()
    want, want_imagined = js.sim_forward(jax_batch, is_dreaming=False)
    got, got_imagined = ps.sim_forward(batch, is_dreaming=False)
    _assert_close(got, want)

    fh = batch["image"].shape[1] - 1
    assert set(got_imagined) == set(want_imagined)
    for key, w in want_imagined.items():
        assert tuple(got_imagined[key].shape) == w.shape, key
        assert torch.isfinite(got_imagined[key]).all(), key
    assert got_imagined["voxel_1"].shape == (1, fh, 64, 64, 64, 2)

    # the mean rollout from the same carry, use_sample=False on both sides
    actions = np.concatenate([batch["throttle_brake"][:, :fh],
                              batch["steering"][:, :fh]], axis=-1)
    model = js.model

    @jax.jit
    def jax_rollout(variables, carry, actions):
        rollout = {"hidden_state": carry.h, "sample": carry.sample,
                   "throttle_brake": actions[..., :1],
                   "steering": actions[..., 1:]}
        return model.apply(variables, rollout, False, fh,
                           jax.random.PRNGKey(0), use_sample=False,
                           method=model.imagine)

    want = jax_rollout(js.variables, js.carry, jnp.asarray(actions))
    got = ps.imagine_rollout(ps.carry, torch.from_numpy(actions),
                             use_sample=False)
    _assert_close(got, want)


def test_large_deployment_tick():
    """One deployment_forward tick of the LARGE model: the newest frame's
    stride-8 tokens (8 x 16 image + 8 x 16 range view at this size), the
    posterior step and every decoder, against muvo_tpu's session."""
    batch, jax_batch, js, ps = _sessions(large=True)
    assert ps.model.feat_decoder.__class__.__name__ == "Decoder"
    _assert_close(ps.deployment_forward(batch, is_dreaming=False),
                  js.deployment_forward(jax_batch, is_dreaming=False))
