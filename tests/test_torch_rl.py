"""The port's PPO expert (muvo_tpu_torch/rl/, sim/ copies, train_rl)
against muvo_tpu's on seeded numpy inputs, on the CPU.

Tolerances: the distributions, the networks at 192 x 192 with carried
weights, the policy's outputs and losses, and one PPO minibatch update
(every parameter after it), fp32 within 1e-5 norm-relative; the update's
losses within 1e-5 x max(1, |value|) (its KL of two close Betas is a
difference of O(1) terms); the global-norm clip within 1e-6 of optax's
(the norm's sums round apart); GAE and the buffer's flattening, and the
observation and action processing, exactly. The Beta sampler (its own
Marsaglia-Tsang gamma on an explicit generator; torch's and JAX's streams
differ) is held to the first two moments within 5 standard errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.rl import agent as jax_agent
from muvo_tpu.rl import distributions as jd
from muvo_tpu.rl.policy import PpoPolicy as JaxPolicy
from muvo_tpu.rl.ppo import PPO as JaxPPO
from muvo_tpu.rl.ppo import RolloutBuffer as JaxBuffer
from muvo_tpu.sim.kinematic_env import KinematicDrivingEnv as JaxEnv
from muvo_tpu_torch import train_rl
from muvo_tpu_torch.rl import agent
from muvo_tpu_torch.rl import distributions as pd
from muvo_tpu_torch.rl.policy import PpoPolicy
from muvo_tpu_torch.rl.ppo import PPO, RolloutBuffer
from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv
from muvo_tpu_torch.weights import flat_rows, ppo_state_dict_from_jax
from torch_port_common import flax_init, import_torch_dynamo

import_torch_dynamo()  # torch.optim's first step imports it

TOL = 1e-5
BIRDVIEW = (15, 192, 192)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    num, den = np.linalg.norm(got - want), np.linalg.norm(want)
    return num / max(den, 1e-30) if den else float(num)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert np.shape(got) == np.shape(want), (np.shape(got), np.shape(want))
    assert _rel(got, want) <= tol, _rel(got, want)


# ---------------------------------------------------------------------------
# distributions


def _beta_pair(rs, n=64):
    draw = [rs.uniform(0.3, 6.0, (n, 2)).astype(np.float32) for _ in range(4)]
    return draw, rs.uniform(0.01, 0.99, (n, 2)).astype(np.float32)


def _codes(rs, n=64):
    return (rs.randint(0, 3, n).astype(np.int32),
            rs.randint(0, 3, n).astype(np.int32))


def test_beta_matches_muvo_tpu():
    rs = np.random.RandomState(0)
    (a, b, a2, b2), x = _beta_pair(rs)
    acc, steer = _codes(rs)
    # every case of the piecewise mode
    a[:4, 0], b[:4, 0] = (2.0, 0.5, 2.0, 0.5), (2.0, 2.0, 0.5, 0.5)
    got, other = pd.BetaDist(_t(a), _t(b)), pd.BetaDist(_t(a2), _t(b2))
    want = jd.BetaDist(jnp.asarray(a), jnp.asarray(b))
    want_other = jd.BetaDist(jnp.asarray(a2), jnp.asarray(b2))
    _close(got.log_prob(_t(x)), want.log_prob(jnp.asarray(x)))
    _close(got.entropy(), want.entropy())
    _close(got.entropy_loss(), want.entropy_loss())
    _close(got.kl(other), want.kl(want_other))
    _close(got.mode(), want.mode())
    _close(got.exploration_loss(_t(acc), _t(steer)),
           want.exploration_loss(jnp.asarray(acc), jnp.asarray(steer)))


def test_gaussians_match_muvo_tpu():
    rs = np.random.RandomState(1)
    mu, mu2 = (rs.randn(64, 2).astype(np.float32) for _ in range(2))
    sigma, sigma2 = (rs.uniform(0.2, 2.0, (64, 2)).astype(np.float32)
                     for _ in range(2))
    x = rs.uniform(-0.99, 0.99, (64, 2)).astype(np.float32)
    acc, steer = _codes(rs)
    got = pd.DiagGaussianDist(_t(mu), _t(sigma))
    want = jd.DiagGaussianDist(jnp.asarray(mu), jnp.asarray(sigma))
    _close(got.log_prob(_t(x)), want.log_prob(jnp.asarray(x)))
    _close(got.entropy(), want.entropy())
    _close(got.entropy_loss(), want.entropy_loss())
    _close(got.kl(pd.DiagGaussianDist(_t(mu2), _t(sigma2))),
           want.kl(jd.DiagGaussianDist(jnp.asarray(mu2),
                                       jnp.asarray(sigma2))))
    _close(got.mode(), want.mode())
    _close(got.exploration_loss(_t(acc), _t(steer)),
           want.exploration_loss(jnp.asarray(acc), jnp.asarray(steer)))
    sq = pd.SquashedGaussianDist(_t(mu), _t(sigma))
    sq_want = jd.SquashedGaussianDist(jnp.asarray(mu), jnp.asarray(sigma))
    _close(sq.log_prob(_t(x)), sq_want.log_prob(jnp.asarray(x)))
    _close(sq.mode(), sq_want.mode())


@pytest.mark.parametrize("concentration", [(0.6, 3.0), (2.5, 1.2)])
def test_beta_sampler_moments_from_an_explicit_generator(concentration):
    """Below and above alpha 1 (the boosted and the direct gamma): the
    sample mean and variance within 5 standard errors of Beta's; the same
    generator seed draws the same samples; torch's global stream is not
    touched."""
    a, b = concentration
    n = 200_000
    dist = pd.BetaDist(torch.full((n,), a), torch.full((n,), b))
    before = torch.random.get_rng_state()
    x = dist.sample(torch.Generator().manual_seed(3)).double()
    assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(dist.sample(torch.Generator().manual_seed(3)).double(),
                       x)
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    # the sample variance's standard error: sqrt((m4 - var^2) / n)
    m4 = ((x - mean) ** 4).mean().item()
    assert abs(x.mean().item() - mean) <= 5 * math.sqrt(var / n)
    assert abs(x.var().item() - var) <= 5 * math.sqrt((m4 - var ** 2) / n)
    assert 0.0 <= x.min().item() and x.max().item() <= 1.0


# ---------------------------------------------------------------------------
# the networks and the policy with carried weights


def _inputs(rs, n=4):
    birdview = (rs.uniform(size=(n,) + BIRDVIEW) < 0.3).astype(np.float32)
    state = rs.randn(n, 6).astype(np.float32)
    return birdview, state


def _policies(feature_extractor="xtma_cnn", distribution="beta"):
    """muvo_tpu's PpoPolicy with seeded variables (biases spread) and the
    port's carrying them."""
    rs = np.random.RandomState(2)
    birdview, state = _inputs(rs, 2)
    jpolicy = JaxPolicy(feature_extractor=feature_extractor,
                        distribution=distribution)
    variables = flax_init(jpolicy, jnp.asarray(birdview.transpose(0, 2, 3, 1)),
                          jnp.asarray(state), jax.random.PRNGKey(1))
    policy = PpoPolicy(feature_extractor=feature_extractor,
                       distribution=distribution)
    policy.load_state_dict(ppo_state_dict_from_jax(variables, policy),
                           strict=True)
    return jpolicy, variables, policy


def _nhwc(birdview):
    return jnp.asarray(birdview.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("extractor", ["xtma_cnn", "impala_cnn"])
def test_feature_extractors_match_at_192(extractor):
    jpolicy, variables, policy = _policies(extractor)
    birdview, state = _inputs(np.random.RandomState(3))
    want = jpolicy.apply(variables, _nhwc(birdview), jnp.asarray(state),
                         method=lambda m, bv, st: m.features(bv, st))
    with torch.no_grad():
        got = policy.features_extractor(_t(birdview), _t(state))
    _close(got, want)
    assert policy.features_extractor.flat_shape == (
        (256, 2, 2) if extractor == "xtma_cnn" else (64, 6, 6))


@pytest.mark.parametrize("distribution", ["beta", "diag_gaussian"])
def test_policy_evaluate_actions_and_deterministic_forward(distribution):
    jpolicy, variables, policy = _policies(distribution=distribution)
    rs = np.random.RandomState(4)
    birdview, state = _inputs(rs)
    actions = rs.uniform(0.05, 0.95, (4, 2)).astype(np.float32)
    acc, steer = _codes(rs, 4)
    want = jpolicy.apply(variables, _nhwc(birdview), jnp.asarray(state),
                         jnp.asarray(actions), jnp.asarray(acc),
                         jnp.asarray(steer), method=jpolicy.evaluate_actions)
    with torch.no_grad():
        got = policy.evaluate_actions(_t(birdview), _t(state), _t(actions),
                                      _t(acc), _t(steer))
        for g, w in zip(got[:4], want[:4]):
            _close(g, w)
        for g, w in zip(got[4], want[4]):
            _close(g, w)
        want_fwd = jpolicy.apply(variables, _nhwc(birdview),
                                 jnp.asarray(state), jax.random.PRNGKey(0),
                                 deterministic=True)
        got_fwd = policy(_t(birdview), _t(state), deterministic=True)
        for g, w in zip(got_fwd, want_fwd):
            _close(g, w)
        value = policy.forward_value(_t(birdview), _t(state))
    _close(value, jpolicy.apply(variables, _nhwc(birdview),
                                jnp.asarray(state),
                                method=jpolicy.forward_value))


def _params_from_state_dict(sd, jparams, policy):
    """The inverse of ppo_state_dict_from_jax, into ``jparams``' tree."""
    inverse = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        inverse[jax.tree_util.keystr(path)] = leaf
    forward = ppo_state_dict_from_jax(jparams, policy)
    # each port entry, back through the same key map: the converter is
    # linear per leaf (a transpose, a row permutation or the identity)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        probe = jax.tree_util.tree_map(np.zeros_like, jparams)
        marker = np.arange(1, np.size(leaf) + 1, dtype=np.float64).reshape(
            np.shape(leaf))
        node = probe
        keys = [p.key for p in path]
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = marker
        mapped = ppo_state_dict_from_jax(probe, policy)
        hits = [(k, v.numpy()) for k, v in mapped.items()
                if np.any(v.numpy() != 0)]
        assert len(hits) == 1, (jax.tree_util.keystr(path), [h[0] for h in
                                                             hits])
        key, value = hits[0]
        # where each element of the leaf went
        flat = np.zeros(np.size(leaf))
        positions = value.reshape(-1)
        flat[positions.astype(np.int64) - 1] = sd[key].reshape(-1).astype(
            np.float64)
        out[jax.tree_util.keystr(path)] = flat.reshape(np.shape(leaf))
        assert forward[key].shape == sd[key].shape
    return out, inverse


@pytest.mark.parametrize("extractor,distribution", [
    ("xtma_cnn", "beta"), ("impala_cnn", "beta"),
    ("xtma_cnn", "diag_gaussian")])
def test_weight_round_trip_to_every_leaf(extractor, distribution):
    """Every muvo_tpu leaf lands in exactly one port entry, every port
    entry is filled (a strict load), and the port's state_dict carried
    back gives each leaf again, element for element."""
    _, variables, policy = _policies(extractor, distribution)
    sd = {k: v.numpy() for k, v in policy.state_dict().items()}
    back, want = _params_from_state_dict(sd, variables["params"], policy)
    assert set(back) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(back[key].astype(np.float32),
                                      np.asarray(leaf), err_msg=key)


def test_flat_rows_permutes_hwc_rows_to_chw_columns():
    c, h, w = 3, 2, 2
    kernel = np.arange((c * h * w + 2) * 5, dtype=np.float32).reshape(-1, 5)
    weight = flat_rows(kernel, (c, h, w))
    hwc = np.arange(c * h * w).reshape(h, w, c)
    for ci in range(c):
        for hi in range(h):
            for wi in range(w):
                np.testing.assert_array_equal(
                    weight[:, (ci * h + hi) * w + wi], kernel[hwc[hi, wi, ci]])
    np.testing.assert_array_equal(weight[:, -2:], kernel[-2:].T)


# ---------------------------------------------------------------------------
# the rollout buffer and PPO


def _fill(buffer_cls, rs, steps, obs_shapes, dones):
    buf = buffer_cls(steps, obs_shapes, n_envs=1, gamma=0.9, gae_lambda=0.8)
    for t in range(steps):
        buf.add({k: rs.randn(1, *s).astype(np.float32)
                 for k, s in obs_shapes.items()},
                rs.uniform(size=(1, 2)), rs.randn(1), np.array([dones[t]]),
                rs.randn(1), rs.randn(1), rs.uniform(1, 3, (1, 2)),
                rs.uniform(1, 3, (1, 2)), rs.randint(0, 3, 1),
                rs.randint(0, 3, 1))
    return buf


def test_gae_equals_muvo_tpus_rollout_buffer():
    dones = [0, 0, 1, 0, 0, 0, 1, 0]
    shapes = {"state": (6,)}
    got = _fill(RolloutBuffer, np.random.RandomState(5), 8, shapes, dones)
    want = _fill(JaxBuffer, np.random.RandomState(5), 8, shapes, dones)
    for buf in (got, want):
        buf.compute_returns_and_advantage(np.array([0.7]), np.array([0.0]))
    got_flat, want_flat = got.flatten(), want.flatten()
    assert set(got_flat) == set(want_flat)
    for key, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], value, err_msg=key)


def _minibatch(policy, rs, n=8):
    """A minibatch whose old log-probabilities sit 0.4 (half of them) or
    0.05 from the policy's, both ways, so the ratio clip engages for some,
    and large returns, so the global-norm clip does."""
    birdview, state = _inputs(rs, n)
    actions = rs.uniform(0.05, 0.95, (n, 2)).astype(np.float32)
    with torch.no_grad():
        _, lp, _, _, dist = policy.evaluate_actions(
            _t(birdview), _t(state), _t(actions),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32))
    shift = np.array([0.4, -0.4, 0.05, -0.05] * (n // 4), np.float32)
    return {"obs_birdview": birdview, "obs_state": state, "actions": actions,
            "old_values": rs.randn(n).astype(np.float32),
            "old_log_probs": lp.numpy() + shift,
            "old_p1": dist[0].numpy() * 1.1, "old_p2": dist[1].numpy(),
            "advantages": rs.randn(n).astype(np.float32),
            "returns": (20.0 * rs.randn(n)).astype(np.float32),
            "acc_codes": rs.randint(0, 3, n).astype(np.int32),
            "steer_codes": rs.randint(0, 3, n).astype(np.int32)}


def test_one_ppo_update_matches_muvo_tpu():
    jpolicy, variables, policy = _policies()
    mb = _minibatch(policy, np.random.RandomState(6))
    lr = 1e-4
    jppo = JaxPPO(jpolicy, variables, learning_rate=lr, batch_size=8)
    params, _, want = jppo._update(
        variables, jppo.opt_state,
        {k: jnp.asarray(v if k != "obs_birdview" else v.transpose(0, 2, 3, 1))
         for k, v in mb.items()})
    ppo = PPO(policy, learning_rate=lr, batch_size=8)
    ppo.loss({k: _t(v) for k, v in mb.items()})[0].backward()
    norm = math.sqrt(sum(float((p.grad ** 2).sum())
                         for p in policy.parameters()))
    assert norm > 10 * ppo.max_grad_norm  # the global-norm clip engages
    got = ppo.update(mb)
    assert 0.0 < float(want["clip_fraction"]) < 1.0  # the ratio clip too
    assert set(got) == set(want)
    for key, w in want.items():
        # the KL of two close Betas is a difference of O(1) terms
        assert abs(float(got[key]) - float(w)) <= TOL * max(abs(float(w)),
                                                            1.0), key
    want_sd = ppo_state_dict_from_jax(jax.device_get(params), policy)
    for key, value in policy.state_dict().items():
        _close(value, want_sd[key].numpy())


def test_clip_by_global_norm_is_optaxs():
    import optax

    from muvo_tpu_torch.rl.ppo import clip_by_global_norm_

    rs = np.random.RandomState(7)
    for scale in (0.01, 10.0):
        grads = [(scale * rs.randn(*s)).astype(np.float32)
                 for s in ((3, 4), (5,))]
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = _t(g).clone()
        clip_by_global_norm_(params, 0.5)
        want, _ = optax.clip_by_global_norm(0.5).update(
            [jnp.asarray(g) for g in grads], None)
        for p, w in zip(params, want):  # the norm's sums round apart
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the env copies, observation processing and train_rl


def test_kinematic_env_copy_steps_as_muvo_tpus():
    got_env, want_env = KinematicDrivingEnv(seed=3), JaxEnv(seed=3)
    got, want = got_env.reset(), want_env.reset()
    for t in range(5):
        control = {"hero": {"throttle": 0.5, "steer": 0.1 * t, "brake": 0.0}}
        got, got_r, got_d, _ = got_env.step(control)
        want, want_r, want_d, _ = want_env.step(control)
        assert got_r == want_r and got_d == want_d
    masks = want["hero"]["birdview"]["masks"]
    np.testing.assert_array_equal(got["hero"]["birdview"]["masks"], masks)
    pi = agent.process_obs(got["hero"], ["control", "vel_xy"], train=False)
    jpi = jax_agent.process_obs(want["hero"], ["control", "vel_xy"],
                                train=False)
    np.testing.assert_array_equal(pi["state"], jpi["state"])
    np.testing.assert_array_equal(pi["birdview"],
                                  jpi["birdview"].transpose(0, 3, 1, 2))
    hwc = {**got["hero"], "birdview": {"masks": masks.transpose(1, 2, 0)}}
    np.testing.assert_array_equal(
        agent.process_obs(hwc, ["control"])["birdview"], pi["birdview"][0])
    for action in (np.array([0.4, -0.3]), np.array([-0.7, 0.9])):
        assert (agent.process_act(action, True)
                == jax_agent.process_act(action, True))
        np.testing.assert_array_equal(
            agent.scale_action(action, -1.0, 1.0),
            jax_agent.scale_action(action, -1.0, 1.0))


def test_birdview_agent_drives_the_deterministic_policy():
    _, _, policy = _policies()
    expert = agent.RlBirdviewAgent(policy, device="cpu")
    obs = KinematicDrivingEnv(seed=1).reset()["hero"]
    control = expert.run_step(obs)
    pi = agent.process_obs(obs, ["control", "vel_xy"], train=False)
    with torch.no_grad():
        actions = policy(_t(pi["birdview"]), _t(pi["state"]),
                         deterministic=True)[0].numpy()
    want = agent.process_act(agent.scale_action(actions, -1.0, 1.0), True,
                             train=False)
    assert control == want
    assert expert.supervision_dict["action"].shape == (3,)


def test_train_rl_runs_48_steps_on_the_kinematic_env(tmp_path):
    out = tmp_path / "policy.pt"
    summaries = train_rl.main(
        ["--env", "kinematic", "--total-timesteps", "48", "--n-steps", "48",
         "--batch-size", "24", "--n-epochs", "2", "--episode-steps", "40",
         "--out", str(out)], device="cpu")
    assert len(summaries) == 1
    summary = summaries[0]
    assert summary["timesteps"] == 48 and 1 <= summary["n_updates"] <= 4
    assert all(math.isfinite(v) for k, v in summary.items()
               if k != "explained_variance")
    policy = PpoPolicy()
    policy.load_state_dict(torch.load(out, weights_only=True), strict=True)


def test_train_rl_refuses_carla_until_the_port_has_its_sim():
    """The port now has its sim/: --env carla builds its CARLA EndlessEnv,
    which raises the env's own ImportError without the carla package."""
    with pytest.raises(ImportError, match="carla"):
        train_rl.main(["--env", "carla"], device="cpu")
