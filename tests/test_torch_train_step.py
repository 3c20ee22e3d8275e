"""The port's training step against muvo_tpu's, on the CPU in fp32.

tiny_test_cfg (voxel 64^3, so the voxel decoder's conv2 and conv3 take the
kernel path on both sides: MUVO_CONV3D=pallas runs muvo_tpu's Pallas
kernels in interpret mode, as tests/test_torch_voxel_decoder.py does),
the same seeded weights on both sides (tests/torch_port_common.py), the
same batch. Sampling takes the mean and dropout and augmentation are off:
the port through ``stochastic=False``, muvo_tpu by monkeypatching in this
file only (torch and JAX random streams differ).

Norm-relative means |got - want| / |want| per leaf, Frobenius norms, the
leaf's own norm and no floor. Tolerances:
- each loss term: 1e-4 relative (fp32, summation order);
- each gradient leaf: 2e-3 norm-relative, plus NOISE_FACTOR times
  muvo_tpu's own fp32 noise on this input, the norm-relative change of
  its gradient when every parameter moves by a relative 1e-7 (about one
  fp32 ulp), the larger of two draws. This model's fp32 gradients are
  ill-conditioned at this size: that one-ulp change moves muvo_tpu's
  gradient by a median 1.7e-4 and up to 3e-2 norm-relative, most in the
  voxel decoder (AdaIN over a few voxels) and above ReLU kinks, so a
  bare 2e-3 would fail on noise that either side would show against
  itself. The test prints its readings (pytest -s). A leaf that is zero
  on muvo_tpu's side must be zero on the port's;
- the AdamW update: the port's optimizer takes muvo_tpu's gradients, and
  its update (parameters after minus before) is held to optax's, 2e-3
  norm-relative per leaf. The step runs at a learning rate of 1 (OneCycle
  starts at LR / 25) and weight decay 0.5, so that Adam's term and the
  decay term are both far above fp32 rounding of the parameters;
- the BatchNorm running statistics after the step: 2e-3 norm-relative.
The LARGE case (test_large_step_matches, marked slow) holds the port's
fp32 step against muvo_tpu's step in float64 (jax.enable_x64), and each
leaf's noise is the port's own fp32 rounding: its fp32 gradient against
its float64 one. In fp32 the image encoder's gradients below its first
stride-32 BatchNorm (48 values a channel, whose gradient sums cancel to a
small remainder) round by up to 1.2e-2 norm-relative in muvo_tpu and
5e-4 in the port, each against its own float64 step, while a one-ulp
change of the parameters moves them by about 5e-4; the two float64 steps
agree to a median 6e-5.
test_checks_fail_on_broken_steps shows that each check fails for a
zeroed or halved gradient leaf, an update not applied, and an update
without weight decay.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.models.rssm import RSSM as JaxRSSM
from muvo_tpu.training.optim import make_optimizer as jax_make_optimizer
from muvo_tpu_torch.data.synthetic import synthetic_batch
from muvo_tpu_torch.models.rssm import RSSM
from muvo_tpu_torch.training.objectives import compute_loss, reduce_loss
from muvo_tpu_torch.training.optim import Optimizer
from muvo_tpu_torch.training.trainer import WorldModelTrainer
from muvo_tpu_torch.weights import running_stats, state_dict_from_jax
from torch_port_common import (
    deterministic_jax,
    fp32_cfgs,
    import_torch_dynamo,
    jax_trainer_and_state,
    port_model,
)

import_torch_dynamo()  # torch.optim's first step imports it

LOSS_TOL = 1e-4
NORM_TOL = 2e-3
NOISE_FACTOR = 8.0  # (rel - NORM_TOL) / noise reaches 3.3 over the 440 leaves
ULP = 1e-7  # relative parameter change that estimates muvo_tpu's noise
NOISE_DRAWS = 2
LR_STEP0 = 1.0
WEIGHT_DECAY = 0.5


def _norm_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    if den == 0.0:
        return 0.0 if num == 0.0 else np.inf
    return num / den


def _grad_ok(got, want, noise):
    return _norm_rel(got, want) <= NORM_TOL + NOISE_FACTOR * noise


def _port_update(model, optimizer, grads):
    """Step ``optimizer`` once with ``grads`` in the parameters' .grad;
    the change of every parameter, in float64."""
    before = {n: p.detach().double().clone()
              for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = grads[n].detach().float().clone()
    assert optimizer.step()
    return {n: p.detach().double() - before[n]
            for n, p in model.named_parameters()}


def _float64_grads(port, batch):
    """The port's gradients of the same step (no noise or dropout) in
    float64, on a copy of its model."""
    model = copy.deepcopy(port.state.model).double().train()
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        pb = port.preprocess(port.to_device(batch), training=False)
        pb = {k: v.double() if v.is_floating_point() else v
              for k, v in pb.items()}
        output, _ = model(pb, training=True, stochastic=False)
        reduce_loss(compute_loss(port.cfg, pb, output)).backward()
    finally:
        torch.set_default_dtype(default)
    return {n: p.grad for n, p in model.named_parameters()}


def _step_pair(large: bool):
    """One training step on both sides: losses, gradients and each leaf's
    noise, the AdamW update from the same gradients, and the BatchNorm
    running statistics. muvo_tpu's step runs in fp32 with its one-ulp
    noise, or for the LARGE step in float64 with the port's own fp32
    rounding as the noise."""
    mp = pytest.MonkeyPatch()
    try:
        deterministic_jax(mp)
        jcfg, pcfg = fp32_cfgs()
        for cfg in (jcfg, pcfg):
            cfg.OPTIMIZER.LR = 25.0 * LR_STEP0
            cfg.OPTIMIZER.WEIGHT_DECAY = WEIGHT_DECAY
            cfg.MODEL.TRANSFORMER.LARGE = large
        batch = synthetic_batch(pcfg, 2, 3, seed=3)
        trainer, state = jax_trainer_and_state(jcfg, batch)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        with jax.enable_x64(large):
            trainer.compute_dtype = jnp.float64 if large else jnp.float32
            params, stats = state.params, state.batch_stats
            if large:
                params, stats = jax.tree_util.tree_map(
                    lambda p: jnp.asarray(p, jnp.float64), (params, stats))
            grad_fn = jax.jit(jax.value_and_grad(
                lambda p, s, b: trainer._loss_fn(
                    p, s, b, jax.random.PRNGKey(0), True), has_aux=True))
            (total, (losses, new_stats)), grads = grad_fn(params, stats,
                                                          jbatch)
            want_grads = state_dict_from_jax(jax.device_get(grads), None,
                                             pcfg)
            rs = np.random.RandomState(7)
            noise = {k: 0.0 for k in want_grads}
            for _ in range(0 if large else NOISE_DRAWS):
                moved = jax.tree_util.tree_map(
                    lambda p: (np.asarray(p) * (1.0 + ULP * rs.standard_normal(
                        np.shape(p)))).astype(np.float32), state.params)
                other = state_dict_from_jax(jax.device_get(
                    grad_fn(moved, state.batch_stats, jbatch)[1]), None, pcfg)
                for k, w in want_grads.items():
                    noise[k] = max(noise[k], _norm_rel(other[k], w))
            tx = jax_make_optimizer(jcfg, params)
            updates, _ = tx.update(grads, tx.init(params), params)
            want = {
                "losses": {"loss": float(total),
                           **{k: float(v) for k, v in losses.items()}},
                "grads": want_grads,
                "noise": noise,
                "updates": state_dict_from_jax(jax.device_get(updates), None,
                                               pcfg),
                "stats": running_stats(state_dict_from_jax(
                    jax.device_get(state.params), jax.device_get(new_stats),
                    pcfg)),
            }
    finally:
        mp.undo()

    port = WorldModelTrainer(pcfg, device="cpu")
    port.init_state(model=port_model(state, pcfg))
    if large:
        exact = _float64_grads(port, batch)
    metrics, grads = port.grads(batch, stochastic=False)
    if large:
        want["noise"] = {k: _norm_rel(g.detach(), exact[k])
                         for k, g in grads.items()}
    model = port.state.model
    got = {"losses": {k: v.item() for k, v in metrics.items()},
           "grads": {k: g.detach().clone() for k, g in grads.items()},
           "stats": {k: v.clone()
                     for k, v in running_stats(model.state_dict()).items()}}
    no_decay_cfg = pcfg.clone()
    no_decay_cfg.OPTIMIZER.WEIGHT_DECAY = 0.0
    twin = copy.deepcopy(model)
    got["updates_without_decay"] = _port_update(
        twin, Optimizer(no_decay_cfg, twin), want["grads"])
    got["updates"] = _port_update(model, port.state.optimizer, want["grads"])
    return got, want


@pytest.fixture(scope="module")
def step_pair():
    return _step_pair(large=False)


def _assert_losses_match(got, want):
    assert set(got["losses"]) == set(want["losses"])
    for key, w in want["losses"].items():
        assert abs(got["losses"][key] - w) <= LOSS_TOL * max(abs(w), 1e-6), (
            key, got["losses"][key], w)


def test_loss_terms_match(step_pair):
    _assert_losses_match(*step_pair)


def _assert_grads_match(got, want):
    assert set(got["grads"]) == set(want["grads"])  # no leaf uncompared
    rel = {k: _norm_rel(got["grads"][k], w) for k, w in want["grads"].items()}
    bad = {k: (rel[k], want["noise"][k]) for k, w in want["grads"].items()
           if not _grad_ok(got["grads"][k], w, want["noise"][k])}
    finite = [v for v in rel.values() if np.isfinite(v)]
    print(f"gradient leaves {len(rel)}, "
          f"{sum(v > NORM_TOL for v in rel.values())} above {NORM_TOL}: "
          f"norm-relative median "
          f"{np.median(finite):.3e}, worst {max(finite):.3e} "
          f"({max(rel, key=rel.get)}); noise median "
          f"{np.median(list(want['noise'].values())):.3e}, worst "
          f"{max(want['noise'].values()):.3e}; worst ratio "
          f"(rel - {NORM_TOL}) / noise "
          f"{max((rel[k] - NORM_TOL) / max(want['noise'][k], 1e-30) for k in rel):.3f}")
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1][0])[:5]


def test_every_grad_leaf_matches(step_pair):
    _assert_grads_match(*step_pair)


def _assert_update_and_stats_match(got, want):
    assert set(got["updates"]) == set(want["updates"])
    rel = {k: _norm_rel(got["updates"][k], u)
           for k, u in want["updates"].items()}
    print(f"update leaves {len(rel)}: worst norm-relative "
          f"{max(rel.values()):.3e}")
    assert max(rel.values()) < NORM_TOL, max(rel.items(), key=lambda kv: kv[1])
    assert want["stats"]  # the encoders' BatchNorms are in the comparison
    assert set(got["stats"]) == set(want["stats"])
    rel = {k: _norm_rel(got["stats"][k], w) for k, w in want["stats"].items()}
    print(f"running statistics {len(rel)}: worst norm-relative "
          f"{max(rel.values()):.3e}")
    assert max(rel.values()) < NORM_TOL, max(rel.items(), key=lambda kv: kv[1])


def test_updated_params_and_batch_stats_match(step_pair):
    _assert_update_and_stats_match(*step_pair)


@pytest.mark.slow  # about 3 minutes: muvo_tpu's float64 step compiles
def test_large_step_matches():
    """The same step with MODEL.TRANSFORMER.LARGE: stride-8 features through
    the top-down Decoder, 256 fusion tokens a frame at this size (on the
    CPU both sides take their math attention path), against muvo_tpu's
    step in float64."""
    got, want = _step_pair(large=True)
    assert any(".upsample_skip_convs." in k for k in want["grads"])
    _assert_losses_match(got, want)
    _assert_grads_match(got, want)
    _assert_update_and_stats_match(got, want)


@pytest.mark.parametrize("fault", ["zeroed_gradient", "halved_gradient",
                                   "unapplied_update",
                                   "update_without_weight_decay"])
def test_checks_fail_on_broken_steps(step_pair, fault):
    """Each comparison above fails for a broken step, leaf by leaf."""
    got, want = step_pair
    if fault in ("zeroed_gradient", "halved_gradient"):
        scale = 0.0 if fault == "zeroed_gradient" else 0.5
        missed = [k for k, w in want["grads"].items() if w.abs().max() > 0
                  and _grad_ok(scale * w, w, want["noise"][k])]
        assert not missed, missed
    elif fault == "unapplied_update":
        missed = [k for k, u in want["updates"].items() if u.abs().max() > 0
                  and _norm_rel(torch.zeros_like(u), u) < NORM_TOL]
        assert not missed, missed
    else:
        for k, u in want["updates"].items():
            rel = _norm_rel(got["updates_without_decay"][k], u)
            assert (rel >= NORM_TOL) == (u.ndim > 1), (k, rel)  # decayed


def test_rssm_sequence_loop_with_forced_dropout_flags():
    """The RSSM over a sequence against muvo_tpu's scan, with the posterior
    dropout flags forced and sampling at the mean."""
    from muvo_tpu_torch.weights import rssm_entries, to_tensors

    rs = np.random.RandomState(0)
    b, s, emb, a = 2, 4, 8, 2
    jm = JaxRSSM(embedding_dim=emb, action_dim=a, hidden_state_dim=12,
                 state_dim=6, action_latent_dim=4, use_dropout=True,
                 dropout_probability=0.5)
    e = rs.randn(b, s, emb).astype(np.float32)
    act = rs.randn(b, s, a).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(e), jnp.asarray(act),
                     use_sample=False)
    pm = RSSM(emb, a, 12, 6, 4)
    sd = {}
    rssm_entries(sd, "", params["params"])
    pm.load_state_dict(to_tensors(sd), strict=True)
    flags = np.array([False, True, False, True])

    # muvo_tpu draws the flags from its key: reproduce them with a forced
    # uniform draw (u < p where flags are set)
    def forced_uniform(key, shape=(), *args, **kwargs):
        return jnp.where(jnp.asarray(flags), 0.0, 1.0)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", forced_uniform)
    try:
        want = jm.apply(params, jnp.asarray(e), jnp.asarray(act),
                        use_sample=False, training=True,
                        rng=jax.random.PRNGKey(1))
    finally:
        mp.undo()
    with torch.no_grad():
        got = pm(torch.from_numpy(e), torch.from_numpy(act), use_sample=False,
                 training=True, use_prior=torch.from_numpy(flags))
    for part in ("prior", "posterior"):
        for key in ("hidden_state", "sample", "mu", "sigma"):
            g, w = got[part][key].numpy(), np.asarray(want[part][key])
            assert g.shape == w.shape == (b, s) + w.shape[2:]
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{part} {key}")
    # with the flags forced off the next step sees the posterior sample,
    # so forcing them changed the rollout
    with torch.no_grad():
        off = pm(torch.from_numpy(e), torch.from_numpy(act), use_sample=False,
                 training=True, use_prior=torch.zeros(s, dtype=torch.bool))
    assert not torch.allclose(off["prior"]["mu"][:, 2], got["prior"]["mu"][:, 2])
