"""The port's eval step against muvo_tpu's, on the CPU in fp32.

WorldModelTrainer.eval_step observes the receptive field (RF 2 frames) and
imagines the future horizon (FH 1) from the last posterior state; it is
held against muvo_tpu's make_eval_step on tiny_test_cfg (voxel 64^3, the
Pallas kernels in interpret mode), with the same seeded weights and batch
and sampling at the mean on both sides (tests/torch_port_common.py).
The same holds with MODEL.TRANSFORMER.LARGE (stride-8 features through the
top-down Decoder; on the CPU both sides take their math attention path).
Tolerance: each loss term of both passes 1e-4 relative (fp32, summation
order), as the train step's; the decoded outputs 1e-3 norm-relative
(|got - want| / |want|, Frobenius norms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muvo_tpu.training.trainer import TrainState
from muvo_tpu_torch.data.synthetic import synthetic_batch
from muvo_tpu_torch.training.trainer import WorldModelTrainer
from torch_port_common import (
    deterministic_jax,
    fp32_cfgs,
    import_torch_dynamo,
    jax_trainer_and_state,
    port_model,
)

import_torch_dynamo()  # WorldModelTrainer builds a torch.optim optimizer

LOSS_TOL = 1e-4
OUTPUT_TOL = 1e-3


def _eval_pair(large: bool):
    mp = pytest.MonkeyPatch()
    try:
        deterministic_jax(mp)
        jcfg, pcfg = fp32_cfgs()
        jcfg.MODEL.TRANSFORMER.LARGE = pcfg.MODEL.TRANSFORMER.LARGE = large
        batch = synthetic_batch(pcfg, 2, 3, seed=4)
        trainer, state = jax_trainer_and_state(jcfg, batch)
        trainer.compute_dtype = jnp.float32
        eval_fn = trainer.make_eval_step()
        want = jax.device_get(eval_fn(
            TrainState(jnp.zeros((), jnp.int32), state.params,
                       state.batch_stats, None),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0)))
    finally:
        mp.undo()
    port = WorldModelTrainer(pcfg, device="cpu")
    port.init_state(model=port_model(state, pcfg))
    got = port.eval_step(batch, stochastic=False)
    return got, want, port


@pytest.fixture(scope="module")
def eval_pair():
    return _eval_pair(large=False)


@pytest.fixture(scope="module")
def eval_pair_large():
    return _eval_pair(large=True)


def _assert_losses_match(pair, part):
    got, want, _ = pair
    assert set(got[part]) == set(want[part])
    for key, w in want[part].items():
        w = float(w)
        g = got[part][key].item()
        assert abs(g - w) <= LOSS_TOL * max(abs(w), 1e-6), (part, key, g, w)


@pytest.mark.parametrize("part", ["losses", "losses_imagine"])
def test_eval_losses_match(eval_pair, part):
    _assert_losses_match(eval_pair, part)


@pytest.mark.parametrize("part", ["losses", "losses_imagine"])
def test_large_eval_losses_match(eval_pair_large, part):
    _assert_losses_match(eval_pair_large, part)


def _assert_outputs_match(pair, part):
    got, want, _ = pair
    keys = [k for k in want[part] if isinstance(want[part][k], np.ndarray)
            and k in got[part] and torch.is_tensor(got[part][k])]
    assert any(k.startswith("voxel") for k in keys), keys
    for key in keys:
        g = got[part][key].double().numpy()
        w = np.asarray(want[part][key], np.float64)
        assert g.shape == w.shape, (key, g.shape, w.shape)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= OUTPUT_TOL, (part, key, rel)


@pytest.mark.parametrize("part", ["output", "output_imagine"])
def test_eval_outputs_match(eval_pair, part):
    _assert_outputs_match(eval_pair, part)


@pytest.mark.parametrize("part", ["output", "output_imagine"])
def test_large_eval_outputs_match(eval_pair_large, part):
    _assert_outputs_match(eval_pair_large, part)


def test_eval_step_returns_to_train_mode(eval_pair):
    _, _, port = eval_pair
    model = port.state.model
    assert model.training
    assert all(m.training for m in model.modules())
