"""The port's optimizer (muvo_tpu_torch/training/optim.py) against
muvo_tpu's optax chain, on the CPU.

Tolerances: the learning rate 1e-4 relative (optax evaluates the schedule
in fp32, the port in fp64; near the end of the cosine 1 + cos cancels and
fp32 keeps about 3e-5 of it); parameters after AdamW steps 1e-5 relative
and 1e-6 absolute (fp32, the same arithmetic in another order, through
Adam's division by the root of the second moment).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from muvo_tpu.data.synthetic import tiny_test_cfg as jax_tiny_cfg
from muvo_tpu.training.optim import make_optimizer as jax_make_optimizer
from muvo_tpu.training.optim import make_schedule as jax_make_schedule
from muvo_tpu_torch.data.synthetic import tiny_test_cfg
from muvo_tpu_torch.training.optim import Optimizer, make_schedule
from torch_port_common import import_torch_dynamo

import_torch_dynamo()  # torch.optim's first step imports it


@pytest.mark.parametrize("steps", [100, 2])
def test_schedule_equals_make_schedule(steps):
    """Every step of OneCycle; at STEPS 2 muvo_tpu clamps the step count to
    ceil(1 / PCT_START) (below one warm-up step optax gives NaN)."""
    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    jcfg.STEPS = pcfg.STEPS = steps
    want, got = jax_make_schedule(jcfg), make_schedule(pcfg)
    n = max(steps, 5) + 5
    w = np.array([float(want(i)) for i in range(n)])
    g = np.array([got(i) for i in range(n)])
    assert np.isfinite(w).all()
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
    assert g.argmax() == w.argmax() == int(0.2 * max(steps, 5))


class _Tiny(nn.Module):
    """A small tree: two matrices (decayed) and two vectors (not)."""

    def __init__(self, rs):
        super().__init__()
        self.fc = nn.Linear(4, 3)
        self.head = nn.Linear(3, 2)
        for p in self.parameters():
            p.data = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))

    def tree(self):
        return {"fc": {"kernel": self.fc.weight.detach().numpy().T.copy(),
                       "bias": self.fc.bias.detach().numpy().copy()},
                "head": {"kernel": self.head.weight.detach().numpy().T.copy(),
                         "bias": self.head.bias.detach().numpy().copy()}}


def _grads(rs):
    return {"fc": {"kernel": rs.randn(4, 3).astype(np.float32),
                   "bias": rs.randn(3).astype(np.float32)},
            "head": {"kernel": rs.randn(3, 2).astype(np.float32),
                     "bias": rs.randn(2).astype(np.float32)}}


def _set_grads(model, g):
    model.fc.weight.grad = torch.from_numpy(g["fc"]["kernel"].T.copy())
    model.fc.bias.grad = torch.from_numpy(g["fc"]["bias"])
    model.head.weight.grad = torch.from_numpy(g["head"]["kernel"].T.copy())
    model.head.bias.grad = torch.from_numpy(g["head"]["bias"])


def _run(accumulate: int, frozen, n_calls: int):
    jcfg, pcfg = jax_tiny_cfg(), tiny_test_cfg()
    for cfg in (jcfg, pcfg):
        cfg.STEPS = 10
        cfg.OPTIMIZER.LR = 0.05
        cfg.OPTIMIZER.WEIGHT_DECAY = 0.1
        cfg.OPTIMIZER.ACCUMULATE_GRAD_BATCHES = accumulate
        cfg.OPTIMIZER.FROZEN.ENABLED = frozen is not None
        cfg.OPTIMIZER.FROZEN.TRAIN_LIST = frozen or []
    rs = np.random.RandomState(0)
    model = _Tiny(rs)
    params = jax.tree_util.tree_map(jnp.asarray, model.tree())
    tx = jax_make_optimizer(jcfg, params)
    state = tx.init(params)
    opt = Optimizer(pcfg, model)
    updated = []
    for _ in range(n_calls):
        g = _grads(rs)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(model, g)
        updated.append(opt.step())
    got = model.tree()
    for path in (("fc", "kernel"), ("fc", "bias"), ("head", "kernel"),
                 ("head", "bias")):
        np.testing.assert_allclose(got[path[0]][path[1]],
                                   np.asarray(params[path[0]][path[1]]),
                                   rtol=1e-5, atol=1e-6, err_msg=str(path))
    return model, opt, updated


def test_adamw_three_steps_with_decay_mask():
    model, opt, updated = _run(1, None, 3)
    assert updated == [True] * 3 and opt.updates == 3
    decayed = {id(p) for p in opt.adamw.param_groups[0]["params"]}
    assert decayed == {id(model.fc.weight), id(model.head.weight)}


def test_multisteps_averages_two_micro_batches():
    """k=2: updates on every second call with the mean gradient, and the
    schedule advances once per update."""
    _, opt, updated = _run(2, None, 4)
    assert updated == [False, True, False, True]
    assert opt.updates == 2


def test_frozen_parameters_stay_put():
    model, opt, _ = _run(1, ["head"], 2)
    trained = {id(p) for g in opt.adamw.param_groups for p in g["params"]}
    assert trained == {id(model.head.weight), id(model.head.bias)}
