"""Optimizer: AdamW with decay masking, the OneCycle schedule, gradient
accumulation and layer freezing (counterpart of muvo_tpu/training/optim.py).

``make_schedule`` reproduces optax.cosine_onecycle_schedule value for value
(a cosine piecewise interpolation between the accumulated scales),
including muvo_tpu's clamp of the step count to at least 1 / PCT_START.
It is not torch.optim.lr_scheduler.OneCycleLR, whose phase boundaries
differ by a step. AdamW is torch's, with optax.adamw's defaults (betas 0.9
and 0.999, eps 1e-8, decoupled weight decay scaled by the learning rate);
parameters of one dimension (biases, norm scales) are not decayed, and
frozen parameters are left out of the optimizer, as optax's set_to_zero
leaves them unchanged.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from muvo_tpu_torch.parallel import mesh


def make_schedule(cfg) -> Callable[[int], float]:
    """The learning rate of optimizer update ``count`` (0, 1, ...)."""
    lr = float(cfg.OPTIMIZER.LR)
    if cfg.SCHEDULER.NAME == "none":
        return lambda count: lr
    if cfg.SCHEDULER.NAME != "OneCycleLR":
        raise ValueError(f"Unknown scheduler: {cfg.SCHEDULER.NAME}")
    pct = float(cfg.SCHEDULER.PCT_START)
    # optax divides by the warm-up span pct * steps: below one step that is
    # NaN at every step, hence muvo_tpu's clamp
    steps = max(cfg.STEPS, math.ceil(1.0 / pct))
    div_factor, final_div_factor = 25.0, 1e4
    # optax.piecewise_interpolate_schedule('cosine', ...) with its
    # boundaries_and_scales dict (a repeated boundary keeps the later scale)
    scales = {int(pct * steps): div_factor,
              int(steps): 1.0 / (div_factor * final_div_factor)}
    bounds = [0] + sorted(scales)
    values = [lr / div_factor]
    for b in sorted(scales):
        values.append(values[-1] * scales[b])

    def schedule(count: int) -> float:
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct_i = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct_i)
                                                    + 1)
        return values[-1]

    return schedule


def frozen(name: str, train_list) -> bool:
    """True for a parameter whose top-level module is not in train_list."""
    top = name.split(".")[0]
    return not any(top.startswith(t) for t in train_list)


def param_groups(cfg, model: nn.Module) -> List[Dict]:
    """AdamW groups: decayed (rank >= 2) and not decayed; frozen parameters
    (OPTIMIZER.FROZEN) are in neither."""
    train_list = list(cfg.OPTIMIZER.FROZEN.TRAIN_LIST)
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if cfg.OPTIMIZER.FROZEN.ENABLED and frozen(name, train_list):
            continue
        (decay if p.ndim > 1 else no_decay).append(p)
    return [{"params": decay, "weight_decay": cfg.OPTIMIZER.WEIGHT_DECAY},
            {"params": no_decay, "weight_decay": 0.0}]


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    return torch.optim.AdamW(param_groups(cfg, model),
                             lr=float(cfg.OPTIMIZER.LR), betas=(0.9, 0.999),
                             eps=1e-8)


class Optimizer:
    """AdamW on the schedule, with optax.MultiSteps' gradient accumulation:
    ``step`` takes one micro-batch's gradients (in the parameters' .grad);
    every ACCUMULATE_GRAD_BATCHES-th call applies their mean at the
    learning rate of the update count, which advances once per update.
    ``state_dict`` holds all of it, the accumulated gradients included
    (keyed by parameter name), so a run resumed between two updates goes
    on as if it had not stopped.

    In a group of ranks each rank accumulates its own gradients and the
    applying call averages them over the ranks before AdamW
    (parallel/mesh.py): one all-reduce an update, whatever
    ACCUMULATE_GRAD_BATCHES is. The mean over micro-batches and the mean
    over ranks commute, so the update is the one-process update at the
    global batch."""

    def __init__(self, cfg, model: nn.Module):
        self.model = model
        self.adamw = make_optimizer(cfg, model)
        self.schedule = make_schedule(cfg)
        self.every = max(1, int(cfg.OPTIMIZER.ACCUMULATE_GRAD_BATCHES))
        self.mini_step = 0
        self.updates = 0
        self.acc: Dict[nn.Parameter, torch.Tensor] = {}

    def step(self) -> bool:
        """Returns True when this call updated the parameters."""
        params = [p for g in self.adamw.param_groups for p in g["params"]]
        if self.every > 1:
            n = self.mini_step
            for p in params:
                if p.grad is None:
                    continue
                acc = self.acc.get(p)
                # running mean, as optax.MultiSteps: acc + (g - acc) / (n + 1)
                self.acc[p] = (p.grad.clone() if acc is None
                               else acc + (p.grad - acc) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.every:
                self.model.zero_grad(set_to_none=True)
                return False
            for p in params:
                p.grad = self.acc.pop(p, None)
            self.mini_step = 0
        mesh.average_gradients(params)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.adamw.step()
        self.model.zero_grad(set_to_none=True)
        self.updates += 1
        return True

    def average_accumulated(self) -> None:
        """In a group of ranks, the accumulated gradients replaced by their
        mean over the ranks, so that any rank's optimizer state is every
        rank's (a checkpoint holds rank 0's). The applying call's mean is
        the same either way."""
        mesh.average_(list(self.acc.values()))

    def state_dict(self) -> Dict:
        """AdamW's state, the micro-batch and update counts, and the
        accumulated gradients by parameter name."""
        names = {p: n for n, p in self.model.named_parameters()}
        return {"adamw": self.adamw.state_dict(),
                "mini_step": self.mini_step, "updates": self.updates,
                "acc": {names[p]: t for p, t in self.acc.items()}}

    def load_state_dict(self, state: Dict) -> None:
        params = dict(self.model.named_parameters())
        unknown = set(state["acc"]) - set(params)
        if unknown:
            raise KeyError(f"accumulated gradients of unknown parameters: "
                           f"{sorted(unknown)[:5]}")
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])
        self.acc = {params[n]: t.to(params[n].device)
                    for n, t in state["acc"].items()}
