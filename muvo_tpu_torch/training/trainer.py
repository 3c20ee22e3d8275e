"""World-model trainer (counterpart of muvo_tpu/training/trainer.py).

``train_step`` runs on-device preprocessing with labels and augmentation,
the model forward over the sequence, every loss of ``compute_loss``, the
backward pass and the AdamW / OneCycle update, on one device. The compute
type follows PRECISION (utils/precision.py): bf16 autocast on the card
with fp32 master weights. ``observe_step`` observes the receptive field
once a batch and ``imagine_step`` imagines the future horizon from it, as
often as a caller wants imagination samples; ``eval_step`` is one of each
and returns the losses of both.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from muvo_tpu_torch.device import resolve_device
from muvo_tpu_torch.models import init
from muvo_tpu_torch.models.preprocess import PreProcess
from muvo_tpu_torch.models.world_model import (MuvoWorldModel,
                                               imagine_inputs, last_state)
from muvo_tpu_torch.parallel import mesh
from muvo_tpu_torch.training.objectives import compute_loss, reduce_loss
from muvo_tpu_torch.training.optim import Optimizer
from muvo_tpu_torch.utils.precision import autocast, compute_dtype_from_cfg


def step_generator(device, step: int, seed: int = 42) -> torch.Generator:
    """The random stream of train step ``step``: a generator on ``device``
    seeded from (seed, step) alone, as muvo_tpu folds the step into one key
    (``fold_in(PRNGKey(42), step)``), so that a resumed run draws at each
    step what an uninterrupted run draws there. In a group of ranks the
    rank is folded in too, (seed, step, rank): each rank's slice of the
    batch draws its own augmentation, dropout and noise (muvo_tpu draws
    one key's values over the sharded global batch instead), and a
    resumed run of the same world size draws what the uninterrupted one
    draws."""
    key = (seed, step, mesh.rank()) if mesh.is_active() else (seed, step)
    entropy = np.random.SeedSequence(key).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(entropy[0]))


class TrainState:
    """The model (fp32 parameters, BatchNorm statistics), its optimizer and
    the number of train steps taken (micro-batches, as muvo_tpu counts)."""

    def __init__(self, model: MuvoWorldModel, optimizer: Optimizer):
        self.model = model
        self.optimizer = optimizer
        self.step = 0


class WorldModelTrainer:
    def __init__(self, cfg, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else compute_dtype_from_cfg(cfg))
        self.preprocess = PreProcess(cfg)
        self.rf = cfg.RECEPTIVE_FIELD
        self.fh = cfg.FUTURE_HORIZON
        # imagination needs the RSSM and a horizon, as muvo_tpu's trainer
        self.imagines = bool(cfg.MODEL.TRANSITION.ENABLED) and self.fh > 0
        self.state: Optional[TrainState] = None

    def init_state(self, seed: int = 42,
                   model: Optional[MuvoWorldModel] = None) -> TrainState:
        """A new model (drawn from muvo_tpu's initialisers with ``seed``,
        models/init.py, unless one is given) on the device, in training
        mode, with its optimizer."""
        if model is None:
            model = init.build(lambda: MuvoWorldModel(self.cfg), seed,
                               self.device)
        model = model.to(self.device).train()
        self.state = TrainState(model, Optimizer(self.cfg, model))
        return self.state

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _loss(self, pb, training, generator, stochastic):
        model = self.state.model
        with autocast(self.device, self.compute_dtype):
            output, state_dict = model(pb, training=training,
                                       generator=generator,
                                       stochastic=stochastic)
        # the losses upcast the (bf16) outputs at their first use
        losses = compute_loss(self.cfg, pb, output)
        return reduce_loss(losses), losses, state_dict

    def grads(self, batch: Dict, generator: Optional[torch.Generator] = None,
              stochastic: bool = True):
        """Forward and backward of one training step without the update:
        ({"loss", every loss term} as device scalars, {parameter name:
        gradient}). ``stochastic=False`` runs without augmentation, dropout
        or sampling noise, for checks. In a group of ranks the losses are
        the global batch's (their mean over the ranks) and the gradients
        this rank's, before the optimizer averages them."""
        model = self.state.model.train()
        model.zero_grad(set_to_none=True)
        pb = self.preprocess(self.to_device(batch), training=stochastic,
                             generator=generator)
        total, losses, _ = self._loss(pb, True, generator, stochastic)
        total.backward()
        metrics = mesh.mean_over_ranks(
            {"loss": total.detach(),
             **{k: v.detach() for k, v in losses.items()}})
        return metrics, {n: p.grad for n, p in model.named_parameters()}

    def train_step(self, batch: Dict,
                   generator: Optional[torch.Generator] = None,
                   stochastic: bool = True) -> Dict[str, torch.Tensor]:
        """One training step on a raw (b, s, ...) batch: ``grads``, then the
        optimizer (which applies every ACCUMULATE_GRAD_BATCHES-th call).
        Returns {"loss", every loss term}."""
        metrics, _ = self.grads(batch, generator, stochastic)
        self.state.optimizer.step()
        self.state.step += 1
        return metrics

    @contextlib.contextmanager
    def _evaluating(self):
        """No autograd and the model in eval mode, back in training mode
        afterwards."""
        model = self.state.model.eval()
        try:
            with torch.no_grad():
                yield model
        finally:
            model.train()

    def observe_step(self, batch: Dict,
                     generator: Optional[torch.Generator] = None,
                     stochastic: bool = True) -> Dict:
        """The posterior observation of the receptive field of a raw batch
        and its reconstruction losses, once a batch: {pb (the preprocessed
        batch, every frame), losses, output (fp32), hidden_state, sample
        (the last posterior state, where the model imagines)}.
        ``stochastic=False`` takes the mean of every latent distribution,
        for checks."""
        with self._evaluating() as model:
            pb = self.preprocess(self.to_device(batch), training=False)
            batch_rf = {k: v[:, :self.rf] for k, v in pb.items()}
            with autocast(self.device, self.compute_dtype):
                output, state_dict = model(batch_rf, training=False,
                                           generator=generator,
                                           stochastic=stochastic)
            output = _to_fp32(output)
            out = {"pb": pb,
                   "losses": compute_loss(self.cfg, batch_rf, output),
                   "output": output}
            if self.imagines:
                out["hidden_state"], out["sample"] = last_state(state_dict)
            return out

    def imagine_step(self, pb: Dict, hidden_state, sample,
                     generator: Optional[torch.Generator] = None,
                     stochastic: bool = True) -> Dict:
        """One imagination of the future horizon from ``observe_step``'s
        last posterior state, and its losses against ``pb``'s future
        frames: {losses_imagine, output_imagine (fp32)}. Run it once for
        each imagination sample of a batch."""
        batch_fh = {k: v[:, self.rf:] for k, v in pb.items()}
        imagine_batch = imagine_inputs(hidden_state, sample, batch_fh)
        with self._evaluating() as model:
            with autocast(self.device, self.compute_dtype):
                imagined = model.imagine(imagine_batch,
                                         future_horizon=self.fh,
                                         generator=generator,
                                         use_sample=stochastic)
            imagined = _to_fp32(imagined)
            return {"losses_imagine": compute_loss(self.cfg, batch_fh,
                                                   imagined),
                    "output_imagine": imagined}

    def eval_step(self, batch: Dict,
                  generator: Optional[torch.Generator] = None,
                  stochastic: bool = True) -> Dict:
        """Observe the receptive field (losses of the reconstruction), then
        imagine the future horizon once from the last posterior state
        (losses of the imagination), as muvo_tpu's eval step: {pb,
        losses, output, losses_imagine, output_imagine}; without the RSSM
        or a horizon, the observation alone."""
        out = self.observe_step(batch, generator, stochastic)
        if self.imagines:
            out.update(self.imagine_step(out["pb"], out.pop("hidden_state"),
                                         out.pop("sample"), generator,
                                         stochastic))
        return out


def _to_fp32(tree):
    """Every floating tensor of a (nested) dict in fp32."""
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.float()
    return tree
