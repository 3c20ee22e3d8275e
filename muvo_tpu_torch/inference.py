"""Stateful serving API for deployment and closed-loop runs (counterpart of
muvo_tpu/inference.py).

A DeploymentSession owns the latent carry (h, sample, last action) on the
device. Each CARLA tick either reuses the cached state (the model acts every
``CARLA_FPS * DATASET.STRIDE_SEC`` frames) or encodes the newest frame and
advances the RSSM one step, then decodes. The stride counter and the carry
follow muvo_tpu's session exactly. Serving runs in fp32 under
``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from muvo_tpu_torch.constants import CARLA_FPS
from muvo_tpu_torch.device import resolve_device
from muvo_tpu_torch.models.preprocess import PreProcess
from muvo_tpu_torch.utils.network import remove_past


class LatentCarry(NamedTuple):
    h: torch.Tensor
    sample: torch.Tensor
    action: torch.Tensor


class DeploymentSession:
    def __init__(self, model, cfg, device=None,
                 generator: Optional[torch.Generator] = None):
        """``device=None`` means the GPU and raises without one; pass
        ``"cpu"`` for the plain PyTorch path. ``generator`` (on ``device``)
        draws the imagination rollout's noise; default seed 0."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.cfg = cfg
        self.preprocess = PreProcess(cfg)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.carry: Optional[LatentCarry] = None
        self.count = 0
        self.n_per_stride = int(CARLA_FPS * cfg.DATASET.STRIDE_SEC)

    # ------------------------------------------------------------------
    def _tensors(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    @torch.inference_mode()
    def observe_update(self, batch: Dict, carry: LatentCarry) -> LatentCarry:
        """Encode the last frame and advance the posterior one step."""
        embedding_t = self.model.encode_frame(self.preprocess(batch))
        out = self.model.observe_step(carry.h, carry.sample, carry.action,
                                      embedding_t, False)["posterior"]
        return LatentCarry(out["hidden_state"], out["sample"], carry.action)

    @torch.inference_mode()
    def imagine_update(self, carry: LatentCarry) -> LatentCarry:
        out = self.model.imagine_step(carry.h, carry.sample, carry.action,
                                      False)
        return LatentCarry(out["hidden_state"], out["sample"], carry.action)

    @torch.inference_mode()
    def decode(self, carry: LatentCarry) -> Dict:
        state = torch.cat([carry.h, carry.sample], dim=-1)
        throttle_brake, steering = self.model.policy_forward(state).chunk(
            2, dim=-1)
        outputs = self.model.decode_state(state, state.shape[0], 1)
        return {
            "throttle_brake": throttle_brake[:, None],
            "steering": steering[:, None],
            "hidden_state": carry.h,
            "sample": carry.sample,
            **outputs,
        }

    @torch.inference_mode()
    def imagine_rollout(self, carry: LatentCarry, actions: torch.Tensor,
                        use_sample: bool = True) -> Dict:
        """Prior rollout over ``actions`` (b, T, 2), then decoding."""
        batch = {
            "hidden_state": carry.h,
            "sample": carry.sample,
            "throttle_brake": actions[..., :1],
            "steering": actions[..., 1:],
        }
        return self.model.imagine(batch, False, actions.shape[1],
                                  self.generator, use_sample)

    # ------------------------------------------------------------------
    def reset(self):
        self.carry = None
        self.count = 0

    def _init_carry(self, b: int) -> LatentCarry:
        t = self.cfg.MODEL.TRANSITION
        return LatentCarry(
            torch.zeros((b, t.HIDDEN_STATE_DIM), device=self.device),
            torch.zeros((b, t.STATE_DIM), device=self.device),
            torch.zeros((b, self.cfg.MODEL.ACTION_DIM), device=self.device),
        )

    def deployment_forward(self, batch: Dict, is_dreaming: bool) -> Dict:
        """One CARLA tick. batch holds the most recent frames (b, s, ...)."""
        if self.count == 0:
            s = batch["image"].shape[1]
            if "action" in batch:
                action_t = self._tensors({"a": batch["action"][:, -2]})["a"]
            else:
                a = self._tensors({"tb": batch["throttle_brake"][:, -2],
                                   "st": batch["steering"][:, -2]})
                action_t = torch.cat([a["tb"], a["st"]], dim=-1)
            if self.carry is None:
                self.carry = self._init_carry(batch["image"].shape[0])
            carry = LatentCarry(self.carry.h, self.carry.sample, action_t)
            if is_dreaming:
                self.carry = self.imagine_update(carry)
            else:
                last = self._tensors(remove_past(batch, s))
                self.carry = self.observe_update(last, carry)
            self.count = self.n_per_stride - 1
        else:
            self.count -= 1
        return self.decode(self.carry)

    def sim_forward(self, batch: Dict, is_dreaming: bool) -> Tuple[Dict, Dict]:
        """Observe frame RECEPTIVE_FIELD of the sequence, decode, then
        imagine the rest of the sequence from the cached latent."""
        rf = self.cfg.RECEPTIVE_FIELD
        if self.count == 0:
            first = self._tensors(remove_past(batch, rf))
            action_t = torch.cat([first["throttle_brake"][:, 0],
                                  first["steering"][:, 0]], dim=-1)
            if self.carry is None:
                self.carry = self._init_carry(batch["image"].shape[0])
                action_last = torch.zeros_like(action_t)
            else:
                action_last = self.carry.action
            carry = LatentCarry(self.carry.h, self.carry.sample, action_last)
            if is_dreaming:
                new_carry = self.imagine_update(carry)
            else:
                new_carry = self.observe_update(first, carry)
            self.carry = LatentCarry(new_carry.h, new_carry.sample, action_t)
            self.count = self.n_per_stride - 1
        else:
            self.count -= 1

        output = self.decode(self.carry)
        fh = batch["image"].shape[1] - 1
        a = self._tensors({"tb": batch["throttle_brake"][:, :fh],
                           "st": batch["steering"][:, :fh]})
        actions = torch.cat([a["tb"], a["st"]], dim=-1)
        return output, self.imagine_rollout(self.carry, actions)
