"""PPO expert agent and the env's observation and action processing
(counterpart of muvo_tpu/rl/agent.py).

``process_obs`` flattens an env observation into {birdview masks in
(C, H, W), the port's layout, scaled to [0, 1]; the state vector};
``process_act`` maps an (acceleration, steer) action onto throttle, steer
and brake; ``RlBirdviewAgent`` runs the policy's deterministic forward on
its device for each tick of data collection. The control is a plain dict
unless the carla package imports.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from muvo_tpu_torch.device import resolve_device
from muvo_tpu_torch.rl.policy import PpoPolicy


def process_obs(obs: Dict, input_states: List[str], train: bool = True
                ) -> Dict:
    """Env obs dict -> {'birdview': (c, h, w), 'state': (n,)} (a leading
    batch of 1 unless ``train``)."""
    state_list = []
    if "speed" in input_states:
        state_list.append(obs["speed"]["speed_xy"])
    if "speed_limit" in input_states:
        state_list.append(obs["control"]["speed_limit"])
    if "control" in input_states:
        state_list.append(obs["control"]["throttle"])
        state_list.append(obs["control"]["steer"])
        state_list.append(obs["control"]["brake"])
        state_list.append(obs["control"]["gear"] / 5.0)
    if "acc_xy" in input_states:
        state_list.append(obs["velocity"]["acc_xy"])
    if "vel_xy" in input_states:
        state_list.append(obs["velocity"]["vel_xy"])
    if "vel_ang_z" in input_states:
        state_list.append(obs["velocity"]["vel_ang_z"])
    state = np.concatenate(state_list).astype(np.float32)

    masks = obs["birdview"]["masks"]
    if masks.ndim == 3 and masks.shape[-1] < masks.shape[0]:
        masks = np.transpose(masks, (2, 0, 1))  # HWC -> CHW
    birdview = masks.astype(np.float32) / 255.0

    if not train:
        birdview = birdview[None]
        state = state[None]
    return {"birdview": birdview, "state": state}


def process_act(action: np.ndarray, acc_as_action: bool, train: bool = True):
    """Action vector -> vehicle control (throttle, steer, brake)."""
    if not train:
        action = action[0]
    if acc_as_action:
        acc, steer = np.asarray(action, np.float64)
        throttle, brake = (acc, 0.0) if acc >= 0.0 else (0.0, abs(acc))
    else:
        throttle, steer, brake = np.asarray(action, np.float64)
    throttle = float(np.clip(throttle, 0, 1))
    steer = float(np.clip(steer, -1, 1))
    brake = float(np.clip(brake, 0, 1))
    try:  # the control type where carla imports and provides it
        import carla

        return carla.VehicleControl(throttle=throttle, steer=steer,
                                    brake=brake)
    except ImportError:
        return {"throttle": throttle, "steer": steer, "brake": brake}


def scale_action(action: np.ndarray, low, high) -> np.ndarray:
    """Policy output in [0, 1] (Beta) -> env action space [low, high]."""
    return low + (high - low) * np.clip(action, 0.0, 1.0)


class RlBirdviewAgent:
    """The PPO expert: obs -> policy -> control and a supervision dict. On
    the GPU unless ``device="cpu"``."""

    def __init__(self, policy: Optional[PpoPolicy] = None,
                 input_states: Tuple[str, ...] = ("control", "vel_xy"),
                 acc_as_action: bool = True,
                 action_low=(-1.0, -1.0), action_high=(1.0, 1.0),
                 device=None):
        self.device = resolve_device(device)
        if policy is None:
            # no checkpoint given: an untrained expert, so collection runs
            print("RlBirdviewAgent: no policy checkpoint, using random init")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                policy = PpoPolicy()
        self.policy = policy.to(self.device).eval()
        self.input_states = list(input_states)
        self.acc_as_action = acc_as_action
        self.action_low = np.asarray(action_low)
        self.action_high = np.asarray(action_high)
        self.supervision_dict: Dict = {}

    @torch.no_grad()
    def run_step(self, input_data: Dict, timestamp=None):
        policy_input = process_obs(input_data, self.input_states, train=False)
        actions, values, _, p1, p2 = self.policy(
            torch.from_numpy(policy_input["birdview"]).to(self.device),
            torch.from_numpy(policy_input["state"]).to(self.device),
            deterministic=True)
        scaled = scale_action(actions.cpu().numpy(), self.action_low,
                              self.action_high)
        control = process_act(scaled, self.acc_as_action, train=False)

        def part(name):
            return (control[name] if isinstance(control, dict)
                    else getattr(control, name))

        self.supervision_dict = {
            "action": np.array([part("throttle"), part("steer"),
                                part("brake")], np.float32),
            "value": float(values[0]),
            "action_mu": p1[0].cpu().numpy(),
            "action_sigma": p2[0].cpu().numpy(),
            "speed": input_data.get("speed", {}).get("forward_speed"),
        }
        return control

    def reset(self, log_file_path: str = ""):
        """The deterministic policy keeps no state between episodes."""
