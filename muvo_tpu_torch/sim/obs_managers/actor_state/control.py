"""Ego control observation (reference: obs_manager/actor_state/control.py)."""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._parent = None
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "throttle": gym.spaces.Box(0.0, 1.0, (1,), np.float32),
            "steer": gym.spaces.Box(-1.0, 1.0, (1,), np.float32),
            "brake": gym.spaces.Box(0.0, 1.0, (1,), np.float32),
            "gear": gym.spaces.Box(0.0, 5.0, (1,), np.float32),
            "speed_limit": gym.spaces.Box(0.0, 50.0, (1,), np.float32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor

    def get_observation(self):
        vehicle = self._parent.vehicle
        control = vehicle.get_control()
        speed_limit = vehicle.get_speed_limit() / 3.6 * 0.8
        return {
            "throttle": np.array([control.throttle], np.float32),
            "steer": np.array([control.steer], np.float32),
            "brake": np.array([control.brake], np.float32),
            "gear": np.array([control.gear], np.float32),
            "speed_limit": np.array([speed_limit], np.float32),
        }

    def clean(self):
        self._parent = None
