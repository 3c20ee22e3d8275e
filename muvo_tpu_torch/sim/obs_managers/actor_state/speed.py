"""Ego speed observation (reference: obs_manager/actor_state/speed.py)."""

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
            "speed": gym.spaces.Box(-10.0, 30.0, (1,), np.float32),
            "speed_xy": gym.spaces.Box(-10.0, 30.0, (1,), np.float32),
            "forward_speed": gym.spaces.Box(-10.0, 30.0, (1,), np.float32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor

    def get_observation(self):
        vehicle = self._parent.vehicle
        velocity = vehicle.get_velocity()
        transform = vehicle.get_transform()
        forward = transform.get_forward_vector()
        np_vel = np.array([velocity.x, velocity.y, velocity.z])
        np_fwd = np.array([forward.x, forward.y, forward.z])
        speed = np.linalg.norm(np_vel)
        speed_xy = np.linalg.norm(np_vel[:2])
        forward_speed = np.dot(np_vel, np_fwd)
        return {
            "speed": np.array([speed], np.float32),
            "speed_xy": np.array([speed_xy], np.float32),
            "forward_speed": np.array([forward_speed], np.float32),
        }

    def clean(self):
        self._parent = None
