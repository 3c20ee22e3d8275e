"""Ego velocity/acceleration in the ego frame
(reference: obs_manager/actor_state/velocity.py)."""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase
from muvo_tpu_torch.sim.agents import vec_global_to_ref


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._parent = None
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "vel_xy": gym.spaces.Box(-30.0, 30.0, (2,), np.float32),
            "acc_xy": gym.spaces.Box(-30.0, 30.0, (2,), np.float32),
            "vel_ang_z": gym.spaces.Box(-10.0, 10.0, (1,), np.float32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor

    def get_observation(self):
        vehicle = self._parent.vehicle
        transform = vehicle.get_transform()
        yaw = transform.rotation.yaw
        vel = vehicle.get_velocity()
        acc = vehicle.get_acceleration()
        ang = vehicle.get_angular_velocity()
        vel_ev = vec_global_to_ref(np.array([vel.x, vel.y, vel.z]), yaw)
        acc_ev = vec_global_to_ref(np.array([acc.x, acc.y, acc.z]), yaw)
        return {
            "vel_xy": vel_ev[:2].astype(np.float32),
            "acc_xy": acc_ev[:2].astype(np.float32),
            "vel_ang_z": np.array([ang.z], np.float32),
        }

    def clean(self):
        self._parent = None
