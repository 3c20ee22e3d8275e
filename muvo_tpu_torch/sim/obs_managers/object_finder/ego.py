"""Ego-vehicle ground-truth state (reference: obs_manager/object_finder/ego.py)."""

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
            "location": gym.spaces.Box(-5000, 5000, (3,), np.float32),
            "rotation": gym.spaces.Box(-180, 180, (3,), np.float32),
            "extent": gym.spaces.Box(0, 20, (3,), np.float32),
            "velocity": gym.spaces.Box(-50, 50, (3,), np.float32),
            "acceleration": gym.spaces.Box(-100, 100, (3,), np.float32),
            "route_completion": gym.spaces.Box(0, 1e5, (2,), np.float32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor

    def get_observation(self):
        v = self._parent.vehicle
        tf = v.get_transform()
        vel = v.get_velocity()
        acc = v.get_acceleration()
        ext = v.bounding_box.extent
        return {
            "location": np.array([tf.location.x, tf.location.y,
                                  tf.location.z], np.float32),
            "rotation": np.array([tf.rotation.roll, tf.rotation.pitch,
                                  tf.rotation.yaw], np.float32),
            "extent": np.array([ext.x, ext.y, ext.z], np.float32),
            "velocity": np.array([vel.x, vel.y, vel.z], np.float32),
            "acceleration": np.array([acc.x, acc.y, acc.z], np.float32),
            "route_completion": np.array(
                [self._parent.route_completed, self._parent.route_length],
                np.float32,
            ),
        }

    def clean(self):
        self._parent = None
