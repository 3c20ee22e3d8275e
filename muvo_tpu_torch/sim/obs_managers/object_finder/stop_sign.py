"""Nearby stop signs in the ego frame
(reference: obs_manager/object_finder/stop_sign.py)."""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.agents import loc_global_to_ref
from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._max_n = int(obs_configs.get("max_detection_number", 5))
        self._dist = float(obs_configs.get("distance_threshold", 30.0))
        self._parent = None
        super().__init__()

    def _define_obs_space(self):
        n = self._max_n
        self.obs_space = gym.spaces.Dict({
            "binary_mask": gym.spaces.MultiBinary(n),
            "location": gym.spaces.Box(-self._dist, self._dist, (n, 3),
                                       np.float32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor
        self._world = parent_actor.vehicle.get_world()

    def get_observation(self):
        ev = self._parent.vehicle
        tf = ev.get_transform()
        ev_loc = np.array([tf.location.x, tf.location.y, tf.location.z])
        out = {"binary_mask": np.zeros(self._max_n, np.int8),
               "location": np.zeros((self._max_n, 3), np.float32)}
        i = 0
        for stop in self._world.get_actors().filter("traffic.stop"):
            if i >= self._max_n:
                break
            stf = stop.get_transform()
            loc = np.array([stf.location.x, stf.location.y, stf.location.z])
            if np.linalg.norm(loc[:2] - ev_loc[:2]) > self._dist:
                continue
            out["binary_mask"][i] = 1
            out["location"][i] = loc_global_to_ref(
                loc, ev_loc, tf.rotation.yaw
            ).astype(np.float32)
            i += 1
        return out

    def clean(self):
        self._parent = None
