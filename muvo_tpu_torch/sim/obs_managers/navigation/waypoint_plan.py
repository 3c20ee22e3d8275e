"""Route waypoint plan in the ego frame
(reference: obs_manager/navigation/waypoint_plan.py)."""

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
        self._steps = int(obs_configs.get("steps", 10))
        self._parent = None
        super().__init__()

    def _define_obs_space(self):
        n = self._steps
        self.obs_space = gym.spaces.Dict({
            "location": gym.spaces.Box(-100, 100, (n, 3), np.float32),
            "command": gym.spaces.Box(-1, 6, (n,), np.int8),
            "road_id": gym.spaces.Box(0, 6000, (n,), np.int32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor

    def get_observation(self):
        n = self._steps
        out = {
            "location": np.zeros((n, 3), np.float32),
            "command": np.full((n,), 4, np.int8),
            "road_id": np.zeros((n,), np.int32),
        }
        route = getattr(self._parent, "_route", [])
        idx = getattr(self._parent, "_route_idx", 0)
        if not route:
            return out
        tf = self._parent.vehicle.get_transform()
        ev_loc = np.array([tf.location.x, tf.location.y, tf.location.z])
        for i in range(n):
            j = min(idx + (i + 1) * 5, len(route) - 1)
            wp, option = route[j]
            out["location"][i] = loc_global_to_ref(
                np.asarray(wp, np.float64), ev_loc, tf.rotation.yaw
            ).astype(np.float32)
            out["command"][i] = int(option)
        return out

    def clean(self):
        self._parent = None
