"""Relevant traffic-light state for the ego lane
(reference: obs_manager/object_finder/traffic_light_new.py)."""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase
from muvo_tpu_torch.sim.traffic_light import TrafficLightHandler


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._dist = float(obs_configs.get("distance_threshold", 18.0))
        self._parent = None
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            # -1 none, 0 green, 1 yellow, 2 red
            "state": gym.spaces.Box(-1, 2, (1,), np.int8),
            "location": gym.spaces.Box(-self._dist, self._dist, (3,),
                                       np.float32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor
        TrafficLightHandler.reset(parent_actor.vehicle.get_world())

    def get_observation(self):
        import carla

        state, loc, _ = TrafficLightHandler.get_light_state(
            self._parent.vehicle, dist_threshold=self._dist
        )
        code = -1
        if state == carla.TrafficLightState.Green:
            code = 0
        elif state == carla.TrafficLightState.Yellow:
            code = 1
        elif state == carla.TrafficLightState.Red:
            code = 2
        return {
            "state": np.array([code], np.int8),
            "location": (loc if loc is not None
                         else np.zeros(3, np.float32)),
        }

    def clean(self):
        self._parent = None
