"""Multi-LiDAR box rig (reference: obs_manager/lidar/ray_cast_multi.py):
several semantic LiDARs at rig offsets, merged into one ego-frame cloud."""

from __future__ import annotations

from typing import List

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase
from muvo_tpu_torch.sim.obs_managers.lidar.ray_cast_semantic import (
    ObsManager as SemanticLidarObsManager,
)


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._rig = obs_configs.get("rig", [
            {"location": [1.0, 0.0, 2.0]},
            {"location": [-1.0, 1.0, 2.0]},
            {"location": [-1.0, -1.0, 2.0]},
        ])
        self._base_cfg = dict(obs_configs)
        self._managers: List[SemanticLidarObsManager] = []
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "frame": gym.spaces.Discrete(2 ** 32 - 1),
            "data": gym.spaces.Dict({
                "points_xyz": gym.spaces.Box(-200, 200, (0, 3), np.float32),
                "ObjTag": gym.spaces.Box(0, 255, (0,), np.uint32),
            }),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._managers = []
        for sensor in self._rig:
            cfg = dict(self._base_cfg)
            cfg["location"] = sensor["location"]
            cfg.pop("rig", None)
            manager = SemanticLidarObsManager(cfg)
            manager.attach_ego_vehicle(parent_actor)
            self._managers.append(manager)

    def get_observation(self):
        obs = [m.get_observation() for m in self._managers]
        points, tags = [], []
        for o, sensor in zip(obs, self._rig):
            xyz = o["data"]["points_xyz"] + np.asarray(
                sensor["location"], np.float32
            )
            points.append(xyz)
            tags.append(o["data"]["ObjTag"])
        return {
            "frame": obs[0]["frame"],
            "data": {
                "points_xyz": np.concatenate(points, axis=0),
                "ObjTag": np.concatenate(tags, axis=0),
            },
        }

    def clean(self):
        for m in self._managers:
            m.clean()
        self._managers = []
