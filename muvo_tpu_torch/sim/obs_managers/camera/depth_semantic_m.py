"""Multi-camera depth+semantic box rig
(reference: obs_manager/camera/depth_semantic_m.py): a grid of depth+semantic
camera pairs pointing outward, tiled into one composite image for
surround-view voxelisation ground truth."""

from __future__ import annotations

from typing import List

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase
from muvo_tpu_torch.sim.obs_managers.camera.depth_semantic import (
    ObsManager as DepthSemanticObsManager,
)


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._height = int(obs_configs.get("height", 320))
        self._width = int(obs_configs.get("width", 320))
        self._fov = float(obs_configs.get("fov", 90))
        # outward-facing rig: yaw angles and mount offsets (fwd, right, up)
        self._rig = obs_configs.get("rig", [
            {"yaw": 0.0, "location": [1.0, 0.0, 2.0]},
            {"yaw": 90.0, "location": [0.0, 1.0, 2.0]},
            {"yaw": 180.0, "location": [-1.0, 0.0, 2.0]},
            {"yaw": -90.0, "location": [0.0, -1.0, 2.0]},
        ])
        self._managers: List[DepthSemanticObsManager] = []
        super().__init__()

    def _define_obs_space(self):
        n = len(self._rig)
        self.obs_space = gym.spaces.Dict({
            "frame": gym.spaces.Discrete(2 ** 32 - 1),
            "data": gym.spaces.Box(
                0, 255, (self._height, self._width * n, 4), np.uint8
            ),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._managers = []
        for cam in self._rig:
            manager = DepthSemanticObsManager({
                "height": self._height, "width": self._width,
                "fov": self._fov, "location": cam["location"],
                "rotation": [0.0, cam["yaw"], 0.0],
            })
            manager.attach_ego_vehicle(parent_actor)
            self._managers.append(manager)

    def get_observation(self):
        obs = [m.get_observation() for m in self._managers]
        frames = {o["frame"] for o in obs}
        assert len(frames) == 1, "multi-camera frame mismatch"
        return {
            "frame": obs[0]["frame"],
            "data": np.concatenate([o["data"] for o in obs], axis=1),
        }

    def clean(self):
        for m in self._managers:
            m.clean()
        self._managers = []
