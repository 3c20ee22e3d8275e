"""Semantic LiDAR observation manager.

(reference: obs_manager/lidar/ray_cast_semantic.py — xyz + CosAngle + ObjIdx
+ ObjTag; rotation frequency pinned to the simulation FPS so each tick yields
a full sweep.)
"""

from __future__ import annotations

import queue
import weakref

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.constants import CARLA_FPS
from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._channels = int(obs_configs.get("channels", 64))
        self._range = float(obs_configs.get("range", 100.0))
        self._points_per_second = int(
            obs_configs.get("points_per_second", 600000)
        )
        self._upper_fov = float(obs_configs.get("upper_fov", 10.0))
        self._lower_fov = float(obs_configs.get("lower_fov", -30.0))
        self._location = obs_configs.get("location", [1.0, 0.0, 2.0])
        self._rotation = obs_configs.get("rotation", [0.0, 0.0, 0.0])
        self._sensor = None
        self._queue = None
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "frame": gym.spaces.Discrete(2 ** 32 - 1),
            "data": gym.spaces.Dict({
                "points_xyz": gym.spaces.Box(
                    low=-self._range, high=self._range, shape=(0, 3),
                    dtype=np.float32,
                ),
                "ObjTag": gym.spaces.Box(0, 255, shape=(0,), dtype=np.uint32),
                "ObjIdx": gym.spaces.Box(0, 2 ** 31, shape=(0,), dtype=np.uint32),
                "CosAngle": gym.spaces.Box(-1, 1, shape=(0,), dtype=np.float32),
            }),
        })

    def attach_ego_vehicle(self, parent_actor):
        import carla

        world = parent_actor.vehicle.get_world()
        bp = world.get_blueprint_library().find(
            "sensor.lidar.ray_cast_semantic"
        )
        bp.set_attribute("channels", str(self._channels))
        bp.set_attribute("range", str(self._range))
        bp.set_attribute("points_per_second", str(self._points_per_second))
        bp.set_attribute("upper_fov", str(self._upper_fov))
        bp.set_attribute("lower_fov", str(self._lower_fov))
        # one full sweep per simulation tick
        bp.set_attribute("rotation_frequency", str(CARLA_FPS))

        fwd, right, up = self._location
        pitch, yaw, roll = self._rotation
        transform = carla.Transform(
            carla.Location(x=fwd, y=right, z=up),
            carla.Rotation(pitch=pitch, yaw=yaw, roll=roll),
        )
        self._sensor = world.spawn_actor(
            bp, transform, attach_to=parent_actor.vehicle
        )
        self._queue = queue.Queue()
        weak_q = weakref.ref(self._queue)
        self._sensor.listen(lambda data: ObsManager._parse(weak_q, data))

    @staticmethod
    def _parse(weak_q, data):
        q = weak_q()
        if q is None:
            return
        raw = np.frombuffer(data.raw_data, dtype=np.dtype([
            ("x", np.float32), ("y", np.float32), ("z", np.float32),
            ("CosAngle", np.float32), ("ObjIdx", np.uint32),
            ("ObjTag", np.uint32),
        ]))
        q.put({
            "frame": data.frame,
            "data": {
                "points_xyz": np.stack(
                    [raw["x"], raw["y"], raw["z"]], axis=-1
                ),
                "ObjTag": raw["ObjTag"].copy(),
                "ObjIdx": raw["ObjIdx"].copy(),
                "CosAngle": raw["CosAngle"].copy(),
            },
        })

    def get_observation(self):
        assert self._queue is not None, "sensor not attached"
        obs = self._queue.get(timeout=10.0)
        assert self._queue.qsize() <= 1, "dropped lidar frames"
        return obs

    def clean(self):
        if self._sensor is not None:
            self._sensor.stop()
            self._sensor.destroy()
            self._sensor = None
        self._queue = None
