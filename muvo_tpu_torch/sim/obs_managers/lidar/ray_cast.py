"""Intensity LiDAR observation manager
(reference: obs_manager/lidar/ray_cast.py — xyz + intensity)."""

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
        self._sensor = None
        self._queue = None
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "frame": gym.spaces.Discrete(2 ** 32 - 1),
            "data": gym.spaces.Dict({
                "points_xyz": gym.spaces.Box(
                    -self._range, self._range, (0, 3), dtype=np.float32
                ),
                "intensity": gym.spaces.Box(0, 1, (0,), dtype=np.float32),
            }),
        })

    def attach_ego_vehicle(self, parent_actor):
        import carla

        world = parent_actor.vehicle.get_world()
        bp = world.get_blueprint_library().find("sensor.lidar.ray_cast")
        bp.set_attribute("channels", str(self._channels))
        bp.set_attribute("range", str(self._range))
        bp.set_attribute("points_per_second", str(self._points_per_second))
        bp.set_attribute("upper_fov", str(self._upper_fov))
        bp.set_attribute("lower_fov", str(self._lower_fov))
        bp.set_attribute("rotation_frequency", str(CARLA_FPS))

        fwd, right, up = self._location
        transform = carla.Transform(carla.Location(x=fwd, y=right, z=up))
        self._sensor = world.spawn_actor(bp, transform,
                                         attach_to=parent_actor.vehicle)
        self._queue = queue.Queue()
        weak_q = weakref.ref(self._queue)
        self._sensor.listen(lambda data: ObsManager._parse(weak_q, data))

    @staticmethod
    def _parse(weak_q, data):
        q = weak_q()
        if q is None:
            return
        raw = np.frombuffer(data.raw_data, dtype=np.float32).reshape(-1, 4)
        q.put({
            "frame": data.frame,
            "data": {"points_xyz": raw[:, :3].copy(),
                     "intensity": raw[:, 3].copy()},
        })

    def get_observation(self):
        obs = self._queue.get(timeout=10.0)
        assert self._queue.qsize() <= 1, "dropped lidar frames"
        return obs

    def clean(self):
        if self._sensor is not None:
            self._sensor.stop()
            self._sensor.destroy()
            self._sensor = None
        self._queue = None
