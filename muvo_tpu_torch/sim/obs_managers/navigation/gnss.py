"""GNSS + IMU + target waypoints observation
(reference: obs_manager/navigation/gnss.py)."""

from __future__ import annotations

import queue
import weakref

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._parent = None
        self._gnss_sensor = None
        self._imu_sensor = None
        self._gnss_queue = None
        self._imu_queue = None
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "gnss": gym.spaces.Box(-180, 180, (3,), np.float64),
            "imu": gym.spaces.Box(-1e3, 1e3, (7,), np.float64),
            "target_gps": gym.spaces.Box(-180, 180, (3,), np.float64),
            "command": gym.spaces.Box(-1, 6, (1,), np.int8),
            "target_gps_next": gym.spaces.Box(-180, 180, (3,), np.float64),
            "command_next": gym.spaces.Box(-1, 6, (1,), np.int8),
        })

    def attach_ego_vehicle(self, parent_actor):
        import carla

        self._parent = parent_actor
        world = parent_actor.vehicle.get_world()
        bp_lib = world.get_blueprint_library()

        self._gnss_queue = queue.Queue()
        self._imu_queue = queue.Queue()
        gq, iq = weakref.ref(self._gnss_queue), weakref.ref(self._imu_queue)

        self._gnss_sensor = world.spawn_actor(
            bp_lib.find("sensor.other.gnss"), carla.Transform(),
            attach_to=parent_actor.vehicle,
        )
        self._gnss_sensor.listen(
            lambda e: gq() and gq().put(
                np.array([e.latitude, e.longitude, e.altitude])
            )
        )
        self._imu_sensor = world.spawn_actor(
            bp_lib.find("sensor.other.imu"), carla.Transform(),
            attach_to=parent_actor.vehicle,
        )
        self._imu_sensor.listen(
            lambda e: iq() and iq().put(np.array([
                e.accelerometer.x, e.accelerometer.y, e.accelerometer.z,
                e.gyroscope.x, e.gyroscope.y, e.gyroscope.z, e.compass,
            ]))
        )

    def get_observation(self):
        gnss = self._gnss_queue.get(timeout=10.0)
        imu = self._imu_queue.get(timeout=10.0)
        # target waypoints along the route in gps coordinates
        target_gps = np.zeros(3)
        target_gps_next = np.zeros(3)
        command = np.array([4], np.int8)
        command_next = np.array([4], np.int8)
        route = getattr(self._parent, "_route", None)
        if route:
            idx = getattr(self._parent, "_route_idx", 0)
            nxt = min(idx + 10, len(route) - 1)
            nxt2 = min(idx + 30, len(route) - 1)
            target_gps = np.asarray(route[nxt][0], np.float64)
            target_gps_next = np.asarray(route[nxt2][0], np.float64)
            command = np.array([int(route[nxt][1])], np.int8)
            command_next = np.array([int(route[nxt2][1])], np.int8)
        return {
            "gnss": gnss, "imu": imu,
            "target_gps": target_gps, "command": command,
            "target_gps_next": target_gps_next, "command_next": command_next,
        }

    def clean(self):
        for sensor in (self._gnss_sensor, self._imu_sensor):
            if sensor is not None:
                sensor.stop()
                sensor.destroy()
        self._gnss_sensor = self._imu_sensor = None
        self._parent = None
