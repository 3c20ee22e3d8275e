"""RGB camera observation manager (reference: obs_manager/camera/rgb.py).

Spawns a CARLA RGB sensor on the ego vehicle; a queue-based listener enforces
frame synchronisation (every tick must consume exactly the frame produced by
that tick — the reference asserts queue size <= 1 and frame-id equality)."""

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
        self._height = int(obs_configs["height"])
        self._width = int(obs_configs["width"])
        self._fov = float(obs_configs["fov"])
        self._camera_loc = obs_configs.get("location", [1.0, 0.0, 2.0])
        self._camera_rot = obs_configs.get("rotation", [0.0, 0.0, 0.0])
        self._sensor = None
        self._queue = None
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "frame": gym.spaces.Discrete(2 ** 32 - 1),
            "data": gym.spaces.Box(
                low=0, high=255, shape=(self._height, self._width, 3),
                dtype=np.uint8,
            ),
        })

    def attach_ego_vehicle(self, parent_actor):
        import carla

        world = parent_actor.vehicle.get_world()
        bp = world.get_blueprint_library().find("sensor.camera.rgb")
        bp.set_attribute("image_size_x", str(self._width))
        bp.set_attribute("image_size_y", str(self._height))
        bp.set_attribute("fov", str(self._fov))

        fwd, right, up = self._camera_loc
        pitch, yaw, roll = self._camera_rot
        transform = carla.Transform(
            carla.Location(x=fwd, y=right, z=up),
            carla.Rotation(pitch=pitch, yaw=yaw, roll=roll),
        )
        self._sensor = world.spawn_actor(
            bp, transform, attach_to=parent_actor.vehicle
        )
        self._queue = queue.Queue()
        weak_q = weakref.ref(self._queue)
        self._sensor.listen(
            lambda image: ObsManager._parse(weak_q, image)
        )

    @staticmethod
    def _parse(weak_q, image):
        q = weak_q()
        if q is None:
            return
        array = np.frombuffer(image.raw_data, dtype=np.uint8)
        array = array.reshape((image.height, image.width, 4))
        rgb = array[:, :, :3][:, :, ::-1].copy()  # BGRA -> RGB
        q.put({"frame": image.frame, "data": rgb})

    def get_observation(self):
        assert self._queue is not None, "sensor not attached"
        obs = self._queue.get(timeout=10.0)
        assert self._queue.qsize() <= 1, "dropped camera frames"
        return obs

    def clean(self):
        if self._sensor is not None:
            self._sensor.stop()
            self._sensor.destroy()
            self._sensor = None
        self._queue = None
