"""Depth + semantic composite camera
(reference: obs_manager/camera/depth_semantic.py).

CARLA depth camera encodes metric depth over the RGB channels; the semantic
camera's tag goes into the alpha channel, giving a single (H, W, 4) uint8
image matching the dataset's depth_semantic files.
"""

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
        self._sensors = []
        self._depth_queue = None
        self._sem_queue = None
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "frame": gym.spaces.Discrete(2 ** 32 - 1),
            "data": gym.spaces.Box(
                low=0, high=255, shape=(self._height, self._width, 4),
                dtype=np.uint8,
            ),
        })

    def attach_ego_vehicle(self, parent_actor):
        import carla

        world = parent_actor.vehicle.get_world()
        bp_lib = world.get_blueprint_library()
        fwd, right, up = self._camera_loc
        pitch, yaw, roll = self._camera_rot
        transform = carla.Transform(
            carla.Location(x=fwd, y=right, z=up),
            carla.Rotation(pitch=pitch, yaw=yaw, roll=roll),
        )

        self._depth_queue = queue.Queue()
        self._sem_queue = queue.Queue()

        for name, q in (("sensor.camera.depth", self._depth_queue),
                        ("sensor.camera.semantic_segmentation",
                         self._sem_queue)):
            bp = bp_lib.find(name)
            bp.set_attribute("image_size_x", str(self._width))
            bp.set_attribute("image_size_y", str(self._height))
            bp.set_attribute("fov", str(self._fov))
            sensor = world.spawn_actor(bp, transform,
                                       attach_to=parent_actor.vehicle)
            weak_q = weakref.ref(q)
            sensor.listen(lambda image, wq=weak_q: ObsManager._parse(wq, image))
            self._sensors.append(sensor)

    @staticmethod
    def _parse(weak_q, image):
        q = weak_q()
        if q is None:
            return
        array = np.frombuffer(image.raw_data, dtype=np.uint8)
        q.put({"frame": image.frame,
               "data": array.reshape(image.height, image.width, 4)})

    def get_observation(self):
        depth = self._depth_queue.get(timeout=10.0)
        sem = self._sem_queue.get(timeout=10.0)
        assert depth["frame"] == sem["frame"], "depth/semantic frame mismatch"
        # depth BGRA carries the 24-bit depth in B,G,R; semantic tag in R
        composite = depth["data"].copy()
        composite[..., 3] = sem["data"][..., 2]
        return {"frame": depth["frame"], "data": composite}

    def clean(self):
        for sensor in self._sensors:
            sensor.stop()
            sensor.destroy()
        self._sensors = []
        self._depth_queue = self._sem_queue = None
