"""Birdview observation manager: CARLA actor polling + pure renderer.

(reference: obs_manager/birdview/chauffeurnet.py; rendering core lives in
muvo_tpu/sim/birdview.py)
"""

from __future__ import annotations

import os

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.birdview import ActorBox, BirdviewRenderer, load_static_map_h5
from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._width = int(obs_configs.get("width_in_pixels", 192))
        self._ppm = float(obs_configs.get("pixels_per_meter", 5.0))
        self._ev_bottom = int(obs_configs.get("pixels_ev_to_bottom", 40))
        self._history_idx = obs_configs.get("history_idx", [-16, -11, -6, -1])
        self._maps_dir = obs_configs.get("maps_dir", "maps")
        self._distance_threshold = float(
            obs_configs.get("distance_threshold", 50.0)
        )
        self._parent = None
        self._renderer = None
        super().__init__()

    def _define_obs_space(self):
        # road/route/lane + vehicle, walker and traffic-light+stop history
        # (reference chauffeurnet.py:53: 3 + 3*len(history_idx))
        n_channels = 3 + 3 * len(self._history_idx)
        self.obs_space = gym.spaces.Dict({
            "rendered": gym.spaces.Box(
                0, 255, (self._width, self._width, 3), np.uint8
            ),
            "masks": gym.spaces.Box(
                0, 255, (n_channels, self._width, self._width), np.uint8
            ),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor
        self._world = parent_actor.vehicle.get_world()
        map_name = self._world.get_map().name.split("/")[-1]
        map_path = os.path.join(self._maps_dir, f"{map_name}.h5")
        static_map = load_static_map_h5(map_path)
        self._renderer = BirdviewRenderer(
            static_map, width_px=self._width, pixels_per_meter=self._ppm,
            pixels_ev_to_bottom=self._ev_bottom,
            history_idx=self._history_idx,
        )

    def _collect_boxes(self, actor_filter, ev_loc):
        boxes = []
        for actor in self._world.get_actors().filter(actor_filter):
            if actor.id == self._parent.vehicle.id:
                continue
            tf = actor.get_transform()
            if tf.location.distance(ev_loc) > self._distance_threshold:
                continue
            ext = actor.bounding_box.extent
            boxes.append(ActorBox(tf.location.x, tf.location.y,
                                  tf.rotation.yaw, ext.x, ext.y))
        return boxes

    def get_observation(self):
        ev = self._parent.vehicle
        tf = ev.get_transform()
        vehicles = self._collect_boxes("vehicle.*", tf.location)
        walkers = self._collect_boxes("walker.pedestrian.*", tf.location)

        route = getattr(self._parent, "_route", [])
        idx = getattr(self._parent, "_route_idx", 0)
        route_xy = np.array(
            [wp[:2] for wp, _ in route[idx:idx + 80]]
        ) if route else np.zeros((0, 2))

        tl_green, tl_yellow, tl_red, stops = [], [], [], []
        try:
            import carla

            for tl in self._world.get_actors().filter("traffic.traffic_light"):
                tltf = tl.get_transform()
                if tltf.location.distance(tf.location) > self._distance_threshold:
                    continue
                box = ActorBox(tltf.location.x, tltf.location.y,
                               tltf.rotation.yaw, 1.5, 1.5)
                if tl.state == carla.TrafficLightState.Green:
                    tl_green.append(box)
                elif tl.state == carla.TrafficLightState.Yellow:
                    tl_yellow.append(box)
                else:
                    tl_red.append(box)
            for sign in self._world.get_actors().filter("traffic.stop"):
                stf = sign.get_transform()
                if stf.location.distance(tf.location) > self._distance_threshold:
                    continue
                stops.append(ActorBox(stf.location.x, stf.location.y,
                                      stf.rotation.yaw, 1.5, 1.5))
        except ImportError:
            pass

        return self._renderer.render(
            tf.location.x, tf.location.y, tf.rotation.yaw,
            vehicles, walkers, route_xy, tl_green, tl_yellow, tl_red, stops,
        )

    def clean(self):
        self._parent = None
        if self._renderer is not None:
            self._renderer.reset()
