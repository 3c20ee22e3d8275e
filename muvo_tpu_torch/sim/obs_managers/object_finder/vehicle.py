"""Surrounding-vehicle finder (reference: obs_manager/object_finder/vehicle.py).

Fixed-capacity ego-frame observations of nearby vehicles: binary mask,
location, rotation, extent, absolute velocity.
"""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.agents import loc_global_to_ref, cast_angle
from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase


class ObsManager(ObsManagerBase):
    ACTOR_FILTER = "vehicle.*"

    def __init__(self, obs_configs):
        self._max_detection_number = int(
            obs_configs.get("max_detection_number", 10)
        )
        self._distance_threshold = float(
            obs_configs.get("distance_threshold", 15.0)
        )
        self._parent = None
        super().__init__()

    def _define_obs_space(self):
        n = self._max_detection_number
        d = self._distance_threshold
        self.obs_space = gym.spaces.Dict({
            "frame": gym.spaces.Discrete(2 ** 32 - 1),
            "binary_mask": gym.spaces.MultiBinary(n),
            "location": gym.spaces.Box(-d, d, (n, 3), np.float32),
            "rotation": gym.spaces.Box(-180, 180, (n, 3), np.float32),
            "extent": gym.spaces.Box(0, 20, (n, 3), np.float32),
            "absolute_velocity": gym.spaces.Box(-10, 50, (n, 3), np.float32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor
        self._world = parent_actor.vehicle.get_world()

    def get_observation(self):
        ev = self._parent.vehicle
        ev_transform = ev.get_transform()
        ev_loc = np.array([ev_transform.location.x, ev_transform.location.y,
                           ev_transform.location.z])
        ev_yaw = ev_transform.rotation.yaw

        candidates = []
        for actor in self._world.get_actors().filter(self.ACTOR_FILTER):
            if actor.id == ev.id:
                continue
            tf = actor.get_transform()
            loc = np.array([tf.location.x, tf.location.y, tf.location.z])
            dist = np.linalg.norm(loc[:2] - ev_loc[:2])
            if dist > self._distance_threshold:
                continue
            local = loc_global_to_ref(loc, ev_loc, ev_yaw)
            vel = actor.get_velocity()
            ext = actor.bounding_box.extent
            candidates.append((dist, {
                "location": local.astype(np.float32),
                "rotation": np.array([
                    cast_angle(tf.rotation.roll),
                    cast_angle(tf.rotation.pitch),
                    cast_angle(tf.rotation.yaw - ev_yaw),
                ], np.float32),
                "extent": np.array([ext.x, ext.y, ext.z], np.float32),
                "absolute_velocity": np.array([vel.x, vel.y, vel.z],
                                              np.float32),
            }))
        candidates.sort(key=lambda c: c[0])
        return self._pack(candidates)

    def _pack(self, candidates):
        n = self._max_detection_number
        obs = {
            "frame": 0,
            "binary_mask": np.zeros(n, np.int8),
            "location": np.zeros((n, 3), np.float32),
            "rotation": np.zeros((n, 3), np.float32),
            "extent": np.zeros((n, 3), np.float32),
            "absolute_velocity": np.zeros((n, 3), np.float32),
        }
        for i, (_, c) in enumerate(candidates[:n]):
            obs["binary_mask"][i] = 1
            for key in ("location", "rotation", "extent", "absolute_velocity"):
                obs[key][i] = c[key]
        return obs

    def clean(self):
        self._parent = None


class PedestrianObsManager(ObsManager):
    ACTOR_FILTER = "walker.pedestrian.*"

    def _define_obs_space(self):
        super()._define_obs_space()
        n = self._max_detection_number
        # reference pedestrian.py:45-52: sidewalk flag + waypoint ids.
        # The reference declares Box(0, 5000, int8) — a bound old gym
        # tolerated but gymnasium rejects (5000 > int8 max). The stored
        # values wrap in int8 regardless, so clamp the declared bound to
        # the dtype range while keeping the reference's int8 quirk.
        self.obs_space["on_sidewalk"] = gym.spaces.MultiBinary(n)
        self.obs_space["road_id"] = gym.spaces.Box(
            0, 127, (n, 1), np.int8)
        self.obs_space["lane_id"] = gym.spaces.Box(
            -20, 20, (n, 1), np.int8)

    def get_observation(self):
        obs = super().get_observation()
        n = self._max_detection_number
        # sidewalk/road/lane require a map waypoint query per pedestrian
        # (reference pedestrian.py:79-89)
        on_sidewalk = np.zeros(n, np.int8)
        road_id = np.zeros((n, 1), np.int8)
        lane_id = np.zeros((n, 1), np.int8)
        try:
            import carla

            carla_map = self._world.get_map()
            ev = self._parent.vehicle.get_transform()
            for i in range(n):
                if not obs["binary_mask"][i]:
                    continue
                # local -> world
                yaw = np.deg2rad(ev.rotation.yaw)
                c, s = np.cos(yaw), np.sin(yaw)
                lx, ly = obs["location"][i][:2]
                wx = ev.location.x + c * lx - s * ly
                wy = ev.location.y + s * lx + c * ly
                loc = carla.Location(x=float(wx), y=float(wy))
                wp = carla_map.get_waypoint(
                    loc, project_to_road=False,
                    lane_type=carla.LaneType.Driving,
                )
                on_sidewalk[i] = 1 if wp is None else 0
                # nearest driving waypoint, projected (pedestrian.py:87-89);
                # np.int8 dtype replicated from the reference (ids wrap)
                wp = carla_map.get_waypoint(loc)
                if wp is not None:
                    # astype wraps (numpy-2-safe) like the reference's
                    # np.array(..., dtype=np.int8) did under numpy 1
                    road_id[i, 0] = np.asarray(wp.road_id).astype(np.int8)
                    lane_id[i, 0] = np.asarray(wp.lane_id).astype(np.int8)
        except Exception:
            pass
        obs["on_sidewalk"] = on_sidewalk
        obs["road_id"] = road_id
        obs["lane_id"] = lane_id
        return obs
