"""Route-relative ego observation
(reference: carla_gym/core/obs_manager/actor_state/route.py:10-66).

Pure geometry over the task vehicle's route bookkeeping — lateral distance
to the current route waypoint, heading difference, the next waypoints in
ego frame, and the remaining route length in km. No CARLA types are
required: everything is computed from the waypoint xy arrays the repo's
TaskVehicle (and the kinematic env's mock) already carry, so the manager is
unit-testable offline.
"""

from __future__ import annotations

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.sim.agents import cast_angle, loc_global_to_ref
from muvo_tpu_torch.sim.obs_managers.base import ObsManagerBase


class ObsManager(ObsManagerBase):
    def __init__(self, obs_configs):
        self._parent = None
        self._route_steps = 5  # reference route.py:14
        super().__init__()

    def _define_obs_space(self):
        self.obs_space = gym.spaces.Dict({
            "lateral_dist": gym.spaces.Box(0.0, 2.0, (1,), np.float32),
            "angle_diff": gym.spaces.Box(-2.0, 2.0, (1,), np.float32),
            "route_locs": gym.spaces.Box(
                -5.0, 5.0, (self._route_steps * 2,), np.float32),
            "dist_remaining": gym.spaces.Box(0.0, 100.0, (1,), np.float32),
        })

    def attach_ego_vehicle(self, parent_actor):
        self._parent = parent_actor

    # ------------------------------------------------------------------
    def _remaining_plan(self):
        """Waypoint xy list from the current route index on (the reference's
        parent.route_plan is the not-yet-consumed tail)."""
        route = getattr(self._parent, "_route", [])
        idx = getattr(self._parent, "_route_idx", 0)
        return [np.asarray(wp, np.float64)[:2] for wp, _ in route[idx:]]

    @staticmethod
    def _wp_yaw_deg(plan, i):
        """Waypoint heading from the segment to the next waypoint (matches
        TaskVehicle.get_route_transform)."""
        if len(plan) < 2:
            return 0.0
        j = min(i, len(plan) - 2)
        d = plan[j + 1] - plan[j]
        return float(np.rad2deg(np.arctan2(d[1], d[0])))

    def get_observation(self):
        tf = self._parent.vehicle.get_transform()
        ev_xy = np.array([tf.location.x, tf.location.y], np.float64)
        ev_yaw = float(tf.rotation.yaw)

        plan = self._remaining_plan()
        if not plan:
            zeros = np.zeros(self._route_steps * 2, np.float32)
            return {
                "lateral_dist": np.zeros(1, np.float32),
                "angle_diff": np.zeros(1, np.float32),
                "route_locs": zeros,
                "dist_remaining": np.zeros(1, np.float32),
            }

        # lateral_dist (reference route.py:33-42): |right · (ev - wp0)|
        wp0 = plan[0]
        wp_yaw = self._wp_yaw_deg(plan, 0)
        yaw_rad = np.deg2rad(wp_yaw)
        fwd = np.array([np.cos(yaw_rad), np.sin(yaw_rad)])
        right = np.array([-fwd[1], fwd[0]])
        lateral_dist = float(np.clip(abs(np.dot(right, ev_xy - wp0)), 0, 2))

        # angle_diff (route.py:45-46): |wrapped yaw difference| in rad
        angle_diff = float(np.clip(
            np.deg2rad(abs(cast_angle(ev_yaw - wp_yaw))), -2, 2))

        # route_locs (route.py:49-59): next waypoints in ego frame,
        # clamped to the last waypoint past the route end
        locs = []
        for i in range(self._route_steps):
            wp = plan[min(i, len(plan) - 1)]
            local = loc_global_to_ref(wp, ev_xy, ev_yaw)
            locs += [float(local[0]), float(local[1])]

        # dist_remaining in km (route.py:62)
        remaining = (getattr(self._parent, "route_length", 0.0)
                     - getattr(self._parent, "route_completed", 0.0)) / 1000.0

        return {
            "lateral_dist": np.array([lateral_dist], np.float32),
            "angle_diff": np.array([angle_diff], np.float32),
            "route_locs": np.array(locs, np.float32),
            "dist_remaining": np.array([remaining], np.float32),
        }

    def clean(self):
        self._parent = None
