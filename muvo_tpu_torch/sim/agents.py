"""Scripted scenario agents: PID controller, waypoint local planner,
basic / constant-speed drivers, and GPS utilities.

Counterparts of reference carla_gym/core/task_actor/scenario_actor/agents/
(utils/controller.py, utils/local_planner.py, basic_agent.py,
constant_speed_agent.py) and carla_gym's gps helpers. All pure numpy except
the CARLA control construction.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from muvo_tpu_torch.sim.route_planner import RoadOption

EARTH_RADIUS_EQUA = 6378137.0  # metres (CARLA's Mercator radius)


# ---------------------------------------------------------------------------
def gps_to_location(gps: Sequence[float]) -> np.ndarray:
    """(lat, lon, alt) -> CARLA world (x, y, z) via the Mercator projection.

    (reference: muvo/data/carlagym_utils.py:54-66)
    """
    lat, lon, z = float(gps[0]), float(gps[1]), float(gps[2])
    x = lon / 180.0 * (math.pi * EARTH_RADIUS_EQUA)
    y = -1.0 * math.log(math.tan((lat + 90.0) * math.pi / 360.0)) \
        * EARTH_RADIUS_EQUA
    return np.array([x, y, z])


def vec_global_to_ref(vec: np.ndarray, ref_yaw_deg: float) -> np.ndarray:
    """Rotate a global-frame 2/3-vector into a reference frame given by yaw."""
    yaw = math.radians(ref_yaw_deg)
    c, s = math.cos(yaw), math.sin(yaw)
    x = c * vec[0] + s * vec[1]
    y = -s * vec[0] + c * vec[1]
    out = np.array([x, y] + ([vec[2]] if len(vec) > 2 else []))
    return out


def loc_global_to_ref(loc: np.ndarray, ref_loc: np.ndarray,
                      ref_yaw_deg: float) -> np.ndarray:
    return vec_global_to_ref(np.asarray(loc) - np.asarray(ref_loc), ref_yaw_deg)


def cast_angle(x: float) -> float:
    """Wrap to (-180, 180]."""
    return ((x + 180.0) % 360.0) - 180.0


# ---------------------------------------------------------------------------
class PIDController:
    """(reference: agents/utils/controller.py)"""

    def __init__(self, pid_list, n=30, dt=0.1):
        self._kp, self._ki, self._kd = pid_list
        self._dt = dt
        self._window = deque(maxlen=n)

    def reset(self):
        self._window.clear()

    def step(self, error: float) -> float:
        self._window.append(error)
        if len(self._window) >= 2:
            integral = sum(self._window) * self._dt
            derivative = (self._window[-1] - self._window[-2]) / self._dt
        else:
            integral = derivative = 0.0
        return self._kp * error + self._ki * integral + self._kd * derivative


class LocalPlanner:
    """Waypoint follower with PID speed/steer (reference local_planner.py)."""

    def __init__(self, target_speed=0.0,
                 longitudinal_pid_params=(0.5, 0.025, 0.1),
                 lateral_pid_params=(0.75, 0.05, 0.0),
                 threshold_before=7.5, threshold_after=5.0):
        self._target_speed = target_speed
        self._speed_pid = PIDController(longitudinal_pid_params)
        self._turn_pid = PIDController(lateral_pid_params)
        self._threshold_before = threshold_before
        self._threshold_after = threshold_after
        self._max_skip = 20
        self._last_command = int(RoadOption.LANEFOLLOW)

    def run_step(self, route_plan: List[Tuple[np.ndarray, RoadOption]],
                 actor_location: np.ndarray, actor_yaw_deg: float,
                 actor_speed: float) -> Tuple[float, float, float]:
        """route_plan: [(xyz, RoadOption)]; location in world coords."""
        target_index = -1
        for i, (wp, option) in enumerate(route_plan[: self._max_skip]):
            if self._last_command == int(RoadOption.LANEFOLLOW) and \
                    int(option) != int(RoadOption.LANEFOLLOW):
                threshold = self._threshold_before
            else:
                threshold = self._threshold_after
            distance = float(np.linalg.norm(
                np.asarray(wp)[:2] - np.asarray(actor_location)[:2]
            ))
            if distance < threshold:
                self._last_command = int(option)
                target_index = i

        target_index = min(target_index + 1, len(route_plan) - 1)
        target_command = route_plan[target_index][1]
        target_world = np.asarray(route_plan[target_index][0])
        target_local = loc_global_to_ref(
            target_world[:2], np.asarray(actor_location)[:2], actor_yaw_deg
        )

        theta = math.atan2(target_local[1], target_local[0])
        steer = self._turn_pid.step(theta)

        target_speed = self._target_speed
        if int(target_command) not in (int(RoadOption.STRAIGHT),
                                       int(RoadOption.LANEFOLLOW)):
            target_speed *= 0.75
        throttle = self._speed_pid.step(target_speed - actor_speed)

        return (float(np.clip(throttle, 0.0, 1.0)),
                float(np.clip(steer, -1.0, 1.0)), 0.0)


class ConstantSpeedAgent:
    """Drives the route at a fixed speed (reference constant_speed_agent.py)."""

    def __init__(self, route_plan, target_speed=6.0):
        self._route_plan = list(route_plan)
        self._planner = LocalPlanner(target_speed=target_speed)

    def run_step(self, location, yaw_deg, speed):
        # drop waypoints already passed
        while len(self._route_plan) > 2 and float(np.linalg.norm(
            np.asarray(self._route_plan[0][0])[:2] - np.asarray(location)[:2]
        )) < 2.0:
            self._route_plan.pop(0)
        return self._planner.run_step(self._route_plan, location, yaw_deg,
                                      speed)


class BasicAgent(ConstantSpeedAgent):
    """Constant-speed driving with naive hazard stops
    (reference basic_agent.py, simplified)."""

    def __init__(self, route_plan, target_speed=6.0, brake_distance=8.0):
        super().__init__(route_plan, target_speed)
        self._brake_distance = brake_distance

    def run_step(self, location, yaw_deg, speed, hazard_locations=()):
        for hazard in hazard_locations:
            local = loc_global_to_ref(
                np.asarray(hazard)[:2], np.asarray(location)[:2], yaw_deg
            )
            if 0 < local[0] < self._brake_distance and abs(local[1]) < 2.0:
                return 0.0, 0.0, 1.0  # full brake
        return super().run_step(location, yaw_deg, speed)
