"""Ego task vehicle: spawning, global-route tracking, infraction criteria.

Counterpart of reference carla_gym/core/task_actor/common/task_vehicle.py and
the criteria modules (collision, blocked, run_red_light, run_stop_sign,
outside_route_lane, route_deviation). The geometric criteria logic is kept
simulator-agnostic where possible; CARLA interaction (sensors, map queries)
is confined to this module.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import numpy as np


class BlockedCriterion:
    """Vehicle considered blocked below speed_threshold for too long.

    (reference criteria/blocked.py)
    """

    def __init__(self, speed_threshold=0.1, below_threshold_max_time=90.0):
        self._speed_threshold = speed_threshold
        self._max_time = below_threshold_max_time
        self._time_last_valid = None

    def tick(self, vehicle, timestamp) -> Optional[Dict]:
        v = vehicle.get_velocity()
        speed = np.linalg.norm([v.x, v.y])
        sim_time = timestamp["relative_simulation_time"]
        if speed < self._speed_threshold:
            if self._time_last_valid is None:
                self._time_last_valid = sim_time
            elif sim_time - self._time_last_valid > self._max_time:
                return {
                    "step": timestamp["step"],
                    "simulation_time": sim_time,
                }
        else:
            self._time_last_valid = None
        return None


class RouteDeviationCriterion:
    """Too far laterally from the route (reference criteria/route_deviation.py)."""

    def __init__(self, max_deviation=30.0):
        self._max_deviation = max_deviation

    def tick(self, task_vehicle, timestamp) -> Optional[Dict]:
        if task_vehicle.lateral_route_distance > self._max_deviation:
            return {
                "step": timestamp["step"],
                "deviation": task_vehicle.lateral_route_distance,
            }
        return None


class CollisionCriterion:
    """Collision sensor wrapper (reference criteria/collision.py)."""

    TYPE_LAYOUT = 0
    TYPE_VEHICLE = 1
    TYPE_PEDESTRIAN = 2
    TYPE_OTHER = 3

    def __init__(self, vehicle, world):
        import carla

        self._events: List[Dict] = []
        bp = world.get_blueprint_library().find("sensor.other.collision")
        self._sensor = world.spawn_actor(
            bp, carla.Transform(), attach_to=vehicle
        )
        weak_self = weakref.ref(self)
        self._sensor.listen(
            lambda event: CollisionCriterion._on_collision(weak_self, event)
        )

    @staticmethod
    def _on_collision(weak_self, event):
        self = weak_self()
        if self is None:
            return
        other = event.other_actor
        type_id = other.type_id if other is not None else ""
        if type_id.startswith("vehicle"):
            ctype = CollisionCriterion.TYPE_VEHICLE
        elif type_id.startswith("walker"):
            ctype = CollisionCriterion.TYPE_PEDESTRIAN
        elif type_id.startswith(("static", "traffic")):
            ctype = CollisionCriterion.TYPE_LAYOUT
        else:
            ctype = CollisionCriterion.TYPE_OTHER
        impulse = event.normal_impulse
        self._events.append({
            "collision_type": ctype,
            "other_actor_id": other.id if other is not None else -1,
            "other_actor_type": type_id,
            "intensity": float(np.linalg.norm(
                [impulse.x, impulse.y, impulse.z]
            )),
            "frame": event.frame,
        })

    def tick(self, timestamp) -> Optional[Dict]:
        if self._events:
            event = self._events[-1]
            self._events.clear()
            event["step"] = timestamp["step"]
            return event
        return None

    def clean(self):
        if self._sensor is not None:
            self._sensor.stop()
            self._sensor.destroy()
            self._sensor = None


class TaskVehicle:
    """Ego vehicle + route bookkeeping + criteria."""

    def __init__(self, vehicle, target_locations: List, world,
                 spawn_transform):
        self.vehicle = vehicle
        self._world = world
        self.spawn_location = spawn_transform.location
        self.criteria_blocked = BlockedCriterion()
        self.criteria_route_dev = RouteDeviationCriterion()
        self.criteria_collision = CollisionCriterion(vehicle, world)
        self.criteria_stop = None  # stop-sign criterion needs map queries
        self.info_criteria: Dict = {}

        self._route: List = []
        self._route_idx = 0
        self.route_length = 0.0
        self.route_completed = 0.0
        self.lateral_route_distance = 0.0
        self._target_locations = target_locations
        self._build_route(target_locations)

    # ------------------------------------------------------------------
    @classmethod
    def spawn(cls, world, config: Dict, ev_id: str) -> "TaskVehicle":
        import carla

        bp_library = world.get_blueprint_library()
        bp = bp_library.find(config.get("model", "vehicle.lincoln.mkz_2017"))
        bp.set_attribute("role_name", ev_id)
        spawn = config.get("spawn_transform")
        if spawn is None:
            spawn_points = world.get_map().get_spawn_points()
            spawn = spawn_points[np.random.randint(len(spawn_points))]
        elif isinstance(spawn, (list, tuple)):
            spawn = carla.Transform(
                carla.Location(*spawn[:3]), carla.Rotation(*spawn[3:])
            )
        actor = world.try_spawn_actor(bp, spawn)
        assert actor is not None, f"failed to spawn ego vehicle {ev_id}"
        world.tick()
        return cls(actor, config.get("targets", []), world, spawn)

    def _build_route(self, target_locations):
        """Trace the global route through the map planner if targets given."""
        if not target_locations:
            return
        try:
            carla_map = self._world.get_map()
            from muvo_tpu_torch.sim.carla_map_adapter import build_segments

            from muvo_tpu_torch.sim.route_planner import GlobalRoutePlanner

            segments = build_segments(carla_map)
            planner = GlobalRoutePlanner(segments)
            origin = self.vehicle.get_location()
            route = []
            start = (origin.x, origin.y, origin.z)
            for target in target_locations:
                route.extend(planner.trace_route(start, tuple(target)))
                start = tuple(target)
            self._route = route
            self.route_length = sum(
                float(np.linalg.norm(
                    np.asarray(route[i + 1][0]) - np.asarray(route[i][0])
                ))
                for i in range(len(route) - 1)
            )
        except Exception as e:  # pragma: no cover
            print(f"route tracing failed: {e}")

    # ------------------------------------------------------------------
    def get_route_transform(self):
        """Current target waypoint transform (location + forward direction)."""
        if not self._route:
            return self.vehicle.get_transform()
        idx = min(self._route_idx, len(self._route) - 2)
        import carla

        wp = np.asarray(self._route[idx][0])
        nxt = np.asarray(self._route[idx + 1][0])
        yaw = np.rad2deg(np.arctan2(nxt[1] - wp[1], nxt[0] - wp[0]))
        return carla.Transform(
            carla.Location(*wp.tolist()), carla.Rotation(yaw=float(yaw))
        )

    def _update_route_tracking(self):
        if not self._route:
            return
        loc = self.vehicle.get_location()
        pos = np.array([loc.x, loc.y, loc.z])
        # advance the route index to the nearest forthcoming waypoint
        window_end = min(self._route_idx + 50, len(self._route))
        dists = [
            np.linalg.norm(pos - np.asarray(self._route[i][0]))
            for i in range(self._route_idx, window_end)
        ]
        best = int(np.argmin(dists))
        if best > 0:
            for i in range(best):
                a = np.asarray(self._route[self._route_idx + i][0])
                b = np.asarray(self._route[self._route_idx + i + 1][0])
                self.route_completed += float(np.linalg.norm(b - a))
            self._route_idx += best
        wp_tf = self.get_route_transform()
        d = np.array([loc.x - wp_tf.location.x, loc.y - wp_tf.location.y])
        fwd = wp_tf.rotation.get_forward_vector()
        right = np.array([-fwd.y, fwd.x])
        self.lateral_route_distance = float(abs(np.dot(right, d)))

    # ------------------------------------------------------------------
    def tick(self, timestamp) -> Dict:
        self._update_route_tracking()
        info = {
            "collision": self.criteria_collision.tick(timestamp),
            "blocked": self.criteria_blocked.tick(self.vehicle, timestamp),
            "route_deviation": self.criteria_route_dev.tick(self, timestamp),
            "run_red_light": None,   # requires TrafficLightHandler (CARLA)
            "run_stop_sign": None,
            "encounter_light": None,
            "outside_route_lane": None,
            "route_completion": {
                "route_completed_in_m": self.route_completed,
                "route_length_in_m": self.route_length,
                "is_route_completed": (
                    self.route_length > 0
                    and self.route_completed >= self.route_length - 1e-3
                ),
            },
        }
        self.info_criteria = info
        return info

    def clean(self):
        self.criteria_collision.clean()
        if self.vehicle is not None:
            self.vehicle.destroy()
            self.vehicle = None
