"""Traffic-light registry + red-light / stop-sign / lane criteria.

Counterparts of reference carla_gym/utils/traffic_light.py and
carla_gym/core/task_actor/common/criteria/{run_red_light, run_stop_sign,
outside_route_lane, encounter_light}.py. Geometric predicates (segment
crossing, trigger-volume containment) are pure numpy; CARLA interaction is
confined to the handler initialisation and actor polling.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def segments_intersect(p1, p2, q1, q2) -> bool:
    """2-D segment intersection (pure; replaces shapely)."""
    p1, p2, q1, q2 = (np.asarray(v, float)[:2] for v in (p1, p2, q1, q2))

    def orient(a, b, c):
        return np.cross(b - a, c - a)

    d1, d2 = orient(q1, q2, p1), orient(q1, q2, p2)
    d3, d4 = orient(p1, p2, q1), orient(p1, p2, q2)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)):
        return True

    def on_seg(a, b, c):
        return (min(a[0], b[0]) - 1e-9 <= c[0] <= max(a[0], b[0]) + 1e-9
                and min(a[1], b[1]) - 1e-9 <= c[1] <= max(a[1], b[1]) + 1e-9)

    for d, a, b, c in ((d1, q1, q2, p1), (d2, q1, q2, p2),
                       (d3, p1, p2, q1), (d4, p1, p2, q2)):
        if abs(d) < 1e-12 and on_seg(a, b, c):
            return True
    return False


def point_in_box(point, box_center, box_extent, box_yaw_deg) -> bool:
    """Is a world point inside an oriented 2-D box?"""
    yaw = np.deg2rad(box_yaw_deg)
    c, s = np.cos(yaw), np.sin(yaw)
    d = np.asarray(point, float)[:2] - np.asarray(box_center, float)[:2]
    local = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
    return bool((np.abs(local) <= np.asarray(box_extent, float)[:2] + 1e-9).all())


class TrafficLightHandler:
    """Static registry of traffic lights + their stop lines.

    (reference: carla_gym/utils/traffic_light.py; reset() walks all traffic
    lights in the world and caches stop-line segments per affected lane)
    """

    num_tl = 0
    list_tl_actor: List = []
    list_tv_loc: List = []
    list_stopline_wps: List = []
    list_stopline_vtx: List = []

    @classmethod
    def reset(cls, world):
        import carla

        cls.list_tl_actor = list(
            world.get_actors().filter("traffic.traffic_light*")
        )
        cls.num_tl = len(cls.list_tl_actor)
        cls.list_tv_loc, cls.list_stopline_wps, cls.list_stopline_vtx = [], [], []
        carla_map = world.get_map()
        for tl in cls.list_tl_actor:
            tf = tl.get_transform()
            tv_loc = tf.transform(tl.trigger_volume.location)
            cls.list_tv_loc.append(tv_loc)
            stop_wps, stop_vtx = [], []
            for wp in tl.get_stop_waypoints():
                stop_wps.append(wp)
                wtf = wp.transform
                right = wtf.get_right_vector()
                half = wp.lane_width / 2.0
                left_pt = wtf.location - right * half
                right_pt = wtf.location + right * half
                stop_vtx.append((left_pt, right_pt))
            cls.list_stopline_wps.append(stop_wps)
            cls.list_stopline_vtx.append(stop_vtx)

    @classmethod
    def get_light_state(cls, vehicle, offset=0.0, dist_threshold=18.0):
        """Nearest relevant light state ahead; returns (state, loc_in_ev, idx)."""
        import carla

        from muvo_tpu_torch.sim.agents import loc_global_to_ref

        ev_tf = vehicle.get_transform()
        ev_loc = ev_tf.location
        ev_yaw = ev_tf.rotation.yaw
        check_pt = ev_tf.transform(carla.Location(x=offset))
        for idx in range(cls.num_tl):
            tl = cls.list_tl_actor[idx]
            tv_loc = cls.list_tv_loc[idx]
            if tv_loc.distance(check_pt) > dist_threshold:
                continue
            for wp in cls.list_stopline_wps[idx]:
                wtf = wp.transform
                wp_dir = wtf.get_forward_vector()
                ev_dir = ev_tf.get_forward_vector()
                if ev_dir.x * wp_dir.x + ev_dir.y * wp_dir.y <= 0:
                    continue
                loc_in_ev = loc_global_to_ref(
                    np.array([tv_loc.x, tv_loc.y, tv_loc.z]),
                    np.array([ev_loc.x, ev_loc.y, ev_loc.z]), ev_yaw,
                )
                if loc_in_ev[0] < -0.5:  # behind
                    continue
                return tl.state, loc_in_ev.astype(np.float32), idx
        return None, None, None


class RunRedLightCriterion:
    def __init__(self, carla_map, distance_light=30.0):
        self._map = carla_map
        self._distance_light = distance_light
        self._last_red_light_id = None

    def tick(self, vehicle, timestamp) -> Optional[Dict]:
        import carla

        ev_tf = vehicle.get_transform()
        ev_loc = ev_tf.location
        ev_dir = ev_tf.get_forward_vector()
        ev_extent = vehicle.bounding_box.extent.x
        tail_close = ev_tf.transform(carla.Location(x=-0.8 * ev_extent))
        tail_far = ev_tf.transform(carla.Location(x=-ev_extent - 1.0))
        tail_wp = self._map.get_waypoint(tail_far)

        for idx in range(TrafficLightHandler.num_tl):
            tl = TrafficLightHandler.list_tl_actor[idx]
            tv_loc = TrafficLightHandler.list_tv_loc[idx]
            if tv_loc.distance(ev_loc) > self._distance_light:
                continue
            if tl.state != carla.TrafficLightState.Red:
                continue
            if self._last_red_light_id == tl.id:
                continue
            for wp_i, wp in enumerate(TrafficLightHandler.list_stopline_wps[idx]):
                wp_dir = wp.transform.get_forward_vector()
                dot = (ev_dir.x * wp_dir.x + ev_dir.y * wp_dir.y
                       + ev_dir.z * wp_dir.z)
                if (tail_wp.road_id == wp.road_id
                        and tail_wp.lane_id == wp.lane_id and dot > 0):
                    left, right = TrafficLightHandler.list_stopline_vtx[idx][wp_i]
                    if segments_intersect(
                        (tail_close.x, tail_close.y), (tail_far.x, tail_far.y),
                        (left.x, left.y), (right.x, right.y),
                    ):
                        tl_loc = tl.get_location()
                        self._last_red_light_id = tl.id
                        return {
                            "step": timestamp["step"],
                            "simulation_time":
                                timestamp["relative_simulation_time"],
                            "id": tl.id,
                            "tl_loc": [tl_loc.x, tl_loc.y, tl_loc.z],
                            "ev_loc": [ev_loc.x, ev_loc.y, ev_loc.z],
                        }
        return None


class EncounterLightCriterion:
    """Reports any relevant light ahead (reference criteria/encounter_light.py)."""

    def __init__(self, dist_threshold=7.5):
        self._dist = dist_threshold

    def tick(self, vehicle, timestamp) -> Optional[Dict]:
        state, loc, idx = TrafficLightHandler.get_light_state(
            vehicle, dist_threshold=self._dist
        )
        if state is None:
            return None
        return {
            "step": timestamp["step"],
            "simulation_time": timestamp["relative_simulation_time"],
            "id": idx,
            "tl_state": str(state),
        }


class RunStopSignCriterion:
    """Stop-sign compliance (reference criteria/run_stop_sign.py): entering a
    stop trigger volume arms the criterion; leaving it without having come to
    a near-stop emits a 'run' event, stopping emits a cleared state."""

    PROXIMITY_THRESHOLD = 50.0
    SPEED_THRESHOLD = 0.1
    WAYPOINT_STEP = 1.0

    def __init__(self, carla_map):
        self._map = carla_map
        self._target_stop_sign = None
        self._stop_completed = False

    def tick(self, vehicle, timestamp, stop_signs) -> Optional[Dict]:
        """stop_signs: iterable of CARLA stop-sign actors."""
        import carla

        info = None
        ev_loc = vehicle.get_location()
        ev_vel = vehicle.get_velocity()
        speed = np.linalg.norm([ev_vel.x, ev_vel.y])

        if self._target_stop_sign is None:
            for stop in stop_signs:
                stf = stop.get_transform()
                if stf.location.distance(ev_loc) > self.PROXIMITY_THRESHOLD:
                    continue
                tv_loc = stf.transform(stop.trigger_volume.location)
                ext = stop.trigger_volume.extent
                if point_in_box(
                    (ev_loc.x, ev_loc.y), (tv_loc.x, tv_loc.y),
                    (max(ext.x, 1.5) + 2.0, max(ext.y, 1.5) + 2.0),
                    stf.rotation.yaw,
                ):
                    self._target_stop_sign = stop
                    self._stop_completed = False
                    info = {
                        "event": "encounter",
                        "step": timestamp["step"],
                        "id": stop.id,
                        "simulation_time":
                            timestamp["relative_simulation_time"],
                    }
                    break
        else:
            if not self._stop_completed and speed < self.SPEED_THRESHOLD:
                self._stop_completed = True
            stop = self._target_stop_sign
            stf = stop.get_transform()
            tv_loc = stf.transform(stop.trigger_volume.location)
            ext = stop.trigger_volume.extent
            inside = point_in_box(
                (ev_loc.x, ev_loc.y), (tv_loc.x, tv_loc.y),
                (max(ext.x, 1.5) + 2.0, max(ext.y, 1.5) + 2.0),
                stf.rotation.yaw,
            )
            if not inside:
                if not self._stop_completed:
                    info = {
                        "event": "run",
                        "step": timestamp["step"],
                        "id": stop.id,
                        "simulation_time":
                            timestamp["relative_simulation_time"],
                    }
                self._target_stop_sign = None
                self._stop_completed = False
        return info


class OutsideRouteLaneCriterion:
    """Wrong-lane / off-road detection (reference
    criteria/outside_route_lane.py)."""

    ALLOWED_OUT_DISTANCE = 1.3

    def __init__(self, carla_map):
        self._map = carla_map
        self._outside_lane = False
        self._wrong_lane = False

    def tick(self, vehicle, timestamp, route_yaw_deg: float) -> Optional[Dict]:
        import carla

        ev_loc = vehicle.get_location()
        wp = self._map.get_waypoint(ev_loc, project_to_road=False,
                                    lane_type=carla.LaneType.Driving)
        self._outside_lane = wp is None
        self._wrong_lane = False
        if wp is not None:
            yaw_diff = abs(((wp.transform.rotation.yaw - route_yaw_deg + 180)
                            % 360) - 180)
            self._wrong_lane = yaw_diff > 120.0
        if self._outside_lane or self._wrong_lane:
            return {
                "step": timestamp["step"],
                "simulation_time": timestamp["relative_simulation_time"],
                "outside_lane": self._outside_lane,
                "wrong_lane": self._wrong_lane,
            }
        return None
