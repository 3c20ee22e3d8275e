"""CARLA map -> RoadSegment list for the GlobalRoutePlanner.

Samples each (entry, exit) waypoint pair of ``carla_map.get_topology()`` into
a waypoint polyline, marking junction segments and lane-change partners.
(reference: navigation/map_utils.get_sampled_topology)
"""

from __future__ import annotations

from typing import List

from muvo_tpu_torch.sim.route_planner import RoadSegment


def _loc(wp):
    loc = wp.transform.location
    return (loc.x, loc.y, loc.z)


def build_segments(carla_map, resolution: float = 1.0) -> List[RoadSegment]:
    segments: List[RoadSegment] = []
    key_by_lane = {}
    topology = carla_map.get_topology()
    for entry_wp, exit_wp in topology:
        path = [_loc(entry_wp)]
        wp = entry_wp
        while True:
            nxt = wp.next(resolution)
            if not nxt:
                break
            wp = nxt[0]
            path.append(_loc(wp))
            if wp.transform.location.distance(exit_wp.transform.location) \
                    < resolution:
                break
            if len(path) > 10000:
                break
        path.append(_loc(exit_wp))
        seg = RoadSegment(
            entry=_loc(entry_wp),
            exit=_loc(exit_wp),
            path=path,
            intersection=bool(entry_wp.is_junction),
        )
        key_by_lane[(entry_wp.road_id, entry_wp.section_id,
                     entry_wp.lane_id)] = len(segments)
        segments.append(seg)

    # lane-change partners via CARLA lane links
    for (road, section, lane), idx in key_by_lane.items():
        left = key_by_lane.get((road, section, lane + (1 if lane > 0 else -1)))
        if left is not None:
            segments[idx].left_lane = left
    return segments
