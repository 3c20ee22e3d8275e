"""Global route planning over a road-topology graph (networkx A*).

Simulator-agnostic counterpart of reference carla_gym/core/task_actor/common/
navigation/global_route_planner.py: the road network is an abstract directed
graph of (xyz entry -> xyz exit) road segments with waypoint polylines;
planning localises endpoints, A*-searches with a Euclidean heuristic, and
annotates the waypoint route with RoadOption commands (turn decisions at
junctions from the cross product of entry/exit headings, lane changes from
topology links). A CARLA map adapter can populate the same RoadSegment list
from `carla_map.get_topology()`.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class RoadOption(enum.IntEnum):
    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4
    CHANGELANELEFT = 5
    CHANGELANERIGHT = 6


@dataclass
class RoadSegment:
    """One directed road segment: entry/exit positions + waypoint polyline."""

    entry: Tuple[float, float, float]
    exit: Tuple[float, float, float]
    path: List[Tuple[float, float, float]] = field(default_factory=list)
    intersection: bool = False
    # optional lane-change partners (indices into the segment list)
    left_lane: Optional[int] = None
    right_lane: Optional[int] = None


def _vector(a, b):
    v = np.asarray(b, float) - np.asarray(a, float)
    n = np.linalg.norm(v) + 1e-9
    return v / n


class GlobalRoutePlanner:
    def __init__(self, segments: Sequence[RoadSegment], resolution: float = 1.0):
        self.segments = list(segments)
        self.resolution = resolution
        import networkx as nx  # only the planner needs it, not RoadOption

        self._graph = nx.DiGraph()
        self._id_map: Dict[Tuple[float, float, float], int] = {}
        self._build_graph()
        self._previous_decision = RoadOption.VOID
        self._intersection_end_node = -1

    # ------------------------------------------------------------------
    def _node_id(self, xyz) -> int:
        key = tuple(round(float(c), 2) for c in xyz)
        if key not in self._id_map:
            self._id_map[key] = len(self._id_map)
            self._graph.add_node(self._id_map[key], vertex=key)
        return self._id_map[key]

    def _build_graph(self):
        for idx, seg in enumerate(self.segments):
            n1 = self._node_id(seg.entry)
            n2 = self._node_id(seg.exit)
            path = seg.path if seg.path else [seg.entry, seg.exit]
            entry_vec = _vector(path[0], path[min(1, len(path) - 1)])
            exit_vec = _vector(path[max(0, len(path) - 2)], path[-1])
            self._graph.add_edge(
                n1, n2,
                length=len(path),
                path=path,
                seg_index=idx,
                entry_vector=entry_vec,
                exit_vector=exit_vec,
                net_vector=_vector(seg.entry, seg.exit),
                intersection=seg.intersection,
                type=RoadOption.LANEFOLLOW,
            )
        # lane-change links
        for idx, seg in enumerate(self.segments):
            for partner, opt in ((seg.left_lane, RoadOption.CHANGELANELEFT),
                                 (seg.right_lane, RoadOption.CHANGELANERIGHT)):
                if partner is None:
                    continue
                p = self.segments[partner]
                n1 = self._node_id(seg.entry)
                n2 = self._node_id(p.exit)
                if not self._graph.has_edge(n1, n2):
                    self._graph.add_edge(
                        n1, n2, length=0, path=[], seg_index=partner,
                        entry_vector=None, exit_vector=None, net_vector=None,
                        intersection=False, type=opt,
                    )

    # ------------------------------------------------------------------
    def _localize(self, location) -> Optional[Tuple[int, int]]:
        """Nearest segment edge to a location."""
        loc = np.asarray(location, float)
        best, best_d = None, float("inf")
        for u, v, data in self._graph.edges(data=True):
            pts = data["path"] or [self._graph.nodes[u]["vertex"]]
            d = min(np.linalg.norm(loc - np.asarray(p, float)) for p in pts)
            if d < best_d:
                best, best_d = (u, v), d
        return best

    def _distance_heuristic(self, n1, n2):
        a = np.asarray(self._graph.nodes[n1]["vertex"], float)
        b = np.asarray(self._graph.nodes[n2]["vertex"], float)
        return float(np.linalg.norm(a - b))

    def _path_search(self, origin, destination) -> List[int]:
        start = self._localize(origin)
        end = self._localize(destination)
        import networkx as nx

        route = nx.astar_path(self._graph, source=start[0], target=end[0],
                              heuristic=self._distance_heuristic,
                              weight="length")
        route.append(end[1])
        return route

    # ------------------------------------------------------------------
    def _turn_decision(self, index, route, threshold=math.radians(35)):
        decision = RoadOption.VOID
        previous_node = route[index - 1]
        current_node = route[index]
        next_node = route[index + 1]
        next_edge = self._graph.edges[current_node, next_node]

        if index > 0:
            current_edge = self._graph.edges[previous_node, current_node]
            calculate_turn = (
                current_edge["type"] == RoadOption.LANEFOLLOW
                and not current_edge["intersection"]
                and next_edge["type"] == RoadOption.LANEFOLLOW
                and next_edge["intersection"]
            )
            if calculate_turn:
                cv = current_edge["exit_vector"]
                nv = next_edge["exit_vector"]
                if cv is None or nv is None:
                    return RoadOption.LANEFOLLOW
                cross = float(np.cross(cv[:2], nv[:2]))
                deviation = math.acos(
                    float(np.clip(np.dot(cv[:2], nv[:2]), -1.0, 1.0))
                )
                if deviation < threshold:
                    decision = RoadOption.STRAIGHT
                elif cross < 0:
                    decision = RoadOption.LEFT
                else:
                    decision = RoadOption.RIGHT
                self._previous_decision = decision
                return decision
        decision = next_edge["type"]
        self._previous_decision = decision
        return decision

    # ------------------------------------------------------------------
    def trace_route(self, origin, destination
                    ) -> List[Tuple[Tuple[float, float, float], RoadOption]]:
        """Waypoint route with per-waypoint RoadOption commands."""
        route_trace = []
        node_route = self._path_search(origin, destination)
        self._previous_decision = RoadOption.VOID
        for i in range(len(node_route) - 1):
            edge = self._graph.edges[node_route[i], node_route[i + 1]]
            if i < len(node_route) - 2:
                road_option = self._turn_decision(i, node_route)
            else:
                road_option = RoadOption.LANEFOLLOW
            path = edge["path"] or [self._graph.nodes[node_route[i]]["vertex"]]
            for wp in path:
                route_trace.append((tuple(wp), road_option))
        return route_trace


def downsample_route(route: List, sample_factor: float) -> List[int]:
    """Route indices to keep: command changes and every ``sample_factor`` m.

    (reference: route_manipulation.py:114-140)
    """
    ids_to_sample = []
    prev_option = None
    dist = 0.0
    for i, (wp, option) in enumerate(route):
        if option != prev_option or option in (
            RoadOption.CHANGELANELEFT, RoadOption.CHANGELANERIGHT
        ):
            ids_to_sample.append(i)
            dist = 0.0
        else:
            if i > 0:
                a = np.asarray(route[i - 1][0], float)
                b = np.asarray(wp, float)
                dist += float(np.linalg.norm(b - a))
            if dist > sample_factor:
                ids_to_sample.append(i)
                dist = 0.0
        prev_option = option
    ids_to_sample.append(len(route) - 1)
    return sorted(set(ids_to_sample))
