"""Hazard-actor detection (pure numpy, simulator-agnostic).

Counterpart of reference carla_gym/utils/hazard_actor.py: given object-finder
observations ({'binary_mask', 'location', 'rotation', ...} in ego frame),
find the nearest blocking vehicle / crossing pedestrian.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def is_within_distance_ahead(target_location, max_distance, up_angle_th=60):
    distance = np.linalg.norm(target_location[0:2])
    if distance < 0.001:
        return True
    if distance > max_distance:
        return False
    angle = np.rad2deg(np.arctan2(target_location[1], target_location[0]))
    return abs(angle) < up_angle_th


def lbc_hazard_vehicle(obs_vehicles: Dict, ev_speed=None,
                       proximity_threshold=9.5) -> Optional[np.ndarray]:
    for i, is_valid in enumerate(obs_vehicles["binary_mask"]):
        if not is_valid:
            continue
        sv_yaw = obs_vehicles["rotation"][i][2]
        same_heading = abs(sv_yaw) <= 150
        sv_loc = obs_vehicles["location"][i]
        if same_heading and is_within_distance_ahead(
            sv_loc, proximity_threshold, up_angle_th=45
        ):
            return sv_loc
    return None


def lbc_hazard_walker(obs_pedestrians: Dict, ev_speed=None,
                      proximity_threshold=9.5) -> Optional[np.ndarray]:
    for i, is_valid in enumerate(obs_pedestrians["binary_mask"]):
        if not is_valid:
            continue
        if int(obs_pedestrians["on_sidewalk"][i]) == 1:
            continue
        ped_loc = obs_pedestrians["location"][i]
        dist = np.linalg.norm(ped_loc)
        degree = 162 / (np.clip(dist, 1.5, 10.5) + 0.3)
        if is_within_distance_ahead(ped_loc, proximity_threshold,
                                    up_angle_th=degree):
            return ped_loc
    return None


def get_collision(p1, v1, p2, v2):
    """Segment intersection test for challenge-style hazard prediction."""
    A = np.stack([v1, -v2], 1)
    b = p2 - p1
    if abs(np.linalg.det(A)) < 1e-3:
        return False, None
    x = np.linalg.solve(A, b)
    collides = all(x >= 0) and all(x <= 1)
    return collides, p1 + x[0] * v1
