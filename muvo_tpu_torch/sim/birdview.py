"""ChauffeurNet-style bird's-eye-view rendering (pure; cv2-based).

Counterpart of the rendering core of reference carla_gym/core/obs_manager/
birdview/chauffeurnet.py: given a pre-rendered static town map (road / lane
mask layers, as produced by tools/render_town_maps.py into h5), the ego pose,
actor history, traffic-light states and the desired route, produce the
stacked binary masks + RGB rendering, warped so the ego faces up.

The CARLA-side actor polling lives in
muvo_tpu/sim/obs_managers/birdview/chauffeurnet.py; this module is pure and
unit-testable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

COLOR_WHITE = (255, 255, 255)


@dataclass
class ActorBox:
    """Actor footprint in world coordinates: centre, yaw (deg), extent (m)."""

    x: float
    y: float
    yaw: float
    extent_x: float
    extent_y: float


@dataclass
class StaticMap:
    """Pre-rendered town layers; world->pixel via pixels_per_meter + offset."""

    road: np.ndarray          # (H, W) uint8 {0, 255}
    lane_marking: np.ndarray  # (H, W) uint8
    pixels_per_meter: float
    world_offset: Tuple[float, float]  # world coords of pixel (0, 0)
    lane_marking_broken: Optional[np.ndarray] = None  # white-broken subset

    def world_to_pixel(self, x, y):
        px = (x - self.world_offset[0]) * self.pixels_per_meter
        py = (y - self.world_offset[1]) * self.pixels_per_meter
        return np.array([px, py], np.float32)


class BirdviewRenderer:
    """History semantics match the reference (chauffeurnet.py:46-50,215-221):
    a maxlen-20 queue of per-tick actor snapshots, sampled at the configured
    ``history_idx`` offsets (default [-16, -11, -6, -1] ≈ 0.5 s spacing at
    10 Hz), each index clamped to the oldest entry while the queue is
    filling."""

    def __init__(self, static_map: StaticMap, width_px: int = 192,
                 pixels_per_meter: float = 5.0, pixels_ev_to_bottom: int = 40,
                 history_idx: Sequence[int] = (-16, -11, -6, -1),
                 queue_maxlen: int = 20):
        assert cv2 is not None, "birdview rendering requires cv2"
        from collections import deque

        self._map = static_map
        self._width = width_px
        self._ppm = pixels_per_meter
        self._ev_bottom = pixels_ev_to_bottom
        self._history_idx = list(history_idx)
        # per tick: (vehicles, walkers, (green, yellow, red, stop))
        self._history_queue = deque(maxlen=queue_maxlen)

    # ------------------------------------------------------------------
    def _warp_transform(self, ev_x, ev_y, ev_yaw_deg):
        """Affine matrix mapping map pixels -> ego-centred BEV pixels."""
        ppm_ratio = self._ppm / self._map.pixels_per_meter
        ev_px = self._map.world_to_pixel(ev_x, ev_y)
        # rotate so ego heading points up, scale, translate
        yaw = np.deg2rad(ev_yaw_deg)
        c, s = np.cos(yaw), np.sin(yaw)
        half = self._width / 2.0
        bottom = self._width - self._ev_bottom
        # forward axis maps to -row
        m = np.array([
            [-s, c, 0.0],
            [-c, -s, 0.0],
        ], np.float32) * ppm_ratio
        t = np.array([half, bottom], np.float32) - m[:, :2] @ ev_px
        m[:, 2] = t
        return m

    def _warp(self, layer: np.ndarray, M) -> np.ndarray:
        return cv2.warpAffine(layer, M, (self._width, self._width))

    def _actor_mask(self, actors: Sequence[ActorBox], M) -> np.ndarray:
        mask = np.zeros((self._width, self._width), np.uint8)
        for a in actors:
            yaw = np.deg2rad(a.yaw)
            c, s = np.cos(yaw), np.sin(yaw)
            corners_world = [
                (a.x + c * dx * a.extent_x - s * dy * a.extent_y,
                 a.y + s * dx * a.extent_x + c * dy * a.extent_y)
                for dx, dy in ((1, 1), (1, -1), (-1, -1), (-1, 1))
            ]
            corners_px = np.array(
                [self._map.world_to_pixel(x, y) for x, y in corners_world]
            )
            corners = cv2.transform(
                corners_px.reshape(1, -1, 2), M
            ).reshape(-1, 2).astype(np.int32)
            cv2.fillConvexPoly(mask, corners, 255)
        return mask

    def _route_mask(self, route_xy: np.ndarray, M) -> np.ndarray:
        mask = np.zeros((self._width, self._width), np.uint8)
        if len(route_xy) >= 2:
            px = np.array([self._map.world_to_pixel(x, y) for x, y in route_xy])
            warped = cv2.transform(px.reshape(1, -1, 2), M).reshape(-1, 2)
            cv2.polylines(mask, [warped.astype(np.int32)], False, 255,
                          thickness=16)
        return mask

    # ------------------------------------------------------------------
    def render(self, ev_x: float, ev_y: float, ev_yaw_deg: float,
               vehicles: Sequence[ActorBox], walkers: Sequence[ActorBox],
               route_xy: np.ndarray,
               tl_green: Sequence[ActorBox] = (),
               tl_yellow: Sequence[ActorBox] = (),
               tl_red: Sequence[ActorBox] = (),
               stops: Sequence[ActorBox] = ()) -> Dict[str, np.ndarray]:
        """Returns {'masks': (3+3*H, H, W) uint8, 'rendered': (H, W, 3)}.

        Channel layout matches the reference exactly
        (chauffeurnet.py:188-208): 0 road, 1 route, 2 lane marking (255,
        white-broken subset re-marked 120), then len(history_idx) vehicle
        history channels (oldest offset first, newest last), the same for
        walkers, then traffic-light+stop history
        (green 80 / yellow 170 / red 255 / stop 255).
        """
        M = self._warp_transform(ev_x, ev_y, ev_yaw_deg)

        road = self._warp(self._map.road, M)
        lanes = self._warp(self._map.lane_marking, M)
        if self._map.lane_marking_broken is not None:
            broken = self._warp(self._map.lane_marking_broken, M)
            lanes = lanes.copy()
            lanes[broken > 0] = 120
        route = self._route_mask(route_xy, M)

        self._history_queue.append(
            (list(vehicles), list(walkers),
             (list(tl_green), list(tl_yellow), list(tl_red), list(stops))))

        # Sample the queue at history_idx, clamping to the oldest entry
        # while it is still filling (reference chauffeurnet.py:216-221).
        qsize = len(self._history_queue)
        vehicle_masks, walker_masks, tl_masks = [], [], []
        for idx in self._history_idx:
            idx = max(idx, -qsize)
            veh, wal, (green, yellow, red, stop) = self._history_queue[idx]
            vehicle_masks.append(self._actor_mask(veh, M))
            walker_masks.append(self._actor_mask(wal, M))
            tl = np.zeros_like(road)
            for boxes, value in ((green, 80), (yellow, 170), (red, 255),
                                 (stop, 255)):
                m = self._actor_mask(boxes, M)
                tl[m > 0] = value
            tl_masks.append(tl)

        masks = np.stack(
            [road, route, lanes] + vehicle_masks + walker_masks + tl_masks,
            axis=0,
        )

        tl_now = tl_masks[-1]
        rendered = np.zeros((self._width, self._width, 3), np.uint8)
        rendered[road > 0] = (85, 85, 85)
        rendered[lanes > 0] = (150, 150, 150)
        rendered[route > 0] = (80, 70, 120)
        rendered[vehicle_masks[-1] > 0] = (0, 83, 138)
        rendered[walker_masks[-1] > 0] = (127, 255, 212)
        rendered[tl_now == 255] = (220, 20, 60)
        rendered[tl_now == 80] = (50, 205, 50)
        return {"masks": masks, "rendered": rendered}

    def reset(self):
        self._history_queue.clear()


def load_static_map_h5(path: str) -> StaticMap:
    """Load a pre-rendered town map (reference maps/TownXX.h5 format)."""
    import h5py

    with h5py.File(path, "r") as f:
        road = np.asarray(f["road"])
        lane = np.asarray(f["lane_marking_all"]) if "lane_marking_all" in f \
            else np.asarray(f.get("lane_marking", np.zeros_like(road)))
        broken = (np.asarray(f["lane_marking_white_broken"])
                  if "lane_marking_white_broken" in f else None)
        ppm = float(np.asarray(f.attrs["pixels_per_meter"]))
        offset = tuple(np.asarray(f.attrs["world_offset_in_meters"]))
    return StaticMap(road=road, lane_marking=lane, pixels_per_meter=ppm,
                     world_offset=offset, lane_marking_broken=broken)
