"""CARLA-free driving environment with the CarlaMultiAgentEnv interface.

A kinematic-bicycle ego on a procedurally generated road network with
synthetic sensors (birdview masks, RGB noise camera, semantic LiDAR rings),
using the same reward/terminal classes and the same obs/reward/info dict
contract as the CARLA env. Enables end-to-end testing and smoke-training of
the full collection + PPO + DataWriter + dataset + world-model pipeline on
machines without a CARLA server.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from muvo_tpu_torch.constants import CARLA_FPS, WHEEL_BASE
from muvo_tpu_torch.sim.reward import (
    RewardInput,
    TerminalInput,
    ValeoActionReward,
    ValeoTerminal,
)


class KinematicEgo:
    def __init__(self, x=0.0, y=0.0, yaw=0.0):
        self.x, self.y, self.yaw = x, y, yaw
        self.speed = 0.0
        self.steer = 0.0

    def step(self, throttle, steer, brake, dt=1.0 / CARLA_FPS):
        accel = 4.0 * throttle - 8.0 * brake - 0.1 * self.speed
        self.speed = max(0.0, self.speed + accel * dt)
        self.steer = float(np.clip(steer, -1, 1))
        yaw_rate = self.speed * math.tan(self.steer * 0.5) / WHEEL_BASE
        self.yaw += yaw_rate * dt
        self.x += self.speed * math.cos(self.yaw) * dt
        self.y += self.speed * math.sin(self.yaw) * dt


class KinematicDrivingEnv:
    """Single-ego env: follow a procedurally generated lane."""

    def __init__(self, seed: int = 0, episode_steps: int = 400,
                 image_hw=(96, 160), bev_hw=(192, 192), lidar_points=2000):
        self._rng = np.random.RandomState(seed)
        self._episode_steps = episode_steps
        self._image_hw = image_hw
        self._bev_hw = bev_hw
        self._lidar_points = lidar_points
        self.reward_handler = ValeoActionReward()
        self.terminal_handler = ValeoTerminal(stuck_steps=100)
        self._ego: Optional[KinematicEgo] = None
        self._route: Optional[np.ndarray] = None
        self._timestamp = None

    # ------------------------------------------------------------------
    def _make_route(self) -> np.ndarray:
        """Smooth random 2-D polyline, 1 m spacing."""
        n = self._episode_steps
        headings = np.cumsum(self._rng.uniform(-0.03, 0.03, n))
        pts = np.cumsum(
            np.stack([np.cos(headings), np.sin(headings)], -1), axis=0
        )
        return np.concatenate([[[0.0, 0.0]], pts], axis=0)

    def _route_tracking(self):
        pos = np.array([self._ego.x, self._ego.y])
        dists = np.linalg.norm(self._route - pos, axis=1)
        idx = int(np.argmin(dists))
        nxt = min(idx + 1, len(self._route) - 1)
        fwd = self._route[nxt] - self._route[idx]
        fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
        right = np.array([-fwd[1], fwd[0]])
        lateral = float(np.dot(right, pos - self._route[idx]))
        heading_err = math.atan2(fwd[1], fwd[0]) - self._ego.yaw
        heading_err = (heading_err + math.pi) % (2 * math.pi) - math.pi
        return idx, lateral, heading_err, fwd

    # ------------------------------------------------------------------
    def _observation(self) -> Dict:
        h, w = self._image_hw
        idx, lateral, heading_err, fwd = self._route_tracking()

        # birdview masks: route polyline rendered into channel 1, road 0
        bh, bw = self._bev_hw
        masks = np.zeros((15, bh, bw), np.uint8)  # reference channel layout
        masks[0] = 255
        ego = np.array([self._ego.x, self._ego.y])
        cos, sin = math.cos(-self._ego.yaw), math.sin(-self._ego.yaw)
        rot = np.array([[cos, -sin], [sin, cos]])
        local = (self._route[idx:idx + 60] - ego) @ rot.T
        px = (bh // 2 - local[:, 0] * 4).astype(int)
        py = (bw // 2 - local[:, 1] * 4).astype(int)
        keep = (px >= 0) & (px < bh) & (py >= 0) & (py < bw)
        masks[1, px[keep], py[keep]] = 255

        # synthetic rgb: gradient + route-direction cue + noise
        rgb = np.zeros((h, w, 3), np.uint8)
        rgb[..., 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
        rgb[..., 1] = int(127 + 100 * math.sin(self._ego.yaw))
        rgb[..., 2] = self._rng.randint(0, 50, (h, w), dtype=np.uint8)

        # synthetic semantic lidar: ground-plane rings + "wall" at route edges
        n = self._lidar_points
        ang = self._rng.uniform(-np.pi, np.pi, n)
        r = self._rng.uniform(2, 40, n)
        ground = np.stack(
            [r * np.cos(ang), r * np.sin(ang), np.full(n, -2.0)], -1
        ).astype(np.float32)
        tags = np.full(n, 7, np.uint8)  # road

        speed = np.array([self._ego.speed], np.float32)
        depth_sem = np.zeros((h, w, 4), np.uint8)
        return {
            "hero": {
                "central_rgb": {"data": rgb},
                "depth_semantic": {"data": depth_sem},
                "gnss": {
                    "gnss": np.zeros(3), "target_gps": np.zeros(3),
                    "imu": np.zeros(7), "command": np.array([4]),
                    "target_gps_next": np.zeros(3),
                    "command_next": np.array([4]),
                },
                "speed": {"forward_speed": speed,
                          "speed_xy": speed},
                "control": {
                    "throttle": np.array([0.0]),
                    "steer": np.array([self._ego.steer]),
                    "brake": np.array([0.0]),
                    "gear": np.array([1.0]),
                    "speed_limit": np.array([8.33]),
                },
                "velocity": {
                    "vel_xy": np.array([
                        self._ego.speed * math.cos(self._ego.yaw),
                        self._ego.speed * math.sin(self._ego.yaw),
                    ], np.float32),
                    "acc_xy": np.zeros(2, np.float32),
                    "vel_ang_z": np.zeros(1, np.float32),
                },
                "route_plan": None,
                "birdview": {"masks": masks,
                             "rendered": np.moveaxis(masks[:3], 0, -1)},
                "lidar_points_semantic": {
                    "data": {
                        "points_xyz": ground,
                        "ObjTag": tags,
                        "ObjIdx": np.zeros(n, np.uint32),
                        "CosAngle": np.ones(n, np.float32),
                    }
                },
            }
        }

    # ------------------------------------------------------------------
    @property
    def timestamp(self):
        return None if self._timestamp is None else dict(self._timestamp)

    def reset(self) -> Dict:
        self._ego = KinematicEgo()
        self._route = self._make_route()
        self.reward_handler.reset()
        self.terminal_handler.reset()
        self._timestamp = {"step": 0, "frame": 0,
                           "relative_simulation_time": 0.0}
        return self._observation()

    def step(self, control_dict: Dict):
        control = control_dict["hero"]
        throttle = control["throttle"] if isinstance(control, dict) \
            else control.throttle
        steer = control["steer"] if isinstance(control, dict) else control.steer
        brake = control["brake"] if isinstance(control, dict) else control.brake
        self._ego.step(throttle, steer, brake)

        self._timestamp["step"] += 1
        self._timestamp["frame"] += 1
        self._timestamp["relative_simulation_time"] += 1.0 / CARLA_FPS

        idx, lateral, heading_err, _ = self._route_tracking()

        reward_input = RewardInput(
            speed=self._ego.speed, steer=self._ego.steer,
            lateral_distance=lateral, heading_error_rad=heading_err,
        )
        terminal_input = TerminalInput(
            speed=self._ego.speed, is_free_road=True,
            lateral_distance=lateral,
            timeout=self._timestamp["step"] >= self._episode_steps,
        )
        done, terminal_reward, terminal_debug = self.terminal_handler(
            terminal_input
        )
        reward, reward_debug = self.reward_handler(reward_input,
                                                   terminal_reward)
        obs = self._observation()
        info = {
            "hero": {
                "reward_debug": reward_debug,
                "terminal_debug": terminal_debug,
                "episode_stat": {
                    "score_route": idx / len(self._route),
                    "length": self._timestamp["step"],
                } if done else None,
            }
        }
        return obs, {"hero": reward}, {"hero": done}, info

    def close(self):
        pass
