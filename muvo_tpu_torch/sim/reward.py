"""Valeo-style action reward, simulator-agnostic.

Counterpart of reference carla_gym/core/task_actor/ego_vehicle/reward/
valeo_action.py: speed shaping against the minimum desired speed induced by
hazards (vehicle / pedestrian / red light / stop sign), lateral-position and
heading penalties against the route waypoint, and a steering-oscillation
penalty. The CARLA-specific state extraction is isolated in a RewardInput
so the shaping itself is a pure, testable function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

MAXIMUM_SPEED = 6.0

LIGHT_GREEN = 0
LIGHT_YELLOW = 1
LIGHT_RED = 2


@dataclass
class RewardInput:
    """Ego state for one tick, everything in the ego frame (metres, m/s)."""

    speed: float
    steer: float
    # hazard locations in ego frame, or None
    hazard_vehicle_loc: Optional[np.ndarray] = None
    hazard_ped_loc: Optional[np.ndarray] = None
    light_state: Optional[int] = None
    light_loc: Optional[np.ndarray] = None
    stop_sign_loc: Optional[np.ndarray] = None
    # route tracking
    lateral_distance: float = 0.0
    heading_error_rad: float = 0.0


def desired_speed_from_hazard(loc: Optional[np.ndarray], clearance: float,
                              maximum_speed: float = MAXIMUM_SPEED) -> float:
    if loc is None:
        return maximum_speed
    dist = max(0.0, float(np.linalg.norm(loc[0:2])) - clearance)
    return maximum_speed * float(np.clip(dist, 0.0, 5.0)) / 5.0


class ValeoActionReward:
    def __init__(self, maximum_speed: float = MAXIMUM_SPEED):
        self.maximum_speed = maximum_speed
        self._last_steer = 0.0

    def reset(self):
        self._last_steer = 0.0

    def __call__(self, inp: RewardInput,
                 terminal_reward: float = 0.0) -> Tuple[float, Dict]:
        # steering oscillation penalty
        r_action = -0.1 if abs(inp.steer - self._last_steer) > 0.01 else 0.0
        self._last_steer = inp.steer

        spd_veh = desired_speed_from_hazard(inp.hazard_vehicle_loc, 8.0,
                                            self.maximum_speed)
        spd_ped = desired_speed_from_hazard(inp.hazard_ped_loc, 6.0,
                                            self.maximum_speed)
        if inp.light_state in (LIGHT_RED, LIGHT_YELLOW) and inp.light_loc is not None:
            spd_rl = desired_speed_from_hazard(inp.light_loc, 5.0,
                                               self.maximum_speed)
        else:
            spd_rl = self.maximum_speed
        spd_stop = desired_speed_from_hazard(inp.stop_sign_loc, 5.0,
                                             self.maximum_speed)

        desired_speed = min(self.maximum_speed, spd_veh, spd_ped, spd_rl,
                            spd_stop)

        r_speed = 1.0 - abs(inp.speed - desired_speed) / self.maximum_speed
        r_position = -1.0 * (abs(inp.lateral_distance) / 2.0)
        r_rotation = -1.0 * abs(inp.heading_error_rad)

        reward = r_speed + r_position + r_rotation + terminal_reward + r_action
        debug = {
            "reward": reward,
            "reward_speed": r_speed,
            "reward_position": r_position,
            "reward_angle": r_rotation,
            "reward_oscillation": r_action,
            "desired_speed": desired_speed,
            "debug_texts": [
                f"Desired speed: {desired_speed:5.2f}m/s",
                f"Reward_terminal:{terminal_reward:5.2f}",
            ],
        }
        return reward, debug


# ---------------------------------------------------------------------------
@dataclass
class TerminalInput:
    """Per-tick state for episode termination checks."""

    speed: float
    is_free_road: bool
    lateral_distance: float
    run_red_light: bool = False
    collision: bool = False
    run_stop_sign: bool = False
    blocked: bool = False
    route_deviation: bool = False
    timeout: bool = False


class ValeoTerminal:
    """Valeo-paper termination: stuck detection, lateral-distance breach,
    infractions; emits exploration suggestions for the PPO loss.

    (reference: terminal/valeo.py)
    """

    def __init__(self, exploration_suggest: bool = True,
                 eval_mode: bool = False, stuck_steps: int = 100):
        self._exploration_suggest = exploration_suggest
        self._eval_mode = eval_mode
        self._stuck_steps = stuck_steps
        self.reset()

    def reset(self):
        self._stuck_counter = 0
        self._speed_queue = []
        self._last_lat_dist = 0.0
        self._min_thresh_lat_dist = 3.5

    def __call__(self, inp: TerminalInput) -> Tuple[bool, float, Dict]:
        self._speed_queue.append(inp.speed)
        if len(self._speed_queue) > 10:
            self._speed_queue.pop(0)
        mean_speed = float(np.mean(self._speed_queue))

        if inp.is_free_road and mean_speed < 1.0:
            self._stuck_counter += 1
        if mean_speed >= 1.0:
            self._stuck_counter = 0
        c_stuck = self._stuck_counter >= self._stuck_steps

        lat = abs(inp.lateral_distance)
        if lat - self._last_lat_dist > 0.8:
            thresh = lat + 0.5
        else:
            thresh = max(self._min_thresh_lat_dist, self._last_lat_dist)
        c_lat = lat > thresh + 1e-2
        self._last_lat_dist = lat

        infractions = (inp.run_red_light or inp.collision or inp.run_stop_sign
                       or inp.blocked)
        done = (c_stuck or c_lat or infractions or inp.route_deviation
                or inp.timeout)

        terminal_reward = 0.0
        if done and not inp.timeout:
            terminal_reward = -1.0
        if inp.run_red_light or inp.collision or inp.run_stop_sign:
            terminal_reward -= inp.speed

        # exploration suggestions: codes 0 none; acc 1 stop, 2 go;
        # steer 1 turn, 2 straight
        acc_code, steer_code = 0, 0
        if self._exploration_suggest:
            if inp.run_red_light or inp.run_stop_sign or inp.collision:
                acc_code = 1  # stop
            if c_stuck or inp.blocked:
                acc_code = 2  # go
            if c_lat or inp.route_deviation:
                steer_code = 1  # turn

        debug = {
            "traffic_rule_violated": bool(inp.run_red_light or inp.collision
                                          or inp.run_stop_sign),
            "blocked": bool(c_stuck or inp.blocked),
            "route_deviation": bool(inp.route_deviation or c_lat),
            "exploration_suggest": {"acc": acc_code, "steer": steer_code},
            "debug_texts": [],
        }
        return done, terminal_reward, debug


class ValeoNoDetPxTerminal(ValeoTerminal):
    """Valeo terminal without the detection-pixel condition — in this
    framework hazard detection feeds in through TerminalInput, so the logic
    is the Valeo terminal itself (reference: terminal/valeo_no_det_px.py
    differs only in dropping the collision-detection-pixel trigger)."""


class LeaderboardTerminal(ValeoTerminal):
    """Leaderboard-style evaluation terminal: no lateral-drift or stuck
    termination; only hard infractions and timeout end the episode
    (reference: terminal/leaderboard.py)."""

    def __call__(self, inp: TerminalInput):
        done = (inp.collision or inp.route_deviation or inp.blocked
                or inp.timeout)
        debug = {
            "traffic_rule_violated": bool(inp.collision),
            "blocked": bool(inp.blocked),
            "route_deviation": bool(inp.route_deviation),
            "exploration_suggest": {"acc": 0, "steer": 0},
            "debug_texts": [],
        }
        return done, 0.0, debug


class LeaderboardDaggerTerminal(ValeoTerminal):
    """Data-collection terminal (reference: terminal/leaderboard_dagger.py):
    like Valeo but without stuck termination (the expert may idle at lights)
    and without terminal speed penalties."""

    def __call__(self, inp: TerminalInput):
        lat = abs(inp.lateral_distance)
        if lat - self._last_lat_dist > 0.8:
            thresh = lat + 0.5
        else:
            thresh = max(self._min_thresh_lat_dist, self._last_lat_dist)
        c_lat = lat > thresh + 1e-2
        self._last_lat_dist = lat

        infractions = (inp.run_red_light or inp.collision or inp.run_stop_sign
                       or inp.blocked)
        done = c_lat or infractions or inp.route_deviation or inp.timeout
        debug = {
            "traffic_rule_violated": bool(inp.run_red_light or inp.collision
                                          or inp.run_stop_sign),
            "blocked": bool(inp.blocked),
            "route_deviation": bool(inp.route_deviation or c_lat),
            "exploration_suggest": {"acc": 0, "steer": 0},
            "debug_texts": [],
        }
        return done, 0.0, debug
