"""The port's own sim/ copies against muvo_tpu's: the cases of
tests/test_sim.py (reward, terminal, hazards, route planner),
tests/test_birdview.py (the birdview renderer) and tests/test_obs_route.py
(the route observation manager), each run on both packages' functions and
held equal, exactly; and data/dataset_utils.preprocess_measurements on
seeded inputs, NaN compasses and negative route commands included, equal
to muvo_tpu's. Everything here is numpy; nothing needs CARLA.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from muvo_tpu.data import dataset_utils as jax_utils
from muvo_tpu_torch.data import dataset_utils as port_utils

MODULES = ("sim.hazard", "sim.reward", "sim.route_planner", "sim.birdview",
           "sim.obs_managers.actor_state.route", "data.dataset_utils")


def _package(root):
    """The modules of ``root`` ("muvo_tpu" or "muvo_tpu_torch") that the
    cases call, as attributes named after their last part."""
    return SimpleNamespace(**{
        name.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{name}")
        for name in MODULES})


PORT, JAX = _package("muvo_tpu_torch"), _package("muvo_tpu")


# ---- tests/test_sim.py ---------------------------------------------------
def desired_speed(m):
    f = m.reward.desired_speed_from_hazard
    return [f(None, 8.0), f(np.array([8.0, 0.0]), 8.0),
            f(np.array([10.5, 0.0]), 8.0)]


def reward_free_road(m):
    return m.reward.ValeoActionReward()(m.reward.RewardInput(speed=6.0,
                                                             steer=0.0))


def reward_red_light(m):
    return m.reward.ValeoActionReward()(m.reward.RewardInput(
        speed=6.0, steer=0.0, light_state=m.reward.LIGHT_RED,
        light_loc=np.array([5.0, 0.0])))


def reward_oscillation(m):
    r = m.reward.ValeoActionReward()
    return [r(m.reward.RewardInput(speed=6.0, steer=0.0)),
            r(m.reward.RewardInput(speed=6.0, steer=0.5))]


def terminal_stuck(m):
    t = m.reward.ValeoTerminal(stuck_steps=5)
    return [t(m.reward.TerminalInput(speed=0.0, is_free_road=True,
                                     lateral_distance=0.0))
            for _ in range(8)]


def terminal_collision(m):
    return m.reward.ValeoTerminal()(m.reward.TerminalInput(
        speed=5.0, is_free_road=False, lateral_distance=0.0, collision=True))


def terminal_lateral(m):
    t = m.reward.ValeoTerminal()
    return [t(m.reward.TerminalInput(speed=5.0, is_free_road=False,
                                     lateral_distance=d)) for d in (3.6, 3.8)]


def hazard_vehicle(m):
    obs = {"binary_mask": [1, 1],
           "location": [np.array([20.0, 0.0, 0.0]),
                        np.array([5.0, 1.0, 0.0])],
           "rotation": [np.array([0.0, 0.0, 10.0]),
                        np.array([0.0, 0.0, 20.0])]}
    near = m.hazard.lbc_hazard_vehicle(obs)
    obs["rotation"][1][2] = 180.0  # oncoming: ignored
    obs["binary_mask"] = [0, 1]
    return [near, m.hazard.lbc_hazard_vehicle(obs)]


def hazard_walker(m):
    obs = {"binary_mask": [1], "location": [np.array([4.0, 0.0, 0.0])],
           "on_sidewalk": [1]}
    on_sidewalk = m.hazard.lbc_hazard_walker(obs)
    obs["on_sidewalk"] = [0]
    return [on_sidewalk, m.hazard.lbc_hazard_walker(obs)]


def _segments(m):
    """A T junction: straight road A->B->C plus a turn B->D."""
    seg = m.route_planner.RoadSegment

    def straight(x0, x1, y):
        return [(float(x), float(y), 0.0) for x in range(x0, x1 + 1)]

    return [
        seg(entry=(0, 0, 0), exit=(10, 0, 0), path=straight(0, 10, 0)),
        seg(entry=(10, 0, 0), exit=(20, 0, 0), path=straight(10, 20, 0),
            intersection=True),
        seg(entry=(10, 0, 0), exit=(10, 10, 0),
            path=[(10, float(y), 0.0) for y in range(0, 11)],
            intersection=True),
        seg(entry=(10, 10, 0), exit=(10, 20, 0),
            path=[(10, float(y), 0.0) for y in range(10, 21)]),
    ]


def _route(route):
    return [(np.asarray(loc, float), int(option)) for loc, option in route]


def route_straight(m):
    planner = m.route_planner.GlobalRoutePlanner(_segments(m))
    return _route(planner.trace_route((0, 0, 0), (20, 0, 0)))


def route_turn(m):
    planner = m.route_planner.GlobalRoutePlanner(_segments(m))
    return _route(planner.trace_route((0, 0, 0), (10, 20, 0)))


def route_downsample(m):
    route = [((float(i), 0.0, 0.0), m.route_planner.RoadOption.LANEFOLLOW)
             for i in range(100)]
    return m.route_planner.downsample_route(route, sample_factor=10)


# ---- tests/test_birdview.py ----------------------------------------------
def _static_map(m):
    road = np.zeros((400, 400), np.uint8)
    road[180:220, :] = 255  # a road band through y ~ [36, 44] m
    lanes = np.zeros_like(road)
    lanes[199:201, :] = 255
    return m.birdview.StaticMap(road=road, lane_marking=lanes,
                                pixels_per_meter=5.0, world_offset=(0.0, 0.0))


def render_ego_up(m):
    r = m.birdview.BirdviewRenderer(_static_map(m), width_px=192,
                                    pixels_per_meter=5.0)
    return r.render(ev_x=40.0, ev_y=40.0, ev_yaw_deg=0.0,
                    vehicles=[m.birdview.ActorBox(45.0, 40.0, 0.0, 2.4, 1.0)],
                    walkers=[], route_xy=np.array([[40.0, 40.0],
                                                   [60.0, 40.0]]))


def render_into_collection(m):
    r = m.birdview.BirdviewRenderer(_static_map(m), width_px=192)
    out = r.render(40.0, 40.0, 0.0, [], [], np.zeros((0, 2)))
    return m.dataset_utils.preprocess_birdview_and_routemap(out["masks"])


def render_history_queue(m):
    r = m.birdview.BirdviewRenderer(_static_map(m), width_px=64)
    outs = [r.render(40.0 + i, 40.0, 0.0,
                     [m.birdview.ActorBox(50.0, 40.0, 0.0, 2.0, 1.0)], [],
                     np.zeros((0, 2))) for i in range(25)]
    return [len(r._history_queue), outs[-1]]


def render_history_spacing(m):
    r = m.birdview.BirdviewRenderer(_static_map(m), width_px=96,
                                    history_idx=[-16, -11, -6, -1])
    box = m.birdview.ActorBox(50.0, 40.0, 0.0, 2.0, 1.0)
    first = [r.render(40.0, 40.0, 0.0, [box] if i < 4 else [], [],
                      np.zeros((0, 2))) for i in range(20)][-1]
    r.reset()
    second = [r.render(40.0, 40.0, 0.0, [box] if i == 3 else [], [],
                       np.zeros((0, 2))) for i in range(19)][-1]
    return [first, second]


def render_history_filling(m):
    r = m.birdview.BirdviewRenderer(_static_map(m), width_px=96)
    return r.render(40.0, 40.0, 0.0,
                    [m.birdview.ActorBox(50.0, 40.0, 0.0, 2.0, 1.0)], [],
                    np.zeros((0, 2)))


# ---- tests/test_obs_route.py ---------------------------------------------
class _Loc:
    def __init__(self, x, y, z=0.0):
        self.x, self.y, self.z = x, y, z


class _Vehicle:
    def __init__(self, x, y, yaw):
        self._tf = SimpleNamespace(location=_Loc(x, y),
                                   rotation=SimpleNamespace(yaw=yaw))

    def get_transform(self):
        return self._tf


class _Parent:
    def __init__(self, x, y, yaw, route_xy, idx=0, length=100.0,
                 completed=0.0):
        self.vehicle = _Vehicle(x, y, yaw)
        self._route = [(np.array([wx, wy, 0.0]), None) for wx, wy in route_xy]
        self._route_idx = idx
        self.route_length = length
        self.route_completed = completed


STRAIGHT = [(float(i), 0.0) for i in range(10)]
ROUTE_CASES = {
    "on_route": (0.0, 0.0, 0.0, STRAIGHT, 0),
    "lateral_offset": (0.0, 1.2, 0.0, STRAIGHT, 0),
    "lateral_clip": (0.0, 7.0, 0.0, STRAIGHT, 0),
    "angle_wraps": (0.0, 0.0, 350.0, STRAIGHT, 0),
    "locs_clamp_at_end": (0.0, 0.0, 0.0, [(0.0, 0.0), (1.0, 0.0)], 0),
    "idx_consumes_plan": (3.0, 0.0, 0.0, STRAIGHT, 3),
    "ego_frame_rotation": (0.0, 0.0, 90.0,
                           [(0.0, float(i)) for i in range(10)], 0),
    "empty_route": (0.0, 0.0, 0.0, [], 0),
}


def _route_obs(name):
    x, y, yaw, route, idx = ROUTE_CASES[name]

    def case(m):
        om = m.route.ObsManager({})
        om.attach_ego_vehicle(_Parent(x, y, yaw, route, idx=idx))
        return om.get_observation()
    return case


CASES = {f.__name__: f for f in (
    desired_speed, reward_free_road, reward_red_light, reward_oscillation,
    terminal_stuck, terminal_collision, terminal_lateral, hazard_vehicle,
    hazard_walker, route_straight, route_turn, route_downsample,
    render_ego_up, render_into_collection, render_history_queue,
    render_history_spacing, render_history_filling)}
CASES.update({f"route_obs_{name}": _route_obs(name) for name in ROUTE_CASES})


def assert_equal_trees(got, want, path="out"):
    """Equal structure, types and values (numpy arrays: dtype and bits;
    NaN equal to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_equal_trees(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_trees(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want), (path, got, want)
        assert got == want or (got != got and want != want), (path, got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sim_case_equals_muvo_tpu(name):
    got, want = CASES[name](PORT), CASES[name](JAX)
    assert_equal_trees(got, want)


def test_route_case_passes_muvo_tpus_assertions():
    """One case's numbers as tests/test_sim.py and test_obs_route.py state
    them, on the port: the equality above then carries every case."""
    options = [opt for _, opt in route_turn(PORT)]
    assert any(o in (1, 2) for o in options)  # LEFT or RIGHT at the junction
    obs = _route_obs("lateral_offset")(PORT)
    np.testing.assert_allclose(obs["lateral_dist"], [1.2], atol=1e-6)


def _measurement_inputs(seed):
    rs = np.random.RandomState(seed)
    command = rs.randint(-1, 7, size=rs.choice([1, 2]))
    ego = np.array([rs.uniform(-1e-3, 1e-3), rs.uniform(-1e-3, 1e-3),
                    rs.uniform(0, 5)])
    target = ego + np.array([rs.uniform(-4e-4, 4e-4),
                             rs.uniform(-4e-4, 4e-4), 0.0])
    imu = rs.uniform(-np.pi, np.pi, 7)
    if seed % 3 == 0:
        imu[-1] = np.nan  # the compass before the IMU's first reading
    return command, ego, target, imu


@pytest.mark.parametrize("seed", range(6))
def test_preprocess_measurements_equals_muvo_tpu(seed):
    inputs = _measurement_inputs(seed)
    got = port_utils.preprocess_measurements(*inputs)
    want = jax_utils.preprocess_measurements(*inputs)
    assert_equal_trees(got, want)


def test_preprocess_measurements_remaps_negative_commands():
    """A negative (VOID) command becomes LANEFOLLOW (4), then 0-based;
    a NaN compass reads as 0, so the target straight north of the ego
    lies ahead; the caller's command array is not changed."""
    command = np.array([-1])
    ego = np.zeros(3)
    target = np.array([-1e-4, 0.0, 0.0])  # north: latitude up
    imu = np.full(7, np.nan)
    route, gps = port_utils.preprocess_measurements(command, ego, target, imu)
    assert route == 3 and route.dtype == np.int64
    assert gps.dtype == np.float32 and command[0] == -1
    want = jax_utils.preprocess_measurements(command, ego, target, imu)
    assert_equal_trees((route, gps), want)
