"""Environment suites: Endless (random spawns, no fixed route) and
Leaderboard (shipped scenario descriptions: routes.xml + actors.json per
town), plus gymnasium registration.

Counterparts of reference carla_gym/envs/suites/{endless_env,
leaderboard_env}.py, carla_gym/utils/config_utils.py:75-104 and
carla_gym/__init__.py. Route/actor descriptions live in
muvo_tpu/sim/scenario_descriptions/LeaderBoard/<Town>/ in the reference
schema; tools/generate_scenarios.py samples new ones from a live CARLA
server.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

from muvo_tpu_torch.sim.env import CarlaMultiAgentEnv

SCENARIO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "scenario_descriptions")

# reference: carla_gym/envs/suites/leaderboard_env.py:44-61 (the LeaderBoard
# groups) and endless_env.py:15-24 (the Endless groups are a subset).
WEATHER_GROUPS = {
    "new": ["SoftRainSunset", "WetSunset", "CloudyNoon", "MidRainSunset"],
    "many_weathers": ["SoftRainSunset", "WetSunset", "ClearNoon", "WetNoon",
                      "HardRainNoon", "ClearSunset"],
    "train": ["ClearNoon", "WetNoon", "HardRainNoon", "ClearSunset"],
    "simple": ["ClearNoon"],
    "train_eval": ["WetNoon", "ClearSunset"],
    "all": ["ClearNoon", "CloudyNoon", "WetNoon", "WetCloudyNoon",
            "SoftRainNoon", "MidRainyNoon", "HardRainNoon", "ClearSunset",
            "CloudySunset", "WetSunset", "WetCloudySunset", "SoftRainSunset",
            "MidRainSunset", "HardRainSunset"],
    "dynamic": ["dynamic_1.0"],
}

ENDLESS_NEW_WEATHERS = ["SoftRainSunset", "WetSunset"]  # endless_env.py:16-17


def resolve_weathers(weather_group: str, endless: bool = False) -> List[str]:
    if endless and weather_group == "new":
        return list(ENDLESS_NEW_WEATHERS)
    return list(WEATHER_GROUPS.get(weather_group, [weather_group]))


def parse_routes_file(routes_xml_path: str) -> Dict[int, Dict]:
    """Leaderboard routes XML -> {route_id: {'ego_vehicles': {id: [wp...]},
    'scenario_actors': {id: [wp...]}}} with waypoints as
    [x, y, z, pitch, yaw, roll] (carla.Transform argument order).

    (reference: carla_gym/utils/config_utils.py:75-104)
    """
    routes: Dict[int, Dict] = {}
    tree = ET.parse(routes_xml_path)
    for route in tree.iter("route"):
        route_id = int(route.attrib["id"])
        desc = {}
        for actor_type in ("ego_vehicle", "scenario_actor"):
            desc[actor_type + "s"] = {}
            for actor in route.iter(actor_type):
                waypoints = []
                for wp in actor.iter("waypoint"):
                    waypoints.append([
                        float(wp.attrib["x"]), float(wp.attrib["y"]),
                        float(wp.attrib["z"]),
                        float(wp.attrib.get("pitch", 0.0)),
                        float(wp.attrib.get("yaw", 0.0)),
                        float(wp.attrib.get("roll", 0.0)),
                    ])
                desc[actor_type + "s"][actor.attrib["id"]] = waypoints
        routes[route_id] = desc
    return routes


def scenario_folder(carla_map: str, routes_group: Optional[str] = None,
                    root: Optional[str] = None) -> str:
    """Town04 splits into Town04_{train,test} route sets; every other town
    has a single folder (reference leaderboard_env.py:56-60)."""
    root = root or SCENARIO_ROOT
    if carla_map == "Town04" and routes_group is not None:
        return os.path.join(root, "LeaderBoard", f"Town04_{routes_group}")
    return os.path.join(root, "LeaderBoard", carla_map)


class EndlessEnv(CarlaMultiAgentEnv):
    """Random spawn, no fixed route; endless driving for data collection.

    (reference: carla_gym/envs/suites/endless_env.py)
    """

    def __init__(self, carla_map, host, port, seed, no_rendering, obs_configs,
                 reward_configs, terminal_configs,
                 num_zombie_vehicles=100, num_zombie_walkers=100,
                 weather_group="dynamic"):
        all_tasks = self.build_all_tasks(
            num_zombie_vehicles, num_zombie_walkers, weather_group
        )
        super().__init__(carla_map, host, port, seed, no_rendering,
                         obs_configs, reward_configs, terminal_configs,
                         all_tasks)

    @staticmethod
    def build_all_tasks(num_zombie_vehicles, num_zombie_walkers,
                        weather_group) -> List[Dict]:
        all_tasks = []
        for weather in resolve_weathers(weather_group, endless=True):
            all_tasks.append({
                "weather": weather,
                "description_folder": "None",
                "route_id": 0,
                "ego_vehicles": {
                    "hero": {"model": "vehicle.lincoln.mkz_2017",
                             "endless": True}
                },
                "scenario_actors": {},
                "num_zombie_vehicles": num_zombie_vehicles,
                "num_zombie_walkers": num_zombie_walkers,
            })
        return all_tasks


class LeaderboardEnv(CarlaMultiAgentEnv):
    """Fixed routes from the shipped LeaderBoard scenario descriptions.

    (reference: carla_gym/envs/suites/leaderboard_env.py)
    """

    # reference leaderboard_env.py:20-42
    NUM_ZOMBIE_VEHICLES = {"Town01": 120, "Town02": 70, "Town03": 70,
                           "Town04": 150, "Town05": 120, "Town06": 120}
    NUM_ZOMBIE_WALKERS = {"Town01": 120, "Town02": 70, "Town03": 70,
                          "Town04": 80, "Town05": 120, "Town06": 80}

    def __init__(self, carla_map, host, port, seed, no_rendering, obs_configs,
                 reward_configs, terminal_configs,
                 weather_group="train", routes_group=None,
                 scenario_root: Optional[str] = None):
        all_tasks = self.build_all_tasks(carla_map, weather_group,
                                         routes_group, scenario_root)
        super().__init__(carla_map, host, port, seed, no_rendering,
                         obs_configs, reward_configs, terminal_configs,
                         all_tasks)

    @classmethod
    def build_all_tasks(cls, carla_map: str, weather_group: str,
                        routes_group: Optional[str] = None,
                        scenario_root: Optional[str] = None) -> List[Dict]:
        assert carla_map in cls.NUM_ZOMBIE_VEHICLES, f"unknown {carla_map}"
        folder = scenario_folder(carla_map, routes_group, scenario_root)
        with open(os.path.join(folder, "actors.json")) as f:
            actor_configs = json.load(f)
        routes = parse_routes_file(os.path.join(folder, "routes.xml"))

        all_tasks = []
        for weather in resolve_weathers(weather_group):
            for route_id, desc in sorted(routes.items()):
                ego_vehicles = {}
                for ev_id, waypoints in desc["ego_vehicles"].items():
                    ego_vehicles[ev_id] = {
                        **actor_configs["ego_vehicles"].get(ev_id, {}),
                        "spawn_transform": waypoints[0],
                        "targets": [wp[:3] for wp in waypoints[1:]],
                        "route_waypoints": waypoints,
                    }
                scenario_actors = {}
                if "scenario_actors" in actor_configs:
                    for sa_id, waypoints in desc["scenario_actors"].items():
                        scenario_actors[sa_id] = {
                            **actor_configs["scenario_actors"].get(sa_id, {}),
                            "route_waypoints": waypoints,
                        }
                all_tasks.append({
                    "weather": weather,
                    "description_folder": folder,
                    "route_id": route_id,
                    "ego_vehicles": ego_vehicles,
                    "scenario_actors": scenario_actors,
                    "num_zombie_vehicles": cls.NUM_ZOMBIE_VEHICLES[carla_map],
                    "num_zombie_walkers": cls.NUM_ZOMBIE_WALKERS[carla_map],
                })
        return all_tasks


NAMESPACE = "muvo_tpu_torch"


def gym_id(env_id: str) -> str:
    """A suite's env id ('Endless-v0') -> the port's registered id."""
    return f"{NAMESPACE}/{env_id}"


def register_envs():
    """Register 'muvo_tpu_torch/Endless-v0' and
    'muvo_tpu_torch/LeaderBoard-v0' with gymnasium. The port's own
    namespace leaves muvo_tpu's 'Endless-v0' and 'LeaderBoard-v0' to
    muvo_tpu in a process that imports both: gymnasium lets a second
    registration of an id replace the first. The env checker is off: it
    asks a single-agent action space of this multi-agent env, which has
    none."""
    import gymnasium as gym

    for env_id, cls in (("Endless-v0", EndlessEnv),
                        ("LeaderBoard-v0", LeaderboardEnv)):
        if gym_id(env_id) not in gym.registry:
            gym.register(id=gym_id(env_id),
                         entry_point=f"muvo_tpu_torch.sim.envs:{cls.__name__}",
                         disable_env_checker=True)
