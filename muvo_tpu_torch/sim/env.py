"""CARLA gym environment core (host-side; CARLA optional).

Counterpart of reference carla_gym/carla_multi_agent_env.py: a gymnasium.Env
that owns the CARLA client connection, runs the synchronous 10 FPS stepping
loop, and orchestrates the pluggable handlers (ego vehicles, observation
managers, scenario actors, background traffic). The obs-manager plug-in
registry resolves dotted module paths exactly like the reference
(carla_gym/core/obs_manager/obs_manager_handler.py:45-50).

CARLA itself is imported lazily: constructing the env without the carla
package raises a clear error, while the registry/config machinery stays
importable for tests and tooling.
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List, Optional

import numpy as np

try:
    import gymnasium as gym
except ImportError:  # pragma: no cover
    import gym  # type: ignore

from muvo_tpu_torch.constants import CARLA_FPS


def load_obs_manager(module_path: str, obs_config: Dict):
    """Resolve 'camera.rgb' -> muvo_tpu_torch.sim.obs_managers.camera.rgb.ObsManager."""
    module = importlib.import_module(
        f"muvo_tpu_torch.sim.obs_managers.{module_path}"
    )
    return module.ObsManager(obs_config)


def load_entry_point(name: str):
    """'pkg.module:ClassName' -> class (reference config_utils.py:53-57)."""
    mod_name, attr_name = name.split(":")
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr_name)


class ObsManagerHandler:
    """Per-ego dict of observation managers (reference obs_manager_handler.py)."""

    def __init__(self, obs_configs: Dict[str, Dict[str, Dict]]):
        self._obs_managers: Dict[str, Dict[str, object]] = {}
        self._obs_configs = obs_configs
        for ev_id, ev_obs_configs in obs_configs.items():
            self._obs_managers[ev_id] = {}
            for obs_id, obs_config in ev_obs_configs.items():
                self._obs_managers[ev_id][obs_id] = load_obs_manager(
                    obs_config["module"], obs_config
                )

    @property
    def observation_space(self):
        spaces = {}
        for ev_id, managers in self._obs_managers.items():
            spaces[ev_id] = gym.spaces.Dict(
                {oid: om.obs_space for oid, om in managers.items()}
            )
        return gym.spaces.Dict(spaces)

    def get_observation(self, timestamp) -> Dict:
        return {
            ev_id: {oid: om.get_observation()
                    for oid, om in managers.items()}
            for ev_id, managers in self._obs_managers.items()
        }

    def reset(self, ego_vehicles: Dict):
        for ev_id, managers in self._obs_managers.items():
            for om in managers.values():
                om.attach_ego_vehicle(ego_vehicles[ev_id])

    def clean(self):
        for managers in self._obs_managers.values():
            for om in managers.values():
                om.clean()


class CarlaMultiAgentEnv(gym.Env):
    def __init__(self, carla_map: str, host: str, port: int,
                 seed: int, no_rendering: bool,
                 obs_configs: Dict, reward_configs: Dict,
                 terminal_configs: Dict, all_tasks: List[Dict]):
        self._all_tasks = all_tasks
        self._obs_configs = obs_configs
        self._carla_map = carla_map
        self._seed = seed
        self._no_rendering = no_rendering
        self._host, self._port = host, port
        self._reward_configs = reward_configs
        self._terminal_configs = terminal_configs

        self._om_handler = ObsManagerHandler(obs_configs)
        self._ev_handler = None
        self._sa_handler = None
        self._zw_handler = None
        self._zv_handler = None

        self._world = None
        self._client = None
        self._task_idx = 0
        self._shuffle_task = True
        self._task = None
        self._timestamp = None

        self._init_client(carla_map, host, port, seed, no_rendering)
        self.name = self.__class__.__name__

    # ------------------------------------------------------------------
    @property
    def num_tasks(self):
        return len(self._all_tasks)

    @property
    def task(self):
        return self._task

    def set_task_idx(self, task_idx: int):
        self._task_idx = task_idx
        self._shuffle_task = False
        self._task = self._all_tasks[task_idx].copy()

    @property
    def timestamp(self):
        return None if self._timestamp is None else self._timestamp.copy()

    @property
    def observation_space(self):
        return self._om_handler.observation_space

    # ------------------------------------------------------------------
    def _init_client(self, carla_map, host, port, seed, no_rendering,
                     retries: int = 6):
        try:
            import carla
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "CarlaMultiAgentEnv requires the carla package; the training "
                "and evaluation paths of muvo_tpu do not."
            ) from e

        client = None
        for attempt in range(retries):
            try:
                client = carla.Client(host, port)
                client.set_timeout(60.0)
                break
            except RuntimeError:
                time.sleep(5.0)
        assert client is not None, f"cannot connect to carla {host}:{port}"
        self._client = client
        self._world = client.load_world(carla_map)
        self._tm = client.get_trafficmanager(port + 6000)

        self._set_sync_mode(True)
        self._tm.set_random_device_seed(seed)
        self._world.tick()

        from muvo_tpu_torch.sim.handlers import (
            EgoVehicleHandler, ScenarioActorHandler,
            ZombieVehicleHandler, ZombieWalkerHandler,
        )

        self._ev_handler = EgoVehicleHandler(
            client, self._reward_configs, self._terminal_configs
        )
        self._sa_handler = ScenarioActorHandler(client)
        self._zv_handler = ZombieVehicleHandler(
            client, tm_port=self._tm.get_port()
        )
        self._zw_handler = ZombieWalkerHandler(client)

    def _set_sync_mode(self, sync: bool):
        import carla

        settings = self._world.get_settings()
        settings.synchronous_mode = sync
        settings.fixed_delta_seconds = 1.0 / CARLA_FPS
        settings.deterministic_ragdolls = True
        settings.no_rendering_mode = self._no_rendering
        self._world.apply_settings(settings)
        self._tm.set_synchronous_mode(sync)

    # ------------------------------------------------------------------
    def reset(self, *, seed=None, options=None):
        if self._shuffle_task:
            self._task_idx = np.random.choice(self.num_tasks)
            self._task = self._all_tasks[self._task_idx].copy()
        self.clean()

        self._wt_handler_reset()
        ev_spawn_locations = self._ev_handler.reset(
            self._task["ego_vehicles"]
        )
        self._sa_handler.reset(
            self._task.get("scenario_actors", {}), self._ev_handler.ego_vehicles
        )
        # suite configs may give [min, max] ranges (config/test_suites/
        # lb_data.yaml); sample per episode like the reference env
        def _n(v):
            return (int(np.random.randint(v[0], v[1]))
                    if isinstance(v, (list, tuple)) else int(v))

        self._zw_handler.reset(
            _n(self._task["num_zombie_walkers"]), ev_spawn_locations
        )
        self._zv_handler.reset(
            _n(self._task["num_zombie_vehicles"]), ev_spawn_locations
        )
        self._om_handler.reset(self._ev_handler.ego_vehicles)

        self._world.tick()
        snap_shot = self._world.get_snapshot()
        self._timestamp = {
            "step": 0,
            "frame": snap_shot.timestamp.frame,
            "relative_wall_time": 0.0,
            "wall_time": snap_shot.timestamp.platform_timestamp,
            "relative_simulation_time": 0.0,
            "simulation_time": snap_shot.timestamp.elapsed_seconds,
            "start_frame": snap_shot.timestamp.frame,
            "start_wall_time": snap_shot.timestamp.platform_timestamp,
            "start_simulation_time": snap_shot.timestamp.elapsed_seconds,
        }

        _, _, _ = self._ev_handler.tick(self.timestamp)
        obs_dict = self._om_handler.get_observation(self.timestamp)
        return obs_dict

    def _wt_handler_reset(self):
        from muvo_tpu_torch.sim.weather import WeatherHandler

        if not hasattr(self, "_wt_handler") or self._wt_handler is None:
            self._wt_handler = WeatherHandler(self._world)
        self._wt_handler.reset(self._task.get("weather"))

    # ------------------------------------------------------------------
    def step(self, control_dict: Dict):
        self._ev_handler.apply_control(control_dict)
        self._sa_handler.tick()
        self._world.tick()

        snap_shot = self._world.get_snapshot()
        self._timestamp["step"] = (
            snap_shot.timestamp.frame - self._timestamp["start_frame"]
        )
        self._timestamp["frame"] = snap_shot.timestamp.frame
        self._timestamp["wall_time"] = snap_shot.timestamp.platform_timestamp
        self._timestamp["relative_wall_time"] = (
            self._timestamp["wall_time"] - self._timestamp["start_wall_time"]
        )
        self._timestamp["simulation_time"] = snap_shot.timestamp.elapsed_seconds
        self._timestamp["relative_simulation_time"] = (
            self._timestamp["simulation_time"]
            - self._timestamp["start_simulation_time"]
        )

        reward_dict, done_dict, info_dict = self._ev_handler.tick(
            self.timestamp
        )
        obs_dict = self._om_handler.get_observation(self.timestamp)
        self._wt_handler.tick(1.0 / CARLA_FPS)
        return obs_dict, reward_dict, done_dict, info_dict

    # ------------------------------------------------------------------
    def clean(self):
        for handler in (self._sa_handler, self._zw_handler, self._zv_handler,
                        self._om_handler, self._ev_handler):
            if handler is not None:
                handler.clean()
        if self._world is not None:
            self._world.tick()

    def close(self):
        self.clean()
        if self._world is not None:
            self._set_sync_mode(False)
        self._client = None
        self._world = None
