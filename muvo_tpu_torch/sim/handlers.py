"""Actor handlers: ego vehicles, scenario actors, background traffic.

Counterparts of reference carla_gym/core/task_actor/ego_vehicle/
ego_vehicle_handler.py, scenario_actor/scenario_actor_handler.py, and
carla_gym/core/zombie_{vehicle,walker}/. CARLA is imported lazily; the
reward/terminal components resolve through the same entry-point-string
mechanism as the reference and default to the simulator-agnostic
muvo_tpu_torch.sim.reward classes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from muvo_tpu_torch.sim.env import load_entry_point


class EgoVehicleHandler:
    """Spawns ego vehicles, owns per-ego reward/terminal, tracks episode
    statistics (route completion, infraction penalties)."""

    PENALTY_COLLISION_PEDESTRIAN = 0.50
    PENALTY_COLLISION_VEHICLE = 0.60
    PENALTY_COLLISION_STATIC = 0.65
    PENALTY_TRAFFIC_LIGHT = 0.70
    PENALTY_STOP = 0.80

    def __init__(self, client, reward_configs: Dict, terminal_configs: Dict):
        self._client = client
        self._world = client.get_world()
        self._reward_configs = reward_configs
        self._terminal_configs = terminal_configs
        self.ego_vehicles: Dict = {}
        self.reward_handlers: Dict = {}
        self.terminal_handlers: Dict = {}
        self.info_buffers: Dict = {}
        self.reward_buffers: Dict = {}

    def reset(self, task_config: Dict) -> List:
        from muvo_tpu_torch.sim.task_vehicle import TaskVehicle

        ev_spawn_locations = []
        for ev_id, config in task_config.items():
            vehicle = TaskVehicle.spawn(
                self._world, config, ev_id
            )
            self.ego_vehicles[ev_id] = vehicle
            ev_spawn_locations.append(vehicle.spawn_location)

            reward_cls = load_entry_point(
                self._reward_configs[ev_id]["entry_point"]
            )
            self.reward_handlers[ev_id] = reward_cls(
                vehicle, **self._reward_configs[ev_id].get("kwargs", {})
            )
            terminal_cls = load_entry_point(
                self._terminal_configs[ev_id]["entry_point"]
            )
            self.terminal_handlers[ev_id] = terminal_cls(
                vehicle, **self._terminal_configs[ev_id].get("kwargs", {})
            )
            self.info_buffers[ev_id] = {
                "collisions_layout": [], "collisions_vehicle": [],
                "collisions_pedestrian": [], "collisions_others": [],
                "red_light": [], "encounter_light": [], "stop_infraction": [],
                "encounter_stop": [], "route_dev": [], "vehicle_blocked": [],
            }
            self.reward_buffers[ev_id] = []
        return ev_spawn_locations

    def apply_control(self, control_dict: Dict):
        for ev_id, control in control_dict.items():
            self.ego_vehicles[ev_id].vehicle.apply_control(control)

    def tick(self, timestamp):
        reward_dict, done_dict, info_dict = {}, {}, {}
        for ev_id, vehicle in self.ego_vehicles.items():
            info_criteria = vehicle.tick(timestamp)
            done, terminal_reward, terminal_debug = \
                self.terminal_handlers[ev_id].get(timestamp)
            reward, reward_debug = self.reward_handlers[ev_id].get(
                terminal_reward
            )
            reward_dict[ev_id] = reward
            done_dict[ev_id] = done
            info_dict[ev_id] = {
                **info_criteria,
                "reward_debug": reward_debug,
                "terminal_debug": terminal_debug,
            }
            self.reward_buffers[ev_id].append(reward)
            self._buffer_infractions(ev_id, info_criteria, timestamp)
            if done:
                info_dict[ev_id]["episode_stat"] = self._episode_stat(
                    ev_id, vehicle, timestamp
                )
        return reward_dict, done_dict, info_dict

    def _buffer_infractions(self, ev_id, info, timestamp):
        buf = self.info_buffers[ev_id]
        collision = info.get("collision")
        if collision:
            key = {
                0: "collisions_layout", 1: "collisions_vehicle",
                2: "collisions_pedestrian",
            }.get(collision.get("collision_type"), "collisions_others")
            buf[key].append(collision)
        if info.get("run_red_light"):
            buf["red_light"].append(info["run_red_light"])
        if info.get("encounter_light"):
            buf["encounter_light"].append(info["encounter_light"])
        stop = info.get("run_stop_sign")
        if stop:
            if stop.get("event") == "run":
                buf["stop_infraction"].append(stop)
            elif stop.get("event") == "encounter":
                buf["encounter_stop"].append(stop)
        if info.get("route_deviation"):
            buf["route_dev"].append(info["route_deviation"])
        if info.get("blocked"):
            buf["vehicle_blocked"].append(info["blocked"])

    def _episode_stat(self, ev_id, vehicle, timestamp) -> Dict:
        buf = self.info_buffers[ev_id]
        route_completed = float(vehicle.route_completed)
        route_length = max(float(vehicle.route_length), 1e-3)
        score_route = min(1.0, route_completed / route_length)
        n_collisions_layout = len(buf["collisions_layout"])
        n_collisions_vehicle = len(buf["collisions_vehicle"])
        n_collisions_pedestrian = len(buf["collisions_pedestrian"])
        n_collisions_others = len(buf["collisions_others"])
        n_red_light = len(buf["red_light"])
        n_stop = len(buf["stop_infraction"])
        score_penalty = (
            self.PENALTY_COLLISION_STATIC ** n_collisions_layout
            * self.PENALTY_COLLISION_VEHICLE ** n_collisions_vehicle
            * self.PENALTY_COLLISION_PEDESTRIAN ** n_collisions_pedestrian
            * self.PENALTY_TRAFFIC_LIGHT ** n_red_light
            * self.PENALTY_STOP ** n_stop
            * self.PENALTY_COLLISION_STATIC ** n_collisions_others
        )
        return {
            "score_route": score_route,
            "score_penalty": score_penalty,
            "score_composed": score_route * score_penalty,
            "length": timestamp["step"],
            "reward": float(np.sum(self.reward_buffers[ev_id])),
            "n_collisions_layout": n_collisions_layout,
            "n_collisions_vehicle": n_collisions_vehicle,
            "n_collisions_pedestrian": n_collisions_pedestrian,
            "n_collisions_others": n_collisions_others,
            "n_red_light": n_red_light,
            "n_encounter_light": len(buf["encounter_light"]),
            "n_stop_infraction": n_stop,
            "n_encounter_stop": len(buf["encounter_stop"]),
            "n_route_dev": len(buf["route_dev"]),
            "n_vehicle_blocked": len(buf["vehicle_blocked"]),
        }

    def clean(self):
        for vehicle in self.ego_vehicles.values():
            vehicle.clean()
        self.ego_vehicles = {}
        self.reward_handlers = {}
        self.terminal_handlers = {}
        self.info_buffers = {}
        self.reward_buffers = {}


class ScenarioActorHandler:
    """Scripted scenario actors (reference scenario_actor_handler.py)."""

    def __init__(self, client):
        self._client = client
        self._world = client.get_world()
        self.scenario_actors: Dict = {}

    def reset(self, task_config: Dict, ego_vehicles: Dict):
        for sa_id, config in (task_config or {}).items():
            agent_cls = load_entry_point(config["entry_point"])
            self.scenario_actors[sa_id] = agent_cls(
                self._world, config, ego_vehicles
            )

    def tick(self):
        for actor in self.scenario_actors.values():
            actor.tick()

    def clean(self):
        for actor in self.scenario_actors.values():
            actor.clean()
        self.scenario_actors = {}


class ZombieVehicleHandler:
    """Background traffic vehicles under the traffic manager."""

    def __init__(self, client, tm_port: int, spawn_distance_to_ev: float = 10.0):
        self._client = client
        self._world = client.get_world()
        self._tm_port = tm_port
        self._spawn_distance = spawn_distance_to_ev
        self.zombie_vehicles: List = []

    def reset(self, num_zombies: int, ev_spawn_locations: List):
        import carla

        blueprints = [
            bp for bp in self._world.get_blueprint_library().filter("vehicle.*")
            if int(bp.get_attribute("number_of_wheels")) == 4
        ]
        spawn_points = list(self._world.get_map().get_spawn_points())
        np.random.shuffle(spawn_points)

        batch = []
        for sp in spawn_points:
            if len(batch) >= num_zombies:
                break
            if any(sp.location.distance(loc) < self._spawn_distance
                   for loc in ev_spawn_locations):
                continue
            bp = np.random.choice(blueprints)
            if bp.has_attribute("color"):
                color = np.random.choice(
                    bp.get_attribute("color").recommended_values
                )
                bp.set_attribute("color", color)
            bp.set_attribute("role_name", "zombie_vehicle")
            batch.append(
                carla.command.SpawnActor(bp, sp).then(
                    carla.command.SetAutopilot(
                        carla.command.FutureActor, True, self._tm_port
                    )
                )
            )
        for response in self._client.apply_batch_sync(batch, True):
            if not response.error:
                self.zombie_vehicles.append(response.actor_id)

    def clean(self):
        import carla

        self._client.apply_batch(
            [carla.command.DestroyActor(x) for x in self.zombie_vehicles]
        )
        self.zombie_vehicles = []


class ZombieWalkerHandler:
    """Background pedestrians with AI controllers."""

    def __init__(self, client):
        self._client = client
        self._world = client.get_world()
        self.zombie_walkers: List = []
        self.controllers: List = []

    def reset(self, num_zombies: int, ev_spawn_locations: List):
        import carla

        walker_bps = self._world.get_blueprint_library().filter(
            "walker.pedestrian.*"
        )
        spawn_batch = []
        for _ in range(num_zombies):
            loc = self._world.get_random_location_from_navigation()
            if loc is None:
                continue
            bp = np.random.choice(walker_bps)
            if bp.has_attribute("is_invincible"):
                bp.set_attribute("is_invincible", "false")
            transform = carla.Transform(location=loc)
            spawn_batch.append(carla.command.SpawnActor(bp, transform))

        walker_ids = []
        for response in self._client.apply_batch_sync(spawn_batch, True):
            if not response.error:
                walker_ids.append(response.actor_id)

        controller_bp = self._world.get_blueprint_library().find(
            "controller.ai.walker"
        )
        ctrl_batch = [
            carla.command.SpawnActor(controller_bp, carla.Transform(), wid)
            for wid in walker_ids
        ]
        for response in self._client.apply_batch_sync(ctrl_batch, True):
            if not response.error:
                self.controllers.append(response.actor_id)
        self.zombie_walkers = walker_ids

        self._world.tick()
        for cid in self.controllers:
            controller = self._world.get_actor(cid)
            controller.start()
            controller.go_to_location(
                self._world.get_random_location_from_navigation()
            )

    def clean(self):
        import carla

        for cid in self.controllers:
            actor = self._world.get_actor(cid)
            if actor is not None:
                actor.stop()
        self._client.apply_batch(
            [carla.command.DestroyActor(x)
             for x in self.controllers + self.zombie_walkers]
        )
        self.zombie_walkers = []
        self.controllers = []
