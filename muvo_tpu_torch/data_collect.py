"""Data-collection entry point of the port (counterpart of the root
data_collect.py): drive the PPO expert, record episodes.

Each invocation handles ONE test-suite env (index read from
port_<port>_checkpoint.txt), collects n_episodes / len(test_suites)
episodes into the dataset (retrying invalid episodes), then advances the
checkpoint and exits with code 1 while suites remain. Pair it with a
bash until-loop (reference data_collect.py:292-297):

    until python -m muvo_tpu_torch.data_collect --dataset-root ... ; do sleep 5; done

Observation suite = the PPO expert's obs (birdview/speed/control/velocity,
reference config/agent/ppo/obs_configs/birdview.yaml) merged with the
camera_lidar_semantic writer suite (reference
config/agent/my/obs_configs/camera_lidar_semantic.yaml), expert keys
winning, the same merge as reference data_collect.py:100-121.

``main`` needs a running CARLA server and the carla package; ``run_episode``
drives any env with the CarlaMultiAgentEnv contract, the CARLA-free
``sim.kinematic_env.KinematicDrivingEnv`` too. The expert runs on the GPU
unless ``main`` is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import List, Optional

import numpy as np
import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "collect")


def load_obs_configs(ev_id: str = "hero"):
    with open(os.path.join(CONFIG_DIR, "obs_ppo_expert.yml")) as f:
        expert = yaml.safe_load(f)
    with open(os.path.join(CONFIG_DIR,
                           "obs_camera_lidar_semantic.yml")) as f:
        writer = yaml.safe_load(f)
    merged = dict(expert)
    for k, v in writer.items():
        merged.setdefault(k, v)
    return {ev_id: merged}


def load_test_suites(name_or_path: str):
    path = name_or_path
    if not os.path.isfile(path):
        path = os.path.join(CONFIG_DIR, "test_suites", f"{name_or_path}.yml")
    with open(path) as f:
        return yaml.safe_load(f)


def load_expert(path: str, device=None):
    """The PPO expert of ``path``: the policy's state_dict that
    ``python -m muvo_tpu_torch.train_rl --out`` saves, or a pickle of
    muvo_tpu's PpoPolicy params (``.pkl``, root train_rl.py's --out),
    converted by ``weights.ppo_state_dict_from_jax``."""
    import torch

    from muvo_tpu_torch.rl.agent import RlBirdviewAgent
    from muvo_tpu_torch.rl.policy import PpoPolicy

    policy = PpoPolicy()
    if path.endswith(".pkl"):
        import pickle

        from muvo_tpu_torch.weights import ppo_state_dict_from_jax

        with open(path, "rb") as f:
            state = ppo_state_dict_from_jax(pickle.load(f), policy)
    else:
        state = torch.load(path, map_location="cpu")
    policy.load_state_dict(state)
    return RlBirdviewAgent(policy, device=device)


def run_episode(env, expert, data_writer, max_steps):
    obs = env.reset()
    ev_id = list(obs.keys())[0]
    expert.reset("")
    total_reward = 0.0
    for _ in range(max_steps):
        control = expert.run_step(obs[ev_id], env.timestamp)
        obs, reward, done, info = env.step({ev_id: control})
        data_writer.write(
            env.timestamp, obs, {ev_id: expert.supervision_dict}, reward
        )
        total_reward += reward[ev_id]
        if done[ev_id]:
            valid = data_writer.close(
                info[ev_id]["terminal_debug"], remove_final_steps=True
            )
            return valid, info[ev_id].get("episode_stat", {}), total_reward
    valid = data_writer.close(
        {"traffic_rule_violated": False, "blocked": False,
         "route_deviation": False},
        remove_final_steps=False,
    )
    return valid, {}, total_reward


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset-root", required=True)
    ap.add_argument("--test-suites", default="lb_data",
                    help="suite name under configs/collect/test_suites or a path")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=2000)
    ap.add_argument("--n-episodes", type=int, default=25,
                    help="total across all suite envs")
    ap.add_argument("--max-steps", type=int, default=3000)
    ap.add_argument("--policy-ckpt", default="")
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--work-dir", default=".")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore an existing checkpoint file")
    return ap


def main(argv: Optional[List[str]] = None, device=None):
    args = parser().parse_args(argv)

    from muvo_tpu_torch.rl.agent import RlBirdviewAgent
    from muvo_tpu_torch.sim.data_writer import DataWriter
    from muvo_tpu_torch.sim.envs import gym_id, register_envs

    register_envs()
    import gymnasium as gym

    test_suites = load_test_suites(args.test_suites)
    obs_configs = load_obs_configs()
    reward_configs = {
        "hero": {"entry_point": "muvo_tpu_torch.sim.reward:ValeoActionReward"}
    }
    terminal_configs = {
        "hero": {"entry_point": "muvo_tpu_torch.sim.reward:ValeoTerminal"}
    }

    # crash-recovery checkpoint: env (suite) index (reference :126-135)
    ckpt_file = os.path.join(args.work_dir,
                             f"port_{args.port}_checkpoint.txt")
    env_idx = 0
    if not args.no_resume and os.path.isfile(ckpt_file):
        with open(ckpt_file) as f:
            env_idx = int(f.read().strip() or 0)
        print(f"Resuming collection at suite env {env_idx}")
    if env_idx >= len(test_suites):
        print(f"Finished! env_idx {env_idx} >= {len(test_suites)} suites")
        return 0

    # per-env episode stats buffer resumes the task index (reference :136-143)
    stat_file = os.path.join(
        args.work_dir, f"port_{args.port}_ep_stat_buffer_{env_idx}.json")
    if not args.no_resume and os.path.isfile(stat_file):
        with open(stat_file) as f:
            ep_stat_buffer = json.load(f)
        task_idx0 = len(ep_stat_buffer["hero"])
    else:
        ep_stat_buffer = {"hero": []}
        task_idx0 = 0

    suite = test_suites[env_idx]
    env_cfg = dict(suite["env_configs"])
    carla_map = env_cfg.pop("carla_map")
    env = gym.make(
        gym_id(suite["env_id"]), obs_configs=obs_configs,
        reward_configs=reward_configs, terminal_configs=terminal_configs,
        carla_map=carla_map, host=args.host, port=args.port,
        seed=args.seed, no_rendering=False, **env_cfg,
    ).unwrapped

    expert = (load_expert(args.policy_ckpt, device) if args.policy_ckpt
              else RlBirdviewAgent(device=device))

    n_per_env = math.ceil(args.n_episodes / len(test_suites))
    dataset_dir = os.path.join(args.dataset_root, "trainval", "train",
                               carla_map)
    save_birdview_label = "birdview_label" in obs_configs["hero"]

    for task_idx in range(task_idx0, n_per_env):
        idx_episode = task_idx + n_per_env * env_idx
        run_name = f"{idx_episode:04d}"
        # retry until a valid (untrimmed-to-nothing) episode lands
        while True:
            env.set_task_idx(np.random.choice(env.num_tasks))
            run_info = {
                "is_expert": True,
                "weather": env.task["weather"],
                "town": carla_map,
                "n_vehicles": env.task["num_zombie_vehicles"],
                "n_walkers": env.task["num_zombie_walkers"],
                "route_id": env.task.get("route_id", 0),
                "env_id": suite["env_id"],
            }
            writer = DataWriter(os.path.join(dataset_dir, run_name), "hero",
                                run_info=run_info,
                                save_birdview_label=save_birdview_label)
            valid, ep_stat, total_reward = run_episode(
                env, expert, writer, args.max_steps)
            if valid:
                break
            print(f"episode {run_name} invalid, retrying")
        ep_stat_buffer["hero"].append(
            {"episode": idx_episode, "reward": total_reward, **ep_stat})
        print(json.dumps(ep_stat_buffer["hero"][-1], default=float))
        with open(stat_file, "w") as f:
            json.dump(ep_stat_buffer, f, indent=2, default=float)

    env.close()

    with open(ckpt_file, "w") as f:
        f.write(str(env_idx + 1))
    if env_idx + 1 < len(test_suites):
        print(f"Suite env {env_idx} done, {env_idx + 1}/{len(test_suites)} — "
              "exiting 1 for the restart loop")
        sys.exit(1)
    print(f"Finished all {len(test_suites)} suite envs")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
