"""Closed-loop evaluation entry point of the port (counterpart of the root
evaluate.py): drive the world model in CARLA.

Each invocation handles ONE suite env (index in
port_<port>_eval_checkpoint.txt), runs every task (route x weather) once
with the MuvoAgent, records the leaderboard episode statistics (route
completion, infractions, driving score), and exits 1 while suites remain:
the same restart contract as data_collect.

    python -m muvo_tpu_torch.evaluate --ckpt <run dir>/checkpoints \\
        --config-file muvo_tpu_torch/configs/muvo.yml [--test-suites lb_test]

``--ckpt`` is a port checkpoint directory (its latest step) or a weights
file: an upstream MUVO Lightning ``.ckpt``, or a ``.pt`` / ``.pth``.
``main`` needs a running CARLA server and the carla package;
``build_agent`` and ``run_episode`` drive any env with the
CarlaMultiAgentEnv contract, the CARLA-free
``sim.kinematic_env.KinematicDrivingEnv`` too. The agent runs on the GPU
unless ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace
from typing import List, Optional

from muvo_tpu_torch.data_collect import load_obs_configs, load_test_suites

INIT_SEED = 42  # the trainer's init_state seed: weights without a checkpoint


def build_agent(cfg, ckpt: str, is_dreaming: bool, device=None):
    """A MuvoAgent on ``cfg``'s model: weights from ``ckpt`` (a checkpoint
    directory, or a ``.ckpt`` / ``.pt`` / ``.pth`` file, through
    ``training.checkpoint.restore_pretrained``), else drawn from
    muvo_tpu's initialisers with INIT_SEED (models/init.py)."""
    from muvo_tpu_torch.agents.muvo_agent import MuvoAgent
    from muvo_tpu_torch.models import init
    from muvo_tpu_torch.models.world_model import MuvoWorldModel
    from muvo_tpu_torch.training.checkpoint import restore_pretrained

    model = init.build(lambda: MuvoWorldModel(cfg), INIT_SEED)
    restore_pretrained(ckpt, SimpleNamespace(model=model, step=0),
                       with_optimizer=False)
    return MuvoAgent(cfg, model, is_dreaming=is_dreaming, device=device)


def run_episode(env, agent, max_steps: int):
    obs = env.reset()
    ev_id = list(obs.keys())[0]
    agent.reset()
    for _ in range(max_steps):
        control = agent.run_step(obs[ev_id], env.timestamp)
        obs, reward, done, info = env.step({ev_id: control})
        if done[ev_id]:
            return info[ev_id].get("episode_stat", {}), \
                info[ev_id].get("episode_event", {})
    return {}, {}


def main(argv: Optional[List[str]] = None, device=None):
    from muvo_tpu_torch.config import get_cfg, get_parser

    ap = get_parser()
    ap.add_argument("--test-suites", default="lb_test")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=2000)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--max-steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--work-dir", default=".")
    ap.add_argument("--dreaming", action="store_true",
                    help="drive from imagination between observation strides")
    args = ap.parse_args(argv)
    cfg = get_cfg(args)

    from muvo_tpu_torch.sim.envs import gym_id, register_envs

    register_envs()
    import gymnasium as gym

    test_suites = load_test_suites(args.test_suites)
    obs_configs = load_obs_configs()
    reward_configs = {
        "hero": {"entry_point": "muvo_tpu_torch.sim.reward:ValeoActionReward"}
    }
    terminal_configs = {
        "hero": {"entry_point": "muvo_tpu_torch.sim.reward:LeaderboardTerminal"}
    }

    # Namespaced per tool: data_collect uses port_<port>_checkpoint.txt
    # in the same work dir, and a stale collection index must not be read
    # as evaluation progress (or vice versa).
    ckpt_file = os.path.join(args.work_dir,
                             f"port_{args.port}_eval_checkpoint.txt")
    env_idx = 0
    if os.path.isfile(ckpt_file):
        with open(ckpt_file) as f:
            env_idx = int(f.read().strip() or 0)
    if env_idx >= len(test_suites):
        print("Evaluation finished for all suite envs")
        return 0

    suite = test_suites[env_idx]
    env_cfg = dict(suite["env_configs"])
    carla_map = env_cfg.pop("carla_map")
    env = gym.make(
        gym_id(suite["env_id"]), obs_configs=obs_configs,
        reward_configs=reward_configs, terminal_configs=terminal_configs,
        carla_map=carla_map, host=args.host, port=args.port,
        seed=args.seed, no_rendering=False, **env_cfg,
    ).unwrapped

    agent = build_agent(cfg, args.ckpt, args.dreaming, device)

    results = []
    for task_idx in range(env.num_tasks):
        env.set_task_idx(task_idx)
        ep_stat, ep_event = run_episode(env, agent, args.max_steps)
        record = {"suite": env_idx, "task": task_idx,
                  "map": carla_map, **ep_stat}
        results.append(record)
        print(json.dumps(record, default=float))
    out_file = os.path.join(args.work_dir,
                            f"port_{args.port}_eval_{env_idx}.json")
    with open(out_file, "w") as f:
        json.dump(results, f, indent=2, default=float)
    env.close()

    with open(ckpt_file, "w") as f:
        f.write(str(env_idx + 1))
    if env_idx + 1 < len(test_suites):
        print(f"Suite env {env_idx} done — exiting 1 for the restart loop")
        sys.exit(1)
    print(f"Finished all {len(test_suites)} suite envs")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
