"""PPO expert training entry point of the port (counterpart of the root
train_rl.py): the bird's-eye-view driving expert that collects the data,
trained with the port's PPO on the CARLA-free kinematic env.

    python -m muvo_tpu_torch.train_rl --env kinematic [--total-timesteps N]

Each iteration rolls the policy out for --n-steps env steps (actions
sampled from a generator seeded by --seed + 1), computes GAE, runs PPO's
epochs, and prints one JSON line; the policy's state_dict is saved to
--out at the end. ``--env carla`` trains on the port's CARLA EndlessEnv
(``--carla-map``, ``--host``, ``--port``), which needs a running CARLA
server and the carla package. It runs on the GPU unless ``main`` is given
``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from muvo_tpu_torch.device import resolve_device

INPUT_STATES = ["control", "vel_xy"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", default="kinematic",
                    choices=["kinematic", "carla"])
    ap.add_argument("--carla-map", default="Town01")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--episode-steps", type=int, default=300)
    ap.add_argument("--total-timesteps", type=int, default=20000)
    ap.add_argument("--n-steps", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--n-epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--out", default="ppo_policy.pt")
    return ap


def make_env(args):
    if args.env == "kinematic":
        from muvo_tpu_torch.sim.kinematic_env import KinematicDrivingEnv

        return KinematicDrivingEnv(seed=args.seed,
                                   episode_steps=args.episode_steps)
    from muvo_tpu_torch.sim.envs import EndlessEnv

    obs_configs = {"hero": {
        "birdview": {"module": "birdview.chauffeurnet"},
        "speed": {"module": "actor_state.speed"},
        "control": {"module": "actor_state.control"},
        "velocity": {"module": "actor_state.velocity"},
    }}
    reward_configs = {"hero": {
        "entry_point": "muvo_tpu_torch.sim.reward:ValeoActionReward"}}
    terminal_configs = {"hero": {
        "entry_point": "muvo_tpu_torch.sim.reward:ValeoTerminal"}}
    return EndlessEnv(args.carla_map, args.host, args.port, args.seed,
                      no_rendering=True, obs_configs=obs_configs,
                      reward_configs=reward_configs,
                      terminal_configs=terminal_configs)


def rollout(env, obs, policy, buffer, generator, device, state: Dict):
    """``buffer.buffer_size`` env steps of ``policy`` from ``obs``,
    sampled from ``generator``, into ``buffer``. ``state`` carries the
    last done flag, the running episode reward and the finished episodes'
    rewards across calls. Returns the last observation."""
    from muvo_tpu_torch.rl.agent import process_obs

    for _ in range(buffer.buffer_size):
        pi = process_obs(obs["hero"], INPUT_STATES, train=False)
        with torch.no_grad():
            out = policy(torch.from_numpy(pi["birdview"]).to(device),
                         torch.from_numpy(pi["state"]).to(device), generator)
        actions, values, log_probs, p1, p2 = (t.cpu().numpy() for t in out)
        acc, steer = 2 * actions[0] - 1  # Beta's [0, 1] -> [-1, 1]
        obs, reward, done, info = env.step(
            {"hero": {"throttle": max(acc, 0.0), "steer": steer,
                      "brake": max(-acc, 0.0)}})
        state["ep_reward"] += reward["hero"]
        sug = info["hero"]["terminal_debug"].get("exploration_suggest",
                                                 {"acc": 0, "steer": 0})
        buffer.add({"birdview": pi["birdview"], "state": pi["state"]},
                   actions, np.array([reward["hero"]]),
                   np.array([state["last_done"]]), values, log_probs, p1, p2,
                   np.array([sug["acc"]]), np.array([sug["steer"]]))
        state["last_done"] = float(done["hero"])
        if done["hero"]:
            state["episodes"].append(state["ep_reward"])
            state["ep_reward"] = 0.0
            obs = env.reset()
    return obs


def main(argv: Optional[List[str]] = None, device=None) -> List[Dict]:
    """Trains, saves the policy and returns each iteration's summary."""
    from muvo_tpu_torch.models import init
    from muvo_tpu_torch.rl.agent import process_obs
    from muvo_tpu_torch.rl.policy import PpoPolicy
    from muvo_tpu_torch.rl.ppo import PPO, RolloutBuffer

    args = parser().parse_args(argv)
    device = resolve_device(device)
    env = make_env(args)
    obs = env.reset()
    pi = process_obs(obs["hero"], INPUT_STATES, train=False)
    bv_shape, st_shape = pi["birdview"].shape[1:], pi["state"].shape[1:]
    policy = init.build(lambda: PpoPolicy(birdview_shape=bv_shape,
                                          state_dim=st_shape[0]),
                        args.seed, device)
    ppo = PPO(policy, learning_rate=args.lr, batch_size=args.batch_size,
              n_epochs=args.n_epochs)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    state = {"last_done": 0.0, "ep_reward": 0.0, "episodes": []}
    num_timesteps, summaries = 0, []
    while num_timesteps < args.total_timesteps:
        buffer = RolloutBuffer(args.n_steps,
                               {"birdview": bv_shape, "state": st_shape})
        t0 = time.perf_counter()
        obs = rollout(env, obs, policy, buffer, generator, device, state)
        rollout_s = time.perf_counter() - t0
        num_timesteps += args.n_steps
        pi = process_obs(obs["hero"], INPUT_STATES, train=False)
        with torch.no_grad():
            last_values = policy.forward_value(
                torch.from_numpy(pi["birdview"]).to(device),
                torch.from_numpy(pi["state"]).to(device)).cpu().numpy()
        buffer.compute_returns_and_advantage(
            last_values, np.array([state["last_done"]]))
        t0 = time.perf_counter()
        summary = ppo.train(buffer)
        summary.update({
            "timesteps": num_timesteps,
            "rollout_fps": args.n_steps / rollout_s,
            "train_s": time.perf_counter() - t0,
            "mean_ep_reward": (float(np.mean(state["episodes"][-10:]))
                               if state["episodes"] else 0.0)})
        print(json.dumps({k: round(float(v), 4) for k, v in summary.items()}),
              flush=True)
        summaries.append(summary)
    torch.save(policy.state_dict(), args.out)
    print(f"saved the policy's state_dict to {args.out}")
    return summaries


if __name__ == "__main__":
    main()
