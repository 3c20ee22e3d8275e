"""PPO (counterpart of muvo_tpu/rl/ppo.py): the clipped surrogate, value,
entropy and exploration losses, Adam after a clip of the gradients' global
norm, the target-KL early stop and the KL-triggered halving of the
learning rate, over a GAE(lambda) rollout buffer.

The rollout buffer is host numpy, as muvo_tpu's; the birdview is stored
(C, H, W). Each minibatch goes to the policy's device for its update.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


class RolloutBuffer:
    """GAE(lambda) rollout storage (host numpy)."""

    def __init__(self, buffer_size: int, obs_shapes: Dict[str, tuple],
                 action_dim: int = 2, gamma: float = 0.99,
                 gae_lambda: float = 0.9, n_envs: int = 1):
        self.buffer_size = buffer_size
        self.n_envs = n_envs
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.obs_shapes = obs_shapes
        self.action_dim = action_dim
        self.reset()

    def reset(self):
        bs, ne = self.buffer_size, self.n_envs
        self.observations = {
            k: np.zeros((bs, ne) + tuple(s), np.float32)
            for k, s in self.obs_shapes.items()
        }
        self.actions = np.zeros((bs, ne, self.action_dim), np.float32)
        self.rewards = np.zeros((bs, ne), np.float32)
        self.dones = np.zeros((bs, ne), np.float32)
        self.values = np.zeros((bs, ne), np.float32)
        self.log_probs = np.zeros((bs, ne), np.float32)
        self.p1 = np.zeros((bs, ne, self.action_dim), np.float32)
        self.p2 = np.zeros((bs, ne, self.action_dim), np.float32)
        self.acc_codes = np.zeros((bs, ne), np.int32)
        self.steer_codes = np.zeros((bs, ne), np.int32)
        self.advantages = np.zeros((bs, ne), np.float32)
        self.returns = np.zeros((bs, ne), np.float32)
        self.pos = 0

    def add(self, obs, actions, rewards, dones, values, log_probs, p1, p2,
            acc_codes=None, steer_codes=None):
        i = self.pos
        for k, v in obs.items():
            self.observations[k][i] = v
        self.actions[i] = actions
        self.rewards[i] = rewards
        self.dones[i] = dones
        self.values[i] = values
        self.log_probs[i] = log_probs
        self.p1[i] = p1
        self.p2[i] = p2
        if acc_codes is not None:
            self.acc_codes[i] = acc_codes
        if steer_codes is not None:
            self.steer_codes[i] = steer_codes
        self.pos += 1

    def compute_returns_and_advantage(self, last_values: np.ndarray,
                                      dones: np.ndarray):
        last_gae = 0.0
        for step in reversed(range(self.buffer_size)):
            if step == self.buffer_size - 1:
                next_non_terminal = 1.0 - dones
                next_values = last_values
            else:
                next_non_terminal = 1.0 - self.dones[step + 1]
                next_values = self.values[step + 1]
            delta = (self.rewards[step]
                     + self.gamma * next_values * next_non_terminal
                     - self.values[step])
            last_gae = (delta + self.gamma * self.gae_lambda
                        * next_non_terminal * last_gae)
            self.advantages[step] = last_gae
        self.returns = self.advantages + self.values

    def flatten(self) -> Dict[str, np.ndarray]:
        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        out = {f"obs_{k}": flat(v) for k, v in self.observations.items()}
        out.update({
            "actions": flat(self.actions),
            "old_values": flat(self.values),
            "old_log_probs": flat(self.log_probs),
            "old_p1": flat(self.p1),
            "old_p2": flat(self.p2),
            "advantages": flat(self.advantages),
            "returns": flat(self.returns),
            "acc_codes": flat(self.acc_codes),
            "steer_codes": flat(self.steer_codes),
        })
        return out


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm on the parameters' gradients, in place:
    each scaled to (g / norm) * max_norm where the global norm reaches
    max_norm (torch's clip_grad_norm_ adds 1e-6 to the norm). Returns the
    norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


class PPO:
    def __init__(self, policy, learning_rate: float = 1e-5,
                 batch_size: int = 256, n_epochs: int = 20,
                 clip_range: float = 0.2, clip_range_vf: Optional[float] = None,
                 ent_coef: float = 0.05, explore_coef: float = 0.05,
                 vf_coef: float = 0.5, max_grad_norm: float = 0.5,
                 target_kl: float = 0.01,
                 lr_schedule_step: Optional[int] = None):
        self.policy = policy
        self.device = next(policy.parameters()).device
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.n_epochs = n_epochs
        self.clip_range = clip_range
        self.clip_range_vf = clip_range_vf
        self.ent_coef = ent_coef
        self.explore_coef = explore_coef
        self.vf_coef = vf_coef
        self.max_grad_norm = max_grad_norm
        self.target_kl = target_kl
        self.lr_schedule_step = lr_schedule_step
        self.kl_early_stop = 0
        # optax.adam's defaults; the learning rate is the host's to change
        self.optimizer = torch.optim.Adam(policy.parameters(),
                                          lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)

    def loss(self, batch: Dict[str, torch.Tensor]):
        """(loss, metrics) of a minibatch of device tensors."""
        values, log_prob, entropy_loss, exploration_loss, dist = \
            self.policy.evaluate_actions(
                batch["obs_birdview"], batch["obs_state"], batch["actions"],
                batch["acc_codes"], batch["steer_codes"])
        advantages = batch["advantages"]
        ratio = torch.exp(log_prob - batch["old_log_probs"])
        pl1 = advantages * ratio
        pl2 = advantages * ratio.clamp(1 - self.clip_range,
                                       1 + self.clip_range)
        policy_loss = -torch.minimum(pl1, pl2).mean()
        if self.clip_range_vf is None:
            values_pred = values
        else:
            values_pred = batch["old_values"] + (
                values - batch["old_values"]).clamp(-self.clip_range_vf,
                                                    self.clip_range_vf)
        value_loss = torch.mean((batch["returns"] - values_pred) ** 2)
        loss = (policy_loss + self.vf_coef * value_loss
                + self.ent_coef * entropy_loss
                + self.explore_coef * exploration_loss)
        old_dist = self.policy.make_dist(batch["old_p1"], batch["old_p2"])
        with torch.no_grad():
            metrics = {
                "loss": loss, "policy_loss": policy_loss,
                "value_loss": value_loss, "entropy_loss": entropy_loss,
                "exploration_loss": exploration_loss,
                "kl": torch.mean(old_dist.kl(dist)),
                "clip_fraction": torch.mean(
                    ((ratio - 1).abs() > self.clip_range).float()),
            }
        return loss, {k: v.detach() for k, v in metrics.items()}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One minibatch's update: the loss's gradients, clipped to
        max_grad_norm, then Adam. Returns its metrics (device scalars)."""
        mb = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(mb)
        loss.backward()
        clip_by_global_norm_(list(self.policy.parameters()),
                             self.max_grad_norm)
        self.optimizer.step()
        return metrics

    def train(self, buffer: RolloutBuffer,
              rng: Optional[np.random.RandomState] = None) -> Dict:
        rng = rng or np.random.RandomState(0)
        data = buffer.flatten()
        n = data["actions"].shape[0]
        all_metrics = []
        for _ in range(self.n_epochs):
            perm = rng.permutation(n)
            kls = []
            for start in range(0, n - self.batch_size + 1, self.batch_size):
                idx = perm[start:start + self.batch_size]
                metrics = self.update({k: v[idx] for k, v in data.items()})
                metrics = {k: float(v) for k, v in metrics.items()}
                kls.append(metrics["kl"])
                all_metrics.append(metrics)
            if (self.target_kl is not None
                    and np.mean(kls) > 1.5 * self.target_kl):
                if self.lr_schedule_step is not None:
                    self.kl_early_stop += 1
                    if self.kl_early_stop >= self.lr_schedule_step:
                        self.learning_rate *= 0.5
                        for group in self.optimizer.param_groups:
                            group["lr"] = self.learning_rate
                        self.kl_early_stop = 0
                break
        ret = buffer.returns.flatten()
        val = buffer.values.flatten()
        var = np.var(ret)
        explained_var = (float("nan") if var == 0
                         else float(1 - np.var(ret - val) / var))
        summary = ({k: float(np.mean([m[k] for m in all_metrics]))
                    for k in all_metrics[0]} if all_metrics else {})
        summary["explained_variance"] = explained_var
        summary["n_updates"] = len(all_metrics)
        return summary
