"""PPO actor-critic policy (counterpart of muvo_tpu/rl/policy.py).

A shared feature extractor, MLP policy and value heads, and the
distribution's head: Beta's alpha and beta are 1 + softplus of two Linear
layers; the Gaussians' mean is a Linear layer and their log std a
state-independent parameter clipped to [-20, 2]. Parameter names follow
carla-roach's rl_birdview PpoPolicy: ``features_extractor``,
``policy_head``, ``value_head``, ``dist_mu`` and ``dist_sigma``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from muvo_tpu_torch.rl.distributions import (BetaDist, DiagGaussianDist,
                                             SquashedGaussianDist)
from muvo_tpu_torch.rl.networks import FEATURE_EXTRACTORS

LOG_STD_INIT = -2.0


def _mlp(in_dim: int, arch: Sequence[int], out_dim: Optional[int] = None):
    layers = []
    for n in arch:
        layers += [nn.Linear(in_dim, n), nn.ReLU()]
        in_dim = n
    if out_dim is not None:
        layers.append(nn.Linear(in_dim, out_dim))
    return nn.Sequential(*layers)


class PpoPolicy(nn.Module):
    def __init__(self, feature_extractor: str = "xtma_cnn",
                 distribution: str = "beta",
                 policy_head_arch: Sequence[int] = (256, 256),
                 value_head_arch: Sequence[int] = (256, 256),
                 action_dim: int = 2,
                 birdview_shape: Tuple[int, int, int] = (15, 192, 192),
                 state_dim: int = 6):
        super().__init__()
        self.distribution = distribution
        self.features_extractor = FEATURE_EXTRACTORS[feature_extractor](
            birdview_shape, state_dim)
        features = self.features_extractor.features_dim
        self.policy_head = _mlp(features, policy_head_arch)
        self.value_head = _mlp(features, value_head_arch, 1)
        latent = policy_head_arch[-1] if policy_head_arch else features
        if distribution == "beta":
            self.dist_mu = nn.Sequential(nn.Linear(latent, action_dim),
                                         nn.Softplus())
            self.dist_sigma = nn.Sequential(nn.Linear(latent, action_dim),
                                            nn.Softplus())
        else:
            self.dist_mu = nn.Linear(latent, action_dim)
            self.dist_sigma = nn.Parameter(
                torch.full((action_dim,), LOG_STD_INIT))

    def _dist(self, latent):
        if self.distribution == "beta":
            return BetaDist(1.0 + self.dist_mu(latent),
                            1.0 + self.dist_sigma(latent))
        mu = self.dist_mu(latent)
        sigma = torch.exp(self.dist_sigma.clamp(-20, 2)) * torch.ones_like(mu)
        if self.distribution == "squashed_gaussian":
            return SquashedGaussianDist(mu, sigma)
        return DiagGaussianDist(mu, sigma)

    def _heads(self, birdview, state):
        features = self.features_extractor(birdview, state)
        dist = self._dist(self.policy_head(features))
        return dist, self.value_head(features)[..., 0]

    def forward(self, birdview, state,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = False):
        """Rollout step: (actions, values, log_probs, p1, p2), p1 and p2
        the distribution's parameters."""
        dist, values = self._heads(birdview, state)
        actions = dist.mode() if deterministic else dist.sample(generator)
        return actions, values, dist.log_prob(actions), dist[0], dist[1]

    def evaluate_actions(self, birdview, state, actions, acc_code,
                         steer_code):
        dist, values = self._heads(birdview, state)
        return (values, dist.log_prob(actions), dist.entropy_loss(),
                dist.exploration_loss(acc_code, steer_code), dist)

    def forward_value(self, birdview, state):
        return self.value_head(self.features_extractor(birdview, state))[
            ..., 0]

    def make_dist(self, p1, p2):
        if self.distribution == "beta":
            return BetaDist(p1, p2)
        if self.distribution == "squashed_gaussian":
            return SquashedGaussianDist(p1, p2)
        return DiagGaussianDist(p1, p2)
