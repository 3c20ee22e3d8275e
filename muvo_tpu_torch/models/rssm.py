"""Recurrent state-space model, one step at a time (counterpart of
muvo_tpu/models/rssm.py's observe_step / imagine_step).

  * prior:     (h, a)          -> N(mu, sigma), sigma = 2*sigmoid(x/2) + 0.1
  * posterior: (h, a, embed)   -> N(mu, sigma)
  * torch GRU cell over h, after a projection of the latent sample

Upstream's ``nn.LeakyReLU(True)`` sets negative_slope = True = 1.0, i.e.
the identity; those slots hold ``nn.Identity`` here so the Linear layers
keep upstream's Sequential indices (``module.0`` / ``module.2``).

Sampling draws its noise from an explicit ``torch.Generator``. torch and
JAX draw different streams, so the parity tests run ``use_sample=False``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


class RepresentationModel(nn.Module):
    def __init__(self, in_channels: int, latent_dim: int,
                 min_std: float = 0.1):
        super().__init__()
        self.min_std = min_std
        self.module = nn.Sequential(
            nn.Linear(in_channels, in_channels),
            nn.Identity(),  # upstream LeakyReLU(True): slope 1.0
            nn.Linear(in_channels, 2 * latent_dim),
        )

    def forward(self, x):
        mu, log_sigma = self.module(x).chunk(2, dim=-1)
        sigma = 2 * torch.sigmoid(log_sigma / 2) + self.min_std
        return mu, sigma


def sample_from_distribution(mu, sigma, use_sample: bool,
                             generator: Optional[torch.Generator]):
    if not use_sample:
        return mu
    noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                        dtype=mu.dtype)
    return mu + sigma * noise


class RSSM(nn.Module):
    def __init__(self, embedding_dim: int, action_dim: int,
                 hidden_state_dim: int, state_dim: int,
                 action_latent_dim: int):
        super().__init__()
        self.pre_gru_net = nn.Sequential(
            nn.Linear(state_dim, hidden_state_dim), nn.Identity())
        self.recurrent_model = nn.GRUCell(hidden_state_dim, hidden_state_dim)
        self.posterior_action_module = nn.Sequential(
            nn.Linear(action_dim, action_latent_dim), nn.Identity())
        self.posterior = RepresentationModel(
            hidden_state_dim + embedding_dim + action_latent_dim, state_dim)
        self.prior_action_module = nn.Sequential(
            nn.Linear(action_dim, action_latent_dim), nn.Identity())
        self.prior = RepresentationModel(
            hidden_state_dim + action_latent_dim, state_dim)

    def imagine_step(self, h_t, sample_t, action_t, use_sample: bool = True,
                     generator: Optional[torch.Generator] = None) -> Dict:
        latent_action = self.prior_action_module(action_t)
        h_next = self.recurrent_model(self.pre_gru_net(sample_t), h_t)
        mu, sigma = self.prior(torch.cat([h_next, latent_action], dim=-1))
        sample = sample_from_distribution(mu, sigma, use_sample, generator)
        return {"hidden_state": h_next, "sample": sample, "mu": mu,
                "sigma": sigma}

    def observe_step(self, h_t, sample_t, action_t, embedding_t,
                     use_sample: bool = True,
                     generator: Optional[torch.Generator] = None) -> Dict:
        prior = self.imagine_step(h_t, sample_t, action_t, use_sample,
                                  generator)
        latent_action = self.posterior_action_module(action_t)
        mu, sigma = self.posterior(
            torch.cat([prior["hidden_state"], embedding_t, latent_action],
                      dim=-1))
        sample = sample_from_distribution(mu, sigma, use_sample, generator)
        posterior = {"hidden_state": prior["hidden_state"], "sample": sample,
                     "mu": mu, "sigma": sigma}
        return {"prior": prior, "posterior": posterior}
