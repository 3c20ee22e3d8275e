"""Recurrent state-space model (counterpart of muvo_tpu/models/rssm.py):
one step at a time (observe_step / imagine_step) and over a sequence
(``forward``).

  * prior:     (h, a)          -> N(mu, sigma), sigma = 2*sigmoid(x/2) + 0.1
  * posterior: (h, a, embed)   -> N(mu, sigma)
  * torch GRU cell over h, after a projection of the latent sample

Upstream's ``nn.LeakyReLU(True)`` sets negative_slope = True = 1.0, i.e.
the identity; those slots hold ``nn.Identity`` here so the Linear layers
keep upstream's Sequential indices (``module.0`` / ``module.2``).

Sampling draws its noise from an explicit ``torch.Generator``. torch and
JAX draw different streams, so the parity tests run ``use_sample=False``.
In training, the sequence loop's posterior dropout (one scalar draw per
step, shared across the batch, never at t=0) feeds the prior sample
forward instead of the posterior one.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from muvo_tpu_torch.parallel import mesh


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
    # in a group of ranks, this rank's rows of the global batch's draw
    noise = mesh.randn_slice(mu.shape, generator, mu.device, mu.dtype)
    return mu + sigma * noise


class RSSM(nn.Module):
    def __init__(self, embedding_dim: int, action_dim: int,
                 hidden_state_dim: int, state_dim: int,
                 action_latent_dim: int, use_dropout: bool = True,
                 dropout_probability: float = 0.15):
        super().__init__()
        self.hidden_state_dim = hidden_state_dim
        self.state_dim = state_dim
        self.use_dropout = use_dropout
        self.dropout_probability = dropout_probability
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

    def forward(self, embedding, action, use_sample: bool = True,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                use_prior: Optional[torch.Tensor] = None) -> Dict:
        """embedding (b, s, C), action (b, s, A) -> {"prior", "posterior"},
        each of hidden_state / sample / mu / sigma shaped (b, s, ...).

        The action fed at step t is action[t-1] (zeros at t=0). In training
        with USE_DROPOUT, step t > 0 takes the prior sample forward with
        probability DROPOUT_PROBABILITY (one draw per step for the whole
        batch); ``use_prior`` (s,) bools set those draws instead.
        """
        b, s, _ = embedding.shape
        shifted = torch.cat([torch.zeros_like(action[:, :1]), action[:, :-1]],
                            dim=1)
        if use_prior is None:
            use_prior = torch.zeros(s, dtype=torch.bool)
            if training and self.use_dropout:
                u = torch.rand(s, generator=generator,
                               device=embedding.device).cpu()
                use_prior = (u < self.dropout_probability) & (
                    torch.arange(s) > 0)
        flags = use_prior.tolist()
        h = embedding.new_zeros((b, self.hidden_state_dim))
        smp = embedding.new_zeros((b, self.state_dim))
        steps = []
        for t in range(s):
            out = self.observe_step(h, smp, shifted[:, t], embedding[:, t],
                                    use_sample, generator)
            h = out["prior"]["hidden_state"]
            smp = out["prior" if flags[t] else "posterior"]["sample"]
            steps.append(out)
        return {part: {key: torch.stack([o[part][key] for o in steps], dim=1)
                       for key in steps[0][part]}
                for part in ("prior", "posterior")}
