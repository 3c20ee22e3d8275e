"""Action distributions of the PPO expert (counterpart of
muvo_tpu/rl/distributions.py).

Log-probabilities summed over the action dims, the entropy and
exploration losses, the KL divergences in muvo_tpu's directions, and
Beta's piecewise mode. Exploration suggestions arrive as integer codes (0
none, 1 stop / turn, 2 go / straight). ``betaln`` is three ``lgamma``s;
``digamma`` is torch's.

Sampling draws from an explicit ``torch.Generator``: torch's Beta and Gamma
samplers take none. Beta samples are G1 / (G1 + G2) of two Gamma draws,
each by Marsaglia and Tsang's method on the generator's normals and
uniforms (``gamma``), boosted by U^(1/alpha) below alpha 1. The samples
are not reparameterised: PPO only evaluates actions that were sampled
without gradients.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def _sum_dims(x):
    return x.sum(-1) if x.ndim > 1 else x.sum()


def betaln(a, b):
    """log B(a, b), as muvo_tpu orders it: the smaller argument alone."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    return torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))


def gamma(alpha: torch.Tensor, generator: Optional[torch.Generator]
          ) -> torch.Tensor:
    """Gamma(alpha, 1) draws, one for each element of ``alpha``: Marsaglia
    and Tsang's squeeze-and-reject on Gamma(alpha') with alpha' = alpha,
    or alpha + 1 and a factor U^(1/alpha) below 1. Each round draws a
    normal and a uniform for every element and keeps the first accepted
    candidate (at least 95% of them a round)."""
    a = alpha.detach()
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.zeros_like(a)
    done = torch.zeros_like(a, dtype=torch.bool)
    while not bool(done.all()):
        x = torch.randn(a.shape, generator=generator, device=a.device,
                        dtype=a.dtype)
        u = torch.rand(a.shape, generator=generator, device=a.device,
                       dtype=a.dtype)
        v = (1.0 + c * x) ** 3
        safe = torch.where(v > 0, v, torch.ones_like(v))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * safe
                        + d * torch.log(safe))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
    if bool(boost.any()):
        u = torch.rand(a.shape, generator=generator, device=a.device,
                       dtype=a.dtype)
        out = torch.where(boost, out * u ** (1.0 / a), out)
    return out


class BetaDist(NamedTuple):
    alpha: torch.Tensor  # concentration1
    beta: torch.Tensor   # concentration0

    def log_prob(self, actions):
        a, b = self.alpha, self.beta
        x = actions.clamp(1e-6, 1 - 1e-6)
        lp = (a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x) - betaln(a, b)
        return _sum_dims(lp)

    def entropy(self):
        a, b = self.alpha, self.beta
        return (betaln(a, b) - (a - 1) * torch.digamma(a)
                - (b - 1) * torch.digamma(b)
                + (a + b - 2) * torch.digamma(a + b))

    def entropy_loss(self):
        return torch.mean(-self.entropy())

    def sample(self, generator: Optional[torch.Generator] = None):
        g1 = gamma(self.alpha, generator)
        g2 = gamma(self.beta, generator)
        return g1 / (g1 + g2)

    def mode(self):
        a, b = self.alpha, self.beta
        mean = a / (a + b)
        interior = (a - 1) / torch.clamp(a + b - 2, min=1e-6)
        zero, one = torch.zeros_like(a), torch.ones_like(a)
        return torch.where((a > 1) & (b > 1), interior,
                           torch.where((a <= 1) & (b > 1), zero,
                                       torch.where((a > 1) & (b <= 1), one,
                                                   mean)))

    def kl(self, other: "BetaDist"):
        """KL(self || other), per element."""
        a1, b1, a2, b2 = self.alpha, self.beta, other.alpha, other.beta
        return (betaln(a2, b2) - betaln(a1, b1)
                + (a1 - a2) * torch.digamma(a1)
                + (b1 - b2) * torch.digamma(b1)
                + (a2 - a1 + b2 - b1) * torch.digamma(a1 + b1))

    def exploration_loss(self, acc_code, steer_code):
        """KL(dist || suggestion). Codes: 0 none, acc 1 stop 2 go, steer 1
        turn 2 straight."""
        def table(code, one, two):
            return torch.where(code == 1, one, torch.where(code == 2, two, 0.0))

        acc_beta, acc_alpha = table(acc_code, 1.5, 1.0), table(acc_code, 1.0,
                                                                2.5)
        st_beta, st_alpha = table(steer_code, 1.0, 3.0), table(steer_code,
                                                                1.0, 3.0)
        tgt_alpha = torch.stack([
            torch.where(acc_code > 0, acc_alpha, self.alpha[:, 0]),
            torch.where(steer_code > 0, st_alpha, self.alpha[:, 1])], -1)
        tgt_beta = torch.stack([
            torch.where(acc_code > 0, acc_beta, self.beta[:, 0]),
            torch.where(steer_code > 0, st_beta, self.beta[:, 1])], -1)
        target = BetaDist(tgt_alpha.detach(), tgt_beta.detach())
        return torch.mean(self.kl(target))


class DiagGaussianDist(NamedTuple):
    mu: torch.Tensor
    sigma: torch.Tensor

    def log_prob(self, actions):
        var = self.sigma ** 2
        lp = (-((actions - self.mu) ** 2) / (2 * var) - torch.log(self.sigma)
              - 0.5 * math.log(2 * math.pi))
        return _sum_dims(lp)

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.sigma)

    def entropy_loss(self):
        return torch.mean(-self.entropy())

    def sample(self, generator: Optional[torch.Generator] = None):
        return self.mu + self.sigma * torch.randn(
            self.mu.shape, generator=generator, device=self.mu.device,
            dtype=self.mu.dtype)

    def mode(self):
        return self.mu

    def kl(self, other: "DiagGaussianDist"):
        return (torch.log(other.sigma / self.sigma)
                + (self.sigma ** 2 + (self.mu - other.mu) ** 2)
                / (2 * other.sigma ** 2) - 0.5)

    def exploration_loss(self, acc_code, steer_code):
        """KL(suggestion || dist) for Gaussians (muvo_tpu's direction)."""
        acc_mu = torch.where(acc_code == 1, -0.66,
                             torch.where(acc_code == 2, 0.66, 0.0))
        acc_ls = torch.full_like(acc_mu, -3.0)
        st_mu = torch.where(steer_code == 2, 3.0, 0.0)
        st_ls = torch.where(steer_code == 1, -1.0,
                            torch.where(steer_code == 2, 3.0, 0.0))
        mu = torch.stack([
            torch.where(acc_code > 0, acc_mu, self.mu[:, 0]),
            torch.where(steer_code > 0, st_mu, self.mu[:, 1])], -1)
        sigma = torch.stack([
            torch.where(acc_code > 0, torch.exp(acc_ls), self.sigma[:, 0]),
            torch.where(steer_code > 0, torch.exp(st_ls), self.sigma[:, 1])],
            -1)
        target = DiagGaussianDist(mu.detach(), sigma.detach())
        return torch.mean(target.kl(self))


class SquashedGaussianDist(NamedTuple):
    """tanh-squashed Gaussian (no closed-form entropy)."""

    mu: torch.Tensor
    sigma: torch.Tensor

    def log_prob(self, actions, gaussian_actions=None):
        eps = 1e-7
        if gaussian_actions is None:
            gaussian_actions = torch.atanh(actions.clamp(-1 + eps, 1 - eps))
        base = DiagGaussianDist(self.mu, self.sigma).log_prob(gaussian_actions)
        correction = (2 * (math.log(2.0) - gaussian_actions
                           - F.softplus(-2 * gaussian_actions))).sum(-1)
        return base - correction

    def sample(self, generator: Optional[torch.Generator] = None):
        return torch.tanh(DiagGaussianDist(self.mu, self.sigma).sample(
            generator))

    def mode(self):
        return torch.tanh(self.mu)


DISTRIBUTIONS = {
    "beta": BetaDist,
    "diag_gaussian": DiagGaussianDist,
    "squashed_gaussian": SquashedGaussianDist,
}
