"""Reflected variance-exploding SDE: sigma(t) = sigma_min (sigma_max /
sigma_min)^t, zero drift, uniform prior on the unit cube (prior_logp = 0).
GTO config: sigma_min 0.01, sigma_max 5, N = 1000."""
from __future__ import annotations

import math

import torch

from .base import SDE


class RVESDE(SDE):
    def __init__(self, sigma_min: float = 0.01, sigma_max: float = 50.0,
                 N: int = 1000, T: float = 1.0):
        super().__init__(N)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self._T = float(T)

    @property
    def T(self) -> float:
        return self._T

    def sigma(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def discrete_sigmas(self, device=None):
        """Geometric sigma ladder of the SMLD discretization (float32)."""
        return torch.exp(torch.linspace(math.log(self.sigma_min),
                                        math.log(self.sigma_max), self.N,
                                        device=device))

    def sde(self, x, t):
        sigma = self.sigma(t)
        drift = torch.zeros_like(x)
        diffusion = sigma * math.sqrt(2.0 * (math.log(self.sigma_max)
                                             - math.log(self.sigma_min)))
        return drift, torch.as_tensor(diffusion, device=x.device).expand(t.shape)

    def marginal_prob(self, x, t):
        return x, self.sigma(t)

    def prior_sampling(self, shape, generator=None, device=None):
        return torch.rand(shape, generator=generator, device=device)

    def prior_logp(self, z):
        return torch.zeros_like(z)

    def discretize(self, x, t):
        """SMLD (NCSN) discretization over the discrete sigma ladder."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int64)
        sigmas = self.discrete_sigmas(device=t.device)
        sigma = sigmas[timestep]
        adjacent = torch.where(timestep == 0, torch.zeros_like(sigma),
                               sigmas[(timestep - 1).clamp(min=0)])
        f = torch.zeros_like(x)
        G = torch.sqrt(sigma ** 2 - adjacent ** 2)
        return f, G
