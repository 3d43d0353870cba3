"""Forward SDE interface; the reverse dynamics are plain functions of
``(x, t, score)``."""
from __future__ import annotations

import abc
import math

import torch


def _bcast(v, x):
    v = torch.as_tensor(v, device=x.device)
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


class SDE(abc.ABC):
    """Forward SDE ``dx = f(x, t) dt + g(t) dW`` on t in [0, T]."""

    def __init__(self, N: int):
        self.N = int(N)

    @property
    @abc.abstractmethod
    def T(self) -> float:
        """End time of the SDE."""

    @abc.abstractmethod
    def sde(self, x, t):
        """Return (drift, diffusion); drift like x, diffusion shaped [B]."""

    @abc.abstractmethod
    def marginal_prob(self, x, t):
        """Mean/std of the marginal p_t(x | x_0): (mean like x, std [B])."""

    @abc.abstractmethod
    def prior_sampling(self, shape, generator=None, device=None):
        """One sample from the prior p_T."""

    @abc.abstractmethod
    def prior_logp(self, z):
        """Log-density of the prior at z."""

    def discretize(self, x, t):
        """Euler-Maruyama discretization ``x_{i+1} = x_i + f_i + G_i z``."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse_sde(self, x, t, score, probability_flow: bool = False):
        """Drift/diffusion of the reverse-time SDE (or ODE) given a score."""
        drift, diffusion = self.sde(x, t)
        scale = 0.5 if probability_flow else 1.0
        drift = drift - _bcast(diffusion, x) ** 2 * score * scale
        diffusion = torch.zeros_like(diffusion) if probability_flow else diffusion
        return drift, diffusion

    def reverse_discretize(self, x, t, score, probability_flow: bool = False):
        """Discretized reverse iteration rule."""
        f, G = self.discretize(x, t)
        scale = 0.5 if probability_flow else 1.0
        rev_f = f - _bcast(G, x) ** 2 * score * scale
        rev_G = torch.zeros_like(G) if probability_flow else G
        return rev_f, rev_G
