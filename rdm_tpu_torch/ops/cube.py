"""Unit-hypercube [0, 1]^D helpers: periodic reflection and the reflected
heat-kernel score.

Port of the JAX package's ``ops/cube.py``.  ``score_hk`` evaluates both
series densely and selects per sample with ``torch.where``, and the series
accumulate in float32 even for bfloat16 inputs: their ``+ 1e-12``
denominator guards lose all signal in bfloat16.
"""
from __future__ import annotations

import math

import torch

__all__ = ["reflect", "inside", "sample_hk", "score_hk"]

_PI = math.pi


def _bcast(v, x):
    """Reshape a per-sample vector [B] to broadcast against x [B, ...]."""
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def _per_sample(sigma, x):
    sigma = torch.as_tensor(sigma, device=x.device)
    if sigma.dim() == 0:
        sigma = torch.full((x.shape[0],), float(sigma), dtype=x.dtype, device=x.device)
    return sigma


def reflect(x):
    """Fold ``x`` into [0, 1] by repeated boundary reflection: ``x mod 2``,
    then mirror the (1, 2] half back down as ``2 - x``."""
    xm2 = torch.remainder(x, 2.0)
    return torch.where(xm2 > 1.0, 2.0 - xm2, xm2)


def inside(x):
    """Per-sample membership of the unit hypercube; bool [B]."""
    flat = x.reshape(x.shape[0], -1)
    return ((flat >= 0.0) & (flat <= 1.0)).all(dim=-1)


def sample_hk(x, sigma, generator=None):
    """Sample the reflected heat kernel centred at ``x`` with std ``sigma``
    (scalar or [B]): Gaussian perturbation, then reflection."""
    sigma = _per_sample(sigma, x)
    z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return reflect(x + _bcast(sigma, x) * z)


def _score_hk_ef(x, x_orig, t, efs: int = 20):
    """Cosine eigenfunction series, accurate for large diffusion time t."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dtype)
    x0f = x_orig.to(dtype)
    tf = t.to(dtype)

    k = torch.arange(1, efs + 1, dtype=dtype, device=x.device)       # [K]
    kx = _PI * xf[None] * _bcast(k, xf[None])
    kx0 = _PI * x0f[None] * _bcast(k, x0f[None])
    e = torch.exp(-tf[None, :] * (k[:, None] ** 2) * (_PI ** 2))    # [K, B]
    e_b = _bcast(e, kx)

    num = -2.0 * _PI * torch.sum(e_b * _bcast(k, kx) * torch.sin(kx) * torch.cos(kx0), dim=0)
    denom = 1.0 + 2.0 * torch.sum(e_b * torch.cos(kx) * torch.cos(kx0), dim=0)
    return (num / (denom + 1e-12)).to(x.dtype)


def _score_hk_refl(x, x_orig, t, refls: int = 10):
    """Method of images, accurate for small diffusion time t: the images of
    x under the reflection group of [0, 1] are {2n + x, 2n - x}."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dtype)
    x0f = x_orig.to(dtype)
    tf = t.to(dtype)

    shifts = torch.arange(-2 * refls, 2 * refls + 1, 2, dtype=dtype, device=x.device)
    r_b = _bcast(shifts, xf[None])
    x_imgs = torch.cat([r_b + xf[None], r_b - xf[None]], dim=0)
    sign = torch.cat([torch.ones_like(shifts), -torch.ones_like(shifts)], dim=0)

    dx = x_imgs - x0f[None]
    four_t = _bcast(4.0 * tf, dx[0])[None]
    coeff = -2.0 * dx / four_t
    e = torch.exp(-(dx ** 2) / four_t)

    num = torch.sum(coeff * e * _bcast(sign, e), dim=0)
    denom = torch.sum(e, dim=0)
    return (num / (denom + 1e-12)).to(x.dtype)


def score_hk(x, x_orig, sigma, efs: int = 20, refls: int = 10, min_cutoff: float = 1e-2):
    """Score of the reflected heat kernel on [0, 1]^D.  The diffusion time
    is ``t = sigma^2 / 2``; samples with ``t > min_cutoff`` take the
    eigenfunction series, the rest the image sum."""
    sigma = _per_sample(sigma, x)
    t = (sigma.to(torch.float32) ** 2) / 2.0
    s_ef = _score_hk_ef(x, x_orig, t, efs=efs)
    s_refl = _score_hk_refl(x, x_orig, t, refls=refls)
    return torch.where(_bcast(t > min_cutoff, x), s_ef, s_refl)
