"""Reflected predictor-corrector sampling.

A plain Python loop over ``timesteps[:-1]``: exactly N - 1 corrector +
predictor updates, one draw of the prior, and a final denoiser whose output
is the result.  Noise comes from a ``torch.Generator`` on the sampling
device; the update rules take a ``noise()`` callable so that a caller can
inject its own draws.
"""
from __future__ import annotations

import math

import torch

from ..ops import cube
from . import (get_corrector, get_denoiser, get_predictor, register_corrector,
               register_denoiser, register_predictor)


def _bcast(v, x):
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


# --------------------------------------------------------------------------
# Predictors: factory(sde, score_fn) -> update(x, t, noise) -> (x, x_mean)

@register_predictor(name="euler_maruyama")
def reflected_euler_maruyama(sde, score_fn):
    dt = -1.0 / sde.N

    def update(x, t, noise):
        z = noise()
        score = score_fn(x, t)
        drift, diffusion = sde.reverse_sde(x, t, score)
        x_mean = x + drift * dt
        x_new = x_mean + _bcast(diffusion, x) * math.sqrt(-dt) * z
        return cube.reflect(x_new), cube.reflect(x_mean)

    return update


@register_predictor(name="none")
def none_predictor(sde, score_fn):
    def update(x, t, noise):
        return x, x
    return update


# --------------------------------------------------------------------------
# Correctors: factory(sde, score_fn, snr, n_steps) -> update(x, t, noise)

@register_corrector(name="langevin")
def reflected_langevin(sde, score_fn, snr, n_steps):
    """SNR-scaled Langevin with batch-mean gradient and noise norms and a
    reflection after every substep."""

    def update(x, t, noise):
        x_mean = x
        for _ in range(n_steps):
            grad = score_fn(x, t)
            z = noise()
            grad_norm = torch.linalg.vector_norm(grad.reshape(grad.shape[0], -1), dim=-1).mean()
            noise_norm = torch.linalg.vector_norm(z.reshape(z.shape[0], -1), dim=-1).mean()
            step_size = (snr * noise_norm / grad_norm) ** 2 * 2.0 * torch.ones_like(t)
            # A score that is identically ~0 (the heat-kernel score underflows
            # at sigma_max in f32) makes the SNR-matched step infinite; without
            # gradient signal the update is skipped instead.
            step_size = torch.where(grad_norm > 1e-10, step_size, torch.zeros_like(step_size))
            x_mean = x + _bcast(step_size, x) * grad
            x = x_mean + _bcast(torch.sqrt(step_size * 2.0), x) * z
            x, x_mean = cube.reflect(x), cube.reflect(x_mean)
        return x, x_mean

    return update


@register_corrector(name="none")
def none_corrector(sde, score_fn, snr, n_steps):
    def update(x, t, noise):
        return x, x
    return update


# --------------------------------------------------------------------------
# Denoisers: factory(denoiser_fn) -> update(x, x_mean, t)

@register_denoiser(name="network")
def trained_denoiser(denoiser_fn):
    """``(x - denoiser(x, t)).clamp(0, 1)``."""
    def update(x, x_mean, t):
        return torch.clamp(x - denoiser_fn(x, t), 0.0, 1.0)
    return update


@register_denoiser(name="mean")
def mean_denoiser(denoiser_fn):
    def update(x, x_mean, t):
        return x_mean
    return update


@register_denoiser(name="none")
def none_denoiser(denoiser_fn):
    def update(x, x_mean, t):
        return x
    return update


# --------------------------------------------------------------------------

def get_pc_sampler(sde, shape, predictor="euler_maruyama", corrector="none",
                   denoiser="none", snr=0.01, n_steps=1, eps=1e-3):
    """Returns ``pc_sampler(score_fn, generator, denoiser_fn=None, z=None) ->
    (x, nfe)``.  ``score_fn(x, t)`` is a plain or guided score closure (see
    ``models.registry``); ``generator`` is a ``torch.Generator`` on the
    sampling device; ``z`` optionally replaces the prior draw."""
    predictor_factory = get_predictor(predictor)
    corrector_factory = get_corrector(corrector)
    denoiser_factory = get_denoiser(denoiser)
    B = shape[0]

    @torch.no_grad()
    def pc_sampler(score_fn, generator, denoiser_fn=None, z=None):
        device = generator.device
        pred_update = predictor_factory(sde, score_fn)
        corr_update = corrector_factory(sde, score_fn, snr, n_steps)
        deno_update = denoiser_factory(denoiser_fn)

        x = sde.prior_sampling(shape, generator=generator, device=device) if z is None else z

        def noise():
            return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=device)

        timesteps = torch.linspace(sde.T, eps, sde.N, device=device)
        x_mean = x
        for t in timesteps[:-1]:
            vec_t = t.expand(B)
            x, _ = corr_update(x, vec_t, noise)
            x, x_mean = pred_update(x, vec_t, noise)

        vec_eps = torch.full((B,), eps, dtype=x.dtype, device=device)
        x = deno_update(x, x_mean, vec_eps)
        return x, sde.N * (n_steps + 1)

    return pc_sampler
