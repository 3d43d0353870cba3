"""Gaussian DDPM on 1-D sequences: the legacy ``GaussianDiffusion1D`` as an
``nn.Module`` over sequences in NCL layout, (B, C, L).

* cosine or linear beta schedules, computed in float64 and stored as
  float32 buffers;
* objectives ``pred_noise``, ``pred_x0`` and ``pred_v`` with their SNR
  loss weights and the closed-form conversions between them;
* ancestral ``p_sample_loop`` and ``ddim_sample`` (DDIM's time pairs are
  numpy's ``linspace(-1, T - 1, S + 1).astype(int)``); the per-step loop
  reads nothing back to the host;
* ``q_sample``, ``q_sample_many`` and latent ``interpolate``;
* the training loss ``p_losses`` with the constraint-violation loss types
  NA | one_over_t | gt_threshold | gt_scaled | gt_std | gt_std_absolute |
  gt_std_threshold | gt_log_likelihood, which take a guided ``p_sample`` of
  x_{t-1} inside the loss.  The constraint function ``constraint_fn(x_flat,
  classes, scale) -> [B]`` is injected; without it only "NA" is allowed.

Every random draw comes from the ``torch.Generator`` the caller passes, or
is given as a tensor: ``t``, the noise of x_t, the guided sample's noise and
the ground-truth draws of ``p_losses``; ``z`` and the per-step noises of the
samplers.  DDIM calls the model with the default ``rescaled_phi`` 0.7
whatever the caller asks; the ancestral sampler passes the caller's.

The model is an ``nn.Module`` with ``channels``, ``forward(x, time,
classes, generator=...)`` (the training forward, with its own label
dropout) and ``forward_with_cond_scale``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .schedules import cosine_beta_schedule, linear_beta_schedule


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def _extract(a, t, ndim):
    return a[t].reshape(t.shape[0], *((1,) * (ndim - 1)))


def _randn(shape, like, generator):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


class GaussianDiffusion1D(nn.Module):
    def __init__(self, model, *, seq_length: int, timesteps: int = 1000,
                 sampling_timesteps: Optional[int] = None,
                 objective: str = "pred_noise", beta_schedule: str = "cosine",
                 ddim_sampling_eta: float = 0.0, auto_normalize: bool = True,
                 constraint_violation_weight: float = 0.001,
                 constraint_condscale: float = 6.0,
                 max_sample_step_with_constraint_loss: int = 500,
                 constraint_loss_type: str = "NA", task_type: str = "cr3bp",
                 constraint_gt_sample_num: int = 1,
                 normalize_xt_by_mean_sigma: str = "False",
                 constraint_fn: Optional[Callable] = None):
        super().__init__()
        assert objective in {"pred_noise", "pred_x0", "pred_v"}
        self.model = model
        self.channels = model.channels
        self.seq_length = seq_length
        self.objective = objective
        self.constraint_violation_weight = constraint_violation_weight
        self.constraint_condscale = constraint_condscale
        self.max_sample_step_with_constraint_loss = max_sample_step_with_constraint_loss
        self.constraint_loss_type = constraint_loss_type
        self.task_type = task_type
        self.constraint_gt_sample_num = constraint_gt_sample_num
        self.normalize_xt_by_mean_sigma = normalize_xt_by_mean_sigma
        self.constraint_fn = constraint_fn
        if constraint_loss_type != "NA" and constraint_fn is None:
            raise ValueError(
                f"constraint_loss_type={constraint_loss_type!r} needs a "
                "constraint_fn (the reference's car/tabletop constraint "
                "modules are external; cr3bp has no constraint function)")

        betas64 = (linear_beta_schedule(timesteps) if beta_schedule == "linear"
                   else cosine_beta_schedule(timesteps))
        alphas = 1.0 - betas64
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        self.num_timesteps = int(timesteps)
        self.sampling_timesteps = sampling_timesteps or timesteps
        assert self.sampling_timesteps <= timesteps
        self.is_ddim_sampling = self.sampling_timesteps < timesteps
        self.ddim_sampling_eta = ddim_sampling_eta

        def buffer(name, v):
            self.register_buffer(name, torch.from_numpy(np.asarray(v, np.float32)))

        buffer("betas", betas64)
        buffer("alphas_cumprod", ac)
        buffer("alphas_cumprod_prev", ac_prev)
        buffer("sqrt_alphas_cumprod", np.sqrt(ac))
        buffer("sqrt_one_minus_alphas_cumprod", np.sqrt(1 - ac))
        buffer("log_one_minus_alphas_cumprod", np.log(1 - ac))
        buffer("sqrt_recip_alphas_cumprod", np.sqrt(1 / ac))
        buffer("sqrt_recipm1_alphas_cumprod", np.sqrt(1 / ac - 1))
        post_var = betas64 * (1 - ac_prev) / (1 - ac)
        buffer("posterior_variance", post_var)
        buffer("posterior_log_variance_clipped", np.log(np.clip(post_var, 1e-20, None)))
        buffer("posterior_mean_coef1", betas64 * np.sqrt(ac_prev) / (1 - ac))
        buffer("posterior_mean_coef2", (1 - ac_prev) * np.sqrt(alphas) / (1 - ac))
        snr = ac / (1 - ac)
        buffer("loss_weight", {"pred_noise": np.ones_like(snr), "pred_x0": snr,
                               "pred_v": snr / (snr + 1)}[objective])
        self.auto_normalize = auto_normalize

    # -- normalisation [0, 1] <-> [-1, 1] ---------------------------------
    def normalize(self, x):
        return x * 2 - 1 if self.auto_normalize else x

    def unnormalize(self, x):
        return (x + 1) * 0.5 if self.auto_normalize else x

    # -- closed-form conversions -------------------------------------------
    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.dim()
        return (_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        nd = x_t.dim()
        return ((_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
                / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd))

    def predict_v(self, x_start, t, noise):
        nd = x_start.dim()
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * noise
                - _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)

    def predict_start_from_v(self, x_t, t, v):
        nd = x_t.dim()
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_t
                - _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    def q_posterior(self, x_start, x_t, t):
        nd = x_t.dim()
        mean = (_extract(self.posterior_mean_coef1, t, nd) * x_start
                + _extract(self.posterior_mean_coef2, t, nd) * x_t)
        var = _extract(self.posterior_variance, t, nd)
        logvar = _extract(self.posterior_log_variance_clipped, t, nd)
        return mean, var, logvar

    # -- model wrappers ------------------------------------------------------
    def model_predictions(self, x, t, classes, cond_scale=6.0, rescaled_phi=0.7,
                          clip_x_start=False, rederive_pred_noise=False):
        out = self.model.forward_with_cond_scale(x, t.to(torch.float32), classes,
                                                 cond_scale=cond_scale,
                                                 rescaled_phi=rescaled_phi)
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (lambda v: v)
        if self.objective == "pred_noise":
            pred_noise = out
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
            if clip_x_start and rederive_pred_noise:
                pred_noise = self.predict_noise_from_start(x, t, x_start)
        elif self.objective == "pred_x0":
            x_start = clip(out)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # pred_v
            x_start = clip(self.predict_start_from_v(x, t, out))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return ModelPrediction(pred_noise, x_start)

    def p_mean_variance(self, x, t, classes, cond_scale, rescaled_phi, clip_denoised=True):
        preds = self.model_predictions(x, t, classes, cond_scale, rescaled_phi)
        x_start = preds.pred_x_start.clamp(-1.0, 1.0) if clip_denoised else preds.pred_x_start
        mean, var, logvar = self.q_posterior(x_start, x, t)
        return mean, var, logvar, x_start

    def p_sample(self, x, t, classes, cond_scale=6.0, rescaled_phi=0.7, clip_denoised=True,
                 generator=None, noise=None):
        """One ancestral step x_t -> x_{t-1}; ``t`` is a [B] integer tensor."""
        mean, _, logvar, x_start = self.p_mean_variance(x, t, classes, cond_scale,
                                                        rescaled_phi, clip_denoised)
        if noise is None:
            noise = _randn(x.shape, x, generator)
        nonzero = (t > 0).reshape(-1, *((1,) * (x.dim() - 1)))
        img = mean + torch.exp(0.5 * logvar) * noise * nonzero
        return img, x_start

    def _start(self, shape, classes, generator, z):
        if z is not None:
            return z
        return torch.randn(shape, generator=generator, device=classes.device)

    @torch.no_grad()
    def p_sample_loop(self, classes, shape, cond_scale=6.0, rescaled_phi=0.7, generator=None,
                      z=None, noises=None):
        """The full ancestral chain from ``z`` (drawn when not given);
        ``noises[i]`` is step i's noise (step 0 is t = T - 1)."""
        img = self._start(shape, classes, generator, z)
        for i, t in enumerate(range(self.num_timesteps - 1, -1, -1)):
            tb = torch.full((shape[0],), t, dtype=torch.long, device=img.device)
            img, _ = self.p_sample(img, tb, classes, cond_scale, rescaled_phi,
                                   generator=generator,
                                   noise=None if noises is None else noises[i])
        return self.unnormalize(img)

    @torch.no_grad()
    def ddim_sample(self, classes, shape, cond_scale=6.0, rescaled_phi=0.7,
                    clip_denoised=True, generator=None, z=None, noises=None):
        """DDIM over ``sampling_timesteps`` pairs of times; the model runs
        with the default ``rescaled_phi`` (0.7), not the argument."""
        total, S, eta = self.num_timesteps, self.sampling_timesteps, self.ddim_sampling_eta
        times = np.linspace(-1, total - 1, S + 1).astype(int)[::-1]
        img = self._start(shape, classes, generator, z)
        for i, (time, time_next) in enumerate(zip(times[:-1].tolist(), times[1:].tolist())):
            tb = torch.full((shape[0],), time, dtype=torch.long, device=img.device)
            pred_noise, x_start = self.model_predictions(img, tb, classes, cond_scale=cond_scale,
                                                         clip_x_start=clip_denoised)
            noise = _randn(img.shape, img, generator) if noises is None else noises[i]
            if time_next < 0:
                img = x_start
                continue
            alpha = self.alphas_cumprod[time]
            alpha_next = self.alphas_cumprod[time_next]
            sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt(torch.clamp(1 - alpha_next - sigma ** 2, min=0.0))
            img = x_start * torch.sqrt(alpha_next) + c * pred_noise + sigma * noise
        return self.unnormalize(img)

    @torch.no_grad()
    def sample(self, classes, cond_scale=6.0, rescaled_phi=0.7, generator=None):
        shape = (classes.shape[0], self.channels, self.seq_length)
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(classes, shape, cond_scale, rescaled_phi, generator=generator)

    @torch.no_grad()
    def interpolate(self, x1, x2, classes, t=None, lam=0.5, cond_scale=6.0, rescaled_phi=0.7,
                    generator=None, noise1=None, noise2=None, noises=None):
        """Diffuse ``x1`` and ``x2`` to ``t``, blend with ``lam`` and denoise
        from step t - 1 down to 0 (``noises[i]``: step i's noise)."""
        t = self.num_timesteps - 1 if t is None else t
        tb = torch.full((x1.shape[0],), t, dtype=torch.long, device=x1.device)
        xt1 = self.q_sample(x1, tb, _randn(x1.shape, x1, generator) if noise1 is None else noise1)
        xt2 = self.q_sample(x2, tb, _randn(x2.shape, x2, generator) if noise2 is None else noise2)
        img = (1 - lam) * xt1 + lam * xt2
        for n, i in enumerate(range(t - 1, -1, -1)):
            ib = torch.full((x1.shape[0],), i, dtype=torch.long, device=x1.device)
            img, _ = self.p_sample(img, ib, classes, cond_scale, rescaled_phi,
                                   generator=generator,
                                   noise=None if noises is None else noises[n])
        return img

    # -- forward process ------------------------------------------------------
    def q_sample(self, x_start, t, noise):
        nd = x_start.dim()
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_sample_many(self, x_start, t, sample_num, generator=None, noise=None):
        """[B, C, L, S] draws of q(x_t); t = -1 clamps to 0."""
        t = torch.where(t == -1, torch.zeros_like(t), t)
        if noise is None:
            noise = _randn((*x_start.shape, sample_num), x_start, generator)
        nd = x_start.dim()
        a = _extract(self.sqrt_alphas_cumprod, t, nd)[..., None]
        b = _extract(self.sqrt_one_minus_alphas_cumprod, t, nd)[..., None]
        return a * x_start[..., None] + b * noise

    # -- training loss ----------------------------------------------------------
    def p_losses(self, x_start, t, classes, generator=None, noise=None, ps_noise=None,
                 gt_noise=None):
        """The training loss of ``x_start`` (already in [-1, 1]) at steps
        ``t``.  ``noise`` (x_t's), ``ps_noise`` (the guided sample's) and
        ``gt_noise`` ([B, C, L, S], the ground-truth draws) replace the
        draws from ``generator`` when given."""
        if noise is None:
            noise = _randn(x_start.shape, x_start, generator)
        x_t = self.q_sample(x_start, t, noise)
        model_out = self.model(x_t, t.to(torch.float32), classes, generator=generator)
        target = {"pred_noise": noise, "pred_x0": x_start,
                  "pred_v": self.predict_v(x_start, t, noise)}[self.objective]
        mse = ((model_out - target) ** 2).mean(dim=tuple(range(1, x_start.dim())))
        base_loss = (mse * self.loss_weight[t]).mean()
        if self.constraint_loss_type == "NA":
            return base_loss

        # the guided sample of x_{t-1} inside the loss
        x_t_1, _ = self.p_sample(x_t, t, classes, self.constraint_condscale, 0.7,
                                 generator=generator, noise=ps_noise)
        safe_t1 = torch.where(t - 1 == -1, torch.zeros_like(t), t - 1)
        nd = x_start.dim()
        mean_t1 = _extract(self.sqrt_alphas_cumprod, safe_t1, nd) * x_start
        sigma_t1 = _extract(self.sqrt_one_minus_alphas_cumprod, safe_t1, nd)
        lo, hi = mean_t1 - 3 * sigma_t1, mean_t1 + 3 * sigma_t1
        by_sigma = self.normalize_xt_by_mean_sigma == "True"
        if by_sigma:
            x01 = ((x_t_1 - lo) / (hi - lo)).clamp(0.0, 1.0)
        else:
            x01 = (x_t_1.clamp(-1.0, 1.0) + 1.0) / 2.0

        B = x_start.shape[0]
        clt = self.constraint_loss_type
        if clt == "one_over_t":
            viol = self.constraint_fn(x01.reshape(B, -1), classes, 1.0 / (t + 1))
        else:
            S = self.constraint_gt_sample_num
            gt = self.q_sample_many(x_start, t - 1, S, generator=generator, noise=gt_noise)
            if by_sigma:
                gt01 = ((gt - lo[..., None]) / (hi - lo)[..., None]).clamp(0.0, 1.0)
            else:
                gt01 = (gt.clamp(-1.0, 1.0) + 1.0) / 2.0
            gt_flat = torch.movedim(gt01, -1, 1).reshape(B * S, -1)
            classes_rep = torch.repeat_interleave(classes, S, dim=0)
            gt_viol = self.constraint_fn(gt_flat, classes_rep, 1.0).reshape(B, S)
            gt_mean = gt_viol.mean(dim=1)
            gt_std = (gt_viol.std(dim=1, correction=1) if S > 1
                      else torch.ones((B,), dtype=gt_viol.dtype, device=gt_viol.device))
            nn_viol = self.constraint_fn(x01.reshape(B, -1), classes, 1.0)
            if clt == "gt_threshold":
                viol = torch.clamp(nn_viol - gt_mean, min=0.0)
            elif clt == "gt_scaled":
                viol = nn_viol / gt_mean
            elif clt == "gt_std":
                viol = (nn_viol - gt_mean) / gt_std
            elif clt == "gt_std_absolute":
                viol = (nn_viol - gt_mean).abs() / gt_std
            elif clt == "gt_std_threshold":
                viol = torch.clamp(nn_viol - gt_mean, min=0.0) / gt_std
            elif clt == "gt_log_likelihood":
                viol = ((nn_viol - gt_mean) / gt_std) ** 2
            else:
                raise ValueError(f"wrong constraint_loss_type {clt}")

        mask = (t <= self.max_sample_step_with_constraint_loss).to(viol.dtype)
        return base_loss + self.constraint_violation_weight * (viol * mask).mean()

    def forward(self, img, classes, generator=None, t=None, **draws):
        """The training objective: uniform ``t`` (drawn when not given),
        [0, 1] -> [-1, 1], ``p_losses`` (``draws``: its noise tensors)."""
        assert img.shape[-1] == self.seq_length, f"seq length must be {self.seq_length}"
        if t is None:
            t = torch.randint(0, self.num_timesteps, (img.shape[0],), generator=generator,
                              device=img.device)
        return self.p_losses(self.normalize(img), t, classes, generator=generator, **draws)
