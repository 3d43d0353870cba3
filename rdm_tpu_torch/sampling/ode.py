"""Probability-flow ODE sampler.

The Dormand-Prince RK45(4) pair with the PI step-size control of scipy's
RK45 (rtol = atol = 1e-5), the mollifier ``bump`` on the drift near the cube
faces and the inset uniform init.  One step size serves the whole batch: the
error norm is the root mean square over every element of the batch, so the
number of score evaluations depends on the batch.  The time, the step, the
error, the state and the stages are float32 tensors on the sampling device;
the loop reads one flag back to the host per step (has ``t`` reached the
end?).
"""
from __future__ import annotations

import torch

# Dormand-Prince 5(4) Butcher tableau.
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _dopri45(f, t0, t1, y0, rtol, atol, max_steps=20_000):
    """Adaptive RK45 from ``t0`` to ``t1`` (0-d float32 tensors; t1 < t0
    works: signed steps).  Returns (y, nfe)."""
    f32 = dict(dtype=torch.float32, device=y0.device)
    c = torch.tensor(_C, **f32)
    b5 = torch.tensor(_B5, **f32)
    b4 = torch.tensor(_B4, **f32)
    direction = torch.sign(t1 - t0)
    h = direction * torch.abs(t1 - t0) * 0.01

    def err_norm(err, y, ynew):
        scale = atol + torch.maximum(torch.abs(y), torch.abs(ynew)) * rtol
        return torch.sqrt(torch.mean((err / scale) ** 2))

    t, y, nfe = t0, y0, 0
    for _ in range(max_steps):
        # Clip the step to land exactly on t1.
        h = torch.where(direction * (t + h - t1) > 0, t1 - t, h)
        ks = []
        for i in range(7):
            yi = y
            for j, a in enumerate(_A[i]):
                yi = yi + h * a * ks[j]
            ks.append(f(t + c[i] * h, yi))
        y5 = y
        y4 = y
        for i in range(7):
            y5 = y5 + h * b5[i] * ks[i]
            y4 = y4 + h * b4[i] * ks[i]
        err = err_norm(y5 - y4, y, y5)
        accept = err <= 1.0
        t = torch.where(accept, t + h, t)
        y = torch.where(accept, y5, y)
        # PI controller (same exponents as scipy RK45).
        h = h * torch.clamp(0.9 * (err + 1e-10) ** -0.2, 0.2, 10.0)
        nfe += 7
        if bool(torch.abs(t - t1) < 1e-12):
            break
    return y, nfe


def make_bump(moll):
    """Mollifier on the reverse drift near the cube faces:
    exp((-1/(0.25 - (0.5 - x)^2) + 4) / moll), a smooth cutoff that
    vanishes at the faces.  With ``moll=0`` it returns ``x`` itself, so
    the drift is then multiplied by ``x``: it is not undamped."""
    def bump(x):
        if moll > 0:
            inner = 0.5**2 - (0.5 - x) ** 2
            safe = torch.clamp(inner, min=1e-8)
            val = torch.exp((-1.0 / safe + 4.0) / moll)
            return torch.where(inner > 0, val, torch.zeros_like(val))
        return x
    return bump


def get_ode_sampler(sde, shape, rtol=1e-5, atol=1e-5, eps=1e-3,
                    moll=200, side_eps=1e-2):
    """Returns ``ode_sampler(score_fn, generator, denoiser_fn=None, z=None)
    -> (x, nfe)``, the signature of the PC sampler.  ``side_eps`` insets the
    uniform init: ``(1 - 2 side_eps) U + side_eps``; ``z`` replaces it.  A
    ``denoiser_fn`` adds a final stage ``clip(x - denoiser(x, eps), 0, 1)``
    and one evaluation to ``nfe``."""
    B = shape[0]
    bump = make_bump(moll)

    @torch.no_grad()
    def ode_sampler(score_fn, generator, denoiser_fn=None, z=None):
        device = generator.device
        if z is None:
            u = torch.rand(shape, generator=generator, device=device)
            x = (1 - 2 * side_eps) * u + side_eps
        else:
            x = z

        def rhs(t, x):
            vec_t = t.expand(B).to(x.dtype)
            score = score_fn(x, vec_t)
            drift, _ = sde.reverse_sde(x, vec_t, score, probability_flow=True)
            return drift * bump(x)

        f32 = dict(dtype=torch.float32, device=x.device)
        x, nfe = _dopri45(rhs, torch.tensor(sde.T, **f32), torch.tensor(eps, **f32),
                          x, rtol, atol)
        if denoiser_fn is not None:
            vec_eps = torch.full((B,), eps, dtype=x.dtype, device=x.device)
            x = torch.clamp(x - denoiser_fn(x, vec_eps), 0.0, 1.0)
            nfe += 1
        return x, nfe

    return ode_sampler
