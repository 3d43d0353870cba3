"""Stable-manifold boundary targets in float32 (torch).

The warm-start NLP ends on the StableLeft stable-manifold arc of the L1 halo
at E_L1 + alpha, parametrised by the departure phase along the orbit (the
sample's halo-period variable, a fraction of the period) and the arc length
in time units (the sample's manifold-length variable).  This module computes
a point of that set, batched over leading dimensions:

1. interpolate the halo family table (``physics/_halo_family_l1.npz``) at the
   sample's energy offset ``alpha`` in float32: seed state, period, stable
   eigenvector (``interp_seed``);
2. propagate the seed ballistically to phase ``tau = tau_frac * T``,
   transporting the stable eigenvector with the exact tangent of the
   discrete RK4 map (a jvp of each step, ``propagate_with_tangent``);
3. step ``MANIFOLD_EPS`` along the transported, renormalised direction and
   integrate BACKWARD for ``L`` time units: the manifold arc.

Counterpart of the JAX package's ``rdm_tpu/physics/manifold.py:40-167``.
These functions are the plain version of the float32 instance of the
``manifold_target`` kernel (``ops/cr3bp.py``); ``manifold_target_batch`` is
the batched entry point, on the card unless the caller names the CPU.  The
float64 target of the f64 solver (variational equations, not the tangent of
the RK4 map) is ``dynamics_f64.manifold_target_from_data``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import halo as _halo
from .cr3bp import CR3BP_MU

# Fixed step counts, one for every sample.
N_HALO_STEPS = 256       # seed -> phase tau (tau <= T ~ 2.8 TU)
N_MANIFOLD_STEPS = 1024  # backward arc, L in [5, 11] TU
MANIFOLD_EPS = _halo.MANIFOLD_EPS

_TABLES = {}


def _table(device) -> dict:
    """The halo family table as float32 tensors on ``device`` (cached)."""
    key = str(torch.device(device))
    if key not in _TABLES:
        t = _halo.family_table()
        _TABLES[key] = {k: torch.as_tensor(np.asarray(t[k], np.float32), device=device)
                        for k in ("alphas", "states", "periods", "vstable")}
    return _TABLES[key]


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for x [...] inside [xp[0], xp[-1]] and fp
    [n] or [n, k]: the same float32 operations, batched."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    if fp.dim() == 2:
        i_, x_ = i[..., None], x[..., None]
        lo, hi = fp[i - 1], fp[i]
        xlo, dx = xp[i_ - 1], xp[i_] - xp[i_ - 1]
    else:
        i_, x_ = i, x
        lo, hi = fp[i - 1], fp[i]
        xlo, dx = xp[i - 1], xp[i] - xp[i - 1]
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    return torch.where(dx0, lo, lo + ((x_ - xlo) / torch.where(dx0, 1.0, dx)) * (hi - lo))


def interp_seed(alpha):
    """float32 family interpolation at energy offsets ``alpha`` [...] (a
    float32 tensor): (state0 [..., 6], period [...], vstable [..., 6]), the
    eigenvector normalised.  Counterpart of ``manifold.interp_seed_jnp``."""
    t = _table(alpha.device)
    a = torch.clamp(alpha, t["alphas"][0], t["alphas"][-1])
    state0 = _interp(a, t["alphas"], t["states"])
    period = _interp(a, t["alphas"], t["periods"])
    vs = _interp(a, t["alphas"], t["vstable"])
    vs = vs / torch.sqrt(torch.sum(vs * vs, dim=-1, keepdim=True))
    return state0, period, vs


def ode6_c(s, mu=CR3BP_MU):
    """The ballistic field on a 6-tuple of components (tensors or the dual
    numbers of ``dual.py``)."""
    x, y, z, vx, vy, vz = s
    r1 = ((x + mu) ** 2 + y * y + z * z).sqrt()
    r2 = ((x - 1 + mu) ** 2 + y * y + z * z).sqrt()
    r13, r23 = r1 ** 3, r2 ** 3
    ax = x - (1 - mu) * (x + mu) / r13 - mu * (x - 1 + mu) / r23 + 2 * vy
    ay = y - (1 - mu) * y / r13 - mu * y / r23 - 2 * vx
    az = -(1 - mu) * z / r13 - mu * z / r23
    return (vx, vy, vz, ax, ay, az)


def _ode6(s, mu=CR3BP_MU):
    """Ballistic CR3BP vector field on [..., 6] states [x y z vx vy vz]."""
    return torch.stack(ode6_c(s.unbind(-1), mu), dim=-1)


def _rk4(f, s, dt):
    k1 = f(s)
    k2 = f(s + 0.5 * dt * k1)
    k3 = f(s + 0.5 * dt * k2)
    k4 = f(s + dt * k3)
    return s + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _step_dt(tof, n_steps: int):
    """dt of a fixed-step propagation, shaped to broadcast against [..., 6]."""
    dt = tof / n_steps
    return dt[..., None] if torch.is_tensor(dt) and dt.dim() else dt


def propagate_ballistic(s0, tof, n_steps: int):
    """Fixed-step RK4 ballistic propagation of [..., 6] states; ``tof``
    ([...] or a float) may be negative."""
    dt = _step_dt(tof, n_steps)
    s = s0
    for _ in range(n_steps):
        s = _rk4(_ode6, s, dt)
    return s


def propagate_with_tangent(s0, v0, tof, n_steps: int):
    """Propagate a state AND a tangent vector: v evolves with the exact
    derivative of the discrete RK4 map (each step on dual numbers: the jvp
    of the JAX package), i.e. the variational equations integrated at the
    same order."""
    from .dual import Dual, rk4_c

    dt = tof / n_steps
    s = tuple(Dual(s0[..., i], v0[..., i]) for i in range(6))
    for _ in range(n_steps):
        s = rk4_c(ode6_c, s, dt)
    return torch.stack([c.v for c in s], dim=-1), torch.stack([c.d for c in s], dim=-1)


def manifold_target_from_data(state0, period, vs, tau_frac, length,
                              n_halo_steps: int = N_HALO_STEPS,
                              n_manifold_steps: int = N_MANIFOLD_STEPS):
    """End state [..., 6] of the manifold arc from pre-interpolated family
    data (seed state [..., 6], period [...], stable eigenvector [..., 6]),
    at phase fraction ``tau_frac`` [...] and arc length ``length`` [...]."""
    zero, one = tau_frac.new_zeros(()), tau_frac.new_ones(())
    tau = torch.minimum(torch.maximum(tau_frac, zero), one) * period
    x_tau, v_tau = propagate_with_tangent(state0, vs, tau, n_halo_steps)
    v_tau = v_tau / (torch.sqrt(torch.sum(v_tau * v_tau, dim=-1, keepdim=True)) + 1e-30)
    seed = x_tau + np.float32(MANIFOLD_EPS) * v_tau
    return propagate_ballistic(seed, -length, n_manifold_steps)


def manifold_target(alpha, tau_frac, length,
                    n_halo_steps: int = N_HALO_STEPS,
                    n_manifold_steps: int = N_MANIFOLD_STEPS):
    """End state (6-vector) of the StableLeft manifold arc of the L1 halo at
    energy ``E_L1 + alpha``, departing at orbit phase ``tau_frac`` and
    integrated backward for ``length`` time units; float32 tensors of equal
    shape [...]."""
    state0, period, vs = interp_seed(alpha)
    return manifold_target_from_data(state0, period, vs, tau_frac, length,
                                     n_halo_steps, n_manifold_steps)


def manifold_target_batch(alphas, tau_fracs, lengths, device=None):
    """Manifold targets [N, 6] (float32) of [N] parameter triples, through
    the ``manifold_target`` kernel on the card unless ``device`` names the
    CPU (where its plain version runs)."""
    from ..device import resolve_device
    from ..ops import cr3bp as shoot_ops

    dev = resolve_device(device)
    a, t, L = (torch.as_tensor(np.asarray(v, np.float32), device=dev)
               for v in (alphas, tau_fracs, lengths))
    state0, period, vs = interp_seed(a)
    return shoot_ops.manifold_target(state0, period, vs, t, L)
