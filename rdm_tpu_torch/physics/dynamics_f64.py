"""CR3BP + low-thrust dynamics and the manifold target in float64 (torch).

Counterpart of the JAX package's ``rdm_tpu/physics/dynamics_df.py``.  There
the mixed-precision solver carries every residual in double-float32 (two
float32 words, ~2^-48) because the TPU's vector unit has no fast float64
(``rdm_tpu/ops/df32.py:5-14``).  The H100 computes float64 natively, so the
port's ``precision="df32"`` runs this plain float64 instead: the same RK4,
the same discretisation (COAST_STEPS 32, SEG_STEPS 16, 256 halo and 1024
manifold steps), 2^-52 in place of 2^-48, and no error-free transforms.

* ``ode6``, ``eom``, ``leg``, ``ballistic``: the float32 module's functions
  (``cr3bp.py``, ``manifold.py``) evaluated on float64 tensors;
* ``_ode12`` and ``ballistic_with_tangent``: the ballistic state with the
  first variational equations, the twin of the C++ oracle's ``eom12`` /
  ``propagate12`` (``native/cr3bp_native.cpp``);
* ``manifold_target_from_data``: the end-boundary target from the host's
  float64 halo data, the tangent transported by the variational equations
  (the float32 target transports it with the tangent of the RK4 map).

These are the plain version of the float64 instances of the shooting
kernels (``ops/cr3bp.py``).
"""
from __future__ import annotations

import torch

from . import manifold
from .cr3bp import CR3BP_MU, eom, leg  # noqa: F401  (the f64 dynamics' API)

ode6 = manifold._ode6
ballistic = manifold.propagate_ballistic


def _ode12(sv, mu=CR3BP_MU):
    """Ballistic CR3BP + first variational equations on [..., 12] states
    [x y z vx vy vz | dx dy dz dvx dvy dvz]: the tangent evolves with
    d(dv)/dt = U(x) dx + C dv, U the Hessian of the gravity part and C the
    Coriolis coupling."""
    s, d = sv[..., :6], sv[..., 6:]
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    dx, dy, dz, dvx, dvy, dvz = (d[..., i] for i in range(6))
    ds = ode6(s, mu)
    yz2 = y * y + z * z

    def grav_var(ux, m):
        # d(acc) . delta = -m/r^3 delta + 3 m (u . delta) u / r^5, u = (ux, y, z)
        r2 = ux * ux + yz2
        r = torch.sqrt(r2)
        ir3 = m / (r * r2)
        ir5_3 = (3.0 * m) / ((r * r2) * r2)
        c = ir5_3 * (ux * dx + y * dy + z * dz)
        return c * ux - ir3 * dx, c * y - ir3 * dy, c * z - ir3 * dz

    g1 = grav_var(x + mu, 1.0 - mu)
    g2 = grav_var(x + (mu - 1.0), mu)
    # centrifugal (+dx, +dy, 0) and Coriolis (+2 dvy, -2 dvx, 0)
    ddvx = g1[0] + g2[0] + dx + 2.0 * dvy
    ddvy = g1[1] + g2[1] + dy - 2.0 * dvx
    ddvz = g1[2] + g2[2]
    return torch.cat([ds, torch.stack([dvx, dvy, dvz, ddvx, ddvy, ddvz], dim=-1)], dim=-1)


def ballistic_with_tangent(s0, v0, tof, n_steps: int):
    """State [..., 6] and tangent [..., 6] through the augmented 12-dim RK4
    (the stencil of the state alone)."""
    dt = manifold._step_dt(tof, n_steps)
    sv = torch.cat([s0, v0], dim=-1)
    for _ in range(n_steps):
        sv = manifold._rk4(_ode12, sv, dt)
    return sv[..., :6], sv[..., 6:]


def manifold_target_from_data(state0, period, vstable, tau_frac, length,
                              n_halo_steps: int = manifold.N_HALO_STEPS,
                              n_manifold_steps: int = manifold.N_MANIFOLD_STEPS,
                              manifold_eps: float = manifold.MANIFOLD_EPS):
    """float64 end state [..., 6] of the StableLeft manifold arc from the
    host's float64 halo data: seed state [..., 6], period [...], stable
    eigenvector [..., 6]; phase fraction ``tau_frac`` and arc length
    ``length`` [...]."""
    tau = torch.clamp(tau_frac, 0.0, 1.0) * period
    x_tau, v_tau = ballistic_with_tangent(state0, vstable, tau, n_halo_steps)
    v_hat = v_tau / (torch.sqrt(torch.sum(v_tau * v_tau, dim=-1, keepdim=True)) + 1e-30)
    seed = x_tau + manifold_eps * v_hat
    return ballistic(seed, -length, n_manifold_steps)
