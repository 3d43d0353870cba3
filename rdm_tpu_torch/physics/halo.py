"""L1 halo orbit family (f64, host) and stable-manifold seed data.

The oracle grades a warm start against the StableLeft stable-manifold arc
of the L1 halo at E_L1 + alpha.  This module gives, per energy offset
alpha, the halo's perpendicular-crossing state, its period (which
normalises the sampled halo-period variable) and the stable eigenvector
of its monodromy matrix:

* ``richardson_seed(Az)``: third-order Richardson (1980) analytic
  approximation of the L1 halo, used only to seed the corrector;
* ``solve_halo(seed, energy)`` / ``solve_halo_unconstrained(z0)``: f64
  differential correction of the perpendicular x-z plane crossing;
* ``monodromy(...)`` / ``stable_eigvec(...)``: the state-transition matrix
  over one period and its contracting eigenvector;
* ``family_table()``: the family over [0.0075, 0.095], read from this
  package's ``_halo_family_l1.npz`` (a copy of the JAX package's table;
  ``rebuild=True`` solves it again with scipy, about a minute);
* ``interp_seed(alpha)``: f64 interpolation of the table, the one source
  the native oracle reads.

Everything here is host-side float64 numpy (scipy only to rebuild the
table or integrate an orbit).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Tuple

import numpy as np
from scipy.integrate import solve_ivp

from .cr3bp import CR3BP_MU, l1_position

_HERE = os.path.dirname(os.path.abspath(__file__))
_TABLE_PATH = os.path.join(_HERE, "_halo_family_l1.npz")

# The benchmark's halo-energy window (cost_alpha in [0.008, 0.095],
# sample_data_diffusion_boundary.py:98-99).  The L1 halo family bifurcates
# from the planar Lyapunov family at alpha ~ 0.0070 (measured by driving
# the Richardson amplitude Az -> 0 through the corrector), so the low pad
# stops just above the bifurcation.  At the high end alpha(z0) FOLDS: the
# classical branch's energy peaks at alpha ~ 0.09525 (z0 ~ 0.190), drops
# to ~ 0.0922 (z0 ~ 0.207) and rises again toward the near-rectilinear
# regime, so energies in (0.0922, 0.0952) have three coexisting halos.
# This table parametrises the CLASSICAL branch only (z0 below the fold) —
# the reference's own sampling window capping at 0.095, right under that
# fold, indicates pydylan's solver lives on the same branch.  Queries are
# clamped to [ALPHA_MIN, ALPHA_MAX].
ALPHA_MIN, ALPHA_MAX = 0.0075, 0.0950

# Stable-manifold globalisation step: the arc seed is x_halo(tau) +
# MANIFOLD_EPS * v_stable(tau).  pydylan's internal magnitude is not
# observable from this image; 1e-4 DU (~38 km) is the standard order used
# for Earth-Moon manifold globalisation and sits comfortably above f32
# round-off for the on-device backend.  Every consumer (datagen, C++
# oracle, TPU oracle) uses this one constant, so grading is self-
# consistent.
MANIFOLD_EPS = 1e-4

_lock = threading.Lock()
_table_cache: Dict[str, np.ndarray] = {}


# --------------------------------------------------------------------------
# f64 ballistic CR3BP + variational equations (host, scipy)

def _eom(t, s, mu=CR3BP_MU):
    x, y, z, vx, vy, vz = s
    r1 = np.sqrt((x + mu) ** 2 + y * y + z * z)
    r2 = np.sqrt((x - 1 + mu) ** 2 + y * y + z * z)
    r13, r23 = r1 ** 3, r2 ** 3
    ax = x - (1 - mu) * (x + mu) / r13 - mu * (x - 1 + mu) / r23 + 2 * vy
    ay = y - (1 - mu) * y / r13 - mu * y / r23 - 2 * vx
    az = -(1 - mu) * z / r13 - mu * z / r23
    return [vx, vy, vz, ax, ay, az]


def _uxx(pos, mu=CR3BP_MU):
    """Hessian of the effective potential Omega (for the variational eqs)."""
    x, y, z = pos
    r1v = np.array([x + mu, y, z])
    r2v = np.array([x - 1 + mu, y, z])
    r1, r2 = np.linalg.norm(r1v), np.linalg.norm(r2v)
    I = np.eye(3)
    H = np.diag([1.0, 1.0, 0.0])
    H = H - (1 - mu) * (I / r1 ** 3 - 3 * np.outer(r1v, r1v) / r1 ** 5)
    H = H - mu * (I / r2 ** 3 - 3 * np.outer(r2v, r2v) / r2 ** 5)
    return H


def _eom_stm(t, y, mu=CR3BP_MU):
    s = y[:6]
    phi = y[6:].reshape(6, 6)
    ds = _eom(t, s, mu)
    A = np.zeros((6, 6))
    A[:3, 3:] = np.eye(3)
    A[3:, :3] = _uxx(s[:3], mu)
    A[3, 4], A[4, 3] = 2.0, -2.0
    dphi = A @ phi
    return np.concatenate([ds, dphi.reshape(-1)])


def propagate_f64(s0, tof, rtol=1e-12, atol=1e-12, mu=CR3BP_MU):
    sol = solve_ivp(_eom, (0.0, tof), np.asarray(s0, float), method="DOP853",
                    rtol=rtol, atol=atol, args=(mu,))
    return sol.y[:, -1]


def energy_f64(s, mu=CR3BP_MU):
    x, y, z, vx, vy, vz = s
    r1 = np.sqrt((x + mu) ** 2 + y * y + z * z)
    r2 = np.sqrt((x - 1 + mu) ** 2 + y * y + z * z)
    omega = 0.5 * (x * x + y * y) + (1 - mu) / r1 + mu / r2
    return 0.5 * (vx * vx + vy * vy + vz * vz) - omega


def _half_crossing(s0, t_max=6.0, mu=CR3BP_MU):
    """Integrate to the next y=0 crossing (the half-period event of a
    perpendicular-crossing periodic orbit).  Returns (state, t_cross)."""
    direction = -1.0 if s0[4] > 0 else 1.0

    def ev(t, s, *_):
        return s[1]

    ev.terminal = True
    ev.direction = direction
    sol = solve_ivp(_eom, (0.0, t_max), np.asarray(s0, float),
                    method="DOP853", rtol=1e-12, atol=1e-12, args=(mu,),
                    events=ev)
    if not len(sol.t_events[0]):
        raise RuntimeError("no y=0 crossing found")
    return sol.y_events[0][0], sol.t_events[0][0]


def _half_crossing_stm(s0, t_max=6.0, mu=CR3BP_MU):
    """Half crossing with the state-transition matrix: (state, t, Phi)."""
    direction = -1.0 if s0[4] > 0 else 1.0

    def ev(t, y, *_):
        return y[1]

    ev.terminal = True
    ev.direction = direction
    y0 = np.concatenate([np.asarray(s0, float), np.eye(6).reshape(-1)])
    sol = solve_ivp(_eom_stm, (0.0, t_max), y0, method="DOP853",
                    rtol=1e-12, atol=1e-12, args=(mu,), events=ev)
    if not len(sol.t_events[0]):
        raise RuntimeError("no y=0 crossing found")
    ye = sol.y_events[0][0]
    return ye[:6], sol.t_events[0][0], ye[6:].reshape(6, 6)


# --------------------------------------------------------------------------
# Richardson third-order seed (Richardson 1980, L1 collinear point)

def _gamma_l1(mu=CR3BP_MU, iters=80):
    """Distance from the secondary to L1 (quintic root), normalised."""
    g = (mu / 3.0) ** (1.0 / 3.0)
    for _ in range(iters):
        f = g ** 5 - (3 - mu) * g ** 4 + (3 - 2 * mu) * g ** 3 \
            - mu * g ** 2 + 2 * mu * g - mu
        df = 5 * g ** 4 - 4 * (3 - mu) * g ** 3 + 3 * (3 - 2 * mu) * g ** 2 \
            - 2 * mu * g + 2 * mu
        g -= f / df
    return g


def richardson_seed(Az: float, northern: bool = True,
                    mu: float = CR3BP_MU) -> Tuple[np.ndarray, float]:
    """Third-order analytic L1 halo: initial perpendicular-crossing state
    [x0, 0, z0, 0, vy0, 0] and period estimate.  ``Az`` is the out-of-plane
    amplitude in gamma-normalised (L1-centred) units."""
    g = _gamma_l1(mu)

    def c(n):
        return (mu + (-1) ** n * (1 - mu) * g ** (n + 1) / (1 - g) ** (n + 1)) / g ** 3

    c2, c3, c4 = c(2), c(3), c(4)
    lam = np.sqrt(((2 - c2) + np.sqrt((c2 - 2) ** 2 + 4 * (c2 - 1) * (1 + 2 * c2))) / 2.0)
    k = 2 * lam / (lam ** 2 + 1 - c2)
    Delta = lam ** 2 - c2

    d1 = 3 * lam ** 2 / k * (k * (6 * lam ** 2 - 1) - 2 * lam)
    d2 = 8 * lam ** 2 / k * (k * (11 * lam ** 2 - 1) - 2 * lam)

    a21 = 3 * c3 * (k ** 2 - 2) / (4 * (1 + 2 * c2))
    a22 = 3 * c3 / (4 * (1 + 2 * c2))
    a23 = -3 * c3 * lam / (4 * k * d1) * (3 * k ** 3 * lam - 6 * k * (k - lam) + 4)
    a24 = -3 * c3 * lam / (4 * k * d1) * (2 + 3 * k * lam)
    b21 = -3 * c3 * lam / (2 * d1) * (3 * k * lam - 4)
    b22 = 3 * c3 * lam / d1
    d21 = -c3 / (2 * lam ** 2)

    a31 = (-9 * lam / (4 * d2) * (4 * c3 * (k * a23 - b21) + k * c4 * (4 + k ** 2))
           + (9 * lam ** 2 + 1 - c2) / (2 * d2)
           * (3 * c3 * (2 * a23 - k * b21) + c4 * (2 + 3 * k ** 2)))
    a32 = (-1 / d2 * (9 * lam / 4 * (4 * c3 * (k * a24 - b22) + k * c4)
                      + 1.5 * (9 * lam ** 2 + 1 - c2)
                      * (c3 * (k * b22 + d21 - 2 * a24) - c4)))
    b31 = (3 / (8 * d2)
           * (8 * lam * (3 * c3 * (k * b21 - 2 * a23) - c4 * (2 + 3 * k ** 2))
              + (9 * lam ** 2 + 1 + 2 * c2)
              * (4 * c3 * (k * a23 - b21) + k * c4 * (4 + k ** 2))))
    b32 = (1 / d2 * (9 * lam * (c3 * (k * b22 + d21 - 2 * a24) - c4)
                     + 3 / 8 * (9 * lam ** 2 + 1 + 2 * c2)
                     * (4 * c3 * (k * a24 - b22) + k * c4)))
    d31 = 3 / (64 * lam ** 2) * (4 * c3 * a24 + c4)
    d32 = 3 / (64 * lam ** 2) * (4 * c3 * (a23 - d21) + c4 * (4 + k ** 2))

    denom = 2 * lam * (lam * (1 + k ** 2) - 2 * k)
    s1 = (1.5 * c3 * (2 * a21 * (k ** 2 - 2) - a23 * (k ** 2 + 2) - 2 * k * b21)
          - 3 / 8 * c4 * (3 * k ** 4 - 8 * k ** 2 + 8)) / denom
    s2 = (1.5 * c3 * (2 * a22 * (k ** 2 - 2) + a24 * (k ** 2 + 2)
                      + 2 * k * b22 + 5 * d21)
          + 3 / 8 * c4 * (12 - k ** 2)) / denom
    a1 = -1.5 * c3 * (2 * a21 + a23 + 5 * d21) - 3 / 8 * c4 * (12 - k ** 2)
    a2 = 1.5 * c3 * (a24 - 2 * a22) + 9 / 8 * c4
    l1c = a1 + 2 * lam ** 2 * s1
    l2c = a2 + 2 * lam ** 2 * s2

    Ax2 = (-Delta - l2c * Az ** 2) / l1c
    if Ax2 <= 0:
        raise ValueError(f"Az={Az} below the halo bifurcation amplitude")
    Ax = np.sqrt(Ax2)

    dn = 1.0 if northern else -1.0
    om = 1 + s1 * Ax ** 2 + s2 * Az ** 2
    # tau1 = 0 phase: cos terms at 1, sin terms at 0 -> perpendicular crossing
    x = a21 * Ax ** 2 + a22 * Az ** 2 - Ax + (a23 * Ax ** 2 - a24 * Az ** 2) \
        + (a31 * Ax ** 3 - a32 * Ax * Az ** 2)
    z = dn * (Az + d21 * Ax * Az * (1 - 3) + (d32 * Az * Ax ** 2 - d31 * Az ** 3))
    # d/dt at tau1=0 (sin terms' derivatives): ydot = lam*om*(k*Ax + 2*(b21*Ax^2
    # - b22*Az^2) + 3*(b31*Ax^3 - b32*Ax*Az^2)); xdot = zdot = 0
    ydot = lam * om * (k * Ax + 2 * (b21 * Ax ** 2 - b22 * Az ** 2)
                       + 3 * (b31 * Ax ** 3 - b32 * Ax * Az ** 2))

    x_l1 = l1_position(mu)
    s0 = np.array([x_l1 + g * x, 0.0, g * z, 0.0, g * ydot, 0.0])
    period = 2 * np.pi / (lam * om)
    return s0, period


# --------------------------------------------------------------------------
# Differential correction

def solve_halo_unconstrained(seed: np.ndarray, max_iters: int = 25,
                             tol: float = 1e-9, mu: float = CR3BP_MU):
    """Fix z0; Newton on (x0, vy0) so vx=vz=0 at the half crossing."""
    s = np.asarray(seed, float).copy()
    for _ in range(max_iters):
        sc, th = _half_crossing(s, mu=mu)
        F = np.array([sc[3], sc[5]])
        if np.linalg.norm(F) < tol:
            return s, 2 * th
        J = np.zeros((2, 2))
        for j, idx in enumerate((0, 4)):
            h = 1e-7
            sp = s.copy()
            sp[idx] += h
            scp, _ = _half_crossing(sp, mu=mu)
            J[:, j] = (np.array([scp[3], scp[5]]) - F) / h
        d = np.linalg.solve(J, -F)
        s[0] += d[0]
        s[4] += d[1]
    raise RuntimeError(f"halo corrector (unconstrained) stalled, |F|={np.linalg.norm(F):.2e}")


def solve_halo(seed: np.ndarray, e_target: float, max_iters: int = 30,
               tol: float = 1e-9, accept_tol: float = 1e-6,
               mu: float = CR3BP_MU):
    """Newton on (x0, z0, vy0): vx=vz=0 at the half crossing AND
    E(s0) = e_target.  Returns (state0, period).

    The Jacobian is exact (state-transition matrix with the standard
    crossing-time correction dt*/du = -Phi_y/vy_c, plus the analytic
    energy gradient), so Newton converges quadratically even at the
    family's sensitive high-energy end; ``accept_tol`` guards event
    round-off (1e-6 perpendicularity is far inside the f32 resolution of
    the on-device consumers)."""
    s = np.asarray(seed, float).copy()
    best, best_norm, best_T = None, np.inf, None
    for _ in range(max_iters):
        sc, th, phi = _half_crossing_stm(s, mu=mu)
        F = np.array([sc[3], sc[5], energy_f64(s, mu) - e_target])
        n = np.linalg.norm(F)
        if n < best_norm:
            best, best_norm, best_T = s.copy(), n, 2 * th
        if n < tol:
            return s, 2 * th
        dsc = np.asarray(_eom(th, sc, mu))       # crossing-state time derivative
        cols = (0, 2, 4)                          # free vars: x0, z0, vy0
        J = np.zeros((3, 3))
        for j, idx in enumerate(cols):
            dt_du = -phi[1, idx] / dsc[1]         # keep y(t*) = 0
            J[0, j] = phi[3, idx] + dsc[3] * dt_du
            J[1, j] = phi[5, idx] + dsc[5] * dt_du
        # dE/du analytically: E = v^2/2 - Omega(pos)
        x, _, z = s[0], s[1], s[2]
        r1 = np.sqrt((x + mu) ** 2 + z * z)
        r2 = np.sqrt((x - 1 + mu) ** 2 + z * z)
        dOm_dx = x - (1 - mu) * (x + mu) / r1 ** 3 - mu * (x - 1 + mu) / r2 ** 3
        dOm_dz = -(1 - mu) * z / r1 ** 3 - mu * z / r2 ** 3
        J[2] = [-dOm_dx, -dOm_dz, s[4]]
        try:
            d = np.linalg.solve(J, -F)
        except np.linalg.LinAlgError:
            break
        s[0] += d[0]
        s[2] += d[1]
        s[4] += d[2]
    if best_norm < accept_tol:
        return best, best_T
    raise RuntimeError(f"halo corrector (energy) stalled, |F|={best_norm:.2e}")


def monodromy(s0: np.ndarray, period: float, mu: float = CR3BP_MU) -> np.ndarray:
    """State-transition matrix over one period."""
    y0 = np.concatenate([np.asarray(s0, float), np.eye(6).reshape(-1)])
    sol = solve_ivp(_eom_stm, (0.0, period), y0, method="DOP853",
                    rtol=1e-12, atol=1e-12, args=(mu,))
    return sol.y[6:, -1].reshape(6, 6)


def stable_eigvec(M: np.ndarray) -> np.ndarray:
    """Real contracting eigenvector of the monodromy matrix (|lambda| < 1),
    normalised.  Halo monodromies have the spectrum
    {lam_u, 1/lam_u, 1, 1, exp(+-i theta)}; the stable direction is the
    real eigenvalue of smallest magnitude."""
    w, V = np.linalg.eig(M)
    real = np.abs(w.imag) < 1e-6 * np.abs(w.real)
    idx = np.argmin(np.where(real, np.abs(w), np.inf))
    v = V[:, idx].real
    return v / np.linalg.norm(v)


# --------------------------------------------------------------------------
# Family table

def _build_family(alphas: np.ndarray, mu: float = CR3BP_MU,
                  verbose: bool = False) -> Dict[str, np.ndarray]:
    """Solve the family by z0-continuation + per-energy secant refinement.

    Energy-constrained Newton on (x0, z0, vy0) can silently slide onto the
    coexisting planar Lyapunov branch (z0 -> 0 satisfies every constraint),
    which was observed mid-family.  The out-of-plane amplitude z0 is a
    monotone, fold-free parameter over the benchmark's whole energy window
    (alpha(z0) measured monotone through 0.115), so instead: (1) walk the
    family upward in z0 with the fixed-z0 corrector — which cannot leave
    the halo branch — then (2) hit each target energy exactly by a secant
    iteration on z0."""
    x_l1 = l1_position(mu)
    e_l1 = energy_f64([x_l1, 0, 0, 0, 0, 0], mu)

    def at_z0(seed, z0):
        s = seed.copy()
        s[2] = z0
        s, T = solve_halo_unconstrained(s, mu=mu)
        return s, T, energy_f64(s, mu) - e_l1

    # Phase 1: z0 walk from just above the bifurcation until the energy
    # window is covered or the classical branch's energy fold is reached
    # (alpha starts decreasing): stay strictly on the pre-fold branch so
    # the energy -> orbit map is single-valued.
    s0, _ = richardson_seed(0.05, mu=mu)
    s, T = solve_halo_unconstrained(s0, mu=mu)
    walk = [(s.copy(), T, energy_f64(s, mu) - e_l1)]
    z0 = s[2]
    step = 2e-3
    while walk[-1][2] <= alphas[-1] + 1e-4:
        z0 += step
        s, T, a = at_z0(walk[-1][0], z0)
        if a <= walk[-1][2]:          # crossed the fold: refine toward it
            if step < 1e-5:
                raise RuntimeError(
                    f"halo family fold at alpha={walk[-1][2]:.5f} below the "
                    f"requested table top {alphas[-1]:.5f}")
            z0 -= step
            step *= 0.25
            continue
        walk.append((s.copy(), T, a))
    walk_alphas = np.array([w[2] for w in walk])

    states = np.zeros((len(alphas), 6))
    periods = np.zeros(len(alphas))
    vstable = np.zeros((len(alphas), 6))
    lam_u = np.zeros(len(alphas))

    for i, a in enumerate(alphas):
        j = int(np.argmin(np.abs(walk_alphas - a)))
        s_a, T_a, al_a = walk[j]
        s_a = s_a.copy()
        k = j + 1 if j + 1 < len(walk) else j - 1
        z_b, al_b = walk[k][0][2], walk[k][2]
        z_a = s_a[2]
        z_lo, z_hi = walk[0][0][2], walk[-1][0][2]
        for _ in range(60):
            if abs(al_a - a) < 1e-10:
                break
            z_new = z_a + (a - al_a) * (z_b - z_a) / (al_b - al_a)
            # stay inside the walked (pre-fold) z0 range: an overshoot past
            # the fold would converge onto a different branch
            z_new = min(max(z_new, z_lo), z_hi)
            s_new, T_new, al_new = at_z0(s_a, z_new)
            z_b, al_b = z_a, al_a
            s_a, T_a, z_a, al_a = s_new, T_new, z_new, al_new
        states[i] = s_a
        periods[i] = T_a
        M = monodromy(s_a, T_a, mu=mu)
        v = stable_eigvec(M)
        w = np.linalg.eigvals(M)
        lam_u[i] = np.max(np.abs(w))
        # Pick the interior (Earth-side) manifold branch — pydylan's
        # StableLeft (...warmstart.py:155): of the two branches +-eps*v,
        # keep the one whose backward arc departs toward smaller x than
        # the orbit itself over a short horizon (before the interior
        # dynamics scrambles endpoint geometry).
        ref = propagate_f64(s_a, -2.0, mu=mu)
        dep = propagate_f64(s_a + MANIFOLD_EPS * v, -2.0, mu=mu)
        if dep[0] - ref[0] > 0:
            v = -v
        vstable[i] = v
        if verbose:
            print(f"alpha={a:.4f}  x0={s_a[0]:.6f} z0={s_a[2]:.6f} "
                  f"vy0={s_a[4]:.6f} T={T_a:.6f} |lam_u|={lam_u[i]:.1f}")

    return {"alphas": alphas, "states": states, "periods": periods,
            "vstable": vstable, "lam_u": lam_u,
            "e_l1": np.float64(e_l1), "mu": np.float64(mu),
            "x_l1": np.float64(x_l1)}


def family_table(rebuild: bool = False, verbose: bool = False) -> Dict[str, np.ndarray]:
    """The L1 halo family over [ALPHA_MIN, ALPHA_MAX]: read from
    ``_halo_family_l1.npz`` next to this module and memoised per process;
    ``rebuild=True`` solves it again (about a minute of host f64
    integration) and rewrites the file.
    """
    with _lock:
        if _table_cache and not rebuild:
            return _table_cache
        if os.path.exists(_TABLE_PATH) and not rebuild:
            with np.load(_TABLE_PATH) as z:
                _table_cache.update({k: z[k] for k in z.files})
            return _table_cache
        # denser near the top: d(state)/d(alpha) grows toward the energy
        # fold (d alpha/d z0 -> 0), so uniform-in-alpha spacing would
        # under-resolve exactly where interpolation needs help
        alphas = np.concatenate([
            np.linspace(ALPHA_MIN, 0.0900, 76, endpoint=False),
            np.linspace(0.0900, ALPHA_MAX, 24),
        ])
        table = _build_family(alphas, verbose=verbose)
        tmp = _TABLE_PATH + f".tmp{os.getpid()}.npz"  # savez appends .npz
        np.savez(tmp, **table)
        os.replace(tmp, _TABLE_PATH)
        _table_cache.clear()
        _table_cache.update(table)
        return _table_cache


def interp_seed(alpha) -> Dict[str, np.ndarray]:
    """f64 family interpolation at energy offset(s) ``alpha``: dict of
    ``state0`` [..., 6], ``period`` [...], ``vstable`` [..., 6].

    Linear interpolation over a 96-point grid: the family varies smoothly
    (curvature-limited error ~1e-6 in the seed state), and the corrector
    tolerance pins the grid points themselves to 1e-11."""
    t = family_table()
    a = np.clip(np.asarray(alpha, float), t["alphas"][0], t["alphas"][-1])
    out_state = np.stack([np.interp(a, t["alphas"], t["states"][:, j])
                          for j in range(6)], axis=-1)
    period = np.interp(a, t["alphas"], t["periods"])
    vs = np.stack([np.interp(a, t["alphas"], t["vstable"][:, j])
                   for j in range(6)], axis=-1)
    vs = vs / np.linalg.norm(vs, axis=-1, keepdims=True)
    return {"state0": out_state, "period": period, "vstable": vs}


def get_halo_period_exact(alpha: float) -> float:
    """Orbit period of the L1 halo at E_L1 + alpha (the quantity pydylan's
    ``halo.orbit_period`` provides in the reference, used to un/normalise
    the sampled halo-period variable)."""
    return float(interp_seed(float(alpha))["period"])
