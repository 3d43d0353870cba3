"""Earth-Moon CR3BP: the constants, states and energies the evaluation path
needs.

* the constants, nondimensionalised in Earth-Moon units;
* classical-orbital-elements -> state conversion (``coe2rv``) and the GTO
  departure state (a = 24510 km, e = 0.7234..., i = 15 deg, apoapsis);
* the x-coordinate of L1 and the CR3BP energy (torch);
* the rotating-frame equations of motion with low-thrust acceleration and
  mass flow (``eom``), one fixed-step RK4 step (``_rk4_step``), a
  constant-control arc (``propagate``) and a flat RK4 scan over per-step
  controls (``leg``): plain torch, batched over leading dimensions, in the
  device and dtype of the tensors they are given (the JAX package's
  ``physics/cr3bp.py:96-160`` and ``solver_tpu._leg``);
* the tangential-thrust spiral from the GTO state to the shooting phase's
  start boundary, on the host.

The shooting kernels of ``ops/cr3bp.py`` run the same RK4 on the card;
these functions are their plain versions' building blocks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# --- Earth-Moon CR3BP constants (km, kg, s) -------------------------------
MU_EARTH = 398600.435507   # km^3/s^2
MU_MOON = 4902.800118
CR3BP_MU = MU_MOON / (MU_EARTH + MU_MOON)   # ~0.0121505
DU_KM = 384400.0                             # Earth-Moon distance
TU_S = math.sqrt(DU_KM**3 / (MU_EARTH + MU_MOON))  # ~375201 s
VU_KMS = DU_KM / TU_S
G0 = 9.80665e-3  # km/s^2


def coe2rv(a, e, inc, raan, argp, nu, mu=MU_EARTH):
    """Classical orbital elements -> inertial (r, v) in km, km/s."""
    p = a * (1 - e**2)
    r_mag = p / (1 + e * np.cos(nu))
    # perifocal frame
    r_pf = np.array([r_mag * np.cos(nu), r_mag * np.sin(nu), 0.0])
    v_pf = np.array([-np.sqrt(mu / p) * np.sin(nu),
                     np.sqrt(mu / p) * (e + np.cos(nu)), 0.0])
    cO, sO = np.cos(raan), np.sin(raan)
    co, so = np.cos(argp), np.sin(argp)
    ci, si = np.cos(inc), np.sin(inc)
    R = np.array([
        [cO * co - sO * so * ci, -cO * so - sO * co * ci, sO * si],
        [sO * co + cO * so * ci, -sO * so + cO * co * ci, -cO * si],
        [so * si, co * si, ci],
    ])
    return R @ r_pf, R @ v_pf


def get_gto_state_cr3bp():
    """The GTO departure state in CR3BP rotating units."""
    r, v = coe2rv(24510.0, 0.72345981, 15.0 * 3.141592 / 180.0, 0.0, 0.0, 3.141592)
    return np.array([
        -CR3BP_MU + r[0] / DU_KM, r[1] / DU_KM, r[2] / DU_KM,
        v[0] / VU_KMS, v[1] / VU_KMS, v[2] / VU_KMS,
    ])


def l1_position(mu=CR3BP_MU, iters: int = 50) -> float:
    """x-coordinate of L1 via Newton on the collinear quintic."""
    x = 1.0 - (mu / 3.0) ** (1.0 / 3.0)
    for _ in range(iters):
        r1, r2 = x + mu, x - (1 - mu)
        f = x - (1 - mu) * (x + mu) / abs(r1)**3 - mu * (x - 1 + mu) / abs(r2)**3
        df = 1 + 2 * (1 - mu) / abs(r1)**3 + 2 * mu / abs(r2)**3
        x -= f / df
    return float(x)


def _omega(pos, mu):
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    r1 = torch.sqrt((x + mu)**2 + y**2 + z**2)
    r2 = torch.sqrt((x - 1 + mu)**2 + y**2 + z**2)
    return 0.5 * (x**2 + y**2) + (1 - mu) / r1 + mu / r2


def jacobi_energy(state, mu=CR3BP_MU):
    """CR3BP energy E = v^2/2 - Omega of a [..., 6] state tensor (E_L1 at the
    libration point, increasing outward), in the state's dtype."""
    v2 = torch.sum(state[..., 3:6]**2, dim=-1)
    return 0.5 * v2 - _omega(state[..., :3], mu)


def _accel_c(x, y, z, vx, vy, mu=CR3BP_MU):
    """Gravity plus the rotating frame's terms, one component each: tensors
    or the dual numbers of ``dual.py`` (the shooting kernels' plain
    versions run both through these expressions)."""
    r1 = ((x + mu)**2 + y**2 + z**2).sqrt()
    r2 = ((x - 1 + mu)**2 + y**2 + z**2).sqrt()
    r13, r23 = r1**3, r2**3
    ax = (x - (1 - mu) * (x + mu) / r13 - mu * (x - 1 + mu) / r23 + 2 * vy)
    ay = (y - (1 - mu) * y / r13 - mu * y / r23 - 2 * vx)
    az = (-(1 - mu) * z / r13 - mu * z / r23)
    return ax, ay, az


def _accel(state, mu=CR3BP_MU):
    """Gravity plus the rotating frame's terms on [..., 6] states."""
    return torch.stack(_accel_c(*state[..., :5].unbind(-1), mu=mu), dim=-1)


def eom_c(s, u, thr, thrust_n, isp_s=1000.0, mu=CR3BP_MU):
    """``eom`` on a 7-tuple of components with direction ``u`` (a 3-tuple)
    and throttle ``thr``."""
    x, y, z, vx, vy, vz, m = s
    ax, ay, az = _accel_c(x, y, z, vx, vy, mu)
    # thrust acc: (T[N] / m[kg]) m/s^2 -> nondimensional via DU/TU^2
    a_mag = thr * thrust_n / m.clamp(min=1e-6) * (TU_S**2 / (DU_KM * 1000.0))
    # mdot[kg/s] = -throttle T / (Isp g0);  g0 in km/s^2 so Isp*g0*1000 = m/s
    mdot = -thr * thrust_n / (isp_s * G0 * 1000.0) * TU_S  # kg per TU
    return (vx, vy, vz, ax + a_mag * u[0], ay + a_mag * u[1], az + a_mag * u[2], mdot)


def eom(aug_state, u_dir, throttle, thrust_n, isp_s=1000.0, mu=CR3BP_MU):
    """d/dt of [x y z vx vy vz m]: CR3BP + low thrust.

    thrust_n: engine thrust in newtons; mass in kg; ``u_dir`` [..., 3] a
    unit vector in the rotating frame; ``throttle`` [...] in [0, 1]."""
    throttle = torch.as_tensor(throttle, dtype=aug_state.dtype, device=aug_state.device)
    ds = eom_c(aug_state.unbind(-1), u_dir.unbind(-1), throttle, thrust_n, isp_s, mu)
    return torch.stack(torch.broadcast_tensors(*ds), dim=-1)


def _rk4_step(s, u_dir, throttle, thrust_n, dt, mu=CR3BP_MU):
    """One RK4 step; ``dt`` broadcasts against ``s`` ([..., 1] per sample)."""
    def f(x):
        return eom(x, u_dir, throttle, thrust_n, mu=mu)

    k1 = f(s)
    k2 = f(s + 0.5 * dt * k1)
    k3 = f(s + 0.5 * dt * k2)
    k4 = f(s + dt * k3)
    return s + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def propagate(aug_state, u_dir, throttle, thrust_n, tof, n_steps: int = 64, mu=CR3BP_MU):
    """Propagate ``tof`` time units with a constant thrust direction, batched
    over the leading dimensions of ``aug_state``; ``tof`` may be a float or
    a tensor of those dimensions."""
    dt = torch.as_tensor(tof, dtype=aug_state.dtype, device=aug_state.device) / n_steps
    dt = dt[..., None] if dt.dim() else dt
    s = aug_state
    for _ in range(n_steps):
        s = _rk4_step(s, u_dir, throttle, thrust_n, dt, mu)
    return s


def leg(s0, u_seq, thr_seq, dt_seq, thrust_n):
    """A shooting leg as one flat RK4 scan over per-step sequences:
    ``u_seq`` [..., n, 3], ``thr_seq`` and ``dt_seq`` [..., n], from
    ``s0`` [..., 7]."""
    s = s0
    for i in range(dt_seq.shape[-1]):
        s = _rk4_step(s, u_seq[..., i, :], thr_seq[..., i], thrust_n,
                      dt_seq[..., i, None], CR3BP_MU)
    return s


# The default mission's spiral endpoint, pinned to a fixed constant: the
# adaptive step control of solve_ivp bifurcates on the caller's
# floating-point environment (flush-to-zero state of the calling thread), so
# every oracle seeds from this value, computed in a clean environment
# (rtol 1e-10 DOP853) and rounded to float32 as the function rounds.
_SPIRAL_END_PINNED = {
    (6.48423370092, 1.0, 700.0, 300.0): np.array(
        [-0.32054030895233154, -0.400390088558197, -0.14529898762702942,
         0.7512170076370239, -0.3711310923099518, -0.1562405228614807,
         751.9212646484375], np.float64),
}


def spiral_to_boundary(start_bdry: float, thrust_n: float = 1.0,
                       fuel_mass: float = 700.0, dry_mass: float = 300.0) -> np.ndarray:
    """The augmented state [x y z vx vy vz m] (float32) after ``start_bdry``
    time units of continuous tangential thrust from the GTO state: the
    start boundary of the shooting phase.  Computed on the host with an
    adaptive f64 integrator (the perigee passes are far too stiff for a
    fixed-step one); the default mission reads the pinned constant."""
    pinned = _SPIRAL_END_PINNED.get(
        (float(start_bdry), float(thrust_n), float(fuel_mass), float(dry_mass)))
    if pinned is not None:
        return pinned.astype(np.float32)

    from scipy.integrate import solve_ivp

    mu = CR3BP_MU
    a_coef = TU_S**2 / (DU_KM * 1000.0)
    mdot = -thrust_n / (1000.0 * G0 * 1000.0) * TU_S  # Isp=1000 s, kg/TU

    def rhs(t, s):
        x, y, z, vx, vy, vz, m = s
        r1 = math.sqrt((x + mu)**2 + y**2 + z**2)
        r2 = math.sqrt((x - 1 + mu)**2 + y**2 + z**2)
        ax = x - (1 - mu) * (x + mu) / r1**3 - mu * (x - 1 + mu) / r2**3 + 2 * vy
        ay = y - (1 - mu) * y / r1**3 - mu * y / r2**3 - 2 * vx
        az = -(1 - mu) * z / r1**3 - mu * z / r2**3
        vmag = math.sqrt(vx**2 + vy**2 + vz**2) + 1e-12
        amag = thrust_n / max(m, 1e-6) * a_coef
        return [vx, vy, vz,
                ax + amag * vx / vmag, ay + amag * vy / vmag,
                az + amag * vz / vmag, mdot]

    s0 = np.concatenate([get_gto_state_cr3bp(), [fuel_mass + dry_mass]])
    sol = solve_ivp(rhs, (0.0, start_bdry), s0, method="DOP853",
                    rtol=1e-10, atol=1e-12, dense_output=False)
    return np.asarray(sol.y[:, -1], np.float32)
