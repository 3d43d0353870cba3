"""The shooting kernels of the batched warm-start solver (``physics/solver_gpu.py``).

Hand-written CUDA kernels of ``csrc/cr3bp_shoot.cu`` with every state in
registers.  They have no Pallas counterpart: the JAX package runs the
same integrations as XLA scans inside one vmapped program
(``rdm_tpu/physics/solver_tpu.py``).

* ``shoot_legs(theta, tgt, spiral_end, thrust, n_segments)``, float32 or
  float64, one thread per (row, leg), a row being a base point or a ladder
  rung: the forward leg from the spiral end and the backward leg from each
  row's target, 192 RK4 steps each at 20 segments; returns the 7-residual
  and the finite flag (a
  non-finite leg or target gives 1e6 in every entry).  ``full=True``
  integrates the whole forward arc instead and returns its state (terminal
  mass).  Plain version: ``solver_gpu._residual_with_target`` /
  ``solver_gpu._shoot``.
* ``shoot_legs_fd(theta, h, tgt, tgt_moved, spiral_end, thrust,
  n_segments)``, float64: the forward-difference Jacobian's 66 residual
  rows a lane (theta with h_j added to variable j), each leg a column
  moves integrated once (``fd_jobs``: 69 legs a lane at 20 segments, not
  66 two-leg rows) and the base point's legs serving the rest; bit-equal
  to ``shoot_legs`` on the 66 trial rows.  Plain version:
  ``shoot_legs_fd_reference``, the same legs through ``_shoot_forward`` /
  ``_shoot_backward``.
* ``manifold_target(state0, period, vstable, tau_frac, length)``: the
  manifold chain, 256 halo steps then 1024 steps of ballistic
  back-integration, a row on a group of ``LANES`` lanes of one warp.
  float64 transports the tangent with the variational equations
  (``dynamics_f64``), float32 with the tangent of the RK4 map
  (``manifold``), as the JAX package does for its two precisions.
* ``shoot_jvp(theta, tgt, state0, period, vstable, ...)``, float32: the
  7 x 66 Jacobian of the float32 residual as forward-mode derivatives on
  dual numbers (the phase column on nested duals through the tangent
  transport).  Plain version: the same derivatives on the dual numbers of
  ``physics/dual.py``.  A leg job integrates one leg with one tangent
  (``jvp_jobs``), a thread a job; columns 64-65 carry the target's tangent
  through the backward leg as -Phi dT, Phi the leg's sensitivity to its
  start state (six more jobs), formed with column 0's two legs by a
  second, small launch.

What limits them. Every kernel here is bound by a chain of dependent RK4
steps, each waiting on square roots and divisions, as much as by its
arithmetic. ``shoot_legs`` runs a thread a leg (a row's forward and
backward legs on two adjacent lanes, which exchange their end states by
``__shfl_xor_sync``), so a launch takes one leg's 192 steps, not two
legs' 384; its whole-arc form keeps a thread a row. ``shoot_legs_fd``
integrates only the legs a column moves: about half the two-leg rows'
work. The manifold chain has at most 10,240 rows a launch, too few to
fill the card with a thread a row, so a launch took one thread's 1,280
dependent steps whatever its width (``PERF.md``: 3.0 ms at 1 row, 3.4 at
10,240 in float64); the operation-count bound over the peak (``*_ops``
below, 0.11 ms) is not the floor at these widths. So a row runs on a group
of ``LANES`` lanes of one warp: every lane holds the whole state and runs
the RK4 update alike, and a stage's square roots and divisions are spread
over the lanes and exchanged by ``__shfl_sync``. float32 computes its six
gravity terms from one reciprocal square root and products, one a lane;
float64 keeps the one-thread kernel's operations and bits (each rounded
once by an intrinsic, fused where that kernel was fused: the header of
``csrc/cr3bp_shoot.cu``), four lanes each taking one square root and up
to three divisions. ``shoot_jvp`` launches its two target columns
first (``jvp_layout``), on the same chain code, so that they start in the
first wave and run under the leg jobs; each leg job runs one leg, 192
steps (t_shoot's column moves both legs: a job each). The layouts are mirrored here
(``target_layout``, ``jvp_layout``, ``fd_layout``); the card tests hold the
lanes a row to the built library. A row's result does not depend on how
many rows share its launch or where it lies in it.

Each wrapper runs the plain version for CPU tensors and, for CUDA tensors,
launches its kernel or raises; it never falls back.  Each counts its
launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build
from ..physics import dual as _dual

NVAR = 66
NRES = 7
_SOURCE = "cr3bp_shoot"
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# Operations (an add, multiply, division or square root: one each) of one
# evaluation of each vector field as the plain versions write it (eom7,
# field6, field12 of csrc/cr3bp_shoot.cu, without the float64 chain's
# copies of a division), and of one RK4 step over n components:
# the arithmetic of the kernels' bounds.  A dual operation costs about
# three real ones (a product three multiplies and an add, a sum two), a
# dual of duals about nine.
OPS_EOM7, OPS_ODE6, OPS_ODE12 = 51, 38, 100
DUAL_OPS = 3


def rk4_ops(field_ops: int, n: int) -> int:
    return 4 * field_ops + 13 * n + 2


def _leg_steps(n_segments: int):
    n_fwd = (n_segments + 1) // 2
    return 32 + 16 * n_fwd, 32 + 16 * (n_segments - n_fwd)


def shoot_legs_ops(M: int, n_segments: int = 20) -> int:
    """Operations of ``shoot_legs`` on M rows (both legs, or the whole
    forward arc: the same 64 + 16 n steps)."""
    return M * (64 + 16 * n_segments) * rk4_ops(OPS_EOM7, 7)


def manifold_target_ops(M: int, dtype) -> int:
    halo = (rk4_ops(OPS_ODE12, 12) if dtype == torch.float64
            else DUAL_OPS * rk4_ops(OPS_ODE6, 6))
    return M * (256 * halo + 1024 * rk4_ops(OPS_ODE6, 6))


def shoot_legs_fd_ops(L: int, n_segments: int = 20) -> int:
    """Operations of ``shoot_legs_fd`` on L lanes: the legs it integrates
    (``fd_jobs``: the base point's two and each column's moved ones)."""
    fwd, bwd = _leg_steps(n_segments)
    steps = sum(bwd if leg else fwd for _, leg in fd_jobs(n_segments))
    return L * steps * rk4_ops(OPS_EOM7, 7)


def shoot_jvp_ops(L: int, n_segments: int = 20) -> int:
    """Operations of ``shoot_jvp`` on L lanes: each column runs only the
    legs its variable moves; 64 and 65 also run the target."""
    n_fwd = (n_segments + 1) // 2
    fwd, bwd = _leg_steps(n_segments)
    leg = DUAL_OPS * rk4_ops(OPS_EOM7, 7)
    per_lane = 0
    for col in range(64):
        runs_fwd = col <= 1 or 3 <= col < 3 + 3 * n_fwd
        runs_bwd = col in (0, 2, 63) or 3 + 3 * n_fwd <= col < 3 + 3 * n_segments
        per_lane += leg * (fwd * runs_fwd + bwd * runs_bwd)
    tail = 1024 * DUAL_OPS * rk4_ops(OPS_ODE6, 6) + bwd * leg
    per_lane += 256 * DUAL_OPS**2 * rk4_ops(OPS_ODE6, 6) + tail
    per_lane += 256 * DUAL_OPS * rk4_ops(OPS_ODE6, 6) + tail
    return L * per_lane


def shoot_jvp_design_ops(L: int, n_segments: int = 20) -> int:
    """Operations of ``shoot_jvp`` as it runs now on L lanes: each leg job
    one dual leg, the target columns' chains without a leg, and the
    combine's products.  ``shoot_jvp_ops`` stays the bound, the count every
    design is held to."""
    fwd, bwd = _leg_steps(n_segments)
    leg = DUAL_OPS * rk4_ops(OPS_EOM7, 7)
    legs = sum((bwd if side else fwd) * leg for side, _ in jvp_jobs(n_segments))
    chain = (256 * (DUAL_OPS**2 + DUAL_OPS) + 2 * 1024 * DUAL_OPS) * rk4_ops(OPS_ODE6, 6)
    return L * (legs + chain + NRES * 2 * 12)


# ---------------------------------------------------------------------------
# the manifold chain's layout (csrc/cr3bp_shoot.cu), mirrored; the card tests
# hold the lanes a row to the built library (rdm_shoot_chain_lanes)

# lanes a row of the chain takes: kChainLanes64 and kChainLanes
LANES = {torch.float64: 4, torch.float32: 8}
THREADS = 128                      # kThreads, a block


def _blocks(threads: int) -> int:
    return -(-threads // THREADS)


def target_layout(M: int, dtype=torch.float32) -> dict:
    """manifold_target's grid at M rows in ``dtype``, a thread an entry:
    ``row`` (-1 where the thread's warp lies wholly past the last row and
    returns; a masked group runs the last row), ``lane`` (its place in the
    row's group), ``store`` (the group's row is its own).  A storing lane j
    writes components j, j + G, ... below 6 (G the lanes a row)."""
    G = LANES[dtype]
    t = np.arange(_blocks(M * G) * THREADS)
    live = (t & ~31) < M * G
    row = t // G
    return dict(row=np.where(live, np.minimum(row, M - 1), -1), lane=t % G,
                store=live & (row < M))


# shoot_jvp's leg jobs (kSeedState, kJvpScratch and its offsets): the code
# of a job seeded on the backward leg's start state component i
# (SEED_STATE + i), and the floats a lane of the scratch between its two
# launches holds: t_shoot's forward and backward tangents [7] each, Phi
# [7, 6], dT [2, 6]
SEED_STATE = 100
JVP_SCRATCH_AT = {"f0": 0, "b0": 7, "phi": 14, "dT": 14 + 7 * 6}
JVP_SCRATCH = JVP_SCRATCH_AT["dT"] + 2 * 6


def jvp_target_threads(L: int) -> int:
    """Threads of each of shoot_jvp's target columns: L groups, whole warps."""
    return -(-L * LANES[torch.float32] // 32) * 32


def jvp_jobs(n_segments: int) -> list:
    """shoot_jvp's leg jobs a lane in the kernel's order, as (leg, column):
    leg 0 forward, 1 backward; the forward leg's 0, 1 and each forward
    segment's controls, the backward leg's 0, 2, 63, each backward
    segment's controls and its start state (SEED_STATE + 0..5)."""
    n_fwd = (n_segments + 1) // 2
    return ([(0, c) for c in (0, 1, *range(3, 3 + 3 * n_fwd))]
            + [(1, c) for c in (0, 2, 63, *range(3 + 3 * n_fwd, 3 + 3 * n_segments))]
            + [(1, SEED_STATE + i) for i in range(6)])


def jvp_threads(L: int, n_segments: int = 20) -> int:
    """Threads of shoot_jvp's first grid at L lanes."""
    return 2 * jvp_target_threads(L) + len(jvp_jobs(n_segments)) * L


def jvp_layout(L: int, n_segments: int = 20) -> dict:
    """shoot_jvp's first grid at L lanes, a thread an entry: ``col`` (64 or
    65 for a target column's thread, -1 otherwise), ``job`` (a leg job's
    index in ``jvp_jobs``, -1 otherwise; both -1 past the grid's work),
    ``lane``, ``j`` (its place in a target column's group), ``store`` (a
    target thread stores the target's tangent component j), and a leg
    job's ``leg`` and ``seeded`` (its column in ``jvp_jobs``), -1 for other
    threads.  The target columns 64 and 65 come first, a group of LANES
    lanes a lane in whole warps, then the leg jobs, job by job, L threads
    each."""
    G = LANES[torch.float32]
    per_col = jvp_target_threads(L)
    jobs = np.array(jvp_jobs(n_segments))
    n = jvp_threads(L, n_segments)
    t = np.arange(_blocks(n) * THREADS)
    tgt = t < 2 * per_col
    grp = (t % per_col) // G
    j = t % per_col % G
    legs = t - 2 * per_col
    job = np.where(~tgt & (t < n), legs // max(L, 1), -1)
    return dict(col=np.where(tgt, 64 + t // per_col, -1), job=job,
                lane=np.where(tgt, np.minimum(grp, L - 1), legs % L),
                j=np.where(tgt, j, 0), store=tgt & (grp < L) & (j < 6),
                leg=np.where(job >= 0, jobs[job, 0], -1),
                seeded=np.where(job >= 0, jobs[job, 1], -1))


def moves(col: int, leg: int, n_segments: int) -> bool:
    """Whether variable ``col`` moves the forward (``leg`` 0) or backward
    (1) leg: the forward leg reads t_shoot, t_c1 and the controls of
    segments [0, n_fwd); the backward leg t_shoot, t_c2, the others, the
    mass and, through the target, the phase and the arc length."""
    n_fwd = (n_segments + 1) // 2
    if leg == 0:
        return col <= 1 or 3 <= col < 3 + 3 * n_fwd
    return col in (0, 2, 63, 64, 65) or 3 + 3 * n_fwd <= col < 3 + 3 * n_segments


def fd_jobs(n_segments: int) -> list:
    """The legs ``shoot_legs_fd`` integrates for one lane, in the kernel's
    order, as (column, leg): the base point's forward and backward legs
    (column -1), then every leg a column moves, column by column."""
    return [(-1, 0), (-1, 1)] + [(c, g) for c in range(NVAR) for g in (0, 1)
                                 if moves(c, g, n_segments)]


def fd_job_of(col: int, leg: int, n_segments: int) -> int:
    """The job whose end state column ``col`` takes for ``leg``, as the
    kernel computes it: the column's own where it moves the leg, else the
    base point's (0 or 1)."""
    if not moves(col, leg, n_segments):
        return leg
    if col <= 2:
        return (2, 4, 5)[col] + (col == 0 and leg == 1)
    if col < 3 + 3 * n_segments:
        return col + 3
    return col - 57 + 3 * n_segments


def fd_layout(L: int, n_segments: int) -> dict:
    """``shoot_legs_fd``'s grid of legs at L lanes, a thread an entry:
    ``job`` (its index in ``fd_jobs``, -1 past the grid's work), ``lane``,
    ``col`` and ``leg``; job by job, L threads each."""
    jobs = np.array(fd_jobs(n_segments))
    n = len(jobs) * L
    t = np.arange(_blocks(n) * THREADS)
    job = np.where(t < n, t // L, -1)
    return dict(job=job, lane=t % L, col=np.where(job >= 0, jobs[job, 0], -2),
                leg=np.where(job >= 0, jobs[job, 1], -1))


# ---------------------------------------------------------------------------
# plain versions

def shoot_legs_reference(theta, tgt, spiral_end, thrust, n_segments, full=False):
    from ..physics import solver_gpu as sg
    if full:
        s = sg._shoot(theta, spiral_end, thrust, n_segments)
        return s, torch.isfinite(s).all(-1)
    return sg._residual_with_target(theta, tgt, spiral_end, thrust, n_segments)


def shoot_legs_fd_reference(theta, h, tgt, tgt_moved, spiral_end, thrust, n_segments):
    """The float64 Jacobian's residual rows [n, 66, 7]: row j of a lane is
    the residual at theta with h_j added to variable j, against the lane's
    target (columns 64-65: against ``tgt_moved``).  Each leg is integrated
    once where a column moves it, and the base point's legs (from
    ``theta + 0.0``, the values a trial row holds off its diagonal) serve
    every column that does not."""
    from ..physics import solver_gpu as sg
    n = theta.shape[0]
    n_fwd = (n_segments + 1) // 2
    jobs = fd_jobs(n_segments)
    E = torch.zeros((n, len(jobs), NVAR), dtype=theta.dtype, device=theta.device)
    for q, (c, _) in enumerate(jobs):
        if c >= 0:
            E[:, q, c] = h[:, c]
    trial = theta[:, None, :] + E                                   # [n, J, 66]
    fq = [q for q, (_, g) in enumerate(jobs) if g == 0]
    bq = [q for q, (_, g) in enumerate(jobs) if g == 1]
    tg = torch.stack([tgt_moved[:, c - 64] if c >= 64 else tgt for c, g in jobs if g == 1], 1)
    s_f = sg._shoot_forward(trial[:, fq], spiral_end, thrust, n_segments, n_fwd)
    s_b = sg._shoot_backward(trial[:, bq], tg, thrust, n_segments, n_fwd)
    at_f = {q: i for i, q in enumerate(fq)}
    at_b = {q: i for i, q in enumerate(bq)}
    s_f = s_f[:, [at_f[fd_job_of(c, 0, n_segments)] for c in range(NVAR)]]
    s_b = s_b[:, [at_b[fd_job_of(c, 1, n_segments)] for c in range(NVAR)]]
    tg_col = torch.cat([tgt[:, None, :].expand(n, 64, 6), tgt_moved], 1)
    r = torch.cat([s_f[..., :6] - s_b[..., :6],
                   ((s_f[..., 6] - s_b[..., 6]) / sg._MASS_SCALE)[..., None]], dim=-1)
    finite = (torch.isfinite(s_f).all(-1) & torch.isfinite(s_b).all(-1)
              & torch.isfinite(tg_col).all(-1))
    return torch.where(finite[..., None], r, torch.full_like(r, 1e6))


def manifold_target_reference(state0, period, vstable, tau_frac, length):
    from ..physics import dynamics_f64, manifold
    if state0.dtype == torch.float64:
        return dynamics_f64.manifold_target_from_data(state0, period, vstable, tau_frac, length)
    return manifold.manifold_target_from_data(state0, period, vstable, tau_frac, length)


def _tangent(x, like):
    return x.d if isinstance(x, _dual.Dual) else torch.zeros_like(like)


def backward_leg_plain(s, theta, thrust, n_segments):
    """The backward leg of L lanes from the 7 components s (tensors or duals
    of [L]) with theta's controls and times as they are: coast t_c2, then
    segments n_segments - 1 down to n_fwd.  Its tangents are those the
    start state carries: seeded on the start state's six components, the
    leg's sensitivity Phi that ``shoot_jvp`` applies to the target's
    tangent."""
    from ..physics import cr3bp

    d = _dual
    T = theta.t()
    n_fwd = (n_segments + 1) // 2

    def eom(u, thr):
        return lambda x: cr3bp.eom_c(x, u, thr, thrust)

    dt = (-torch.clamp(T[2], min=0.0)) / 32
    for _ in range(32):
        s = d.rk4_c(eom((0.0, 0.0, 0.0), 0.0), s, dt)
    dt = -((torch.clamp(T[0], min=1e-3) / n_segments) / 16)
    for k in range(n_segments - 1, n_fwd - 1, -1):
        a, b = T[3 + 3 * k], T[4 + 3 * k]
        u = (b.cos() * a.cos(), b.cos() * a.sin(), b.sin())
        thr = torch.clamp(T[5 + 3 * k], 0.0, 1.0)
        for _ in range(16):
            s = d.rk4_c(eom(u, thr), s, dt)
    return s


def shoot_jvp_reference(theta, tgt, state0, period, vstable, spiral_end, thrust,
                        n_segments, min_mani, max_mani):
    """J [L, 7, 66] of the float32 residual on dual numbers, as the kernel
    computes it: columns 0-63 along the legs against the fixed target, 64
    (the phase, through the tangent transport: nested duals) and 65 (the arc
    length) through the target and the backward leg."""
    from ..physics import cr3bp, manifold

    d = _dual
    Dual = d.Dual
    L = theta.shape[0]
    n_fwd = (n_segments + 1) // 2
    T = theta.t()                                             # [66, L]
    E = torch.eye(64, dtype=theta.dtype, device=theta.device)[:, :, None]

    def var(j, val, factor=1.0):
        """Variable j's value with its derivative along columns 0-63."""
        return Dual(val, E[:, j] * factor)

    def eom(u, thr):
        return lambda s: cr3bp.eom_c(s, u, thr, thrust)

    t_shoot = var(0, torch.clamp(T[0], min=1e-3), d.max_d(T[0], 1e-3))
    seg_dt = t_shoot / n_segments

    def segment(s, k, dt):
        r = T[5 + 3 * k]
        a, b = var(3 + 3 * k, T[3 + 3 * k]), var(4 + 3 * k, T[4 + 3 * k])
        thr = var(5 + 3 * k, torch.clamp(r, 0.0, 1.0), d.clip_d(r, 0.0, 1.0))
        u = (b.cos() * a.cos(), b.cos() * a.sin(), b.sin())
        for _ in range(16):
            s = d.rk4_c(eom(u, thr), s, dt)
        return s

    def coast(s, dt):
        for _ in range(32):
            s = d.rk4_c(eom((0.0, 0.0, 0.0), 0.0), s, dt)
        return s

    # forward leg: spiral end, coast t_c1, segments [0, n_fwd)
    s = tuple(spiral_end[i].expand(L) for i in range(7))
    s = coast(s, var(1, torch.clamp(T[1], min=0.0), d.max_d(T[1], 0.0)) / 32)
    for k in range(n_fwd):
        s = segment(s, k, seg_dt / 16)
    s_f = s
    # backward leg from the fixed target: coast t_c2, segments n-1 down to n_fwd
    t_c2 = var(2, torch.clamp(T[2], min=0.0), d.max_d(T[2], 0.0))
    mass = var(63, torch.clamp(T[63], 301.0, 752.0), d.clip_d(T[63], 301.0, 752.0))
    s = coast(tuple(tgt[:, i] for i in range(6)) + (mass,), (-t_c2) / 32)
    for k in range(n_segments - 1, n_fwd - 1, -1):
        s = segment(s, k, -(seg_dt / 16))
    rows = [_tangent(s_f[i], E[:, 0] * T[0]) - _tangent(s[i], E[:, 0] * T[0]) for i in range(7)]
    rows[6] = rows[6] / 100.0
    J = torch.stack(rows, dim=0).permute(2, 0, 1)            # [L, 7, 64]

    # the target's columns: the phase through the tangent transport (a dual
    # of duals), the length through the back-integration's step
    tau_c = torch.clamp(T[64], 0.0, 1.0)
    d_tau = d.clip_d(T[64], 0.0, 1.0) * d.clip_d(tau_c, 0.0, 1.0)
    length = torch.clamp(T[65], min_mani, max_mani)
    d_len = d.clip_d(T[65], min_mani, max_mani)
    dt_h = (tau_c * period) / 256
    dt_hd = ((d_tau * period) / 256)[None]
    z = torch.zeros_like(dt_hd)
    s = tuple(Dual(Dual(state0[:, i], vstable[:, i]), Dual(z, z)) for i in range(6))
    dt = Dual(Dual(dt_h, 0.0), Dual(dt_hd, 0.0))
    for _ in range(256):
        s = d.rk4_c(manifold.ode6_c, s, dt)
    x_tau = [Dual(c.v.v, c.d.v) for c in s]
    v_tau = [Dual(c.v.d, c.d.d) for c in s]
    nrm = v_tau[0] * v_tau[0]
    for v in v_tau[1:]:
        nrm = nrm + v * v
    nrm = nrm.sqrt() + 1e-30
    eps = torch.tensor(1e-4, dtype=theta.dtype, device=theta.device)
    zero = torch.zeros_like(dt_hd)
    seed = [x + eps * (v / nrm) for x, v in zip(x_tau, v_tau)]
    s = tuple(Dual(c.v, torch.cat([c.d, zero])) for c in seed)
    dt = Dual((-length) / 1024, torch.cat([zero, (-d_len / 1024)[None]]))
    for _ in range(1024):
        s = d.rk4_c(manifold.ode6_c, s, dt)
    # the backward leg from that target, controls and times as they are
    s = backward_leg_plain(s + (torch.clamp(T[63], 301.0, 752.0),), theta, thrust, n_segments)
    rows = [-_tangent(s[i], torch.zeros_like(zero).expand(2, L)) for i in range(7)]
    rows[6] = rows[6] / 100.0
    tail = torch.stack(rows, dim=0).permute(2, 0, 1)         # [L, 7, 2]
    return torch.cat([J, tail], dim=-1)


# ---------------------------------------------------------------------------
# wrappers

def _on_cpu(name, tensors, dtypes):
    """Raise unless the tensors share one dtype of ``dtypes`` and one device,
    the CPU or a card; on a card they must be contiguous.  Returns whether
    they lie on the CPU."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in dtypes:
        raise ValueError(f"{name}: unsupported dtype {dt}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: tensors on {t.device}/{t.dtype} and {dev}/{dt}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return False


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


# The solver's split over cards launches from a thread a card: the counts'
# read-modify-write takes this lock.
_COUNT_LOCK = threading.Lock()


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


def _launch(fn_name, argtypes, args, device):
    lib = _build.library(_SOURCE, fn_name, argtypes)
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on(lib, err, fn_name)


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def consts():
    """The mission's constants as the kernels take them, computed as the
    plain version computes them: mu, the thrust acceleration coefficient
    TU^2 / (DU_KM * 1000), Isp * G0 * 1000 and TU."""
    from ..physics.cr3bp import CR3BP_MU, DU_KM, G0, TU_S
    return [CR3BP_MU, TU_S**2 / (DU_KM * 1000.0), 1000.0 * G0 * 1000.0, TU_S]


def shoot_legs(theta, tgt, spiral_end, thrust, n_segments, full=False):
    """Both shooting legs of M variants: theta [M, 66], tgt [M, 6] (unused
    with ``full``), spiral_end [7], one dtype (float32 or float64).  Returns
    (residual [M, 7], finite [M]) or, with ``full``, (state [M, 7] after the
    whole forward arc, finite [M])."""
    M = theta.shape[0]
    _check_shape("shoot_legs", theta, (M, NVAR))
    _check_shape("shoot_legs", spiral_end, (7,))
    ins = [theta, spiral_end]
    if not full:
        _check_shape("shoot_legs", tgt, (M, 6))
        ins.append(tgt)
    if not 1 <= n_segments <= 20:
        raise ValueError(f"shoot_legs: n_segments {n_segments} outside [1, 20]")
    if _on_cpu("shoot_legs", ins, tuple(_SUFFIX)):
        return shoot_legs_reference(theta, tgt, spiral_end, thrust, n_segments, full)
    out = torch.empty((M, 7), dtype=theta.dtype, device=theta.device)
    finite = torch.empty(M, dtype=torch.uint8, device=theta.device)
    if M:
        _launch(f"rdm_shoot_legs_{_SUFFIX[theta.dtype]}",
                [_P, _P, _P, _D, _I, _I, _D, _D, _D, _D, _P, _P, _I, _P],
                [theta.data_ptr(), None if full else tgt.data_ptr(), spiral_end.data_ptr(),
                 float(thrust), int(n_segments), int(bool(full)), *consts(), out.data_ptr(),
                 finite.data_ptr(), M], theta.device)
        _count(shoot_legs)
    return out, finite.bool()


shoot_legs.launches = 0


def shoot_legs_fd(theta, h, tgt, tgt_moved, spiral_end, thrust, n_segments):
    """The float64 Jacobian's residual rows [n, 66, 7] at theta [n, 66]
    with steps h [n, 66]: row j is the residual at theta with h_j added to
    variable j, against the lane's target tgt [n, 6], rows 64 and 65 against
    tgt_moved [n, 2, 6]; spiral_end [7]; float64.  Each leg a column moves
    is integrated once, the base point's legs serve the rest: the residuals
    of the 66 trial rows through ``shoot_legs``, bit for bit."""
    n = theta.shape[0]
    for t, shape in ((theta, (n, NVAR)), (h, (n, NVAR)), (tgt, (n, 6)), (tgt_moved, (n, 2, 6)),
                     (spiral_end, (7,))):
        _check_shape("shoot_legs_fd", t, shape)
    if not 1 <= n_segments <= 20:
        raise ValueError(f"shoot_legs_fd: n_segments {n_segments} outside [1, 20]")
    ins = [theta, h, tgt, tgt_moved, spiral_end]
    if _on_cpu("shoot_legs_fd", ins, (torch.float64,)):
        return shoot_legs_fd_reference(*ins, thrust, n_segments)
    out = torch.empty((n, NVAR, NRES), dtype=theta.dtype, device=theta.device)
    if n:
        jobs = len(fd_jobs(n_segments))
        legs = torch.empty((jobs, n, 7), dtype=theta.dtype, device=theta.device)
        ok = torch.empty((jobs, n), dtype=torch.uint8, device=theta.device)
        _launch("rdm_shoot_legs_fd_f64", [_P] * 5 + [_D, _I] + [_D] * 4 + [_P] * 3 + [_I, _P],
                [t.data_ptr() for t in ins] + [float(thrust), int(n_segments), *consts(),
                                               legs.data_ptr(), ok.data_ptr(), out.data_ptr(), n],
                theta.device)
        _count(shoot_legs_fd)
    return out


shoot_legs_fd.launches = 0


def manifold_target(state0, period, vstable, tau_frac, length):
    """Manifold targets [M, 6] from state0 [M, 6], period [M], vstable
    [M, 6], tau_frac [M] and length [M], one dtype: float64 through the
    variational equations, float32 through the tangent of the RK4 map."""
    M = state0.shape[0]
    for t, shape in ((state0, (M, 6)), (period, (M,)), (vstable, (M, 6)),
                     (tau_frac, (M,)), (length, (M,))):
        _check_shape("manifold_target", t, shape)
    ins = [state0, period, vstable, tau_frac, length]
    if _on_cpu("manifold_target", ins, tuple(_SUFFIX)):
        return manifold_target_reference(*ins)
    out = torch.empty((M, 6), dtype=state0.dtype, device=state0.device)
    if M:
        _launch(f"rdm_manifold_target_{_SUFFIX[state0.dtype]}", [_P] * 5 + [_D] * 4 + [_P, _I, _P],
                [t.data_ptr() for t in ins] + consts() + [out.data_ptr(), M], state0.device)
        _count(manifold_target)
    return out


manifold_target.launches = 0


def shoot_jvp(theta, tgt, state0, period, vstable, spiral_end, thrust, n_segments,
              min_mani, max_mani):
    """The float32 Jacobian [L, 7, 66] of the residual at theta [L, 66] with
    its target tgt [L, 6] and halo data (state0 [L, 6], period [L], vstable
    [L, 6]); spiral_end [7].  The derivative of every clip at a bound is
    half (the JAX package's ``jnp.clip``/``jnp.maximum`` convention)."""
    L = theta.shape[0]
    for t, shape in ((theta, (L, NVAR)), (tgt, (L, 6)), (state0, (L, 6)), (period, (L,)),
                     (vstable, (L, 6)), (spiral_end, (7,))):
        _check_shape("shoot_jvp", t, shape)
    if not 1 <= n_segments <= 20:
        raise ValueError(f"shoot_jvp: n_segments {n_segments} outside [1, 20]")
    ins = [theta, tgt, state0, period, vstable, spiral_end]
    if _on_cpu("shoot_jvp", ins, (torch.float32,)):
        return shoot_jvp_reference(*ins, thrust, n_segments, min_mani, max_mani)
    J = torch.empty((L, NRES, NVAR), dtype=theta.dtype, device=theta.device)
    if L:
        scratch = torch.empty((L, JVP_SCRATCH), dtype=theta.dtype, device=theta.device)
        _launch("rdm_shoot_jvp_f32", [_P] * 6 + [_D, _I] + [_D] * 6 + [_P, _P, _I, _P],
                [t.data_ptr() for t in ins] + [float(thrust), int(n_segments), float(min_mani),
                                               float(max_mani), *consts(), J.data_ptr(),
                                               scratch.data_ptr(), L],
                theta.device)
        _count(shoot_jvp)
    return J


shoot_jvp.launches = 0
