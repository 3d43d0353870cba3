"""The shooting kernels of the batched warm-start solver (``physics/solver_gpu.py``).

Three hand-written CUDA kernels of ``csrc/cr3bp_shoot.cu`` with every state
in registers.  They have no Pallas counterpart: the JAX package runs the
same integrations as XLA scans inside one vmapped program
(``rdm_tpu/physics/solver_tpu.py``).

* ``shoot_legs(theta, tgt, spiral_end, thrust, n_segments)``, float32 or
  float64, one thread per (lane, variant), a variant being a base point, a
  finite-difference column or a ladder rung: the forward leg from the
  spiral end and the backward leg from each row's target, 192 RK4 steps
  each at 20 segments; returns the 7-residual and the finite flag (a
  non-finite leg or target gives 1e6 in every entry).  ``full=True``
  integrates the whole forward arc instead and returns its state (terminal
  mass).  Plain version: ``solver_gpu._residual_with_target`` /
  ``solver_gpu._shoot``.
* ``manifold_target(state0, period, vstable, tau_frac, length)``: the
  manifold chain, 256 halo steps then 1024 steps of ballistic
  back-integration, a row a thread in float64 and a group of lanes in
  float32.  float64 transports the tangent with the variational
  equations (``dynamics_f64``), float32 with the tangent of the RK4 map
  (``manifold``), as the JAX package does for its two precisions.
* ``shoot_jvp(theta, tgt, state0, period, vstable, ...)``, float32: the
  7 x 66 Jacobian of the float32 residual as forward-mode derivatives on
  dual numbers (the phase column on nested duals through the tangent
  transport).  Plain version: the same derivatives on the dual numbers of
  ``physics/dual.py``.

What limits them. ``shoot_legs`` and the Jacobian's 64 leg columns fill the
card (65,536-67,584 threads at 1024 lanes) and are bound by their
arithmetic. The manifold chain is bound by its latency: a launch has at
most 10,240 rows, and with a thread a row the card held less than a warp a
scheduler, so a launch took one thread's 1,280 dependent steps whatever its
width (``PERF.md``: 3.2 ms at 1 row, 3.5 at 10,240 in float64); the
operation-count bound over the peak (``*_ops`` below, 0.11 ms) is not the
floor at these widths. So a row of the float32 chain runs on a group of
``LANES`` lanes of one warp: every lane holds the whole state and runs the
RK4 update alike, the stage's six gravity terms are spread over the lanes,
one a lane, each from one reciprocal square root and products in place of
a square root and divisions, and exchanged by ``__shfl_sync`` once a
stage. float64 keeps a thread a row: split the same way it ran
faster, but it moved the float64 solver's verdicts below the smoke's
agreement gate (``PERF.md``). ``shoot_jvp`` launches its two target columns
first (``jvp_layout``), on the same chain code, so that they start in the
first wave and run under the leg columns. The layouts are mirrored here
(``target_layout``, ``jvp_layout``); the card tests hold the lanes a row
to the built library. A row's result does not depend on how many rows share its
launch or where it lies in it.

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
# evaluation of each vector field as the kernels write it (eom7, ode6,
# ode12 of csrc/cr3bp_shoot.cu), and of one RK4 step over n components:
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


# ---------------------------------------------------------------------------
# the manifold chain's layout (csrc/cr3bp_shoot.cu), mirrored; the card tests
# hold the lanes a row to the built library (rdm_shoot_chain_lanes)

# lanes a row of the chain takes: float64 a thread a row; float32 kChainLanes
LANES = {torch.float64: 1, torch.float32: 8}
THREADS = 128                      # kThreads, a block


def _blocks(threads: int) -> int:
    return -(-threads // THREADS)


def target_layout(M: int) -> dict:
    """manifold_target's float32 grid at M rows (float64 runs a thread a
    row), a thread an entry: ``row`` (-1 where the thread's warp lies wholly
    past the last row and returns; a masked group runs the last row),
    ``lane`` (its place in the row's group), ``store`` (the group's row is
    its own).  A storing lane j < 6 writes component j."""
    G = LANES[torch.float32]
    t = np.arange(_blocks(M * G) * THREADS)
    live = (t & ~31) < M * G
    row = t // G
    return dict(row=np.where(live, np.minimum(row, M - 1), -1), lane=t % G,
                store=live & (row < M))


def jvp_target_threads(L: int) -> int:
    """Threads of each of shoot_jvp's target columns: L groups, whole warps."""
    return -(-L * LANES[torch.float32] // 32) * 32


def jvp_layout(L: int) -> dict:
    """shoot_jvp's grid at L lanes, a thread an entry: ``col`` (-1 past the
    grid's work), ``lane``, ``j`` (its place in a target column's group),
    ``stride`` (the lanes a row in the target columns, 1 in the leg columns)
    and ``store``; a storing thread writes the rows i of J with
    i % stride == j.  The target columns 64 and 65 come first, then columns
    0-63, each L threads."""
    G = LANES[torch.float32]
    per_col = jvp_target_threads(L)
    n = 2 * per_col + 64 * L
    t = np.arange(_blocks(n) * THREADS)
    tgt = t < 2 * per_col
    grp = (t % per_col) // G
    legs = t - 2 * per_col
    col = np.where(tgt, 64 + t // per_col, legs // L)
    return dict(col=np.where(t < n, col, -1),
                lane=np.where(tgt, np.minimum(grp, L - 1), legs % L),
                j=np.where(tgt, t % per_col % G, 0), stride=np.where(tgt, G, 1),
                store=(t < n) & (~tgt | (grp < L)))


# ---------------------------------------------------------------------------
# plain versions

def shoot_legs_reference(theta, tgt, spiral_end, thrust, n_segments, full=False):
    from ..physics import solver_gpu as sg
    if full:
        s = sg._shoot(theta, spiral_end, thrust, n_segments)
        return s, torch.isfinite(s).all(-1)
    return sg._residual_with_target(theta, tgt, spiral_end, thrust, n_segments)


def manifold_target_reference(state0, period, vstable, tau_frac, length):
    from ..physics import dynamics_f64, manifold
    if state0.dtype == torch.float64:
        return dynamics_f64.manifold_target_from_data(state0, period, vstable, tau_frac, length)
    return manifold.manifold_target_from_data(state0, period, vstable, tau_frac, length)


def _tangent(x, like):
    return x.d if isinstance(x, _dual.Dual) else torch.zeros_like(like)


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

    def segment(s, k, dt, seeded=True):
        a, b, r = T[3 + 3 * k], T[4 + 3 * k], T[5 + 3 * k]
        thr = torch.clamp(r, 0.0, 1.0)
        if seeded:
            a, b = var(3 + 3 * k, a), var(4 + 3 * k, b)
            thr = var(5 + 3 * k, thr, d.clip_d(r, 0.0, 1.0))
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
    t_shoot = torch.clamp(T[0], min=1e-3)
    s = coast(s + (torch.clamp(T[63], 301.0, 752.0),), (-torch.clamp(T[2], min=0.0)) / 32)
    for k in range(n_segments - 1, n_fwd - 1, -1):
        s = segment(s, k, -((t_shoot / n_segments) / 16), seeded=False)
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
        _launch("rdm_shoot_jvp_f32", [_P] * 6 + [_D, _I] + [_D] * 6 + [_P, _I, _P],
                [t.data_ptr() for t in ins] + [float(thrust), int(n_segments), float(min_mani),
                                               float(max_mani), *consts(), J.data_ptr(), L],
                theta.device)
        _count(shoot_jvp)
    return J


shoot_jvp.launches = 0
