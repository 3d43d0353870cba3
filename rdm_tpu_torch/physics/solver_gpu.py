"""Batched Levenberg-Marquardt warm-start solver on the card.

Counterpart of the JAX package's ``rdm_tpu/physics/solver_tpu.py``.  Every
diffusion sample is graded by a local solve of the GTO -> halo insertion NLP
from the sample as warm start:

* free variables: the full 66-vector [t_shoot, t_c1, t_c2, 20 x (alpha,
  beta, throttle), mass, halo-phase fraction, manifold length];
* start boundary: the fixed GTO-spiral end state (``oracle._mission_constants``);
* end boundary: the StableLeft stable-manifold arc of the L1 halo at
  E_L1 + cost_alpha, at the sample's phase and arc length;
* a 7-vector residual: the 6-state mismatch where the forward shoot from
  the spiral and the backward shoot from the manifold target meet, and the
  mass binding (100 kg per unit).

Levenberg-Marquardt refines it: per iteration a 7 x 66 Jacobian, a ladder of
eight damped steps solved at once, and the first rung that lowers the cost.
``solver_mode="optimal"`` runs the fused feasibility + mass-ascent ratchet
(``_ratchet_loop``): an 8th residual row chases a mass target that ratchets
up while the lane is feasible; its step collapsing below ``_OPT_GAIN_TOL``
certifies a constrained local optimum (``snopt_inform == 1``).

Two precisions, as in the JAX package:

* ``"f32"``: float32 residuals with the halo table interpolated in float32
  on the card, and the Jacobian as forward-mode derivatives of that residual
  (the JAX package differentiates it in reverse mode, ``jacrev``; same derivative,
  another order of rounding); LU step algebra.
* ``"df32"`` (the benchmark's default) maps to float64 here: the card has
  native float64, so the JAX package's double-float32 words
  (``rdm_tpu/ops/df32.py``) give way to plain float64 residuals from the
  host's float64 halo data, a forward-difference Jacobian (columns 0-62
  against the fixed target, 63-65 through the full residual, step
  1e-6 (|theta| + 1)) and Cholesky step algebra, all in float64.  The mass
  rate diagnostic differentiates the float32 residual on float32 casts of
  the same data, as the JAX package's does.

The integrations run in the hand-written kernels of ``csrc/cr3bp_shoot.cu``
(``ops/cr3bp.py``): ``shoot_legs`` (both shooting legs, or the whole forward
arc), ``shoot_legs_fd`` (the float64 Jacobian's residual rows),
``manifold_target`` (the end-boundary target) and ``shoot_jvp`` (the
float32 Jacobian).  Everything else is PyTorch on batched tensors.  JAX's
vmap of a ``while_loop`` becomes one loop on the host over the lanes still
active: each iteration reads back one "any lane active" flag, gathers the
active lanes, and writes their new carry back; a finished lane's carry never
changes.  On CPU tensors the kernels' plain versions run.

Lanes are independent, so ``n_devices`` > 1 (the JAX package shards each
tile over a mesh) splits each tile into contiguous parts, one per card,
solved at once by a thread per card and concatenated: the result is that of
one card, lane for lane.  The shooting kernels set no per-context launch
attribute, so one process may drive them on several cards.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cr3bp as shoot_ops
from . import halo as _halo
from . import manifold
from .cr3bp import leg
from .oracle import _grade, _mission_constants, _OPT_GAIN_TOL, nlp_box

# Full-NLP variable count: 3 times + 60 controls + mass + tau + length.
NVAR = 66
NRES = 7
_MASS_SCALE = 100.0       # kg per residual unit: tol 1e-3 ~ 0.1 kg binding
# Default mass-variable box: the reference's min/max_mass_to_sample window.
_MASS_MIN = 408.0
_MASS_MAX = 470.0
_MASS_DRY = 301.0         # kg, just above dry mass (physical sanity)
_MASS_WET = 752.0         # kg, spiral-end wet mass
_N_LAMBDA = 8             # rungs of the parallel damping ladder
_COAST_STEPS = 32
_SEG_STEPS = 16
# Mass-ascent (optimal mode) knobs.
_OPT_BUDGET = 96          # extra LM iterations granted to the ascent phase
_OPT_GAIN_KG = 2.0        # initial mass-target ratchet step
_OPT_GAIN_MAX = 64.0      # kg cap: gain grows 1.5x per success up to this
# the forward-difference step of the float64 Jacobian: 1e-6 (|theta| + 1)
_FD_STEP = 1e-6


def _clip(x, lo, hi):
    """clip as min(max(x, lo), hi): a tie with a bound passes half the
    derivative, as the JAX package's ``jnp.clip`` does."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _clamp_vars(theta, n_segments, max_shoot, max_coast, min_shoot=0.0,
                min_mani=5.0, max_mani=11.0, mass_min=_MASS_MIN, mass_max=_MASS_MAX):
    """The NLP's variable box on [..., 66]: times, throttles in [0, 1], mass,
    phase fraction in [0, 1], manifold length."""
    out = theta.clone()
    out[..., 0] = torch.clamp(theta[..., 0], max(1e-3, min_shoot), max_shoot)
    out[..., 1:3] = torch.clamp(theta[..., 1:3], 0.0, max_coast)
    thr = slice(5, 3 + 3 * n_segments, 3)
    out[..., thr] = torch.clamp(theta[..., thr], 0.0, 1.0)
    out[..., 63] = torch.clamp(theta[..., 63], mass_min, mass_max)
    out[..., 64] = torch.clamp(theta[..., 64], 0.0, 1.0)
    out[..., 65] = torch.clamp(theta[..., 65], min_mani, max_mani)
    return out


def _controls(theta, n_segments):
    """Thrust directions [..., n, 3] and throttles [..., n] of the segments."""
    ctrl = theta[..., 3:3 + 3 * n_segments].reshape(*theta.shape[:-1], n_segments, 3)
    alpha, beta = ctrl[..., 0], ctrl[..., 1]
    throttle = _clip(ctrl[..., 2], 0.0, 1.0)
    u_dir = torch.stack([torch.cos(beta) * torch.cos(alpha),
                         torch.cos(beta) * torch.sin(alpha),
                         torch.sin(beta)], dim=-1)
    return u_dir, throttle


def _seg_sequences(u_dir, throttle, seg_dt, lo, hi, reverse=False):
    """Per-step sequences for thrust segments [lo, hi) at ``_SEG_STEPS``
    substeps each: u [..., n, 3], throttle [..., n], dt [..., n]."""
    u = torch.repeat_interleave(u_dir[..., lo:hi, :], _SEG_STEPS, dim=-2)
    thr = torch.repeat_interleave(throttle[..., lo:hi], _SEG_STEPS, dim=-1)
    n = (hi - lo) * _SEG_STEPS
    dt = (seg_dt / _SEG_STEPS)[..., None].expand(*seg_dt.shape, n)
    if reverse:
        u, thr, dt = u.flip(-2), thr.flip(-1), -dt
    return u, thr, dt


def _coast(t_coast, sign, like):
    """Zero-thrust sequences of ``_COAST_STEPS`` steps of sign * t / steps."""
    shape = t_coast.shape
    z3 = like.new_zeros(*shape, _COAST_STEPS, 3)
    z = like.new_zeros(*shape, _COAST_STEPS)
    dt = ((sign * t_coast) / _COAST_STEPS)[..., None].expand(*shape, _COAST_STEPS)
    return z3, z, dt


def _shoot_forward(theta, spiral_end, thrust, n_segments, n_fwd):
    """Forward leg: spiral end -> coast t_c1 -> segments [0, n_fwd)."""
    t_shoot = torch.maximum(theta[..., 0], theta.new_tensor(1e-3))
    t_c1 = torch.maximum(theta[..., 1], theta.new_tensor(0.0))
    u_dir, throttle = _controls(theta, n_segments)
    seg_dt = t_shoot / n_segments
    zc, tc, dc = _coast(t_c1, 1.0, theta)
    us, ts, ds = _seg_sequences(u_dir, throttle, seg_dt, 0, n_fwd)
    s0 = spiral_end.expand(*theta.shape[:-1], 7)
    return leg(s0, torch.cat([zc, us], -2), torch.cat([tc, ts], -1),
               torch.cat([dc, ds], -1), thrust)


def _shoot_backward(theta, target6, thrust, n_segments, n_fwd):
    """Backward leg: manifold target (mass = the sample's mass variable) <-
    coast t_c2 <- segments [n_fwd, n_segments), in reverse time."""
    t_shoot = torch.maximum(theta[..., 0], theta.new_tensor(1e-3))
    t_c2 = torch.maximum(theta[..., 2], theta.new_tensor(0.0))
    u_dir, throttle = _controls(theta, n_segments)
    seg_dt = t_shoot / n_segments
    # physical sanity only: the NLP's mass box is _clamp_vars'
    mass_end = _clip(theta[..., 63], _MASS_DRY, _MASS_WET)
    s0 = torch.cat([target6, mass_end[..., None]], dim=-1)
    zc, tc, dc = _coast(t_c2, -1.0, theta)
    us, ts, ds = _seg_sequences(u_dir, throttle, seg_dt, n_fwd, n_segments, reverse=True)
    return leg(s0, torch.cat([zc, us], -2), torch.cat([tc, ts], -1),
               torch.cat([dc, ds], -1), thrust)


def _shoot(theta, spiral_end, thrust, n_segments):
    """The whole forward arc (terminal-mass reporting): coast t_c1, every
    segment, coast t_c2."""
    t_shoot = torch.maximum(theta[..., 0], theta.new_tensor(1e-3))
    t_c1 = torch.maximum(theta[..., 1], theta.new_tensor(0.0))
    t_c2 = torch.maximum(theta[..., 2], theta.new_tensor(0.0))
    u_dir, throttle = _controls(theta, n_segments)
    seg_dt = t_shoot / n_segments
    zc, tc, dc1 = _coast(t_c1, 1.0, theta)
    _, _, dc2 = _coast(t_c2, 1.0, theta)
    us, ts, ds = _seg_sequences(u_dir, throttle, seg_dt, 0, n_segments)
    s0 = spiral_end.expand(*theta.shape[:-1], 7)
    return leg(s0, torch.cat([zc, us, zc], -2), torch.cat([tc, ts, tc], -1),
               torch.cat([dc1, ds, dc2], -1), thrust)


def _residual_with_target(theta, tgt, spiral_end, thrust, n_segments):
    """Forward-backward shooting residual against a given target [..., 6]:
    (r [..., 7], finite [...]); a non-finite leg or target gives 1e6 in
    every entry.  The plain version of the ``shoot_legs`` kernel."""
    n_fwd = (n_segments + 1) // 2
    s_f = _shoot_forward(theta, spiral_end, thrust, n_segments, n_fwd)
    s_b = _shoot_backward(theta, tgt, thrust, n_segments, n_fwd)
    r = torch.cat([s_f[..., :6] - s_b[..., :6],
                   ((s_f[..., 6] - s_b[..., 6]) / _MASS_SCALE)[..., None]], dim=-1)
    finite = (torch.isfinite(s_f).all(-1) & torch.isfinite(s_b).all(-1)
              & torch.isfinite(tgt).all(-1))
    return torch.where(finite[..., None], r, torch.full_like(r, 1e6)), finite


def _target(theta, data, min_mani, max_mani):
    """The end-boundary target [n, 6] of [n, 66] iterates from their halo
    data (state0 [n, 6], period [n], vstable [n, 6]): ``manifold_target``
    kernel."""
    tau = torch.clamp(theta[:, 64], 0.0, 1.0).contiguous()
    length = torch.clamp(theta[:, 65], min_mani, max_mani).contiguous()
    return shoot_ops.manifold_target(*data, tau, length)


def _fd_tail(theta, h):
    """Rows 64 and 65 of the forward differences' trial rows theta +
    diag(h), whose targets move: [n * 2, 66]."""
    step = torch.zeros((theta.shape[0], NVAR - 64, NVAR), dtype=theta.dtype, device=theta.device)
    step[:, 0, 64], step[:, 1, 65] = h[:, 64], h[:, 65]
    return (theta[:, None, :] + step).reshape(-1, NVAR)


def _residual_data(theta, data, spiral_end, thrust, n_segments, min_mani, max_mani):
    """The full residual of [n, 66] iterates from pre-interpolated halo data:
    (r [n, 7], target [n, 6], finite [n]).  In float32 it is the JAX
    package's ``_residual_data32`` (and ``_residual`` once the data come
    from ``manifold.interp_seed``); in float64 its ``_residual_df``."""
    tgt = _target(theta, data, min_mani, max_mani)
    r, finite = shoot_ops.shoot_legs(theta, tgt, spiral_end, thrust, n_segments)
    return r, tgt, finite


def _residual(theta, alpha, spiral_end, thrust, n_segments, min_mani, max_mani):
    """float32 residual with the halo table interpolated in float32 at the
    lanes' energy offsets ``alpha`` [n]."""
    return _residual_data(theta, manifold.interp_seed(alpha), spiral_end, thrust,
                          n_segments, min_mani, max_mani)


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


# Small matrices a batched linear-algebra call takes: every call takes exactly
# this many, the last chunk padded with copies of its first matrix.
_GRANULE = 4096


def _fixed_batch(fn, *args):
    """``fn`` over batches of small matrices (``args`` share their leading
    axes; ``fn`` returns a tensor or a tuple of tensors with those leading
    axes), called on chunks of exactly ``_GRANULE`` matrices.  The
    libraries pick their algorithm, and so their rounding, by the batch's
    size (a product or factorisation of one matrix rounds otherwise than
    one in a batch of two, a float32 LU solve of 8,192 otherwise than one
    of 4,096), so a lane's result would depend on how many lanes share the
    call; with one batch size it does not, and a tile split over cards
    solves each lane as one card does.  Every device takes the same chunks
    (the CPU's batched routines loop over the matrices, so there they cost
    only the padding)."""
    nd = args[0].dim() - 2
    lead = args[0].shape[:nd]
    flat = [a.reshape(-1, *a.shape[nd:]) for a in args]
    n = flat[0].shape[0]
    if n == 0:
        return fn(*args)
    pad = -n % _GRANULE
    if pad:
        flat = [torch.cat([f, f[:1].expand(pad, *f.shape[1:])]) for f in flat]
    outs = [fn(*(f[i:i + _GRANULE] for f in flat)) for i in range(0, n + pad, _GRANULE)]
    single = not isinstance(outs[0], tuple)
    cols = [[o] for o in outs] if single else outs
    res = tuple(torch.cat(c)[:n].reshape(*lead, *c[0].shape[1:]) for c in zip(*cols))
    return res[0] if single else res


def _bmm(a, b):
    """``a @ b`` over a batch of small matrices, rounded alike whatever the
    batch's size (``_fixed_batch``)."""
    return _fixed_batch(torch.matmul, a, b)


def _gather(data, lanes, k=None):
    """Per-lane data for ``lanes``, repeated for k variants of each lane."""
    out = []
    for a in data:
        a = a[lanes]
        out.append(a if k is None else a.repeat_interleave(k, dim=0))
    return out


class _Problem:
    """One tile's NLP in one precision: clamp, residual, Jacobian and the
    damped solve, on lane subsets given by index."""

    def __init__(self, dtype, data, spiral_end, thrust, n_segments, box):
        self.dtype = dtype
        self.data = data                  # (state0 [L, 6], period [L], vstable [L, 6])
        self.spiral_end = spiral_end      # [7]
        self.thrust = float(thrust)
        self.n_segments = int(n_segments)
        self.box = box                    # max_shoot, max_coast, min_shoot, min_mani, max_mani, mass_min, mass_max
        self.min_mani, self.max_mani = box[3], box[4]

    def clamp(self, theta):
        max_shoot, max_coast, min_shoot, min_mani, max_mani, mass_min, mass_max = self.box
        return _clamp_vars(theta, self.n_segments, max_shoot, max_coast, min_shoot,
                           min_mani, max_mani, mass_min, mass_max)

    def residual(self, theta, lanes):
        """theta [n, 66] or [n, k, 66] of ``lanes`` [n] -> r, target, finite."""
        k = theta.shape[1] if theta.dim() == 3 else None
        flat = theta.reshape(-1, NVAR)
        r, tgt, finite = _residual_data(flat, _gather(self.data, lanes, k), self.spiral_end,
                                        self.thrust, self.n_segments, self.min_mani,
                                        self.max_mani)
        lead = theta.shape[:-1]
        return r.reshape(*lead, NRES), tgt.reshape(*lead, 6), finite.reshape(lead)

    def jacobian(self, theta, r, tgt, finite, lanes):
        """J [n, 7, 66] at theta [n, 66] (r, the target and the finite flag
        of that point given)."""
        if self.dtype == torch.float64:
            return self._jac_fd(theta, r, tgt, lanes)
        J = shoot_ops.shoot_jvp(theta, tgt, *_gather(self.data, lanes), self.spiral_end,
                                self.thrust, self.n_segments, self.min_mani, self.max_mani)
        # the residual is a constant 1e6 where it is not finite
        return torch.where(finite[:, None, None], J, torch.zeros_like(J))

    def _jac_fd(self, theta, r0, tgt, lanes):
        """Forward differences of the float64 residual: columns 0-63 move
        only the legs (the target of theta is reused), 64 and 65 the
        target too.  The residual rows come from ``shoot_legs_fd``, which
        integrates each leg a column moves once and the base point's legs
        for the rest."""
        n = theta.shape[0]
        h = _FD_STEP * (torch.abs(theta) + 1.0)                      # [n, 66]
        tg = _target(_fd_tail(theta, h), _gather(self.data, lanes, NVAR - 64), self.min_mani,
                     self.max_mani).reshape(n, NVAR - 64, 6)
        rv = shoot_ops.shoot_legs_fd(theta, h, tgt, tg, self.spiral_end, self.thrust,
                                     self.n_segments)
        J = (rv - r0[:, None, :]) / h[:, :, None]
        return J.transpose(1, 2)

    def solve(self, A, b):
        """a of A a = b for SPD A [..., m, m] and b [..., m]; NaN where the
        factorisation fails (that rung's cost is then inf and it is
        rejected), never an exception."""
        if self.dtype == torch.float64:
            L, info = _fixed_batch(torch.linalg.cholesky_ex, A)
            a = _fixed_batch(lambda rhs, f: torch.cholesky_solve(rhs, f), b[..., None], L)
        else:
            a, info = _fixed_batch(torch.linalg.solve_ex, A, b[..., None])
        a = a[..., 0]
        return torch.where((info != 0)[..., None], torch.full_like(a, float("nan")), a)


def _ladder(prob, J, theta, r, lam):
    """The eight damped steps of every lane: (trials [n, 8, 66], lambdas
    [n, 8]) for J [n, m, 66], r [n, m]."""
    m = r.shape[-1]
    lambdas = lam[:, None] * (10.0 ** torch.arange(_N_LAMBDA, dtype=r.dtype, device=r.device))
    JJt = _bmm(J, J.transpose(1, 2))
    eye = torch.eye(m, dtype=r.dtype, device=r.device)
    A = JJt[:, None] + lambdas[..., None, None] * eye
    a = prob.solve(A, torch.broadcast_to(-r[:, None, :], (r.shape[0], _N_LAMBDA, m)))
    d = _bmm(a, J)                                                  # [n, 8, 66]
    return prob.clamp(theta[:, None, :] + d), lambdas


def _first_improving(cost_t, cost):
    """(any rung improves [n], the first improving rung [n]) with non-finite
    costs never improving."""
    cost_t = torch.where(torch.isfinite(cost_t), cost_t, torch.full_like(cost_t, float("inf")))
    improving = cost_t < cost[:, None]
    return improving.any(1), torch.argmax(improving.to(torch.uint8), dim=1), cost_t


def _lm_loop(prob, theta0, max_iters, tol):
    """LM iteration of every lane until its cost is below tol, a step fails
    (stuck) or ``max_iters`` accepted steps: (theta, r, cost, iters)."""
    L = theta0.shape[0]
    dev = theta0.device
    lanes = torch.arange(L, device=dev)
    theta = prob.clamp(theta0)
    r, tgt, fin = prob.residual(theta, lanes)
    cost = _norm(r)
    lam = torch.full((L,), 1e-3, dtype=theta.dtype, device=dev)
    it = torch.zeros(L, dtype=torch.int32, device=dev)
    stuck = torch.zeros(L, dtype=torch.bool, device=dev)
    while True:
        idx = torch.nonzero((cost > tol) & ~stuck & (it < max_iters)).squeeze(1)
        n = idx.numel()
        if n == 0:
            break
        th, rr, c, la = theta[idx], r[idx], cost[idx], lam[idx]
        J = prob.jacobian(th, rr, tgt[idx], fin[idx], idx)
        trials, lambdas = _ladder(prob, J, th, rr, la)
        r_t, tgt_t, fin_t = prob.residual(trials, idx)
        any_imp, k, cost_t = _first_improving(_norm(r_t), c)
        rows = torch.arange(n, device=dev)
        keep = any_imp[:, None]
        theta[idx] = torch.where(keep, trials[rows, k], th)
        r[idx] = torch.where(keep, r_t[rows, k], rr)
        tgt[idx] = torch.where(keep, tgt_t[rows, k], tgt[idx])
        fin[idx] = torch.where(any_imp, fin_t[rows, k], fin[idx])
        cost[idx] = torch.where(any_imp, cost_t[rows, k], c)
        lam[idx] = torch.where(any_imp, torch.clamp(lambdas[rows, k] * 0.3, min=1e-12), la)
        # a stuck (rejected) final iteration is not counted
        it[idx] += any_imp.to(torch.int32)
        stuck[idx] = ~any_imp
    return theta, r, cost, it


def _ratchet_loop(prob, theta0, base_iters, total_iters, tol):
    """Feasibility LM and mass ascent fused into one loop: an 8th residual
    row ``(m_target - theta[63]) / _MASS_SCALE`` binds the mass to a target
    pushed ``gain`` kg above it whenever the lane is feasible; ``gain`` grows
    1.5x when a step gains at least 30% of it, else halves.  The row stays
    inactive until the lane first reaches feasibility, and such a lane gets
    only ``base_iters``.  Returns (theta, r, cost, iters, gain, has_best):
    the best feasible point seen where there is one."""
    L = theta0.shape[0]
    dev, dt = theta0.device, theta0.dtype
    lanes = torch.arange(L, device=dev)
    theta = prob.clamp(theta0)
    r, tgt, fin = prob.residual(theta, lanes)
    c7 = _norm(r)
    has_b = c7 < tol
    m_tgt = theta[:, 63] + torch.where(has_b, _OPT_GAIN_KG, 0.0).to(dt)
    gain = torch.full((L,), _OPT_GAIN_KG, dtype=dt, device=dev)
    lam = torch.full((L,), 1e-3, dtype=dt, device=dev)
    it = torch.zeros(L, dtype=torch.int32, device=dev)
    best, br, bc7 = theta.clone(), r.clone(), c7.clone()
    stuck = torch.zeros(L, dtype=torch.bool, device=dev)
    e63 = torch.zeros(NVAR, dtype=dt, device=dev)
    e63[63] = 1.0
    while True:
        converged = (c7 < tol) & (gain < _OPT_GAIN_TOL)
        budget = torch.where(has_b, total_iters, base_iters)
        idx = torch.nonzero(~stuck & ~converged & (it < budget)).squeeze(1)
        n = idx.numel()
        if n == 0:
            break
        th, rr, c, la, hb, mt, g = theta[idx], r[idx], c7[idx], lam[idx], has_b[idx], m_tgt[idx], gain[idx]
        J7 = prob.jacobian(th, rr, tgt[idx], fin[idx], idx)
        w_row = torch.where(hb, -1.0 / _MASS_SCALE, 0.0).to(dt)
        J = torch.cat([J7, (w_row[:, None] * e63)[:, None, :]], dim=1)
        r8 = torch.cat([rr, torch.where(hb, (mt - th[:, 63]) / _MASS_SCALE,
                                        torch.zeros_like(mt))[:, None]], dim=1)
        trials, lambdas = _ladder(prob, J, th, r8, la)
        r7_t, tgt_t, fin_t = prob.residual(trials, idx)
        m_term = torch.where(hb[:, None], ((mt[:, None] - trials[..., 63]) / _MASS_SCALE) ** 2,
                             torch.zeros_like(trials[..., 63]))
        c8_t = torch.sqrt(torch.sum(r7_t ** 2, dim=-1) + m_term)
        any_imp, k, _ = _first_improving(c8_t, _norm(r8))
        rows = torch.arange(n, device=dev)
        keep = any_imp[:, None]
        theta_n = torch.where(keep, trials[rows, k], th)
        r_n = torch.where(keep, r7_t[rows, k], rr)
        c7_n = torch.where(any_imp, _norm(r7_t[rows, k]), c)
        feas_n = c7_n < tol
        better = feas_n & (~hb | (theta_n[:, 63] > best[idx, 63]))
        best[idx] = torch.where(better[:, None], theta_n, best[idx])
        br[idx] = torch.where(better[:, None], r_n, br[idx])
        bc7[idx] = torch.where(better, c7_n, bc7[idx])
        # feasible lanes chase current mass + gain; infeasible ones anchor
        # the target at the current mass
        ratchet_ok = any_imp & (theta_n[:, 63] - th[:, 63] > 0.3 * g)
        gain_n = torch.where(~hb, g, torch.where(ratchet_ok, torch.clamp(g * 1.5, max=_OPT_GAIN_MAX),
                                                 g * 0.5))
        m_tgt[idx] = torch.where(feas_n, theta_n[:, 63] + gain_n, theta_n[:, 63])
        gain[idx] = gain_n
        lam[idx] = torch.where(any_imp, torch.clamp(lambdas[rows, k] * 0.3, min=1e-12), la)
        theta[idx], r[idx], c7[idx] = theta_n, r_n, c7_n
        tgt[idx] = torch.where(keep, tgt_t[rows, k], tgt[idx])
        fin[idx] = torch.where(any_imp, fin_t[rows, k], fin[idx])
        has_b[idx] = hb | feas_n
        # an infeasible lane the ladder cannot move is done; a feasible one
        # halves gain and re-anchors instead
        stuck[idx] = ~any_imp & ~feas_n
        it[idx] += any_imp.to(torch.int32)
    hb = has_b[:, None]
    return (torch.where(hb, best, theta), torch.where(hb, br, r),
            torch.where(has_b, bc7, c7), it, gain, has_b)


def _bounds_arrays(n_segments, max_shoot, max_coast, min_shoot, min_mani, max_mani,
                   mass_min=_MASS_MIN, mass_max=_MASS_MAX, device=None):
    """(lower, upper) float32 [66] box bounds of the NLP variables."""
    lo = np.full(NVAR, -np.inf, np.float32)
    hi = np.full(NVAR, np.inf, np.float32)
    lo[0], hi[0] = max(1e-3, min_shoot), max_shoot
    lo[1:3], hi[1:3] = 0.0, max_coast
    for k in range(n_segments):
        lo[3 + 3 * k + 2], hi[3 + 3 * k + 2] = 0.0, 1.0
    lo[63], hi[63] = mass_min, mass_max
    lo[64], hi[64] = 0.0, 1.0
    lo[65], hi[65] = min_mani, max_mani
    return torch.as_tensor(lo, device=device), torch.as_tensor(hi, device=device)


def _mass_rate(J, theta, lower, upper):
    """First-order achievable mass-increase rate at ``theta`` [n, 66] with
    the float32 Jacobian J [n, 7, 66]: project e_mass onto the constraint
    null space, zero components that push through an active box bound,
    re-project (the KKT-style stationarity diagnostic)."""
    n = theta.shape[0]
    Jt = J.transpose(1, 2)
    JJt = _bmm(J, Jt) + 1e-8 * torch.eye(NRES, dtype=J.dtype, device=J.device)

    def proj(v):
        a, info = _fixed_batch(torch.linalg.solve_ex, JJt, _bmm(J, v[..., None]))
        a = torch.where((info != 0)[:, None, None], torch.full_like(a, float("nan")), a)
        return v - _bmm(Jt, a)[..., 0]

    e63 = torch.zeros(n, NVAR, dtype=J.dtype, device=J.device)
    e63[:, 63] = 1.0
    d = proj(e63)
    d = torch.where((theta <= lower + 1e-6) & (d < 0), torch.zeros_like(d), d)
    d = torch.where((theta >= upper - 1e-6) & (d > 0), torch.zeros_like(d), d)
    return torch.clamp(proj(d)[:, 63], min=0.0)


def _solve_tile(g, energies, dev, use_f64, optimal, thrust, n_segments, max_iters, tol,
                box, spiral_end64):
    """One tile's solve: the result columns as float64 / int64 numpy."""
    max_shoot, max_coast, min_shoot, min_mani, max_mani, mass_min, mass_max = box
    spiral32 = torch.as_tensor(np.asarray(spiral_end64, np.float32), device=dev)
    if use_f64:
        sd = _halo.interp_seed(np.asarray(energies, np.float64))
        data64 = tuple(torch.as_tensor(np.asarray(a, np.float64), device=dev) for a in (
            np.atleast_2d(sd["state0"]), np.atleast_1d(sd["period"]),
            np.atleast_2d(sd["vstable"])))
        # the mass-rate diagnostic differentiates the float32 residual on
        # float32 casts of the same host data
        data32 = tuple(a.float() for a in data64)
        prob = _Problem(torch.float64, data64, torch.as_tensor(
            np.asarray(spiral_end64, np.float64), device=dev), thrust, n_segments, box)
        theta0 = torch.as_tensor(np.asarray(g, np.float64), device=dev)
    else:
        alpha = torch.as_tensor(np.asarray(energies, np.float32), device=dev)
        data32 = manifold.interp_seed(alpha)
        prob = None
        theta0 = torch.as_tensor(np.asarray(g, np.float32), device=dev)
    prob32 = _Problem(torch.float32, data32, spiral32, thrust, n_segments, box)
    prob = prob or prob32
    L = theta0.shape[0]
    big = torch.full((L,), 1e6, dtype=torch.float32, device=dev)

    if optimal:
        theta, r, cost, it, gain, has_b = _ratchet_loop(prob, theta0, max_iters,
                                                        max_iters + _OPT_BUDGET, tol)
        opt_gain = torch.where(has_b, gain.float(), big)
        stationarity = big.clone()
        idx = torch.nonzero(has_b).squeeze(1)
        if idx.numel():
            th32 = theta[idx].float()
            r32, tgt32, fin32 = prob32.residual(th32, idx)
            J = prob32.jacobian(th32, r32, tgt32, fin32, idx)
            lower, upper = _bounds_arrays(n_segments, max_shoot, max_coast, min_shoot,
                                          min_mani, max_mani, mass_min, mass_max, dev)
            stationarity[idx] = _mass_rate(J, th32, lower, upper)
    else:
        theta, r, cost, it = _lm_loop(prob, theta0, max_iters, tol)
        opt_gain = big
        stationarity = big

    finite = cost < 1e5
    pos_err = torch.where(finite, _norm(r[:, :3]), 1e6)
    vel_err = torch.where(finite, _norm(r[:, 3:6]), 1e6)
    final_mass = torch.where(finite, torch.clamp(theta[:, 63], mass_min, mass_max), -1.0)
    # the whole forward arc in float32, for the propagated terminal mass
    term, term_finite = shoot_ops.shoot_legs(theta.float(), None, spiral32, thrust,
                                             n_segments, full=True)
    terminal_mass = torch.where(term_finite, term[:, 6], -1.0)

    def host(x, dtype=np.float64):
        return x.detach().cpu().numpy().astype(dtype)

    return (host(theta), host(cost), host(pos_err), host(vel_err), host(final_mass),
            host(terminal_mass), host(it, np.int64), host(stationarity), host(opt_gain))


def solver_devices(device=None, n_devices: int = 1) -> list:
    """The devices a solve splits each tile over: an explicit list or tuple
    ``device`` as given (``["cpu", "cpu"]`` splits on the CPU); otherwise
    the first ``n_devices`` cards (0: every card present), clamped to the
    cards present, or the one device ``device`` names."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [torch.device(d) for d in device]
    base = resolve_device(device)
    count = torch.cuda.device_count() if base.type == "cuda" else 1
    n = max(1, min(count if n_devices == 0 else int(n_devices), count))
    return [base] if n == 1 else [torch.device("cuda", i) for i in range(n)]


def _split_tile(devices, g, e, *args):
    """``_solve_tile`` over contiguous parts of the lanes, one a device, each
    card's in its own thread and on its own stream (inside
    ``torch.cuda.device``: a part's read-backs then wait for its own work
    only, also where two parts share a card); the parts' columns
    concatenated in lane order.  Parts on the CPU run in turn: their
    operations already use every core, and two threads of them contend."""
    if len(devices) == 1:
        return _solve_tile(g, e, devices[0], *args)
    bounds = np.linspace(0, len(g), len(devices) + 1).round().astype(int)
    jobs = [(d, lo, hi) for d, lo, hi in zip(devices, bounds[:-1], bounds[1:]) if hi > lo]

    def solve(job):
        d, lo, hi = job
        if d.type != "cuda":
            return _solve_tile(g[lo:hi], e[lo:hi], d, *args)
        with torch.cuda.device(d), torch.cuda.stream(torch.cuda.Stream(d)):
            return _solve_tile(g[lo:hi], e[lo:hi], d, *args)

    if all(d.type == "cuda" for d, _, _ in jobs):
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            parts = list(pool.map(solve, jobs))
    else:
        parts = [solve(job) for job in jobs]
    return tuple(np.concatenate(cols) for cols in zip(*parts))


def refine_warmstarts_gpu(guesses: np.ndarray, halo_energies: np.ndarray,
                          thrust: float = 1.0, n_segments: int = 20,
                          start_bdry: float = 6.48423370092,
                          max_iters: int = 30, tol: float = 1e-3,
                          max_shoot: float = 40.0, max_coast: float = 15.0,
                          batch_tile: int = 4096, n_devices: int = 1,
                          min_shoot: float = 0.0,
                          min_manifold_length: float = 5.0,
                          max_manifold_length: float = 11.0,
                          min_mass: float = _MASS_MIN,
                          max_mass: float = _MASS_MAX,
                          solver_mode: str = "optimal",
                          mbh_rounds: int = 0,
                          mbh_sigma: float = 0.05,
                          mbh_seed: int = 0,
                          precision: str = "f32",
                          device=None):
    """Solve and grade [N, 66] warm starts on the card: the result dict of
    ``oracle.evaluate_warmstarts_native``, the twin of the JAX package's
    ``refine_warmstarts_tpu``.

    ``solver_mode`` ``"optimal"`` runs the mass-ascent ratchet after
    feasibility and certifies ``inform = 1`` when its step collapses;
    ``"feasible"`` stops at feasibility (``inform = 3``).  ``precision``
    ``"df32"`` (or ``"f64"``) solves in float64 with a forward-difference
    Jacobian, ``"f32"`` in float32 with the forward-mode Jacobian.
    ``batch_tile`` bounds the lanes solved at once (memory); larger batches
    run in tiles.  ``n_devices`` > 1 splits each tile over that many cards
    (0: every card), clamped to the cards present; ``batch_tile`` is then
    rounded up to a multiple of it.  ``mbh_rounds`` > 0 adds monotonic basin
    hopping of the still-infeasible lanes (``oracle._mbh_loop``).
    ``device`` is the card unless it names the CPU, where the kernels' plain
    versions run; a list of devices splits each tile over them."""
    if str(precision) not in ("f32", "df32", "f64"):
        raise ValueError(f"precision {precision!r}: expected 'df32', 'f64' or 'f32'")
    devices = solver_devices(device, n_devices)
    optimal = str(solver_mode) != "feasible"
    use_f64 = str(precision) != "f32"
    box = (float(max_shoot), float(max_coast), float(min_shoot), float(min_manifold_length),
           float(max_manifold_length), float(min_mass), float(max_mass))
    spiral_end64, _l1x, _e_l1 = _mission_constants(start_bdry)
    tile = max(1, int(batch_tile))
    tile += -tile % len(devices)

    def _solve_once(guesses_in, energies_in):
        # the f32 path takes float32 warm starts, the f64 path the caller's values
        g = np.asarray(guesses_in, np.float64 if use_f64 else np.float32)
        e = np.asarray(energies_in, np.float64)
        parts = [_split_tile(devices, g[lo:lo + tile, :NVAR], e[lo:lo + tile], use_f64,
                             optimal, thrust, n_segments, max_iters, tol, box, spiral_end64)
                 for lo in range(0, len(g), tile)]
        (theta, cost, pos_err, vel_err, final_mass, terminal_mass, iters, stat,
         opt_gain) = (np.concatenate(cols) for cols in zip(*parts))
        refined = g.astype(np.float64)
        refined[:, :NVAR] = theta
        out = {"refined": refined, "cost": cost, "pos_err": pos_err, "vel_err": vel_err,
               "final_mass": final_mass, "terminal_mass": terminal_mass, "iters": iters,
               "stationarity": stat, "opt_gain": opt_gain}
        return _grade(out, tol, optimal, solver_mode)

    if mbh_rounds > 0:
        from .oracle import _mbh_loop
        lo_b, hi_b = nlp_box(n_segments, max_shoot, max_coast, min_shoot,
                             min_manifold_length, max_manifold_length, min_mass, max_mass)
        return _mbh_loop(_solve_once, np.asarray(guesses, np.float64)[:, :NVAR],
                         np.asarray(halo_energies, np.float64), mbh_rounds, mbh_sigma,
                         mbh_seed, lo_b, hi_b)
    return _solve_once(guesses, halo_energies)
