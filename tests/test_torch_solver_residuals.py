"""The GPU solver's residuals and Jacobians against the JAX package and the
port's native oracle, on the CPU, at seeded rows of the in-tree round-2
flagship samples (``benchmark_results/round2_flagship_1024``).

The CR3BP shoot amplifies a rounding by the transfer's sensitivity kappa,
1e3-1e5 (``rdm_tpu/physics/solver_tpu.py:416-420``), so float32 comparisons
of whole residuals hold on benign lanes only: those whose float32 residual
(the JAX package's) lies within 1e-2 of the float64 one (the port's, itself
within 1e-10 of the C++ oracle), kappa 2^-24 <= 1e-2.  The legs alone,
given the same target, agree on every lane; float64 comparisons hold on
every lane."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rdm_tpu.ops import df32 as jdf
from rdm_tpu.physics import solver_tpu as jst
from rdm_tpu_torch import native
from rdm_tpu_torch.ops import cr3bp as shoot_ops
from rdm_tpu_torch.physics import halo, manifold, solver_gpu as sg
from rdm_tpu_torch.physics.oracle import _mission_constants

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND2 = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024", "gto_halo",
                      "generated_samples.npy")
BOX = (40.0, 15.0, 0.0, 5.0, 11.0, 408.0, 470.0)


@pytest.fixture(scope="module")
def lanes():
    """Eight seeded round-2 rows in the NLP's box, their halo data in both
    precisions, residuals and targets, and the JAX package's float32
    residual."""
    physical = np.load(ROUND2)
    idx = np.random.default_rng(1).choice(len(physical), 8, replace=False)
    G, H = physical[idx, 1:], physical[idx, 0]
    sp64 = _mission_constants(6.48423370092)[0]
    th64 = sg._clamp_vars(torch.tensor(G), 20, 40.0, 15.0)
    th32 = th64.float()
    sd = halo.interp_seed(H)
    d64 = tuple(torch.tensor(np.asarray(a, np.float64))
                for a in (sd["state0"], sd["period"], sd["vstable"]))
    d32 = manifold.interp_seed(torch.tensor(H, dtype=torch.float32))
    r64, t64, fin64 = sg._residual_data(th64, d64, torch.tensor(sp64), 1.0, 20, 5.0, 11.0)
    r32, t32, fin32 = sg._residual(th32, torch.tensor(H, dtype=torch.float32),
                                   torch.tensor(sp64, dtype=torch.float32), 1.0, 20, 5.0, 11.0)
    spj = jnp.asarray(sp64, jnp.float32)
    res = jax.jit(jax.vmap(lambda t, a: jst._residual(t, a, spj, 1.0, 20, 5.0, 11.0)[0]))
    rj = np.asarray(res(th32.numpy(), H.astype(np.float32)))
    benign = np.abs(rj - r64.numpy()).max(axis=1) < 1e-2
    assert benign.sum() >= 4, benign
    return dict(G=G, H=H, sp64=sp64, th64=th64, th32=th32, d64=d64, d32=d32, r64=r64, t64=t64,
                r32=r32, t32=t32, fin32=fin32, rj=rj, benign=benign, spj=spj)


def test_f32_legs_match_jax(lanes):
    """Both legs from the same float32 target: ``_shoot_forward`` and
    ``_shoot_backward`` of the JAX package against the port's plain
    ``_residual_with_target``, the same float32 operations in the same
    order (no FMA on either side here) but for the sines and cosines of the
    thrust angles (XLA's and PyTorch's float32 sin/cos differ by an ulp at
    places), which the legs amplify by kappa: within 1e-4 of max(1, |r|) on
    benign lanes, 1e-2 on every lane."""
    th, tgt = lanes["th32"].numpy(), lanes["t32"].numpy()

    def r(t, g):
        s_f = jst._shoot_forward(t, lanes["spj"], 1.0, 20, 10)
        s_b = jst._shoot_backward(t, g, 1.0, 20, 10)
        return jnp.concatenate([s_f[:6] - s_b[:6], ((s_f[6] - s_b[6]) / 100.0)[None]])

    theirs = np.asarray(jax.jit(jax.vmap(r))(th, tgt))
    ours, finite = sg._residual_with_target(lanes["th32"], lanes["t32"], torch.tensor(
        lanes["sp64"], dtype=torch.float32), 1.0, 20)
    assert finite.all()
    err = np.abs(ours.numpy() - theirs).max(axis=1) / np.maximum(1.0, np.abs(theirs).max(axis=1))
    assert err[lanes["benign"]].max() < 1e-4 and err.max() < 1e-2, err


def test_f32_residual_matches_jax(lanes):
    """``_residual`` jitted alone against the port's float32 residual (the
    kernels' plain versions).  They differ only in how the target's tangent
    transport rounds (autodiff against dual numbers, see
    test_torch_solver_dynamics), which the arcs amplify: within 1e-2 of
    max(1, |r|) on benign lanes, and a median of 1e-4; finite everywhere."""
    r, rj, b = lanes["r32"].numpy(), lanes["rj"], lanes["benign"]
    assert lanes["fin32"].all() and np.isfinite(rj).all()
    err = np.abs(r - rj).max(axis=1) / np.maximum(1.0, np.abs(rj).max(axis=1))
    assert err[b].max() < 1e-2 and np.median(err[b]) < 1e-4, err


def test_f64_residual_matches_native(lanes):
    """The float64 residual against the C++ oracle's ``residual_batch`` on
    the same host halo data: the same float64 operations but for the order
    of a few sums and g++'s sin/cos, which the 1280-step target and the
    legs amplify by kappa up to 1e5: within 1e-8 on every lane."""
    G64 = lanes["th64"].numpy()
    nat = native.residual_batch(G64, lanes["H"], lanes["sp64"])
    np.testing.assert_allclose(lanes["r64"].numpy(), nat, rtol=0, atol=1e-8)


@pytest.mark.slow  # the JAX package's df32 residual takes about 9 minutes to compile here
def test_f64_residual_matches_df32(lanes):
    """The float64 residual against the JAX package's double-float32
    ``_residual_df`` on the same host data (its eigenvector in float32, as
    the df32 path takes it): within 1e-6 on benign lanes, the df32 target's
    float32 normalisation moving the seed by ~6e-12 before the arc
    amplifies it (test_torch_solver_dynamics)."""
    b = lanes["benign"]
    sd = halo.interp_seed(lanes["H"][b])
    vs32 = np.asarray(sd["vstable"], np.float32)
    spd = jdf.const(np.asarray(lanes["sp64"], np.float64))

    def one(th, s0, per, vs):
        return jst._residual_df(jdf.DF(th[0], th[1]), jdf.DF(s0[0], s0[1]),
                                jdf.DF(per[0], per[1]), vs, spd, 1.0, 20, 5.0, 11.0)

    def split(x):
        x = np.asarray(x, np.float64)
        hi = x.astype(np.float32)
        return hi, (x - hi).astype(np.float32)

    out = jax.jit(jax.vmap(one))(split(lanes["th64"].numpy()[b]), split(sd["state0"]),
                                 split(sd["period"]), vs32)
    theirs = jdf.to_f64(out)
    ours, _, _ = sg._residual_data(lanes["th64"][b], tuple(torch.tensor(np.asarray(a, np.float64))
                                   for a in (sd["state0"], sd["period"], vs32)),
                                   torch.tensor(lanes["sp64"]), 1.0, 20, 5.0, 11.0)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jacobians(lanes):
    """The port's float32 Jacobian (the dual numbers of ``shoot_jvp``'s
    plain version), JAX's ``jacrev`` of ``_residual`` and the port's
    float64 forward-difference Jacobian."""
    sp32 = torch.tensor(lanes["sp64"], dtype=torch.float32)
    J32 = shoot_ops.shoot_jvp(lanes["th32"], lanes["t32"], *lanes["d32"], sp32, 1.0, 20, 5.0,
                              11.0).numpy()
    spj = lanes["spj"]
    jac = jax.jit(jax.vmap(jax.jacrev(lambda t, a: jst._residual(t, a, spj, 1.0, 20, 5.0,
                                                                  11.0)[0])))
    Jj = np.asarray(jac(lanes["th32"].numpy(), lanes["H"].astype(np.float32)))
    prob = sg._Problem(torch.float64, lanes["d64"], torch.tensor(lanes["sp64"]), 1.0, 20, BOX)
    Jfd = prob.jacobian(lanes["th64"], lanes["r64"], lanes["t64"], None,
                        torch.arange(8)).numpy()
    return J32, Jj, Jfd


def test_f32_jacobian_matches_jacrev(lanes, jacobians):
    """Forward-mode derivatives against JAX's reverse mode, the same
    derivative of residuals that differ as test_f32_residual_matches_jax
    says: within 2e-2 of each benign lane's largest entry, a median of
    1e-3 (every clip at a bound passes half the derivative on both sides:
    many throttles sit at 0 or 1)."""
    J32, Jj, _ = jacobians
    b = lanes["benign"]
    scale = np.abs(Jj).max(axis=(1, 2))
    err = np.abs(J32 - Jj).max(axis=(1, 2)) / scale
    assert err[b].max() < 2e-2 and np.median(err[b]) < 1e-3, err
    assert np.isfinite(J32).all()


def test_fd_jacobian_against_f32_jacobian(lanes, jacobians):
    """The float64 forward-difference Jacobian (step 1e-6 (|theta| + 1))
    against the float32 forward-mode one on benign lanes, leaving out the
    columns whose variable lies within a step of a clip bound (there the
    difference crosses the clip: a one-sided slope, not the half-derivative):
    within 5e-2 of the lane's largest entry, the forward difference's
    truncation error h |d2r/dtheta2| on these chaotic arcs."""
    J32, _, Jfd = jacobians
    th = lanes["th64"].numpy()
    h = 1e-6 * (np.abs(th) + 1.0)
    lo, hi = sg._bounds_arrays(20, *BOX[:5])
    lo, hi = lo.double().numpy(), hi.double().numpy()
    lo[3:63:3], hi[3:63:3] = -np.inf, np.inf        # the angles are not clipped
    lo[[0, 1, 2]], hi[[1, 2]] = [1e-3, 0.0, 0.0], [np.inf, np.inf]   # max(t, c) only
    lo[63], hi[63] = 301.0, 752.0
    near = (th - lo < 2 * h) | (hi - th < 2 * h)
    b = lanes["benign"]
    for i in np.nonzero(b)[0]:
        cols = ~near[i]
        scale = np.abs(J32[i]).max()
        err = np.abs(Jfd[i][:, cols] - J32[i][:, cols]).max() / scale
        assert err < 5e-2, (i, err)


def test_damped_solve_never_raises():
    """A singular damped system gives NaN (its rung is then rejected), in
    float32 (LU) and float64 (Cholesky), instead of an exception."""
    for dtype in (torch.float32, torch.float64):
        prob = sg._Problem(dtype, None, None, 1.0, 20, BOX)
        A = torch.zeros(2, 8, 7, 7, dtype=dtype)
        A[0] = torch.eye(7, dtype=dtype)
        b = torch.ones(2, 8, 7, dtype=dtype)
        a = prob.solve(A, b)
        assert torch.isnan(a[1]).all() and torch.equal(a[0], b[0])


@pytest.mark.slow  # the JAX package's df32 residuals take about ten minutes to compile here
def test_fd_jacobian_matches_df32(lanes, jacobians):
    """The float64 forward-difference Jacobian against forward differences
    of the JAX package's double-float32 residual at the steps its
    ``_jac_fd_df`` takes (h = 1e-6 (|theta| + 1) in float32): columns 0-63
    with ``_residual_with_target_df`` against the lane's target, 64 and 65
    through ``_residual_df``; ``_jac_fd_df`` itself, all 66 columns in one
    program, did not finish compiling in 45 minutes here.  On two benign
    lanes, within 1e-3 of each lane's largest entry in the legs' columns
    (the df32 side carries 2^-48 and an eigenvector in float32:
    test_f64_residual_matches_df32), within 1e-2 in the target's: the df32
    target normalises the transported direction in float32
    (``dynamics_df.py:236-240``), so its seed moves by up to
    MANIFOLD_EPS 2^-24 ~ 6e-12 between the two residuals of a difference,
    which the arc amplifies and the step h ~ 1e-6 divides."""
    _, _, Jfd = jacobians
    idx = np.nonzero(lanes["benign"])[0][:2]
    sd = halo.interp_seed(lanes["H"][idx])
    vs32 = np.asarray(sd["vstable"], np.float32)
    spd = jdf.const(np.asarray(lanes["sp64"], np.float64))
    th = lanes["th64"].numpy()[idx]
    h = (np.float32(1e-6) * (np.abs(th.astype(np.float32)) + np.float32(1.0))).astype(np.float64)

    def split(x):
        x = np.asarray(x, np.float64)
        hi = x.astype(np.float32)
        return hi, (x - hi).astype(np.float32)

    def full(t, s0, per, vs):
        return jst._residual_df(jdf.DF(*t), jdf.DF(*s0), jdf.DF(*per), vs, spd, 1.0, 20, 5.0,
                                11.0)

    def legs(t, g):
        return jst._residual_with_target_df(jdf.DF(*t), jdf.DF(*g), spd, 1.0, 20)

    n = len(idx)
    trial = th[:, None, :] + np.eye(66)[None] * h[:, None, :]           # [n, 66, 66]
    rows = np.concatenate([th[:, None], trial[:, 64:]], axis=1).reshape(-1, 66)
    rep = lambda a: np.repeat(np.asarray(a), 3, axis=0)
    r_full = jdf.to_f64(jax.jit(jax.vmap(full))(split(rows), split(rep(sd["state0"])),
                                                split(rep(sd["period"])), rep(vs32)))
    r_full = r_full.reshape(n, 3, 7)
    tgt = lanes["t64"].numpy()[idx]
    rows = np.concatenate([th[:, None], trial[:, :64]], axis=1).reshape(-1, 66)
    r_legs = jdf.to_f64(jax.jit(jax.vmap(legs))(split(rows), split(np.repeat(tgt, 65, axis=0))))
    r_legs = r_legs.reshape(n, 65, 7)
    theirs = np.concatenate([(r_legs[:, 1:] - r_legs[:, :1]) / h[:, :64, None],
                             (r_full[:, 1:] - r_full[:, :1]) / h[:, 64:, None]], axis=1)
    theirs = theirs.transpose(0, 2, 1)                                      # [n, 7, 66]
    scale = np.abs(theirs).max(axis=(1, 2), keepdims=True)
    err = (np.abs(Jfd[idx] - theirs) / scale).max(axis=(0, 1))            # per column
    assert err[:64].max() < 1e-3, err
    assert err[64:].max() < 1e-2, err
