"""The GPU solver's float32 path and the defect check as a whole on the CPU
(the kernels' plain versions) against the JAX package's
``refine_warmstarts_tpu`` and ``evaluate_warmstarts``.

A float32 solve floors at kappa 2^-24 (``rdm_tpu/physics/solver_tpu.py``:
the mixed-precision section), about the 1e-3 feasibility tolerance on
these lanes, where two float32 solvers that round differently (the port's
dual-number Jacobian, JAX's reverse mode) decide a lane either way.  So the
two are held at a tolerance of 1e-2, above that floor: from near-solutions
both decide every lane alike, in the same number of iterations.  Defects
compare on benign lanes: those whose float32 defect (the JAX package's)
lies within 1e-2 of max(1, d) of the float64 one (the native oracle's)."""
import numpy as np
import pytest
import torch

from test_torch_solver import near_solutions

from rdm_tpu.physics import oracle as joracle
from rdm_tpu.physics.solver_tpu import refine_warmstarts_tpu
from rdm_tpu_torch.physics import oracle, solver_gpu as sg

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(scope="module")
def near():
    return near_solutions()


def test_f32_solve_matches_jax(near):
    G, H = near
    ours = sg.refine_warmstarts_gpu(G, H, max_iters=1, tol=1e-2, solver_mode="feasible",
                                    device="cpu")
    theirs = refine_warmstarts_tpu(G, H, max_iters=1, tol=1e-2, solver_mode="feasible")
    np.testing.assert_array_equal(ours["feasible"], theirs["feasible"])
    np.testing.assert_array_equal(ours["iters"], theirs["iters"])
    assert ours["feasible"].sum() >= 3
    # on the lanes both solved, the solved variables and masses agree to
    # the float32 solves' own spread (one LM step from the same point)
    ok = ours["feasible"]
    for key in ("refined", "final_mass", "terminal_mass"):
        np.testing.assert_allclose(ours[key][ok], theirs[key][ok], rtol=0, atol=1e-2, err_msg=key)


def test_defect_check_matches_jax(near):
    """The defect check (a float32 solve with no iteration) on the
    near-solutions and on raw round-2 samples: on benign lanes the defect
    within 2e-3 of max(1, d) (the float32 targets differ as
    test_torch_solver_dynamics says) and the same tier wherever the defect
    is not within that of a tier's edge; finite everywhere."""
    G, H = near
    physical = np.load(__import__("test_torch_solver").ROUND2)
    G = np.concatenate([G, physical[:4, 1:]]).astype(np.float32)
    H = np.concatenate([H, physical[:4, 0]]).astype(np.float32)
    ours = oracle.evaluate_warmstarts(G, H, device="cpu")
    theirs = joracle.evaluate_warmstarts(G, H)
    d64 = oracle.evaluate_warmstarts_native(G, H, refine=False)["cost"]
    d, dj = ours["cost"], theirs["cost"]
    benign = np.abs(dj - d64) < 1e-2 * np.maximum(1.0, d64)
    assert benign.sum() >= 6 and np.isfinite(d).all()
    np.testing.assert_allclose(d[benign], dj[benign], rtol=0,
                               atol=2e-3 * np.maximum(1.0, dj[benign]).max())
    clear = benign.copy()
    for edge in (oracle._DEFECT_TOL_TIGHT, oracle._DEFECT_TOL_LOOSE):
        clear &= np.abs(dj - edge) > 2e-3 * np.maximum(1.0, dj)
    np.testing.assert_array_equal(ours["inform"][clear], theirs["inform"][clear])
    assert set(np.unique(ours["inform"])) <= {1, 3, 13}
    assert (ours["inform"][:4][benign[:4]] < 13).all()   # near-solutions pass the check
