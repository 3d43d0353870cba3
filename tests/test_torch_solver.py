"""The GPU solver as a whole on the CPU (the kernels' plain versions),
float64 (precision df32): against the port's native oracle, which grades
bit for bit as the JAX package's does (test_torch_evaluation.py), and
against the JAX package's df32 solver (slow: its program takes about ten
minutes to compile here); basin hopping and the argument rules.  Tiling and optimal mode: test_torch_solver_modes.py; the float32
solve and the defect check against the JAX package:
test_torch_solver_f32.py."""
import os

import numpy as np
import pytest
import torch

from rdm_tpu_torch.physics import oracle, solver_gpu as sg

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND2 = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024", "gto_halo",
                      "generated_samples.npy")


def near_solutions(seed=4, n=4, scale=1e-4):
    """n seeded round-2 samples solved by the native oracle (feasible mode,
    30 iterations), moved off their solutions by seeded noise of ``scale``
    of each variable's box width: warm starts a few LM steps from
    feasibility, so that a short solve decides feasibility."""
    physical = np.load(ROUND2)
    idx = np.random.default_rng(seed).choice(len(physical), n, replace=False)
    G, H = physical[idx, 1:], physical[idx, 0]
    sol = oracle.evaluate_warmstarts_native(G, H, max_iters=30, solver_mode="feasible")
    lo, hi = oracle.nlp_box()
    noise = np.random.default_rng(seed + 1).normal(size=(n, 66)) * scale * (hi - lo)
    return np.clip(sol["refined"] + noise, lo, hi), H


@pytest.fixture(scope="module")
def near():
    return near_solutions()


@pytest.fixture(scope="module")
def f64_solve(near):
    G, H = near
    ours = sg.refine_warmstarts_gpu(G, H, max_iters=3, solver_mode="feasible",
                                    precision="df32", device="cpu")
    return G, H, ours


def test_f64_solve_matches_native(f64_solve):
    """Three LM iterations in float64 from near-solutions against the C++
    oracle's: the same algorithm and arithmetic (forward-difference
    Jacobian, the first improving rung of the same ladder), so the same
    feasible flags and iteration counts, costs within 1e-6 and solved
    variables within 1e-5 (rounding amplified through three solves)."""
    G, H, ours = f64_solve
    nat = oracle.evaluate_warmstarts_native(G, H, max_iters=3, solver_mode="feasible")
    np.testing.assert_array_equal(ours["feasible"], nat["feasible"])
    np.testing.assert_array_equal(ours["iters"], nat["iters"])
    np.testing.assert_array_equal(ours["inform"], nat["inform"])
    np.testing.assert_allclose(ours["cost"], nat["cost"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours["refined"], nat["refined"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours["final_mass"], nat["final_mass"], rtol=0, atol=1e-5)
    assert ours["feasible"].sum() >= 2
    for key in ("pos_err", "vel_err"):
        np.testing.assert_allclose(ours[key], nat[key], rtol=0, atol=1e-6)


def test_result_dict_and_bounds(f64_solve):
    G, H, ours = f64_solve
    for k in ("feasible", "optimal", "inform", "cost", "pos_err", "vel_err", "refined", "iters",
              "final_mass", "terminal_mass", "stationarity", "opt_gain"):
        assert len(ours[k]) == len(G), k
    assert ours["refined"].dtype == np.float64 and not ours["optimal"].any()
    r = ours["refined"]
    assert (r[:, 0] >= 1e-3).all() and (r[:, 0] <= 40.0).all()
    throttles = r[:, 3:63].reshape(len(r), 20, 3)[:, :, 2]
    assert (throttles >= 0).all() and (throttles <= 1).all()
    assert (r[:, 63] >= 408.0).all() and (r[:, 63] <= 470.0).all()
    assert ((r[:, 64] >= 0) & (r[:, 64] <= 1)).all() and ((r[:, 65] >= 5) & (r[:, 65] <= 11)).all()
    # the terminal mass is the whole forward arc's, propagated in float32
    assert ((ours["terminal_mass"] > 300) & (ours["terminal_mass"] < 752)).all()


def test_mbh_hops_only_the_stuck_lanes(near):
    """One basin hop re-solves the lanes the first solve left infeasible;
    a lane feasible at first keeps its result, the iteration counts add."""
    G, H = near
    one = sg.refine_warmstarts_gpu(G, H, max_iters=1, solver_mode="feasible",
                                   precision="df32", device="cpu")
    hop = sg.refine_warmstarts_gpu(G, H, max_iters=1, solver_mode="feasible", mbh_rounds=1,
                                   precision="df32", device="cpu")
    kept = one["feasible"]
    np.testing.assert_array_equal(hop["refined"][kept], one["refined"][kept])
    assert (hop["iters"][~kept] >= one["iters"][~kept]).all()
    assert (hop["feasible"] | ~one["feasible"]).all()


def test_argument_rules(monkeypatch):
    G, H = np.full((1, 66), 0.5), np.array([0.05])
    # n_devices is clamped to the cards present (0: all of them); a list of
    # devices is taken as given; the CPU is one device
    cpu = torch.device("cpu")
    assert sg.solver_devices("cpu", 2) == [cpu]
    assert sg.solver_devices(["cpu", "cpu"], 1) == [cpu, cpu]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 4)
        assert sg.solver_devices(None, 0) == [torch.device("cuda", i) for i in range(4)]
        assert sg.solver_devices(None, 8) == [torch.device("cuda", i) for i in range(4)]
        assert sg.solver_devices(None, 2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
        assert sg.solver_devices(None, 1) == [torch.device("cuda")]
    with pytest.raises(ValueError, match="precision"):
        sg.refine_warmstarts_gpu(G, H, precision="bf16", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sg.refine_warmstarts_gpu(G, H)


@pytest.mark.slow  # the JAX package's df32 solver compiles for about ten minutes here
def test_f64_solve_matches_jax_df32(f64_solve):
    """Against ``refine_warmstarts_tpu(precision="df32")``: the same
    algorithm, 2^-52 against 2^-48 and float32 step algebra on the JAX
    side; the same feasible flags, costs within 1e-4."""
    from rdm_tpu.physics.solver_tpu import refine_warmstarts_tpu

    G, H, ours = f64_solve
    theirs = refine_warmstarts_tpu(G, H, max_iters=3, solver_mode="feasible", precision="df32")
    np.testing.assert_array_equal(ours["feasible"], theirs["feasible"])
    np.testing.assert_allclose(ours["cost"], theirs["cost"], rtol=0, atol=1e-4)
