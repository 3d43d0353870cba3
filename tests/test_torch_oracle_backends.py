"""The port's oracle backends as they are wired: pydylan (the JAX package's
recording mock, tests/test_pydylan_wiring.py), the simulator's tpu, hybrid
and jax backends and the benchmark's grading branches (each with a
recording stand-in for the batched solver: the solves themselves are held
against the JAX package in test_torch_solver.py), and the automatic rule."""
import sys

import numpy as np
import pytest
import torch

from test_pydylan_wiring import _make_fake_pydylan, _Recorder

from rdm_tpu_torch.benchmark import gto_halo
from rdm_tpu_torch.physics import oracle, solver_gpu

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture()
def fake_pydylan(monkeypatch):
    rec = _Recorder()
    monkeypatch.setitem(sys.modules, "pydylan", _make_fake_pydylan(rec))
    return rec


def test_pydylan_backend_wiring(fake_pydylan):
    """The reference's call sequence, as the JAX package's twin pins it."""
    rec = fake_pydylan
    sim = oracle.CR3BPEarthMissionWarmstartSimulatorBoundary(
        number_of_segments=20, maximum_shooting_time=40.0, minimum_shooting_time=0.0,
        start_bdry=6.48423370092, thrust=1.0, solver_mode="optimal", snopt_time_limit=500.0,
        min_manifold_length=5.0, max_manifold_length=11.0, backend="pydylan")
    guess = np.linspace(0.1, 0.9, 66)
    result = sim.simulate(earth_initial_guess=guess, halo_energy=0.02)

    assert rec.halo_energy_arg == pytest.approx(3.0 + 0.02)
    assert ("halo_solve",) in rec.calls
    assert rec.spiral_tof == pytest.approx(6.48423370092)
    assert rec.snopt.derivative_mode == "analytic"
    assert rec.snopt.total_iteration_limit == 15000
    assert rec.snopt.optimality_tolerance == pytest.approx(1e-3)
    assert rec.snopt.time_limit == pytest.approx(500.0)
    assert rec.snopt.solver_mode == "optimal_enum"
    assert rec.thruster.fuel_mass == pytest.approx(752.1)
    assert rec.thruster.thrust == pytest.approx(1.0)
    assert rec.phase.number_of_segments == 20
    assert rec.phase.maximum_initial_coast_time == pytest.approx(15.0)
    assert rec.phase.maximum_final_coast_time == pytest.approx(15.0)
    assert rec.phase.maximum_shooting_time == pytest.approx(40.0)
    assert rec.phase.minimum_shooting_time == pytest.approx(0.0)
    assert rec.phase.control_coordinate_transcription == "spherical"
    np.testing.assert_allclose(rec.start_bc_state, [0.1, 0.2, 0.0, 0.3, 0.4, 0.0, 752.1])
    halo, direction, lower, upper = rec.end_bc
    assert direction == "StableLeft"
    np.testing.assert_allclose(lower, [3.02, 0.0, 5.0])
    np.testing.assert_allclose(upper, [3.02, 2.77, 11.0])
    expected = guess.copy()
    expected[-2] = guess[-2] * 2.77
    np.testing.assert_allclose(rec.injected_guess, expected)
    assert result["feasibility"] is True
    assert result["snopt_inform"] == 1
    assert result["cost_alpha"] == pytest.approx(0.02)
    np.testing.assert_allclose(result["results.control"], expected)


def test_pydylan_backend_feasible_mode_enum(fake_pydylan):
    sim = oracle.CR3BPEarthMissionWarmstartSimulatorBoundary(solver_mode="feasible",
                                                             backend="pydylan")
    sim.simulate(earth_initial_guess=np.full(66, 0.5), halo_energy=0.05)
    assert fake_pydylan.snopt.solver_mode == "feasible_enum"


def _graded(n, feasible=True):
    """A solver result dict of n lanes, graded."""
    out = {"refined": np.full((n, 66), 0.25), "cost": np.full(n, 5e-4 if feasible else 0.03),
           "pos_err": np.full(n, 1e-4), "vel_err": np.full(n, 2e-4),
           "final_mass": np.full(n, 440.0), "terminal_mass": np.full(n, 439.0),
           "iters": np.full(n, 7), "stationarity": np.full(n, 1e-3), "opt_gain": np.full(n, 0.1)}
    return oracle._grade(out, 1e-3, True, "optimal")


@pytest.fixture()
def solver_calls(monkeypatch):
    """The batched solver replaced by a recorder that returns graded lanes
    (near misses, cost 0.03, for float32; feasible lanes otherwise), and the
    native oracle by one that records the polish and returns feasible
    lanes."""
    calls = []

    def fake(guesses, halo_energies, **kwargs):
        calls.append(dict(kwargs, guesses=np.asarray(guesses), energies=np.asarray(halo_energies)))
        return _graded(len(guesses), feasible=kwargs.get("precision", "f32") != "f32")

    def fake_native(guesses, halo_energies, **kwargs):
        calls.append(dict(kwargs, native=True, guesses=np.asarray(guesses)))
        return _graded(len(guesses))

    monkeypatch.setattr(solver_gpu, "refine_warmstarts_gpu", fake)
    monkeypatch.setattr(oracle, "evaluate_warmstarts_native", fake_native)
    return calls


@pytest.mark.parametrize("backend", ["tpu", "hybrid", "jax"])
def test_simulator_batched_backends(backend, solver_calls):
    """tpu and hybrid solve the one warm start with the simulator's problem
    (float32, as the JAX package's simulator asks), hybrid then polishes the
    near miss with the native oracle; jax checks the defect with no
    iteration.  Each places the solve on the simulator's device."""
    sim = oracle.CR3BPEarthMissionWarmstartSimulatorBoundary(
        backend=backend, solver_mode="feasible", maximum_shooting_time=35.0, device="cpu")
    guess = np.full(66, 0.5)
    guess[0], guess[63], guess[65] = 20.0, 440.0, 7.0
    res = sim.simulate(guess, halo_energy=0.03)
    call = solver_calls[0]
    assert len(solver_calls) == (2 if backend == "hybrid" else 1)
    assert call["device"] == "cpu" and call["guesses"].shape == (1, 66)
    assert call["energies"].tolist() == [0.03]
    assert "precision" not in call
    if backend == "jax":
        assert call["max_iters"] == 0 and call["solver_mode"] == "feasible"
        assert res["snopt_control_evaluations"] is None
        assert res["feasibility"] is True and res["snopt_inform"] == 1   # defect 0.03 < 0.05
        np.testing.assert_array_equal(res["results.control"], guess)
        return
    assert call["max_shoot"] == 35.0 and call["solver_mode"] == "feasible"
    assert res["cost_alpha"] == 0.03
    if backend == "tpu":
        assert res["feasibility"] is False and res["snopt_inform"] == 13
        assert res["snopt_control_evaluations"] == 7 * 15
    else:
        # the native polish of the near miss: from the solve's point, ten
        # iterations, no hops; its feasible result replaces the solve's
        polish = solver_calls[1]
        assert polish["native"] and polish["max_iters"] == 10 and "mbh_rounds" not in polish
        np.testing.assert_array_equal(polish["guesses"], np.full((1, 66), 0.25))
        assert res["feasibility"] is True and res["residual_norm"] == 5e-4
        assert res["snopt_control_evaluations"] == 14 * 15


def test_automatic_backend_rule(monkeypatch):
    """pydylan where it imports, else hybrid with a card, native without."""
    assert oracle.auto_backend(True) == ("pydylan" if oracle.PYDYLAN_AVAILABLE else "hybrid")
    bench = gto_halo.GTOHaloBenchmarker.__new__(gto_halo.GTOHaloBenchmarker)
    bench.config = gto_halo.GTOHaloBenchmarkConfig(model_path="")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert bench.oracle_backend() == "hybrid"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.oracle_backend() == "native"
    bench.config.oracle_backend = "tpu"
    assert bench.oracle_backend() == "tpu"


@pytest.mark.parametrize("backend,precision", [("tpu", "df32"), ("tpu", "f32"),
                                               ("hybrid", "df32"), ("jax", "df32")])
def test_benchmark_grading_branches(backend, precision, solver_calls):
    """The benchmark's branches: tpu solves the float32-cast samples in the
    configured precision and reports the arithmetic it used (df32 is
    float64 on the card); hybrid solves in float32 whatever the precision;
    both rerun the solve once for a steady time at this size; jax grades
    the defect."""
    bench = gto_halo.GTOHaloBenchmarker.__new__(gto_halo.GTOHaloBenchmarker)
    bench.config = gto_halo.GTOHaloBenchmarkConfig(
        model_path="", oracle_backend=backend, oracle_precision=precision, device="cpu",
        oracle_mbh_rounds=2, oracle_max_iters=5)
    samples = np.full((3, 67), 0.5)
    samples[:, 0] = [0.02, 0.04, 0.06]
    samples[:, 1], samples[:, 64], samples[:, 66] = 20.0, 440.0, 7.0
    pv = bench.compute_physical_validation_metrics(samples)
    assert pv["oracle_backend"] == backend and pv["total_tested"] == 3
    call = solver_calls[0]
    assert call["device"] == "cpu"
    if backend == "jax":
        assert len(solver_calls) == 1 and call["max_iters"] == 0
        assert call["guesses"].dtype == np.float32
        return
    solves = [c for c in solver_calls if "native" not in c]
    assert len(solves) == 2                           # the steady-time rerun
    assert call["max_iters"] == 5 and call["mbh_rounds"] == 2
    if backend == "tpu":
        assert call["precision"] == precision and call["guesses"].dtype == np.float32
        assert pv["oracle_grading_precision"] == {"df32": "f64", "f32": "f32"}[precision]
        assert pv["feasible_ratio"] == (1.0 if precision == "df32" else 0.0)
    else:
        assert "precision" not in call and pv["oracle_grading_precision"] == "f32"
        assert len(solver_calls) == 4 and pv["feasible_ratio"] == 1.0   # two polishes
    assert pv["mean_refine_iters"] >= 7 and not pv["avg_solving_time_includes_compile"]
