"""Physical-validation oracle behind the reference simulator interface.

``CR3BPEarthMissionWarmstartSimulatorBoundary(...).simulate(initial_guess,
halo_energy)`` returns ``{results.control, feasibility,
snopt_control_evaluations, snopt_inform, thrust, solving_time,
cost_alpha, ...}`` for one warm start; the batch functions grade many.  All
backends solve or check the manifold-insertion NLP: forward-backward
shooting from the GTO-spiral boundary onto the StableLeft stable-manifold
arc of the L1 halo at E_L1 + halo_energy, parametrised by the sample's
halo-period and manifold-length variables, with the terminal mass bound to
the sample's mass variable.

* **pydylan**: the reference's C++ astrodynamics and SNOPT, wired as the
  JAX package wires them; it runs only where ``pydylan`` imports.
* **native**: the package's own C++ oracle (``rdm_tpu_torch/native``), an
  f64 Levenberg-Marquardt local solve and a projected mass ascent on a
  std::thread pool.
* **tpu**: the same local solve batched on the card
  (``physics/solver_gpu.refine_warmstarts_gpu``; the name is the JAX
  package's).
* **hybrid**: the batched float32 solve, then an f64 native polish of the
  lanes that ended just above the tolerance (``evaluate_warmstarts_hybrid``).
* the defect check (``DEFECT_CHECK_BACKEND``, the name the JAX package
  gives it): the forward-backward midpoint defect of the guess as it is (no
  refinement), graded in tiers (``evaluate_warmstarts``): a
  dynamical-consistency check, not 1:1 comparable with solver numbers.

The batched backends run on the card unless the caller names the CPU
(``device``), where the kernels' plain versions run.

``snopt_inform``: 1 = feasible and the mass-ascent ratchet converged (its
step collapsed below ``_OPT_GAIN_TOL``: a constrained local optimum of the
mass; ``solver_mode`` optimal); 3 = feasible, but the ascent was still
gaining mass when its budget ran out (or feasible mode was asked for);
13 = the local solve did not converge.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

try:  # the reference's astrodynamics package, absent from this image
    import pydylan  # type: ignore  # noqa: F401
    PYDYLAN_AVAILABLE = True
except ImportError:
    PYDYLAN_AVAILABLE = False

BACKENDS = ("pydylan", "hybrid", "tpu", "native", "jax")
DEFECT_CHECK_BACKEND = "jax"

# Feasibility = local-solver convergence below this residual norm
# (position/velocity in nondimensional CR3BP units, mass at 100 kg per unit).
_FEAS_TOL = 1e-3
# Tiers of the defect check (no refinement) on the raw midpoint defect.
_DEFECT_TOL_TIGHT = 0.05
_DEFECT_TOL_LOOSE = 0.15
# kg: the mass-ascent ratchet's last step below this certifies inform 1.
_OPT_GAIN_TOL = 0.25


def native_available() -> bool:
    """True when the package's C++ oracle builds and loads."""
    from .. import native
    return native.available()


def auto_backend(accelerator_present: bool) -> str:
    """The backend an unset ``oracle_backend`` picks: pydylan, then the
    accelerator's hybrid (f32 solve + native f64 polish) or batched solver,
    then the native oracle, then the defect check."""
    if PYDYLAN_AVAILABLE:
        return "pydylan"
    if accelerator_present and native_available():
        return "hybrid"
    if accelerator_present:
        return "tpu"
    if native_available():
        return "native"
    return "jax"


class CR3BPEarthMissionWarmstartSimulatorBoundary:
    """Reference-compatible constructor signature (keyword use only);
    ``device`` places the batched backends (the card unless it names the
    CPU)."""

    # Shooting evaluations per LM iteration, for snopt_control_evaluations:
    # native = 66-column finite differences + ladder trials; tpu/hybrid =
    # the JAX package's count for its solver (7 cotangent sweeps + 8 trials).
    _SHOOTS_PER_ITER = {"native": 70, "tpu": 15, "hybrid": 15}

    def __init__(self, seed=0, seed_step=1, quiet_snopt=True,
                 number_of_segments=20, maximum_shooting_time=40.0,
                 minimum_shooting_time=0.0, sample_path=None,
                 start_bdry=6.48423370092, end_bdry=8.0, thrust=1.0,
                 solver_mode="optimal", min_mass_to_sample=408,
                 max_mass_to_sample=470, snopt_time_limit=1000.0,
                 result_folder=None, min_manifold_length=5.0,
                 max_manifold_length=11.0, backend: Optional[str] = None,
                 device=None):
        self.seed = seed
        self.seed_step = seed_step
        self.quiet_snopt = quiet_snopt
        self.number_of_segments = number_of_segments
        self.maximum_shooting_time = maximum_shooting_time
        self.minimum_shooting_time = minimum_shooting_time
        self.sample_path = sample_path
        self.start_bdry = start_bdry
        self.end_bdry = end_bdry
        self.thrust = thrust
        self.solver_mode = solver_mode
        self.min_mass_to_sample = min_mass_to_sample
        self.max_mass_to_sample = max_mass_to_sample
        self.snopt_time_limit = snopt_time_limit
        self.result_folder = result_folder
        self.min_manifold_length = min_manifold_length
        self.max_manifold_length = max_manifold_length
        self.halo_energy = None
        self.backend = backend or ("pydylan" if PYDYLAN_AVAILABLE else "jax")
        self.device = device

    def simulate(self, earth_initial_guess, halo_energy=None):
        if halo_energy is not None:
            self.halo_energy = halo_energy
        if self.halo_energy is None:
            raise ValueError("halo_energy is not sampled!")
        guess = np.asarray(earth_initial_guess, float)
        if self.backend == "pydylan":
            return self._simulate_pydylan(guess)
        if self.backend == "native":
            return self._simulate_native(guess)
        if self.backend == "tpu":
            return self._simulate_batched(_refine_warmstarts_gpu(), guess)
        if self.backend == "hybrid":
            return self._simulate_batched(evaluate_warmstarts_hybrid, guess)
        return self._simulate_jax(guess)

    def _simulate_pydylan(self, guess):
        """The reference's own wiring of pydylan and SNOPT."""
        import pydylan  # noqa: F811
        pydylan.set_logging_severity(pydylan.enum.error)
        earth, moon = pydylan.Body("Earth"), pydylan.Body("Moon")
        cr3bp = pydylan.eom.CR3BP(primary=earth, secondary=moon)
        l1 = cr3bp.find_equilibrium_point(pydylan.enum.LibrationPoint.L1)
        halo = pydylan.periodic_orbit.Halo(
            cr3bp, pydylan.enum.LibrationPoint.L1, l1[1] + self.halo_energy, 8000.)
        assert halo.solve_for_orbit() == pydylan.enum.OrbitGenerationResult.Success

        thr = pydylan.ThrustParameters(fuel_mass=700., dry_mass=300., Isp=1000., thrust=1.0)
        from .cr3bp import get_gto_state_cr3bp
        spiral = pydylan.phases.lowthrust_spiral(cr3bp, get_gto_state_cr3bp(), thr)
        spiral.evaluate(time_of_flight=self.start_bdry)

        snopt = pydylan.SNOPT_options_structure()
        snopt.derivative_mode = pydylan.enum.derivative_mode_type.analytic
        snopt.quiet_SNOPT = self.quiet_snopt
        snopt.time_limit = self.snopt_time_limit
        snopt.total_iteration_limit = 15000
        snopt.optimality_tolerance = 1e-3
        snopt.solver_mode = (pydylan.enum.solver_mode_type.feasible
                             if self.solver_mode == "feasible"
                             else pydylan.enum.solver_mode_type.optimal)

        thr = pydylan.ThrustParameters(fuel_mass=700., dry_mass=300., Isp=1000.,
                                       thrust=self.thrust)
        thr.fuel_mass = spiral.get_states()[-1, 6]
        phase = pydylan.phase_options_structure()
        phase.number_of_segments = self.number_of_segments
        phase.maximum_initial_coast_time = 15.
        phase.maximum_final_coast_time = 15.
        phase.maximum_shooting_time = self.maximum_shooting_time
        phase.minimum_shooting_time = self.minimum_shooting_time
        phase.control_coordinate_transcription = pydylan.enum.spherical

        start_bc = pydylan.FixedBoundaryCondition(spiral.get_final_states())
        lo = min(self.min_manifold_length, self.max_manifold_length)
        hi = max(self.min_manifold_length, self.max_manifold_length)
        end_bc = pydylan.LibrationOrbitBoundaryCondition(
            halo, pydylan.enum.PerturbationDirection.StableLeft,
            np.asarray([halo.orbit_energy, 0 * halo.orbit_period, lo]),
            np.asarray([halo.orbit_energy, 1 * halo.orbit_period, hi]))

        mission = pydylan.Mission(cr3bp, start_bc, end_bc, pydylan.enum.snopt)
        mission.add_phase_options(phase)
        mission.set_thruster_parameters(thr)
        guess = guess.copy()
        guess[-2] = guess[-2] * halo.orbit_period  # un-normalise halo period
        mission.add_control_initial_guess(guess)

        t0 = time.time()
        mission.optimize(snopt, pydylan.MBH_options_structure())
        solving_time = time.time() - t0
        results = mission.evaluate_and_return_solution(
            mission.get_control_state(), optimize=False) \
            if hasattr(mission, "evaluate_and_return_solution") else None
        feas = mission.is_best_solution_feasible()
        return {
            "results.control": np.asarray(mission.get_control_state()),
            "feasibility": bool(feas),
            "snopt_control_evaluations": getattr(mission, "get_all_SNOPT_control_evaluations",
                                                 lambda: None)(),
            "snopt_inform": int(mission.get_SNOPT_inform())
            if hasattr(mission, "get_SNOPT_inform") else None,
            "thrust": self.thrust,
            "solving_time": solving_time,
            "cost_alpha": self.halo_energy,
            "_results": results,
        }

    def _problem_kwargs(self):
        return dict(thrust=self.thrust, n_segments=self.number_of_segments,
                    start_bdry=self.start_bdry,
                    max_shoot=self.maximum_shooting_time,
                    min_shoot=self.minimum_shooting_time,
                    min_manifold_length=self.min_manifold_length,
                    max_manifold_length=self.max_manifold_length,
                    min_mass=self.min_mass_to_sample,
                    max_mass=self.max_mass_to_sample,
                    solver_mode=self.solver_mode)

    def _simulate_native(self, guess):
        t0 = time.time()
        res = evaluate_warmstarts_native(
            np.asarray(guess)[None, :], np.asarray([self.halo_energy]),
            **self._problem_kwargs())
        return self._result_from_batch(res, time.time() - t0)

    def _simulate_batched(self, solve, guess):
        """The tpu or hybrid backend on one warm start (the batch functions
        are where the speed is)."""
        t0 = time.time()
        res = solve(np.asarray(guess)[None, :], np.asarray([self.halo_energy]),
                    device=self.device, **self._problem_kwargs())
        return self._result_from_batch(res, time.time() - t0)

    def _result_from_batch(self, res, solving_time):
        spi = self._SHOOTS_PER_ITER.get(self.backend, 66)
        return {
            # like SNOPT, the local solvers return the SOLVED control state
            "results.control": res["refined"][0],
            "feasibility": bool(res["feasible"][0]),
            "snopt_control_evaluations": int(res["iters"][0]) * spi,
            "snopt_inform": int(res["inform"][0]),
            "thrust": self.thrust,
            "solving_time": solving_time,
            "cost_alpha": self.halo_energy,
            "residual_norm": float(res["cost"][0]),
            "terminal_pos_error": float(res["pos_err"][0]),
            "terminal_vel_error": float(res["vel_err"][0]),
            "final_mass": float(res["final_mass"][0]),
            "terminal_mass": float(res["terminal_mass"][0]),
        }

    def _simulate_jax(self, guess):
        """The defect check, no refinement."""
        t0 = time.time()
        res = evaluate_warmstarts(np.asarray(guess)[None, :],
                                  np.asarray([self.halo_energy]),
                                  thrust=self.thrust,
                                  n_segments=self.number_of_segments,
                                  start_bdry=self.start_bdry,
                                  min_manifold_length=self.min_manifold_length,
                                  max_manifold_length=self.max_manifold_length,
                                  device=self.device)
        return {
            "results.control": guess,
            "feasibility": bool(res["feasible"][0]),
            "snopt_control_evaluations": None,
            "snopt_inform": int(res["inform"][0]),
            "thrust": self.thrust,
            "solving_time": time.time() - t0,
            "cost_alpha": self.halo_energy,
            "residual_norm": float(res["cost"][0]),
            "terminal_pos_error": float(res["pos_err"][0]),
            "terminal_vel_error": float(res["vel_err"][0]),
        }


def _refine_warmstarts_gpu():
    """``solver_gpu.refine_warmstarts_gpu`` (imported at use: the solver
    imports this module)."""
    from .solver_gpu import refine_warmstarts_gpu
    return refine_warmstarts_gpu


# --------------------------------------------------------------------------
# Shared mission constants

_NATIVE_CONST_CACHE = {}


def _mission_constants(start_bdry: float):
    """(spiral_end f64[7], l1x, e_l1), cached per exact boundary time (a
    rounded key would alias two boundaries to one spiral endpoint).  E_L1 is
    the float32 energy of the L1 state."""
    key = float(start_bdry)
    if key not in _NATIVE_CONST_CACHE:
        from . import cr3bp as dyn
        spiral_end = np.asarray(dyn.spiral_to_boundary(start_bdry, thrust_n=1.0), np.float64)
        l1x = dyn.l1_position()
        l1_state = torch.tensor([l1x, 0, 0, 0, 0, 0], dtype=torch.float32)
        e_l1 = float(dyn.jacobi_energy(l1_state))
        _NATIVE_CONST_CACHE[key] = (spiral_end, l1x, e_l1)
    return _NATIVE_CONST_CACHE[key]


# --------------------------------------------------------------------------
# Monotonic basin hopping over stuck lanes: when the local solve stalls,
# re-seed from a perturbation of the warm start and solve again, keeping
# the best (the reference's SNOPT runs under MBH).

def nlp_box(n_segments: int = 20, max_shoot: float = 40.0,
            max_coast: float = 15.0, min_shoot: float = 0.0,
            min_mani: float = 5.0, max_mani: float = 11.0,
            min_mass: float = 408.0, max_mass: float = 470.0):
    """(lower, upper) f64[66] variable box of the manifold-insertion NLP."""
    lo, hi = np.zeros(66), np.zeros(66)
    lo[0], hi[0] = max(1e-3, min_shoot), max_shoot
    lo[1:3], hi[1:3] = 0.0, max_coast
    for k in range(n_segments):
        lo[3 + 3 * k: 6 + 3 * k] = 0.0
        hi[3 + 3 * k: 6 + 3 * k] = [2 * np.pi, 2 * np.pi, 1.0]
    lo[63], hi[63] = min_mass, max_mass
    lo[64], hi[64] = 0.0, 1.0
    lo[65], hi[65] = min_mani, max_mani
    return lo, hi


_MERGEABLE = ("feasible", "optimal", "inform", "cost", "pos_err", "vel_err",
              "refined", "final_mass", "terminal_mass", "stationarity",
              "opt_gain")


def _mbh_loop(solve, guesses, energies, rounds: int, sigma: float,
              seed: int, lo, hi):
    """Run ``solve(G, he) -> result dict`` with up to ``rounds`` basin
    hops of the still-infeasible lanes.  Hops perturb the ORIGINAL warm
    start (N(0, sigma * box-width) per variable, clipped to the box), so
    every accepted solution remains a local solve attributable to the
    graded sample.  Monotonic: a hop's result replaces the incumbent only
    if it reaches feasibility or lowers the residual.  Deterministic:
    seeded independently of call order."""
    res = solve(guesses, energies)
    if rounds <= 0:
        return res
    best = dict(res)
    for k in _MERGEABLE:
        best[k] = np.asarray(best[k]).copy()
    best["iters"] = np.asarray(best["iters"], np.int64).copy()
    for r in range(rounds):
        stuck = ~best["feasible"]
        if not stuck.any():
            break
        rng = np.random.default_rng(seed + 7919 * r)
        pert = rng.standard_normal((len(guesses), 66)) * sigma * (hi - lo)
        hop = np.clip(np.asarray(guesses, np.float64)[stuck] + pert[stuck], lo, hi)
        sub = solve(hop, np.asarray(energies)[stuck])
        idx = np.nonzero(stuck)[0]
        better = sub["feasible"] | (np.asarray(sub["cost"]) < best["cost"][idx])
        take = idx[better]
        for k in _MERGEABLE:
            best[k][take] = np.asarray(sub[k])[better]
        best["iters"][idx] += np.asarray(sub["iters"], np.int64)
    return best


def evaluate_warmstarts_hybrid(guesses: np.ndarray, halo_energies: np.ndarray,
                               polish_iters: int = 10,
                               polish_window: float = 100.0,
                               n_threads: int = 0,
                               device=None,
                               **kwargs):
    """The batched float32 solve on the card, then an f64 native polish of
    the near misses: the lanes whose residual landed within
    ``polish_window`` x tol above the tolerance are re-solved from their
    refined point for ``polish_iters`` iterations on the host, and a
    polished lane replaces its solve where it is feasible or lower.  The
    solve is float32 whatever ``precision`` a caller holds (the JAX
    package passes it none).  Takes the keyword arguments of
    ``evaluate_warmstarts_native`` and of ``refine_warmstarts_gpu``."""
    tol = kwargs.get("tol", _FEAS_TOL)
    res = _refine_warmstarts_gpu()(guesses, halo_energies, device=device, **kwargs)

    near = (~res["feasible"]) & np.isfinite(res["cost"]) \
        & (res["cost"] < polish_window * tol)
    if near.any():
        sub_kwargs = dict(kwargs)
        sub_kwargs["max_iters"] = polish_iters
        sub_kwargs.pop("mbh_rounds", None)   # the polish is a local finish
        sub_kwargs.pop("batch_tile", None)
        sub_kwargs.pop("n_devices", None)
        sub = evaluate_warmstarts_native(
            res["refined"][near][:, :66], np.asarray(halo_energies)[near],
            n_threads=n_threads, **sub_kwargs)
        idx = np.nonzero(near)[0]
        better = sub["feasible"] | (sub["cost"] < res["cost"][idx])
        take = idx[better]
        for k in _MERGEABLE:
            res[k] = np.asarray(res[k]).copy()
            res[k][take] = np.asarray(sub[k])[better]
        res["iters"] = np.asarray(res["iters"], np.int64).copy()
        res["iters"][idx] += np.asarray(sub["iters"], np.int64)
    return res


def evaluate_warmstarts(guesses: np.ndarray, halo_energies: np.ndarray,
                        thrust: float = 1.0, n_segments: int = 20,
                        start_bdry: float = 6.48423370092,
                        min_manifold_length: float = 5.0,
                        max_manifold_length: float = 11.0,
                        device=None):
    """Defect check of [N, 66] guesses, no solve: the batched float32
    solver with no iteration, so the defect is the residual the solver
    minimises; tiers: feasible below ``_DEFECT_TOL_LOOSE``, inform 1 below
    ``_DEFECT_TOL_TIGHT``."""
    res = _refine_warmstarts_gpu()(
        guesses, halo_energies, thrust=thrust, n_segments=n_segments,
        start_bdry=start_bdry, max_iters=0, solver_mode="feasible",
        min_manifold_length=min_manifold_length,
        max_manifold_length=max_manifold_length, device=device)
    cost = res["cost"]
    sane = np.isfinite(cost) & (cost < 1e5)
    tight = sane & (cost < _DEFECT_TOL_TIGHT)
    loose = sane & (cost < _DEFECT_TOL_LOOSE)
    inform = np.where(tight, 1, np.where(loose, 3, 13))
    return {"feasible": loose, "optimal": tight, "inform": inform,
            "cost": cost, "pos_err": res["pos_err"],
            "vel_err": res["vel_err"], "final_mass": res["final_mass"],
            "terminal_mass": res["terminal_mass"]}


# --------------------------------------------------------------------------
# The native C++ oracle: a thread-pool batched LM solve of every warm start.

def evaluate_warmstarts_native(guesses: np.ndarray, halo_energies: np.ndarray,
                               thrust: float = 1.0, n_segments: int = 20,
                               start_bdry: float = 6.48423370092,
                               refine: bool = True, max_iters: int = 30,
                               tol: float = _FEAS_TOL,
                               max_shoot: float = 40.0, max_coast: float = 15.0,
                               min_shoot: float = 0.0,
                               min_manifold_length: float = 5.0,
                               max_manifold_length: float = 11.0,
                               min_mass: float = 408.0,
                               max_mass: float = 470.0,
                               solver_mode: str = "optimal",
                               mbh_rounds: int = 0,
                               mbh_sigma: float = 0.05,
                               mbh_seed: int = 0,
                               n_threads: int = 0,
                               spiral_end: Optional[np.ndarray] = None):
    """Grade [N, 66] warm starts with the native C++ solver.

    With ``refine=True`` each guess is locally solved (Levenberg-Marquardt
    on the manifold-insertion boundary residual, plus the mass ascent when
    ``solver_mode != 'feasible'``) before grading: a sample counts as
    feasible when the local solver CONVERGES from it.  With
    ``refine=False`` this is a straight defect check.  ``mbh_rounds`` > 0
    re-solves still-infeasible lanes from perturbations of their warm start
    (monotonic basin hopping), keeping the best.  ``spiral_end`` (f64[7])
    replaces the default start boundary state."""
    from .. import native

    guesses = np.ascontiguousarray(guesses, np.float64)
    energies = np.ascontiguousarray(halo_energies, np.float64)
    if spiral_end is None:
        spiral_end, _l1x, _e_l1 = _mission_constants(start_bdry)
    else:
        spiral_end = np.ascontiguousarray(spiral_end, np.float64)
        if spiral_end.shape != (7,):
            raise ValueError(f"spiral_end has shape {spiral_end.shape}, expected (7,)")
    optimal = str(solver_mode) != "feasible"

    if refine:
        def _solve(G, he):
            out = native.refine_batch(
                G, he, spiral_end, n_segments=n_segments,
                thrust=thrust, max_iters=max_iters, tol=tol,
                max_shoot=max_shoot, max_coast=max_coast,
                min_shoot=min_shoot,
                min_manifold_length=min_manifold_length,
                max_manifold_length=max_manifold_length,
                min_mass=min_mass, max_mass=max_mass,
                solver_mode=solver_mode, n_threads=n_threads)
            return _grade(out, tol, optimal, solver_mode)

        lo, hi = nlp_box(n_segments, max_shoot, max_coast, min_shoot,
                         min_manifold_length, max_manifold_length,
                         min_mass, max_mass)
        return _mbh_loop(_solve, guesses, energies, mbh_rounds, mbh_sigma,
                         mbh_seed, lo, hi)

    cost, pos_err, vel_err, terminal_mass = native.evaluate_batch(
        guesses, energies, spiral_end, n_segments=n_segments,
        thrust=thrust, min_manifold_length=min_manifold_length,
        max_manifold_length=max_manifold_length, n_threads=n_threads)
    out = {"refined": guesses, "cost": cost, "pos_err": pos_err,
           "vel_err": vel_err, "final_mass": guesses[:, 63].copy(),
           "terminal_mass": terminal_mass, "iters": np.zeros(len(guesses), np.int32),
           "stationarity": np.full(len(guesses), 1e6),
           "opt_gain": np.full(len(guesses), 1e6)}
    return _grade(out, tol, optimal, solver_mode)


def _grade(out: dict, tol: float, optimal: bool, solver_mode: str) -> dict:
    """Solver outputs -> graded result dict (feasible/optimal/inform)."""
    cost, final_mass = out["cost"], out["final_mass"]
    sane = (np.isfinite(cost) & (cost < 1e5)
            & (final_mass > 300.0) & (final_mass < 1000.1))
    feasible = sane & (cost < tol)
    certified = feasible & optimal & (out["opt_gain"] < _OPT_GAIN_TOL)
    inform = np.where(certified, 1, np.where(feasible, 3, 13))
    return {"feasible": feasible, "optimal": certified, "inform": inform,
            "cost": cost, "pos_err": out["pos_err"],
            "vel_err": out["vel_err"], "refined": out["refined"],
            "iters": out["iters"], "final_mass": final_mass,
            "terminal_mass": out["terminal_mass"],
            "stationarity": out["stationarity"],
            "opt_gain": out["opt_gain"], "solver_mode": solver_mode}
