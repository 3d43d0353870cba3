"""GTO halo domain benchmark.

Pipeline: EMA sampling -> (N, 81) -> (N, 67) -> inverse data pipeline
(de-standardise the model outputs with the run's ``data.gto_mean`` and
``data.gto_std``, unnormalise each variable to physical units, cartesian ->
spherical controls with clip counts) -> component statistics -> physical
validation through the CR3BP oracle -> JSON + summary.txt + plots.

The port grades with the ``native`` oracle: one batched C++ solve whose
threads fan out over the host's cores (``max_workers``).  The other
backends raise ``NotImplementedError`` (``physics.oracle``); an unset
backend follows the JAX package's rule, under which a card picks
``hybrid``, so on the card the caller passes ``--oracle_backend native``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..physics import oracle as oracle_lib
from ..sde import RVESDE
from .common import LoadedModel, generate_raw_samples, sampling_efficiency_metrics
from .ml_statistics import save_plots_or_say

# physical unnormalisation constants
MIN_SHOOTING_TIME, MAX_SHOOTING_TIME = 0.0, 40.0
MIN_COAST_TIME, MAX_COAST_TIME = 0.0, 15.0
MIN_HALO_ENERGY, MAX_HALO_ENERGY = 0.008, 0.095
MIN_FUEL_MASS, MAX_FUEL_MASS = 408.0, 470.0
MIN_MANIFOLD_LENGTH, MAX_MANIFOLD_LENGTH = 5.0, 11.0
THRUST = 1.0
# the reference's de-standardisation, for runs whose config records none
GTO_MEAN, GTO_STD = 0.4652, 0.1811


@dataclasses.dataclass
class GTOHaloBenchmarkConfig:
    model_path: str
    config_path: Optional[str] = None
    num_samples: int = 100
    batch_size: int = 50
    sampling_method: str = "pc"
    guidance_weight: float = 0.0
    enable_physical_validation: bool = True
    output_dir: str = "benchmark_results/gto_halo"
    save_samples: bool = True
    save_plots: bool = True
    device: Optional[str] = None
    max_workers: Optional[int] = None
    test_mode: bool = False
    oracle_backend: Optional[str] = None  # None: the automatic rule
    solver_mode: str = "optimal"
    oracle_max_iters: int = 30
    # monotonic basin hops of still-infeasible lanes
    oracle_mbh_rounds: int = 8
    # solver arithmetic of the tpu and hybrid backends (not ported)
    oracle_precision: str = "df32"
    # the SDE's discretisation steps for sampling (None: the run's own N)
    num_steps: Optional[int] = None


class GTOHaloBenchmarker:
    def __init__(self, config: GTOHaloBenchmarkConfig):
        self.config = config
        if config.test_mode:
            config.num_samples = min(config.num_samples, 10)
            config.batch_size = min(config.batch_size, 5)
        self.lm = LoadedModel(config.model_path, config.config_path, device=config.device)
        if config.sampling_method:
            self.lm.cfg.sampling.method = config.sampling_method
        self.total_spherical_clips = 0
        self.total_spherical_elements = 0
        if config.enable_physical_validation:
            self.oracle_backend()           # an unported backend raises before sampling

    # ------------------------------------------------------------------ #
    def generate_samples(self):
        sde_override = None
        if self.config.num_steps:
            c = self.lm.cfg.sde
            sde_override = RVESDE(c.sigma_min, c.sigma_max, int(self.config.num_steps))
        raw, times = generate_raw_samples(
            self.lm, self.config.num_samples, self.config.batch_size,
            guidance_weight=self.config.guidance_weight, sde_override=sde_override)
        return self._inverse_pipeline(raw), times

    def _inverse_pipeline(self, samples: np.ndarray) -> np.ndarray:
        """(N, 67) model-space -> physical 67-vectors (float64)."""
        class_labels_normalized = samples[:, 0]
        out = samples[:, 1:].astype(np.float64)

        # de-standardise with the mean/std the run was trained with
        lm = getattr(self, "lm", None)
        data_cfg = lm.cfg.data if lm is not None else {}
        out = (out * data_cfg.get("gto_std", GTO_STD)
               + data_cfg.get("gto_mean", GTO_MEAN))

        # times
        out[:, 0] = out[:, 0] * (MAX_SHOOTING_TIME - MIN_SHOOTING_TIME) + MIN_SHOOTING_TIME
        out[:, 1] = out[:, 1] * (MAX_COAST_TIME - MIN_COAST_TIME) + MIN_COAST_TIME
        out[:, 2] = out[:, 2] * (MAX_COAST_TIME - MIN_COAST_TIME) + MIN_COAST_TIME

        # cartesian controls back to [-1, 1], then -> spherical
        out[:, 3:-3] = out[:, 3:-3] * 2 * THRUST - THRUST
        ctrl = out[:, 3:-3]
        n_trip = ctrl.shape[1] // 3
        ctrl = ctrl[:, :n_trip * 3].reshape(-1, n_trip, 3)
        alpha, beta, r = self._convert_to_spherical(ctrl[:, :, 0], ctrl[:, :, 1], ctrl[:, :, 2])
        ctrl[:, :, 0], ctrl[:, :, 1], ctrl[:, :, 2] = alpha, beta, r
        out[:, 3:3 + n_trip * 3] = ctrl.reshape(-1, n_trip * 3)

        # fuel mass / manifold length; the halo period stays normalised
        out[:, -3] = out[:, -3] * (MAX_FUEL_MASS - MIN_FUEL_MASS) + MIN_FUEL_MASS
        out[:, -1] = out[:, -1] * (MAX_MANIFOLD_LENGTH - MIN_MANIFOLD_LENGTH) + MIN_MANIFOLD_LENGTH

        halo_energies = class_labels_normalized * (MAX_HALO_ENERGY - MIN_HALO_ENERGY) + MIN_HALO_ENERGY
        return np.column_stack((halo_energies, out))

    def _convert_to_spherical(self, ux, uy, uz):
        """Cartesian controls -> (alpha, beta, |u| clipped at 1), counting
        the clipped magnitudes."""
        u = np.sqrt(ux**2 + uy**2 + uz**2)
        theta = np.zeros_like(u)
        nz = u != 0
        theta[nz] = np.arcsin(np.clip(uz[nz] / u[nz], -1, 1))
        alpha = np.arctan2(uy, ux)
        alpha = np.where(alpha >= 0, alpha, 2 * np.pi + alpha)
        theta = np.where(theta >= 0, theta, 2 * np.pi + theta)

        clips = int(np.sum(u > 1))
        self.total_spherical_clips += clips
        self.total_spherical_elements += u.size
        if clips:
            print(f"SPHERICAL CONVERSION CLIPPING: {clips}/{u.size} values "
                  f"({100 * clips / u.size:.2f}%) exceeded magnitude 1")
        u = np.minimum(u, 1.0)
        return alpha, theta, u

    # ------------------------------------------------------------------ #
    def compute_gto_halo_metrics(self, samples: np.ndarray) -> Dict[str, Any]:
        """Component statistics of the physical samples."""
        if samples.size == 0:
            return {}
        groups = {
            "class_label": samples[:, 0],
            "time_vars": samples[:, 1:4],
            "thrust_vars": samples[:, 4:64],
            "mass_vars": samples[:, 64:67],
        }
        metrics: Dict[str, Any] = {}
        for name, arr in groups.items():
            metrics[f"{name}_mean"] = float(np.mean(arr))
            metrics[f"{name}_std"] = float(np.std(arr))
            metrics[f"{name}_min"] = float(np.min(arr))
            metrics[f"{name}_max"] = float(np.max(arr))
        metrics["has_nan"] = bool(np.any(np.isnan(samples)))
        metrics["has_inf"] = bool(np.any(np.isinf(samples)))
        return metrics

    # ------------------------------------------------------------------ #
    def oracle_backend(self) -> str:
        """The configured backend, or the automatic rule's choice with "an
        accelerator is present" read as ``torch.cuda.is_available()``;
        raises ``NotImplementedError`` for a backend the port does not run
        (on the card the rule picks ``hybrid``)."""
        backend = self.config.oracle_backend or oracle_lib.auto_backend(
            torch.cuda.is_available())
        if backend != "native":
            raise oracle_lib.unported_backend(backend)
        return backend

    def compute_physical_validation_metrics(self, samples: np.ndarray) -> Dict[str, Any]:
        cfgb = self.config
        if not cfgb.enable_physical_validation:
            return {
                "physical_validation_disabled": True,
                "reason": "disabled by configuration",
                "missing_metrics": [
                    "feasible_solution_ratio", "local_optimal_solution_ratio",
                    "average_final_mass_feasible", "average_final_mass_optimal",
                    "snopt_inform_distribution", "solving_time_analysis"],
            }
        backend = self.oracle_backend()
        print(f"Computing physical validation via the {backend} oracle...")
        # ONE batched LM solve of the whole batch; the C++ library fans it
        # out over a std::thread pool.
        t0 = time.time()
        res = oracle_lib.evaluate_warmstarts_native(
            samples[:, 1:].astype(np.float64),
            samples[:, 0].astype(np.float64),
            max_iters=cfgb.oracle_max_iters,
            solver_mode=cfgb.solver_mode,
            mbh_rounds=cfgb.oracle_mbh_rounds,
            n_threads=cfgb.max_workers or 0)
        per_sample_time = (time.time() - t0) / max(len(samples), 1)
        results = [{
            "results.control": res["refined"][i],
            "feasibility": bool(res["feasible"][i]),
            "snopt_inform": int(res["inform"][i]),
            "thrust": 1.0,
            "solving_time": per_sample_time,
            "cost_alpha": float(samples[i, 0]),
            # the SOLVED mass variable; terminal_mass is the forward-
            # propagated mass (the scales differ)
            "final_mass": float(res["final_mass"][i]),
            "terminal_mass": float(res["terminal_mass"][i]),
        } for i in range(len(samples))]
        metrics = self.compute_cr3bp_statistics(results)
        metrics.update({
            "oracle_backend": backend,
            "oracle_note": ("C++ Levenberg-Marquardt local solve of the "
                            "manifold-insertion NLP for each warm start "
                            "(pydylan/SNOPT unavailable); feasible = the local "
                            "solver converged from the sample"),
            "oracle_solver_mode": cfgb.solver_mode,
            "oracle_mbh_rounds": cfgb.oracle_mbh_rounds,
            "oracle_grading_precision": "f64",
            "oracle_wall_time_with_compile_s": time.time() - t0,
            "avg_solving_time_includes_compile": False,
            "mean_refine_iters": float(np.mean(res["iters"])),
            "mean_terminal_pos_error": float(np.mean(res["pos_err"])),
            "mean_terminal_vel_error": float(np.mean(res["vel_err"])),
        })
        return metrics

    def compute_cr3bp_statistics(self, results: List[Dict]) -> Dict[str, Any]:
        """Feasible and locally optimal ratios, their mean final masses, the
        solve times and the inform distribution."""
        if not results:
            return {}
        total = len(results)
        feasible = [r for r in results if r["feasibility"]]
        optimal = [r for r in results if r["feasibility"] and r.get("snopt_inform") == 1]

        def final_mass(rs):
            # the solver-reported mass, else control[-3] (the solved mass)
            vals = [r["final_mass"] if r.get("final_mass") is not None
                    else r["results.control"][-3] for r in rs
                    if r.get("final_mass") is not None
                    or r.get("results.control") is not None]
            return float(np.mean(vals)) if vals else 0.0

        informs = [r["snopt_inform"] for r in results if r.get("snopt_inform") is not None]
        dist: Dict[int, int] = {}
        for i in informs:
            dist[i] = dist.get(i, 0) + 1
        return {
            "feasible_ratio": len(feasible) / total,
            "avg_final_mass_feasible": final_mass(feasible),
            "local_optimal_ratio": len(optimal) / total,
            "avg_final_mass_optimal": final_mass(optimal),
            "avg_solving_time": float(np.mean([r["solving_time"] for r in results])),
            "snopt_inform_distribution": dist,
            "total_tested": total,
            "feasible_count": len(feasible),
            "local_optimal_count": len(optimal),
        }

    # ------------------------------------------------------------------ #
    def run_benchmark(self) -> Dict[str, Any]:
        print("Starting GTO Halo comprehensive benchmark...")
        samples, sampling_times = self.generate_samples()

        results: Dict[str, Any] = {}
        results["benchmark_config"] = {
            "model_path": self.config.model_path,
            "num_samples": self.config.num_samples,
            "sampling_method": self.config.sampling_method,
            "guidance_weight": self.config.guidance_weight,
            "num_steps": self.config.num_steps or int(self.lm.sde.N),
            "oracle_backend": self.config.oracle_backend,
            "oracle_max_iters": self.config.oracle_max_iters,
            "oracle_mbh_rounds": self.config.oracle_mbh_rounds,
            "oracle_precision": self.config.oracle_precision,
            "solver_mode": self.config.solver_mode,
        }
        results["gto_halo_metrics"] = self.compute_gto_halo_metrics(samples)
        results["physical_validation"] = self.compute_physical_validation_metrics(samples)
        results["sampling_efficiency"] = sampling_efficiency_metrics(sampling_times)

        self.save_results(results, samples)
        if self.config.save_plots:
            save_plots_or_say(self.generate_plots, samples)
        self.print_spherical_conversion_stats()
        return results

    # ------------------------------------------------------------------ #
    def save_results(self, results: Dict[str, Any], samples: np.ndarray):
        out = self.config.output_dir
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "gto_halo_results.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)
        if self.config.save_samples:
            np.save(os.path.join(out, "generated_samples.npy"), samples)
            with open(os.path.join(out, "generated_samples.pkl"), "wb") as f:
                pickle.dump(samples, f)
        lines = ["=" * 60, "GTO HALO BENCHMARK RESULTS", "=" * 60, ""]
        for section, vals in results.items():
            lines.append(f"{section.upper()}:")
            if isinstance(vals, dict):
                for k, v in vals.items():
                    lines.append(f"  {k}: {v}")
            lines.append("")
        with open(os.path.join(out, "summary.txt"), "w") as f:
            f.write("\n".join(lines))
        print("\n".join(lines))

    def print_spherical_conversion_stats(self):
        out = self.config.output_dir
        os.makedirs(out, exist_ok=True)
        total, clips = self.total_spherical_elements, self.total_spherical_clips
        rate = 100 * clips / total if total else 0.0
        text = (f"SPHERICAL CONVERSION CLIPPING STATS\n"
                f"total elements: {total}\nclipped: {clips}\nrate: {rate:.4f} %\n")
        with open(os.path.join(out, "spherical_clipping_stats.txt"), "w") as f:
            f.write(text)
        print(text)

    def generate_plots(self, plt, samples: np.ndarray):
        out = os.path.join(self.config.output_dir, "plots")
        os.makedirs(out, exist_ok=True)
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        axes[0, 0].hist(samples[:, 0], bins=30)
        axes[0, 0].set_title("halo energy")
        axes[0, 1].hist(samples[:, 1], bins=30)
        axes[0, 1].set_title("shooting time")
        axes[1, 0].hist(samples[:, 4:64].ravel(), bins=50)
        axes[1, 0].set_title("controls (spherical)")
        axes[1, 1].hist(samples[:, 64], bins=30)
        axes[1, 1].set_title("fuel mass")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "component_distributions.png"), dpi=100)
        plt.close(fig)
