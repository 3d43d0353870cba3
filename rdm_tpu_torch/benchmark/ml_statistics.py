"""ML statistics benchmark: generated (N, 67) model-space samples against
the training pickle (MSE, MAE, mean and std of the absolute error,
histogram KL, 1-D Wasserstein distance) and the sampling efficiency;
JSON + summary.txt + plots.  MSE and MAE are numpy means in the samples'
dtype, as sklearn computes them."""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

from .common import LoadedModel, generate_raw_samples, sampling_efficiency_metrics


@dataclasses.dataclass
class MLStatisticsConfig:
    model_path: str
    config_path: Optional[str] = None
    data_path: Optional[str] = None
    num_samples: int = 100
    batch_size: int = 50
    sampling_method: str = "pc"
    guidance_weight: float = 0.0
    output_dir: str = "benchmark_results/ml_statistics"
    save_samples: bool = True
    save_plots: bool = True
    device: Optional[str] = None
    test_mode: bool = False


def save_plots_or_say(generate, *args) -> None:
    """Run ``generate(plt, *args)`` with matplotlib's Agg backend, or print
    one line saying the plots were skipped when matplotlib is missing."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is not installed: plots skipped")
        return
    generate(plt, *args)


class MLStatisticsBenchmarker:
    def __init__(self, config: MLStatisticsConfig):
        self.config = config
        if config.test_mode:
            config.num_samples = min(config.num_samples, 10)
            config.batch_size = min(config.batch_size, 5)
        self.lm = LoadedModel(config.model_path, config.config_path, device=config.device)
        if config.sampling_method:
            self.lm.cfg.sampling.method = config.sampling_method

    def generate_samples(self):
        return generate_raw_samples(self.lm, self.config.num_samples,
                                    self.config.batch_size,
                                    guidance_weight=self.config.guidance_weight)

    # ------------------------------------------------------------------ #
    def load_reference_data(self) -> Optional[np.ndarray]:
        path = self.config.data_path or self.lm.cfg.data.get("pkl_path")
        try:
            if path and os.path.exists(path):
                if path.endswith(".pkl"):
                    with open(path, "rb") as f:
                        return np.asarray(pickle.load(f))
                if path.endswith(".npy"):
                    return np.load(path)
        except (OSError, pickle.UnpicklingError, ValueError) as e:
            print(f"Warning: Could not load reference data: {e}")
        return None

    def compute_standard_metrics(self, samples, reference) -> Dict[str, float]:
        n = min(samples.shape[0], reference.shape[0])
        s, r = samples[:n], reference[:n]
        d = min(s.shape[1], r.shape[1])
        s, r = s[:, :d], r[:, :d]
        abs_err = np.abs(s - r)
        return {
            # per-column means, then their mean (sklearn's uniform average)
            "mse": float(np.average(np.average((r - s) ** 2, axis=0))),
            "mae": float(np.average(np.average(np.abs(s - r), axis=0))),
            "mean_error": float(np.mean(abs_err)),
            "std_error": float(np.std(abs_err)),
            "kl_divergence": self.compute_kl_divergence(s, r),
            "wasserstein_distance": self.compute_wasserstein_distance(s, r),
        }

    @staticmethod
    def compute_kl_divergence(samples, reference) -> float:
        """KL(reference || samples) of 50-bin histograms of all values; inf
        when a histogram has no finite range (non-finite samples)."""
        try:
            hs, _ = np.histogram(samples.ravel(), bins=50, density=True)
            hr, _ = np.histogram(reference.ravel(), bins=50, density=True)
        except ValueError:
            return float("inf")
        eps = 1e-10
        hs, hr = hs + eps, hr + eps
        hs, hr = hs / hs.sum(), hr / hr.sum()
        return float(np.sum(hr * np.log(hr / hs)))

    @staticmethod
    def compute_wasserstein_distance(samples, reference) -> float:
        from scipy.stats import wasserstein_distance
        return float(wasserstein_distance(samples.ravel(), reference.ravel()))

    @staticmethod
    def compute_image_metrics(samples, reference) -> Dict[str, float]:
        """PSNR/SSIM (one window per image) of [N, H, W, C] float arrays in
        [0, 1], quantised to 8 bits."""
        n = min(samples.shape[0], reference.shape[0])
        s = np.clip(np.round(samples[:n] * 255), 0, 255)
        r = np.clip(np.round(reference[:n] * 255), 0, 255)
        psnrs, ssims = [], []
        c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
        for i in range(n):
            mse = float(np.mean((s[i] - r[i]) ** 2))
            psnrs.append(10 * np.log10(255.0**2 / max(mse, 1e-12)))
            mu_s, mu_r = s[i].mean(), r[i].mean()
            var_s, var_r = s[i].var(), r[i].var()
            cov = float(np.mean((s[i] - mu_s) * (r[i] - mu_r)))
            ssims.append(((2 * mu_s * mu_r + c1) * (2 * cov + c2))
                         / ((mu_s**2 + mu_r**2 + c1) * (var_s + var_r + c2)))
        return {"psnr_mean": float(np.mean(psnrs)),
                "psnr_std": float(np.std(psnrs)),
                "ssim_mean": float(np.mean(ssims)),
                "ssim_std": float(np.std(ssims))}

    # ------------------------------------------------------------------ #
    def run_benchmark(self) -> Dict[str, Any]:
        print("Starting ML statistics benchmark...")
        samples, sampling_times = self.generate_samples()
        reference = self.load_reference_data()

        results: Dict[str, Any] = {}
        if reference is not None:
            results["standard_metrics"] = self.compute_standard_metrics(samples, reference)
        results["sampling_efficiency"] = sampling_efficiency_metrics(sampling_times)

        self.save_results(results, samples)
        if self.config.save_plots:
            save_plots_or_say(self.generate_plots, samples, reference)
        return results

    def save_results(self, results: Dict[str, Any], samples: np.ndarray):
        out = self.config.output_dir
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "ml_statistics_results.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)
        if self.config.save_samples:
            np.save(os.path.join(out, "generated_samples.npy"), samples)
        lines = ["=" * 60, "ML STATISTICS BENCHMARK RESULTS", "=" * 60]
        if "standard_metrics" in results:
            lines.append("\nSTANDARD METRICS:")
            lines += [f"  {k}: {v:.6f}" for k, v in results["standard_metrics"].items()]
        if "sampling_efficiency" in results:
            lines.append("\nSAMPLING EFFICIENCY:")
            lines += [f"  {k}: {v:.6f}" for k, v in results["sampling_efficiency"].items()]
        lines.append("\n" + "=" * 60)
        with open(os.path.join(out, "summary.txt"), "w") as f:
            f.write("\n".join(lines))
        print("\n".join(lines))

    def generate_plots(self, plt, samples, reference=None):
        out = os.path.join(self.config.output_dir, "plots")
        os.makedirs(out, exist_ok=True)
        fig, ax = plt.subplots(figsize=(7, 5))
        ax.hist(samples.ravel(), bins=60, alpha=0.6, density=True, label="generated")
        if reference is not None:
            ax.hist(np.asarray(reference).ravel(), bins=60, alpha=0.6,
                    density=True, label="reference")
        ax.legend()
        ax.set_title("value distributions")
        fig.savefig(os.path.join(out, "distributions.png"), dpi=100)
        plt.close(fig)
