"""Offline analysis of the GTO halo training pickle: component
distributions, the 9x9 layout's mean and spread, classifier statistics,
values outside [0, 1], correlations, PCA and outliers.  Writes the results
pickle and, where matplotlib is installed, four figures.

    python -m rdm_tpu_torch.telemetry.comprehensive_data_analysis \
        --pkl_path datasets/training_data_boundary_80073.pkl --output_dir data_analysis
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..benchmark.ml_statistics import save_plots_or_say
from ..data import GTOHaloImageDataset

FIGURES = ("component_distributions.png", "spatial_patterns.png", "correlations.png",
           "pca_outliers.png")


def compute(ds: GTOHaloImageDataset) -> tuple:
    """The numbers of the analysis, and what the figures draw."""
    raw = ds.raw                                  # [N, 67] in [0, 1]
    images = ds.images[:, 0]                      # [N, 9, 9] standardised
    labels = ds.labels[:, 0]
    results: dict = {"n_samples": len(ds)}

    # 1. component distributions
    groups = {"halo energy (label)": raw[:, 0], "times": raw[:, 1:4].ravel(),
              "controls": raw[:, 4:64].ravel(), "fuel mass": raw[:, 64],
              "halo period": raw[:, 65], "manifold length": raw[:, 66]}
    for name, arr in groups.items():
        results[f"stats/{name}"] = dict(mean=float(arr.mean()), std=float(arr.std()),
                                        min=float(arr.min()), max=float(arr.max()))
    # 2. the 9x9 layout
    results["spatial_mean"] = images.mean(0)
    results["spatial_std"] = images.std(0)
    # 3. classifier
    results["classifier"] = dict(mean=float(labels.mean()), std=float(labels.std()),
                                 min=float(labels.min()), max=float(labels.max()))
    # 4. values outside [0, 1] before standardisation
    viol = ((raw < 0) | (raw > 1)).sum(0)
    results["boundary_violations_per_dim"] = viol
    results["boundary_violation_total"] = int(viol.sum())
    # 5. correlations
    results["correlation_matrix"] = np.corrcoef(raw.T)
    # 6. PCA and outliers
    x = raw - raw.mean(0)
    evals, evecs = np.linalg.eigh(np.cov(x.T))
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    proj = x @ evecs[:, :2]
    dist = np.linalg.norm(x @ evecs[:, :10] / np.sqrt(evals[:10] + 1e-12), axis=1)
    outliers = np.argsort(dist)[-10:]
    results["pca_explained_variance_ratio"] = evals / evals.sum()
    results["outlier_indices"] = outliers
    return results, {"groups": groups, "proj": proj}


def draw(plt, results: dict, extra: dict, output_dir: str) -> None:
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    for ax, (name, arr) in zip(axes.ravel(), extra["groups"].items()):
        ax.hist(arr, bins=50, density=True)
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, FIGURES[0]), dpi=110)
    plt.close(fig)

    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    for ax, (name, img) in zip(axes, [("mean", results["spatial_mean"]),
                                      ("std", results["spatial_std"])]):
        im = ax.imshow(img, cmap="viridis")
        ax.set_title(f"9x9 {name}")
        fig.colorbar(im, ax=ax)
    fig.savefig(os.path.join(output_dir, FIGURES[1]), dpi=110)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(results["correlation_matrix"], cmap="RdBu_r", vmin=-1, vmax=1)
    fig.colorbar(im, ax=ax)
    ax.set_title("component correlations")
    fig.savefig(os.path.join(output_dir, FIGURES[2]), dpi=110)
    plt.close(fig)

    proj, outliers = extra["proj"], results["outlier_indices"]
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.scatter(proj[:, 0], proj[:, 1], s=3, alpha=0.3)
    ax.scatter(proj[outliers, 0], proj[outliers, 1], s=20, color="red", label="top outliers")
    ax.legend()
    ax.set_title("PCA projection")
    fig.savefig(os.path.join(output_dir, FIGURES[3]), dpi=110)
    plt.close(fig)


def analyze(pkl_path: str, output_dir: str = "data_analysis") -> dict:
    """Analyse ``pkl_path`` into ``output_dir`` (``analysis_results.pkl``
    and the figures); returns the results."""
    os.makedirs(output_dir, exist_ok=True)
    results, extra = compute(GTOHaloImageDataset(pkl_path))
    save_plots_or_say(draw, results, extra, output_dir)
    with open(os.path.join(output_dir, "analysis_results.pkl"), "wb") as f:
        pickle.dump(results, f)
    print(f"analysis complete -> {output_dir}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pkl_path", required=True)
    p.add_argument("--output_dir", default="data_analysis")
    args = p.parse_args(argv)
    return analyze(args.pkl_path, args.output_dir)


if __name__ == "__main__":
    main()
