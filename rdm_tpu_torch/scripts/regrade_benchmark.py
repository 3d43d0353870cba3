"""Regrade a benchmark result's physical validation in place.

    python -m rdm_tpu_torch.scripts.regrade_benchmark <result_dir> [...]
        [--oracle_backend tpu] [--oracle_precision df32] [--mbh_rounds 8]
        [--max_iters 30] [--solver_mode optimal]

A result directory (``<dir>/gto_halo/``) keeps the physical samples
(``generated_samples.npy``) beside the metrics computed when they were
graded.  This reruns only the physical validation on the stored samples
with the oracle configuration given and rewrites ``gto_halo_results.json``
and ``summary.txt``: the previous numbers move to
``physical_validation_pre_regrade`` and the new block records what it was
regraded from (``regraded_from``).  It writes into the directory it is
given: point it at a copy to keep the original.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..benchmark.gto_halo import GTOHaloBenchmarkConfig, GTOHaloBenchmarker


def regrade(result_dir: str, *, oracle_backend: str, oracle_precision: str,
            mbh_rounds: int, max_iters: int, solver_mode: str, device=None) -> dict:
    gto_dir = os.path.join(result_dir, "gto_halo")
    samples = np.load(os.path.join(gto_dir, "generated_samples.npy"))
    results_path = os.path.join(gto_dir, "gto_halo_results.json")
    with open(results_path) as f:
        results = json.load(f)

    # a benchmarker shell around the stored samples: grading reads only .config
    bench = GTOHaloBenchmarker.__new__(GTOHaloBenchmarker)
    bench.config = GTOHaloBenchmarkConfig(
        model_path="<regrade>", output_dir=gto_dir, oracle_backend=oracle_backend,
        oracle_precision=oracle_precision, oracle_mbh_rounds=mbh_rounds,
        oracle_max_iters=max_iters, solver_mode=solver_mode, num_samples=len(samples),
        batch_size=len(samples), device=device)
    bench.total_spherical_clips = 0
    bench.total_spherical_elements = 0

    old = results.get("physical_validation")
    new = bench.compute_physical_validation_metrics(samples)
    new["regraded_from"] = {
        "oracle_backend": (old or {}).get("oracle_backend"),
        "oracle_grading_precision": (old or {}).get("oracle_grading_precision", "f32"),
        "feasible_ratio": (old or {}).get("feasible_ratio"),
        "local_optimal_ratio": (old or {}).get("local_optimal_ratio"),
    }
    results["physical_validation_pre_regrade"] = old
    results["physical_validation"] = new
    with open(results_path, "w") as f:
        json.dump(results, f, indent=2, default=str)
    # summary.txt as save_results writes it (the pre-regrade block stays in the JSON)
    lines = ["=" * 60, "GTO HALO BENCHMARK RESULTS", "=" * 60, ""]
    for section, vals in results.items():
        if section == "physical_validation_pre_regrade":
            continue
        lines.append(f"{section.upper()}:")
        if isinstance(vals, dict):
            for k, v in vals.items():
                lines.append(f"  {k}: {v}")
        lines.append("")
    with open(os.path.join(gto_dir, "summary.txt"), "w") as f:
        f.write("\n".join(lines))
    print(f"{result_dir}: feasible {new['feasible_ratio']:.4f} "
          f"(was {(old or {}).get('feasible_ratio')}), optimal "
          f"{new['local_optimal_ratio']:.4f} "
          f"[{oracle_backend}/{oracle_precision}, LM-{max_iters}, MBH-{mbh_rounds}]")
    return new


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("result_dirs", nargs="+")
    p.add_argument("--oracle_backend", default="tpu")
    p.add_argument("--oracle_precision", default="df32")
    p.add_argument("--mbh_rounds", type=int, default=8)
    p.add_argument("--max_iters", type=int, default=30)
    p.add_argument("--solver_mode", default="optimal")
    p.add_argument("--device", default=None, help="tpu backend: default the CUDA card")
    args = p.parse_args(argv)
    return [regrade(d, oracle_backend=args.oracle_backend,
                    oracle_precision=args.oracle_precision, mbh_rounds=args.mbh_rounds,
                    max_iters=args.max_iters, solver_mode=args.solver_mode,
                    device=args.device) for d in args.result_dirs]


if __name__ == "__main__":
    main()
