"""Benchmark CLI: ML statistics and the GTO halo benchmark of a training run.

    python -m rdm_tpu_torch.run_benchmark --model_path "Training Runs/<run>" \\
        --benchmark_type both --num_samples 1024 --batch_size 1024 \\
        --sampling_method ode --oracle_backend native

It samples on the card unless ``--device cpu`` names the CPU; the native
oracle grades on the host's cores.  ``--test_mode`` caps the run at 10
samples in batches of 5.  Results go under ``--output_dir``:
``ml_statistics/`` and ``gto_halo/`` with their JSON, summary.txt and
samples.
"""
from __future__ import annotations

import argparse
import os

from .physics.oracle import BACKENDS


def make_parser():
    p = argparse.ArgumentParser(description="Comprehensive diffusion model evaluation")
    p.add_argument("--benchmark_type", default="both",
                   choices=["ml_only", "gto_halo_only", "both"])
    p.add_argument("--model_path", required=True,
                   help="training run directory (contains .hydra/ and checkpoints/)")
    p.add_argument("--config_path", default=None,
                   help="directory with .hydra/config.yaml if different from model_path")
    p.add_argument("--data_path", default=None,
                   help="reference pkl for ML statistics")
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--sampling_method", default="pc", choices=["pc", "ode"])
    p.add_argument("--num_steps", type=int, default=None,
                   help="override the run config's SDE discretisation steps "
                        "(default: the run's own N)")
    p.add_argument("--guidance_weight", type=float, default=0.0)
    p.add_argument("--enable_physical_validation", action="store_true", default=True)
    p.add_argument("--disable_physical_validation", dest="enable_physical_validation",
                   action="store_false")
    p.add_argument("--oracle_backend", default=None, choices=[None, *BACKENDS],
                   help="default auto: pydylan > hybrid > tpu (with a card) > native; "
                        "only native runs in this package, the others raise")
    p.add_argument("--max_workers", type=int, default=None,
                   help="threads of the native oracle (default: every core)")
    p.add_argument("--oracle_mbh_rounds", type=int, default=8,
                   help="monotonic basin hops of still-infeasible lanes; 0 = one "
                        "cold local solve per sample")
    p.add_argument("--oracle_precision", default="df32", choices=["df32", "f32"],
                   help="solver arithmetic of the tpu and hybrid backends")
    p.add_argument("--output_dir", default="benchmark_results")
    p.add_argument("--save_samples", action="store_true", default=True)
    p.add_argument("--save_plots", action="store_true", default=True)
    p.add_argument("--device", default=None,
                   help="sampling device (default: the card; 'cpu' runs on the CPU)")
    p.add_argument("--test_mode", action="store_true",
                   help="cap at 10 samples / batch 5 for smoke testing")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)

    from .benchmark import (GTOHaloBenchmarker, GTOHaloBenchmarkConfig,
                            MLStatisticsBenchmarker, MLStatisticsConfig)

    # both benchmarkers are built (models loaded, the oracle backend
    # checked) before either samples
    runs = []
    if args.benchmark_type in ("ml_only", "both"):
        runs.append(("ml_statistics", "RUNNING ML STATISTICS BENCHMARK", MLStatisticsBenchmarker(
            MLStatisticsConfig(
                model_path=args.model_path, config_path=args.config_path,
                data_path=args.data_path, num_samples=args.num_samples,
                batch_size=args.batch_size, sampling_method=args.sampling_method,
                guidance_weight=args.guidance_weight,
                output_dir=os.path.join(args.output_dir, "ml_statistics"),
                save_samples=args.save_samples, save_plots=args.save_plots,
                device=args.device, test_mode=args.test_mode))))
    if args.benchmark_type in ("gto_halo_only", "both"):
        runs.append(("gto_halo", "RUNNING GTO HALO BENCHMARK", GTOHaloBenchmarker(
            GTOHaloBenchmarkConfig(
                model_path=args.model_path, config_path=args.config_path,
                num_samples=args.num_samples, batch_size=args.batch_size,
                sampling_method=args.sampling_method,
                guidance_weight=args.guidance_weight,
                enable_physical_validation=args.enable_physical_validation,
                output_dir=os.path.join(args.output_dir, "gto_halo"),
                save_samples=args.save_samples, save_plots=args.save_plots,
                device=args.device, max_workers=args.max_workers,
                test_mode=args.test_mode, oracle_backend=args.oracle_backend,
                oracle_mbh_rounds=args.oracle_mbh_rounds,
                oracle_precision=args.oracle_precision,
                num_steps=args.num_steps))))

    results = {}
    for key, banner, bench in runs:
        print("=" * 60)
        print(banner)
        print("=" * 60)
        results[key] = bench.run_benchmark()

    print("\nBenchmarks complete. Results under", args.output_dir)
    return results


if __name__ == "__main__":
    main()
