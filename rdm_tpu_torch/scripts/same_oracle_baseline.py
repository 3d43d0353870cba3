"""Grade the reference model's samples and this port's with one oracle.

    python -m rdm_tpu_torch.scripts.same_oracle_baseline [--model_path <run>]
        [--ref_samples PATH] [--backend native|tpu] [--out PATH]

The reference's checked-in ``samples.npy`` (50 physical 67-vectors, graded
0.86 feasible by its own SNOPT; ``--ref_samples``, or its place under
``$RDM_REFERENCE_ROOT``, and skipped without either) and, with
``--model_path``, samples of a
port run drawn through the benchmark's sampling and inverse pipeline
(``GTOHaloBenchmarker.generate_samples``) are graded by the same local
solve: LM with the mass ascent under monotonic basin hopping, on the host
(``native``, default) or on the card (``tpu``).  The reference's halo
period slot is in time units and is re-normalised by the orbit period
first.  Prints a table and one JSON line; ``--out`` writes the JSON too.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from ..physics.oracle import evaluate_warmstarts_native
from ..physics.solver_gpu import refine_warmstarts_gpu
from .study_common import load_reference_set, reference_path, reference_root, write_json

# the reference's checked-in samples, under a checkout of it
REF_SAMPLES = "Benchmark/benchmark_results/gto_halo_50samples_16workers_results/samples.npy"


def grade(samples67: np.ndarray, label: str, args) -> dict:
    """Grade [N, 67] physical samples whose halo period slot is already an
    orbit-phase fraction."""
    he = samples67[:, 0].astype(np.float64)
    G = samples67[:, 1:].astype(np.float64)
    kw = dict(max_iters=args.max_iters, solver_mode=args.solver_mode,
              mbh_rounds=args.mbh_rounds)
    if args.backend == "tpu":
        res = refine_warmstarts_gpu(G, he, device=args.device, **kw)
    else:
        res = evaluate_warmstarts_native(G, he, **kw)
    feas = res["feasible"]
    return {"samples": label, "n": int(len(G)), "feasible_ratio": float(feas.mean()),
            "local_optimal_ratio": float(res["optimal"].mean()),
            "avg_final_mass_feasible":
                float(res["final_mass"][feas].mean()) if feas.any() else None}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", default=None,
                   help="a trained run for the port's row; omit to grade only the reference")
    p.add_argument("--num_samples", type=int, default=50)
    p.add_argument("--guidance_weight", type=float, default=0.0)
    p.add_argument("--backend", default="native", choices=["native", "tpu"])
    p.add_argument("--solver_mode", default="optimal", choices=["feasible", "optimal"])
    p.add_argument("--max_iters", type=int, default=30)
    p.add_argument("--mbh_rounds", type=int, default=8)
    p.add_argument("--ref_samples", default=None,
                   help=f"the reference's samples (default: {REF_SAMPLES} under "
                        "$RDM_REFERENCE_ROOT; without either that row is skipped)")
    p.add_argument("--device", default=None,
                   help="device of the sampling and of the tpu backend (default: the card)")
    p.add_argument("--out", default=None, help="write the JSON here too")
    args = p.parse_args(argv)

    ref = args.ref_samples or reference_path(reference_root(), REF_SAMPLES)
    rows = [] if ref is None else [grade(load_reference_set(ref),
                                         "reference model (checked-in samples.npy)", args)]
    if args.model_path:
        from ..benchmark.gto_halo import GTOHaloBenchmarkConfig, GTOHaloBenchmarker
        b = GTOHaloBenchmarker(GTOHaloBenchmarkConfig(
            model_path=args.model_path, num_samples=args.num_samples,
            batch_size=min(args.num_samples, 512), guidance_weight=args.guidance_weight,
            enable_physical_validation=False, device=args.device,
            output_dir=os.path.join(tempfile.gettempdir(), "same_oracle_bench"),
            save_samples=False, save_plots=False))
        samples, _ = b.generate_samples()
        rows.append(grade(np.asarray(samples), f"rdm_tpu_torch model ({args.model_path})",
                          args))
    context = {"samples": "reference model, graded by reference SNOPT (its own summary.txt; "
                          "NOT the same oracle)",
               "n": 50, "feasible_ratio": 0.86, "local_optimal_ratio": 0.86,
               "avg_final_mass_feasible": None}

    oracle = (f"{args.backend} LM, solver_mode={args.solver_mode}, "
              f"max_iters={args.max_iters}, mbh_rounds={args.mbh_rounds}")
    print(f"\nSAME-ORACLE BASELINE (oracle: {oracle})")
    print("-" * 78)
    for r in rows:
        m = f"{r['avg_final_mass_feasible']:.1f}" if r["avg_final_mass_feasible"] else "n/a"
        print(f"{r['samples'][:52]:52s} n={r['n']:<5d} feas {r['feasible_ratio']:.2f} "
              f"opt {r['local_optimal_ratio']:.2f} mass {m}")
    print("-" * 78)
    print(f"{context['samples'][:52]:52s} n=50    feas 0.86 opt 0.86 (context only)")
    blob = {"oracle": oracle, "rows": rows, "context": context}
    print(json.dumps(blob))
    if args.out:
        write_json(args.out, blob)
    return blob


if __name__ == "__main__":
    main()
