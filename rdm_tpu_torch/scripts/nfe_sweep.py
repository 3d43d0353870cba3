"""Warm-start quality against the number of PC steps.

    python -m rdm_tpu_torch.scripts.nfe_sweep ["Training Runs/<run>"] [n]
        [--steps 100,250,500,1000] [--precision df32] [--seed 0]
        [--max_iters 30] [--mbh_rounds 8] [--timing_only] [--out PATH]

For each N in ``--steps`` the run's EMA model samples 2n trajectories in
batches of n with the PC sampler (Euler-Maruyama, w = 0) and the first n
are graded on the card by ``physics.solver_gpu.refine_warmstarts_gpu``
(``--backend native``: the host's C++ oracle):
LM-``--max_iters`` cold and with ``--mbh_rounds`` basin hops.  The steady
sampling time is the second batch's (the first builds the kernels and
cuDNN's plans).  Feasible ratios carry 95 % Wilson intervals.

Rows are keyed by (steps, seed, max_iters) and merged into an existing
artifact.  A grading run writes its own oracle block and stores
``precision`` and ``mbh_rounds`` in each row it grades (rows of a prior
artifact that lack them get the prior block's values first, so no row is
relabelled).  ``--timing_only`` re-measures the sampling times of rows that
exist, keeps the artifact's ``n`` and oracle block (its quality columns
were graded under them) and records the timing batch as ``timing_n``.

Default artifact: ``benchmark_results/torch/nfe_sweep.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..benchmark.common import generate_raw_samples
from ..benchmark.gto_halo import GTOHaloBenchmarkConfig, GTOHaloBenchmarker
from ..sde import RVESDE
from .study_common import FLAGSHIP_RUN, default_out, grade, rounded_ci, write_json

TIMING_NOTE = ("steady_sampling_s is the least wall time of the batches after the first of "
               "one generate_raw_samples call (the first builds the kernels and cuDNN's "
               "plans); each batch ends in a device synchronisation, and at low step counts "
               "a fixed per-call cost weighs more, so traj_per_s scales sub-linearly in 1/N "
               "there")


def _row_key(r, default_iters=30):
    return (r["steps"], r.get("seed", 0), r.get("max_iters", default_iters))


def _load_prior(path):
    if not os.path.exists(path):
        return None, []
    with open(path) as f:
        blob = json.load(f)
    return blob, blob["rows"]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir", nargs="?", default=FLAGSHIP_RUN)
    p.add_argument("n", nargs="?", type=int, default=1024)
    p.add_argument("--steps", default="100,250,500,1000")
    p.add_argument("--precision", default="df32")
    p.add_argument("--seed", type=int, default=0, help="sampling seed (replication rows)")
    p.add_argument("--max_iters", type=int, default=30)
    p.add_argument("--mbh_rounds", type=int, default=8)
    p.add_argument("--out", default=default_out("nfe_sweep.json"))
    p.add_argument("--backend", default="tpu", choices=["tpu", "native"],
                   help="tpu: refine_warmstarts_gpu on the card (or --device); native: the "
                        "host's C++ oracle (float64 whatever --precision says)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--timing_only", action="store_true",
                   help="re-measure the sampling times of existing rows and merge them into "
                        "the artifact; the quality columns and their n carry over")
    args = p.parse_args(argv)
    steps_list = [int(s) for s in args.steps.split(",")]

    prior_blob, prior_rows = _load_prior(args.out)
    if args.timing_only:
        # never fall through to grading: a missing artifact or step is a usage error
        if prior_blob is None:
            p.error(f"--timing_only needs an existing artifact at {args.out}")
        have = {r["steps"] for r in prior_rows}
        missing = [s for s in steps_list if s not in have]
        if missing:
            p.error(f"--timing_only: steps {missing} have no prior row in {args.out}; "
                    "run a full grading pass for them first")

    bench = GTOHaloBenchmarker(GTOHaloBenchmarkConfig(
        model_path=args.run_dir, num_samples=args.n, batch_size=args.n,
        enable_physical_validation=False, device=args.device,
        output_dir=os.path.join(tempfile.gettempdir(), "nfe_sweep")))
    cfg, device = bench.lm.cfg, bench.lm.device
    precision = args.precision if args.backend == "tpu" else "f64"
    oracle_meta = {"backend": args.backend, "precision": precision,
                   "max_iters": args.max_iters, "mbh_rounds": args.mbh_rounds,
                   "solver_mode": "optimal"}

    new_rows = []
    for steps in steps_list:
        sde = RVESDE(cfg.sde.sigma_min, cfg.sde.sigma_max, steps)
        raw2, t = generate_raw_samples(bench.lm, 2 * args.n, args.n, sde_override=sde,
                                       seed=args.seed)
        steady = min(t[1:])
        if args.timing_only:
            # the time depends only on the step count: refresh every row at it
            for r in prior_rows:
                if r["steps"] == steps:
                    r["steady_sampling_s"] = round(steady, 3)
                    r["traj_per_s"] = round(args.n / steady, 1)
                    r["timing_n"] = args.n
            print({"steps": steps, "steady_sampling_s": round(steady, 3),
                   "traj_per_s": round(args.n / steady, 1), "timing_n": args.n})
            continue
        phys = bench._inverse_pipeline(raw2[:args.n])
        guesses = phys[:, 1:].astype(np.float32)
        alphas = phys[:, 0].astype(np.float32)
        t0 = time.time()
        cold = grade(guesses, alphas, args.backend, device, max_iters=args.max_iters,
                     precision=args.precision)
        mbh = (grade(guesses, alphas, args.backend, device, max_iters=args.max_iters,
                     precision=args.precision, mbh_rounds=args.mbh_rounds)
               if args.mbh_rounds > 0 else cold)
        grade_s = time.time() - t0
        k_mbh = int(mbh["feasible"].sum())
        row = {
            "steps": steps, "seed": args.seed, "max_iters": args.max_iters,
            "precision": precision, "mbh_rounds": args.mbh_rounds,
            "steady_sampling_s": round(steady, 3),
            "traj_per_s": round(args.n / steady, 1),
            "feasible_cold": round(float(cold["feasible"].mean()), 4),
            "optimal_cold": round(float(cold["optimal"].mean()), 4),
            "median_pos_err_cold": round(float(np.median(cold["pos_err"])), 4),
            f"feasible_mbh{args.mbh_rounds}": round(k_mbh / args.n, 4),
            f"feasible_mbh{args.mbh_rounds}_ci95": rounded_ci(k_mbh, args.n),
            f"optimal_mbh{args.mbh_rounds}": round(float(mbh["optimal"].mean()), 4),
            "grading_s": round(grade_s, 1),
        }
        new_rows.append(row)
        print(row)

    if args.timing_only:
        out = dict(prior_blob, rows=prior_rows, timing_n=args.n, timing_note=TIMING_NOTE)
    else:
        prior_meta = (prior_blob or {}).get("oracle", oracle_meta)
        for r in prior_rows:       # the prior block's grading stays with its rows
            r.setdefault("precision", prior_meta.get("precision"))
            r.setdefault("mbh_rounds", prior_meta.get("mbh_rounds"))
        default_iters = prior_meta.get("max_iters", 30)
        merged = {_row_key(r, default_iters): r for r in prior_rows}
        for r in new_rows:
            merged[_row_key(r)] = r
        out = {
            "run_dir": args.run_dir, "n": args.n, "sampler": "pc/euler_maruyama w=0",
            "oracle": oracle_meta,
            "row_key": "rows are keyed by (steps, seed, max_iters); missing seed/max_iters "
                       "on old rows mean seed 0 and the oracle block's max_iters; each row "
                       "names the precision and basin hops it was graded with",
            "timing_note": TIMING_NOTE,
            "rows": [merged[k] for k in sorted(merged)],
        }
    write_json(args.out, out)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
