"""Warm-start feasibility of several sampler configurations.

    python -m rdm_tpu_torch.scripts.sampler_quality_study [run_dir] [n]
        [--max_iters 30] [--precision f32] [--out PATH]

Samples n trajectories from the run's EMA model under PC/EM at w = 0, 2
and 5, PC/EM with the Langevin corrector, and the probability-flow ODE,
and grades each batch on the card with
``physics.solver_gpu.refine_warmstarts_gpu`` (LM-``--max_iters``, cold;
``--backend native``: on the host's C++ oracle).
Prints one line a configuration and writes the rows to ``--out``
(default ``benchmark_results/torch/sampler_quality_study.json``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..benchmark.common import generate_raw_samples
from ..benchmark.gto_halo import GTOHaloBenchmarkConfig, GTOHaloBenchmarker
from .study_common import FLAGSHIP_RUN, default_out, grade, write_json

PC = dict(method="pc", predictor="euler_maruyama")
CONFIGS = [
    ("pc_em w=0", dict(PC, corrector="none"), 0.0),
    ("pc_em w=2", dict(PC, corrector="none"), 2.0),
    ("pc_em w=5", dict(PC, corrector="none"), 5.0),
    ("pc_em+langevin", dict(PC, corrector="langevin"), 0.0),
    ("ode", dict(method="ode"), 0.0),
]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir", nargs="?", default=FLAGSHIP_RUN)
    p.add_argument("n", nargs="?", type=int, default=1024)
    p.add_argument("--max_iters", type=int, default=30)
    p.add_argument("--precision", default="f32")
    p.add_argument("--out", default=default_out("sampler_quality_study.json"))
    p.add_argument("--backend", default="tpu", choices=["tpu", "native"],
                   help="native: grade on the host's C++ oracle instead")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    bench = GTOHaloBenchmarker(GTOHaloBenchmarkConfig(
        model_path=args.run_dir, num_samples=args.n, batch_size=args.n,
        enable_physical_validation=False, device=args.device,
        output_dir=os.path.join(tempfile.gettempdir(), "sampler_study")))
    rows = []
    for name, overrides, weight in CONFIGS:
        for k, v in overrides.items():
            bench.lm.cfg.sampling[k] = v
        raw, times = generate_raw_samples(bench.lm, args.n, args.n, guidance_weight=weight)
        phys = bench._inverse_pipeline(raw)
        res = grade(phys[:, 1:].astype(np.float32), phys[:, 0].astype(np.float32),
                    args.backend, bench.lm.device, max_iters=args.max_iters,
                    precision=args.precision)
        row = {"config": name, "w": weight, **overrides, "n": args.n,
               "sampling_s": float(sum(times)),
               "feasible": float(res["feasible"].mean()),
               "optimal": float(res["optimal"].mean()),
               "median_pos_err": float(np.median(res["pos_err"]))}
        rows.append(row)
        print(f"{name:18s} sampling {row['sampling_s']:6.2f}s  feasible {row['feasible']:.3f}  "
              f"optimal {row['optimal']:.3f}  median pos_err {row['median_pos_err']:.4f}",
              flush=True)
    out = {"run_dir": args.run_dir, "n": args.n,
           "oracle": {"backend": args.backend, "precision": args.precision,
                      "max_iters": args.max_iters, "mbh_rounds": 0},
           "rows": rows}
    write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
