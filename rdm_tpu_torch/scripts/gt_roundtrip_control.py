"""Ground-truth round trip through the oracle: the feasible ratio a
perfect generative model would score.

    python -m rdm_tpu_torch.scripts.gt_roundtrip_control [training_pkl] [n] [backend]
        [--max_iters 30] [--device cpu] [--out PATH]

Rows of a [N, 67] training pickle (normalised feasible solutions) go
through the benchmark's inverse pipeline (unnormalisation, cartesian to
spherical controls) and are graded by the oracle: ``native`` (the host's
C++ solver, default) or ``tpu`` (``physics.solver_gpu`` on the card).
With the uniform-guess floor it brackets every model's benchmark number.
Writes the result to ``--out`` (default
``benchmark_results/torch/gt_roundtrip_control.json``).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..physics.oracle import evaluate_warmstarts_native
from ..physics.solver_gpu import refine_warmstarts_gpu
from .study_common import GT_PKL, default_out, gt_inverse, load_rows, write_json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?", default=GT_PKL)
    p.add_argument("n", nargs="?", type=int, default=1024)
    p.add_argument("backend", nargs="?", default="native", choices=["native", "tpu"])
    p.add_argument("--max_iters", type=int, default=30)
    p.add_argument("--out", default=default_out("gt_roundtrip_control.json"))
    p.add_argument("--device", default=None, help="tpu backend: default the CUDA card")
    args = p.parse_args(argv)

    alpha_phys, guesses = gt_inverse(load_rows(args.path, args.n))
    if args.backend == "tpu":
        res = refine_warmstarts_gpu(guesses, alpha_phys, max_iters=args.max_iters,
                                    device=args.device)
    else:
        res = evaluate_warmstarts_native(guesses, alpha_phys, max_iters=args.max_iters)
    out = {"path": args.path, "n": len(guesses), "backend": args.backend,
           "max_iters": args.max_iters,
           "feasible": float(res["feasible"].mean()), "optimal": float(res["optimal"].mean()),
           "median_pos_err": float(np.median(res["pos_err"]))}
    print(f"GT round-trip ({args.backend}, n={out['n']}): feasible {out['feasible']:.3f} "
          f"optimal {out['optimal']:.3f} median pos_err {out['median_pos_err']:.4f} LU")
    write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
