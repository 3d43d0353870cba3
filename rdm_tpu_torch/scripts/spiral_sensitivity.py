"""How the flagship's feasible ratio moves with the start boundary.

    python -m rdm_tpu_torch.scripts.spiral_sensitivity [--n 256] [--mbh 8] [--iters 30]

The NLP starts from the end state of a GTO low-thrust spiral.  The
reference takes it from pydylan's ``lowthrust_spiral``; this package
integrates a tangential-thrust spiral in f64 and pins its end state
(``physics/cr3bp.py``: ``spiral_to_boundary``).  A modelling error there
would shift every feasibility number together.  This regrades the flagship
samples with the native f64 oracle from perturbed start states: +-1e-3 on
each position (LU) and velocity (VU) axis, and random directions of norm
1e-4, 1e-3 and 3e-3, beside the baseline.  All host work: no card.  The
artifact (default ``benchmark_results/torch/spiral_sensitivity.json``) is
written after every case and resumed.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..physics.oracle import _mission_constants, evaluate_warmstarts_native
from .study_common import FLAGSHIP_SAMPLES, default_out, write_json

START_BDRY = 6.48423370092


def cases(se0: np.ndarray) -> list:
    """(name, spiral end state) of every perturbation, the baseline first."""
    out = [("baseline", se0.copy())]
    for i, name in enumerate(["x", "y", "z", "vx", "vy", "vz"]):
        for sgn in (+1.0, -1.0):
            se = se0.copy()
            se[i] += sgn * 1e-3
            out.append((f"{name}{'+' if sgn > 0 else '-'}1e-3", se))
    rs = np.random.RandomState(0)
    for mag in (1e-4, 1e-3, 3e-3):
        d = rs.standard_normal(6)
        se = se0.copy()
        se[:6] += d / np.linalg.norm(d) * mag
        out.append((f"random_{mag:g}", se))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--mbh", type=int, default=8)
    p.add_argument("--samples", default=FLAGSHIP_SAMPLES)
    p.add_argument("--out", default=default_out("spiral_sensitivity.json"))
    args = p.parse_args(argv)

    S = np.load(args.samples).astype(np.float64)[:args.n]
    he, G = S[:, 0], S[:, 1:]
    se0, _l1x, _e_l1 = _mission_constants(START_BDRY)

    blob = {"flagship": args.samples, "n": int(len(G)),
            "oracle": f"native f64 LM-{args.iters} optimal + MBH-{args.mbh}",
            "spiral_end_baseline": se0.tolist(),
            "note": "the start boundary is the tangential-thrust spiral stand-in "
                    "(physics/cr3bp.py: spiral_to_boundary); rows show how the flagship "
                    "feasible ratio responds to boundary modelling error",
            "cases": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            blob["cases"] = json.load(f).get("cases", [])
    done = {c["case"] for c in blob["cases"]}

    for name, se in cases(se0):
        if name in done:
            continue
        t0 = time.time()
        res = evaluate_warmstarts_native(G, he, max_iters=args.iters, solver_mode="optimal",
                                         mbh_rounds=args.mbh, spiral_end=se)
        feas = res["feasible"]
        row = {"case": name, "feasible_ratio": float(feas.mean()),
               "local_optimal_ratio": float(res["optimal"].mean()),
               "avg_final_mass_feasible":
                   float(res["final_mass"][feas].mean()) if feas.any() else None,
               "wall_s": round(time.time() - t0, 1)}
        blob["cases"].append(row)
        print(f"[{time.strftime('%H:%M:%S')}] {name:14s} feas {row['feasible_ratio']:.3f} "
              f"opt {row['local_optimal_ratio']:.3f} ({row['wall_s']:.0f}s)", flush=True)
        write_json(args.out, blob)

    base = next(c for c in blob["cases"] if c["case"] == "baseline")
    worst = max(blob["cases"], key=lambda c: abs(c["feasible_ratio"] - base["feasible_ratio"]))
    blob["summary"] = {"baseline_feasible": base["feasible_ratio"],
                       "worst_case": worst["case"], "worst_feasible": worst["feasible_ratio"],
                       "max_abs_shift": round(abs(worst["feasible_ratio"]
                                                  - base["feasible_ratio"]), 4)}
    write_json(args.out, blob)
    print("summary:", json.dumps(blob["summary"]))
    return blob


if __name__ == "__main__":
    main()
