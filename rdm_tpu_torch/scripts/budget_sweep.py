"""Feasibility of every sample set across a grid of oracle budgets.

    python -m rdm_tpu_torch.scripts.budget_sweep [--n_flagship 1024] [--n_control 256]
        [--iters 30,100,300] [--mbh 0,8,32] [--sets a,b] [--extra_set NAME=PATH]

Grades each sample set with the native f64 oracle (Levenberg-Marquardt
with the mass ascent, ``solver_mode=optimal``, under monotonic basin
hopping: ``physics.oracle.evaluate_warmstarts_native``) at every LM
iteration budget x basin-hop count of the grid, so a comparison of sample
sets can be read at any budget.  The sets: the flagship's round-2 physical
samples, the reference's three checked-in sample artifacts (under
``--reference_root`` or ``$RDM_REFERENCE_ROOT``; without either, or where
a file is absent, the set is skipped with a line saying so), a
uniform-guess floor and a ground-truth round-trip ceiling.  All host
work: no card.

The artifact (default ``benchmark_results/torch/budget_sweep.json``) is
written after every cell and resumed: a cell graded at no fewer rows than
asked is not graded again.  ``--annotate_cis`` only (re)computes the
cells' Wilson intervals.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..physics.oracle import evaluate_warmstarts_native
from .study_common import (FLAGSHIP_SAMPLES, GT_PKL, default_out, gt_inverse,
                           load_reference_set, load_rows, reference_path, reference_root,
                           rounded_ci, write_json)

REF_SETS = {   # the reference's checked-in sample artifacts, under --reference_root
    "ref_50samples_16workers":
        "Benchmark/benchmark_results/gto_halo_50samples_16workers_results/samples.npy",
    "ref_fast_20250804":
        "Benchmark/benchmark_results/gto_halo_fast_results_20250804_004930/samples.npy",
    "ref_8samples_8workers":
        "Benchmark/benchmark_results/gto_halo_8samples_8workers_results/samples.npy",
}
ITER_GRID = (30, 100, 300)
MBH_GRID = (0, 8, 32)


def uniform_floor(n: int, seed: int = 0) -> np.ndarray:
    """Uniform warm starts [n, 67] in physical units, the distribution of
    the data generator's ``uniform_sample``."""
    rs = np.random.RandomState(seed)
    he = rs.uniform(0.008, 0.095, n)
    t_shoot = rs.uniform(0.0, 40.0, (n, 1))
    t_init = rs.uniform(0.0, 15.0, (n, 1))
    t_final = rs.uniform(0.0, 15.0, (n, 1))
    theta = rs.uniform(0, 2 * np.pi, (n, 20))
    psi = rs.uniform(0, 2 * np.pi, (n, 20))
    r = rs.uniform(0, 1, (n, 20))
    ctrl = np.stack([theta, psi, r], -1).reshape(n, 60)
    mass = rs.uniform(408.0, 470.0, (n, 1))
    manifold_start = rs.uniform(0, 1, (n, 1))
    manifold_len = rs.uniform(5.0, 11.0, (n, 1))
    G = np.concatenate([t_shoot, t_init, t_final, ctrl, mass, manifold_start, manifold_len],
                       axis=1)
    return np.concatenate([he[:, None], G], axis=1)


def gt_ceiling(n: int, path: str = GT_PKL) -> np.ndarray:
    """The first n training rows through the inverse pipeline [n, 67]."""
    alpha_phys, out = gt_inverse(load_rows(path, n))
    return np.concatenate([alpha_phys[:, None], out], axis=1)


def sample_sets(n_flagship: int, n_control: int, ref_root: str | None,
                flagship: str = FLAGSHIP_SAMPLES) -> dict:
    """Every set of the sweep, by name, [N, 67] physical units (the
    reference's only under a ``ref_root`` that holds them)."""
    sets = {"flagship_rdm_tpu": np.load(flagship).astype(np.float64)[:n_flagship]}
    for name, rel in REF_SETS.items():
        path = reference_path(ref_root, rel)
        if path is not None:
            sets[name] = load_reference_set(path)
    sets["uniform_floor"] = uniform_floor(n_control)
    sets["gt_ceiling"] = gt_ceiling(n_control)
    return sets


def annotate_cis(path: str) -> None:
    """Add Wilson intervals to every cell of an artifact (k from ratio x n)."""
    with open(path) as f:
        blob = json.load(f)
    for c in blob["cells"]:
        c["feasible_ci95"] = rounded_ci(int(round(c["feasible_ratio"] * c["n"])), c["n"])
    blob["ci_note"] = "feasible_ci95 = 95% Wilson score interval on feasible_ratio at the cell's n"
    write_json(path, blob)
    print(f"annotated {len(blob['cells'])} cells in {path}")


def main(argv=None) -> dict | None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--annotate_cis", action="store_true",
                   help="only (re)compute feasible_ci95 on the existing artifact")
    p.add_argument("--n_flagship", type=int, default=1024)
    p.add_argument("--n_control", type=int, default=256,
                   help="n of the uniform floor and the ground-truth ceiling")
    p.add_argument("--iters", default=",".join(map(str, ITER_GRID)))
    p.add_argument("--mbh", default=",".join(map(str, MBH_GRID)))
    p.add_argument("--out", default=default_out("budget_sweep.json"))
    p.add_argument("--sets", default=None, help="comma-separated names of the sets to run")
    p.add_argument("--reference_root", default=reference_root(),
                   help="a checkout of the reference (default: $RDM_REFERENCE_ROOT; "
                        "without either its sets are skipped)")
    p.add_argument("--extra_set", action="append", default=[], metavar="NAME=PATH",
                   help="another [N, 67] physical-unit .npy to grade (repeatable)")
    p.add_argument("--n_extra", type=int, default=None, help="rows of each --extra_set")
    args = p.parse_args(argv)
    if args.annotate_cis:
        annotate_cis(args.out)
        return None

    sets = sample_sets(args.n_flagship, args.n_control, args.reference_root)
    for spec in args.extra_set:
        name, path = spec.split("=", 1)
        s = np.load(path).astype(np.float64)
        sets[name] = s[:args.n_extra] if args.n_extra else s
    if args.sets:
        keep = set(args.sets.split(","))
        sets = {k: v for k, v in sets.items() if k in keep}
    iter_grid = [int(v) for v in args.iters.split(",")]
    mbh_grid = [int(v) for v in args.mbh.split(",")]

    blob = {
        "oracle": "native f64 LM + mass ascent (solver_mode=optimal) + monotonic basin "
                  "hopping; feasible = local solve converges below 1e-3 residual",
        "grid": {"max_iters": iter_grid, "mbh_rounds": mbh_grid},
        "context": {
            "reference_snopt_budget": "SNOPT total_iteration_limit=15000 under MBH "
                                      "(the reference's warm-start simulator)",
            "reference_snopt_self_grade": {
                "ref_50samples_16workers": 0.86,
                "note": "the reference's own summary.txt for that sample set; different "
                        "grader, context only"}},
        "cells": [],
    }
    if os.path.exists(args.out):                 # resume: keep prior cells
        with open(args.out) as f:
            blob["cells"] = json.load(f).get("cells", [])
    done = {}
    for c in blob["cells"]:
        k = (c["set"], c["max_iters"], c["mbh_rounds"])
        done[k] = max(done.get(k, 0), c["n"])

    # cheapest cells first, so a partial run covers the whole grid coarsely
    for it, mbh in sorted(((i, m) for i in iter_grid for m in mbh_grid),
                          key=lambda c: c[0] * (1 + c[1])):
        for name, s in sets.items():
            if done.get((name, it, mbh), 0) >= len(s):
                continue
            blob["cells"] = [c for c in blob["cells"]
                             if (c["set"], c["max_iters"], c["mbh_rounds"]) != (name, it, mbh)]
            he, G = s[:, 0], s[:, 1:]
            t0 = time.time()
            res = evaluate_warmstarts_native(G, he, max_iters=it, solver_mode="optimal",
                                             mbh_rounds=mbh)
            dt = time.time() - t0
            feas = res["feasible"]
            cell = {"set": name, "n": int(len(G)), "max_iters": it, "mbh_rounds": mbh,
                    "feasible_ratio": float(feas.mean()),
                    "feasible_ci95": rounded_ci(int(feas.sum()), len(G)),
                    "local_optimal_ratio": float(res["optimal"].mean()),
                    "avg_final_mass_feasible":
                        float(res["final_mass"][feas].mean()) if feas.any() else None,
                    "wall_s": round(dt, 1)}
            blob["cells"].append(cell)
            print(f"[{time.strftime('%H:%M:%S')}] {name:28s} iters={it:<4d} mbh={mbh:<3d} "
                  f"n={cell['n']:<5d} feas {cell['feasible_ratio']:.3f} "
                  f"opt {cell['local_optimal_ratio']:.3f} ({dt:.0f}s)", flush=True)
            write_json(args.out, blob)
    print("sweep complete:", args.out)
    return blob


if __name__ == "__main__":
    main()
