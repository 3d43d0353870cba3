"""Grade the same sample sets with solvers of other families.

    python -m rdm_tpu_torch.scripts.second_solver_crosscheck [--solvers trf,slsqp]
        [--n_flagship 256] [--n_control 256] [--mbh 0,8] [--sets a,b]

The budget sweep (``scripts/budget_sweep.py``) varies the grading budget
but keeps one solver family (Levenberg-Marquardt with the mass ascent and
basin hopping).  This grades the same sets with algorithmically different
f64 solvers of the identical residual (``native.residual_batch``, the C++
forward-backward shooting residual the LM oracle minimises):

* ``trf``: scipy's ``least_squares(method="trf")``, a bounded trust-region
  reflective least-squares solve;
* ``slsqp``: scipy's ``minimize(method="SLSQP")``, an SQP (the algorithm
  class of the reference's SNOPT) that maximises the terminal mass subject
  to the 7 shooting equalities and the NLP box.

Both run cold and under the same monotonic basin hopping
(``physics.oracle._mbh_loop``, sigma 0.05).  Feasible: the solver converges
below the same 1e-3 residual norm.  Jacobians are forward differences,
one ``residual_batch`` call each (h = 1e-6 (|x_v| + 1), the C++ oracle's
step).  All host work: no card.  The artifact (default
``benchmark_results/torch/second_solver_crosscheck.json``) is written
after every cell and resumed.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
from scipy.optimize import least_squares, minimize

from .. import native
from ..physics.oracle import _mbh_loop, _mission_constants, nlp_box
from . import budget_sweep as bs
from .study_common import default_out, reference_root, wilson_ci, write_json

FEAS_TOL = 1e-3
FD_STEP = 1e-6          # the C++ oracle's hstep = 1e-6 * (|g_v| + 1)
START_BDRY = 6.48423370092


class Problem:
    """One sample's residual and batched forward-difference Jacobian over
    the native f64 residual, its halo family data computed once."""

    def __init__(self, spiral_end, seed, period, vstable):
        self._sp = spiral_end
        self._hd1 = (seed[None], np.asarray([period]), vstable[None])
        self._hd67 = (np.repeat(seed[None], 67, 0), np.repeat(np.asarray([period]), 67),
                      np.repeat(vstable[None], 67, 0))
        self.nfev = 0

    def fun(self, x):
        self.nfev += 1
        return native.residual_batch(x[None], None, self._sp, halo_data=self._hd1,
                                     n_threads=1)[0]

    def jac(self, x):
        """[7, 66]: 67 residuals in one batch call (row 0 the base point)."""
        h = FD_STEP * (np.abs(x) + 1.0)
        pts = np.concatenate([x[None], x[None] + np.diag(h)])
        r = native.residual_batch(pts, None, self._sp, halo_data=self._hd67, n_threads=1)
        self.nfev += 67
        return (r[1:] - r[0]).T / h


def _box():
    lo, hi = nlp_box()
    return lo, hi, 1e-9 * (hi - lo)    # trf needs lo < x0 < hi strictly


def _result_dict(n):
    """Empty results in the oracle's layout, so ``_mbh_loop`` merges them."""
    return {"feasible": np.zeros(n, bool), "optimal": np.zeros(n, bool),
            "inform": np.full(n, 13), "cost": np.full(n, 1e6), "pos_err": np.full(n, 1e6),
            "vel_err": np.full(n, 1e6), "refined": np.zeros((n, 66)),
            "final_mass": np.full(n, -1.0), "terminal_mass": np.full(n, -1.0),
            "iters": np.zeros(n, np.int64), "stationarity": np.full(n, 1e6),
            "opt_gain": np.full(n, 1e6)}


def _finish_lane(out, i, prob, x, nfev):
    r = prob.fun(x)
    cost = float(np.linalg.norm(r))
    mass = float(x[63])
    sane = np.isfinite(cost) and cost < 1e5 and 300.0 < mass < 1000.1
    out["refined"][i] = x
    out["cost"][i] = cost
    out["pos_err"][i] = float(np.linalg.norm(r[:3]))
    out["vel_err"][i] = float(np.linalg.norm(r[3:6]))
    out["final_mass"][i] = mass if sane else -1.0
    out["feasible"][i] = bool(sane and cost < FEAS_TOL)
    # no mass-ascent certificate here: inform 1 never fires
    out["inform"][i] = 3 if out["feasible"][i] else 13
    out["iters"][i] = nfev


def _problems(G, he):
    sp, _, _ = _mission_constants(START_BDRY)
    seeds, periods, vstables = native._halo_arrays(he, len(he))
    return [Problem(sp, seeds[i], periods[i], vstables[i]) for i in range(len(G))]


def solve_trf(G, he, max_nfev=160):
    """Bounded trust-region-reflective least squares on the 7 residuals."""
    lo, hi, eps = _box()
    out = _result_dict(len(G))
    for i, prob in enumerate(_problems(G, he)):
        x0 = np.clip(G[i], lo + eps, hi - eps)
        try:
            x = least_squares(prob.fun, x0, jac=prob.jac, bounds=(lo, hi), method="trf",
                              x_scale="jac", max_nfev=max_nfev).x
        except Exception:
            x = x0
        _finish_lane(out, i, prob, x, prob.nfev)
    return out


def solve_slsqp(G, he, maxiter=80):
    """SQP: maximise the terminal mass subject to the 7 equalities and the box."""
    lo, hi, eps = _box()
    grad = np.zeros(66)
    grad[63] = -1.0 / 100.0   # mass, scaled to the residual's order
    out = _result_dict(len(G))
    for i, prob in enumerate(_problems(G, he)):
        x0 = np.clip(G[i], lo + eps, hi - eps)
        try:
            sol = minimize(lambda x: -x[63] / 100.0, x0, jac=lambda x: grad, method="SLSQP",
                           bounds=list(zip(lo, hi)),
                           constraints=[{"type": "eq", "fun": prob.fun, "jac": prob.jac}],
                           options={"maxiter": maxiter, "ftol": 1e-10})
            x = np.clip(sol.x, lo, hi)
        except Exception:
            x = x0
        _finish_lane(out, i, prob, x, prob.nfev)
    return out


SOLVERS = {"trf": solve_trf, "slsqp": solve_slsqp}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--solvers", default="trf,slsqp")
    p.add_argument("--n_flagship", type=int, default=256)
    p.add_argument("--n_control", type=int, default=256)
    p.add_argument("--mbh", default="0,8")
    p.add_argument("--sets", default=None)
    p.add_argument("--reference_root", default=reference_root(),
                   help="a checkout of the reference (default: $RDM_REFERENCE_ROOT; "
                        "without either its sets are skipped)")
    p.add_argument("--out", default=default_out("second_solver_crosscheck.json"))
    args = p.parse_args(argv)

    sets = bs.sample_sets(args.n_flagship, args.n_control, args.reference_root)
    if args.sets:
        keep = set(args.sets.split(","))
        sets = {k: v for k, v in sets.items() if k in keep}

    blob = {
        "residual": "rdm_tpu_torch.native residual_batch: the identical f64 "
                    "forward-backward shooting residual the LM oracle minimises; feasible = "
                    "converged below 1e-3",
        "solvers": {
            "trf": "scipy least_squares method=trf (trust-region reflective, bounded), "
                   "batched-FD Jacobian",
            "slsqp": "scipy minimize method=SLSQP (SQP, SNOPT's algorithm class): max mass "
                     "s.t. 7 eq constraints + box"},
        "mbh": "rdm_tpu_torch.physics.oracle._mbh_loop, sigma=0.05: the same globalisation "
               "as the headline table",
        "cells": [],
    }
    if os.path.exists(args.out):
        with open(args.out) as f:
            blob["cells"] = json.load(f).get("cells", [])
    done = {(c["solver"], c["set"], c["mbh_rounds"]) for c in blob["cells"]}

    lo, hi = nlp_box()
    for solver in args.solvers.split(","):
        fn = SOLVERS[solver]
        for mbh in [int(m) for m in args.mbh.split(",")]:
            for name, s in sets.items():
                if (solver, name, mbh) in done:
                    continue
                he, G = s[:, 0], s[:, 1:]
                t0 = time.time()
                res = _mbh_loop(fn, G, he, mbh, 0.05, 0, lo, hi) if mbh > 0 else fn(G, he)
                dt = time.time() - t0
                k, n = int(res["feasible"].sum()), len(G)
                ci = wilson_ci(k, n)
                cell = {"solver": solver, "set": name, "n": n, "mbh_rounds": mbh,
                        "feasible_ratio": round(k / n, 4),
                        "feasible_ci95": [round(ci[0], 4), round(ci[1], 4)],
                        "median_cost": round(float(np.median(res["cost"])), 5),
                        "avg_final_mass_feasible": (
                            round(float(res["final_mass"][res["feasible"]].mean()), 2)
                            if k else None),
                        "wall_s": round(dt, 1)}
                blob["cells"].append(cell)
                print(cell, flush=True)
                write_json(args.out, blob)
    print(f"wrote {args.out}")
    return blob


if __name__ == "__main__":
    main()
