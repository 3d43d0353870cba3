"""Where the time of a GPU grading goes, on the card.

    python -m rdm_tpu_torch.benchmark.profile_oracle [--precision df32,f32,hybrid]
        [--mbh_rounds 8] [--parent DIR]

Grades the 1024 in-tree round-2 physical samples
(``benchmark_results/round2_flagship_1024``) in optimal mode, in each
precision of ``--precision``: ``df32`` and ``f32`` with
``solver_gpu.refine_warmstarts_gpu``, ``hybrid`` with
``oracle.evaluate_warmstarts_hybrid`` (the card's float32 solve, then the
native oracle's polish).  Each is warmed up on 16 samples (which builds
what it needs), timed on the host clock (ending in a synchronisation), and
graded once more under ``torch.profiler``.  With ``--parent`` (another copy
of ``csrc/``, e.g. a parent commit's) the shooting kernels are also built
from that copy and the two copies grade in turns, parent, change, change,
parent, each bound through ``knockouts.bound_to``, which also gives each
copy its own route to the float64 Jacobian's rows: ``shoot_legs_fd`` where
the copy's library has it, else (a parent from before it) one
``shoot_legs`` launch of the 66 trial rows a lane; the lanes whose
feasible verdict differs between the copies are listed with the other
precisions' verdicts on them, and those whose optimal verdict differs
(a float64 grading's optimal verdict reads the float32 Jacobian: its
mass-rate diagnostic).  Prints one JSON line: per precision and
copy the wall times, the grades, the device time (the sum of the kernels'
durations in the trace: one stream, so they do not overlap), the device's
idle share, kernel launches, the shooting kernels' launches, the
kernels that take the most device time, grouped by name, ``shoot_jvp``'s
kernels' device ms and share of the device time, and the widths of the
float32 Jacobian's launches in the profiled grading: launches by lane
count bucket (``jvp_widths``).

With ``--parent`` and ``--repeats K``, the float32 and hybrid gradings are
repeated K more times for both copies, each repeat on a benign
perturbation of the same problem: every guess entry moved by -1, 0 or +1
times 2**-22 of itself (a float32 rounding step; numpy seed k) and basin
hopping seeded k.  A float32 grading's verdicts flip both ways with any
rounding, so the copies' difference at one input is one draw: the repeats
give the change's net feasible and optimal lanes against the parent's,
repeat by repeat (``repeats``), the spread that a claim about verdicts
needs.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import time

import numpy as np
import torch

from ..ops import _build
from ..ops import cr3bp as shoot_ops
from ..physics import oracle
from ..physics import solver_gpu
from ..physics.solver_gpu import refine_warmstarts_gpu
from .common import ROUND2, trace_kernels
from .knockouts import bound_to, build_variants

KERNELS = (shoot_ops.shoot_legs, shoot_ops.shoot_legs_fd, shoot_ops.manifold_target,
           shoot_ops.shoot_jvp)
OUT = os.path.join(_build.BUILD_DIR, "profile_oracle")
# lane-count buckets of the float32 Jacobian's launches: (low, high) inclusive
WIDTHS = ((1, 1), (2, 7), (8, 31), (32, 127), (128, 511), (512, 1024))


@contextlib.contextmanager
def jvp_widths(record: list):
    """Append the lane count of every float32 Jacobian the solver forms
    (one ``shoot_jvp`` launch each, where it has a lane) to ``record``."""
    real = solver_gpu._Problem.jacobian

    def jacobian(self, theta, *a):
        if self.dtype == torch.float32 and theta.shape[0]:
            record.append(int(theta.shape[0]))
        return real(self, theta, *a)

    solver_gpu._Problem.jacobian = jacobian
    try:
        yield
    finally:
        solver_gpu._Problem.jacobian = real


def buckets(widths: list) -> dict:
    """Launches and their mean lane count by ``WIDTHS`` bucket."""
    w = np.asarray(widths, dtype=np.int64)
    out = {}
    for lo, hi in WIDTHS:
        sel = w[(w >= lo) & (w <= hi)]
        out[f"{lo}-{hi}" if hi > lo else str(lo)] = {
            "launches": int(sel.size), "mean_lanes": float(sel.mean()) if sel.size else 0.0}
    return out


def perturbed(G: np.ndarray, k: int) -> np.ndarray:
    """G with every entry moved by -1, 0 or +1 times 2**-22 of itself
    (numpy seed k)."""
    r = np.random.default_rng(k).integers(-1, 2, G.shape)
    return G * (1.0 + r * 2.0 ** -22)


def repeats(grade, copies: dict, kinds: list, G: np.ndarray, n: int) -> dict:
    """Both copies' verdicts on n perturbed copies of G (``perturbed``,
    basin hopping seeded alike), in alternating order: per kind and repeat
    the copies' feasible and optimal counts, the change's lanes gained and
    lost against the parent's, and over the repeats the mean and standard
    deviation of its net feasible and optimal lanes."""
    out = {}
    for kind in kinds:
        rows = []
        for k in range(1, n + 1):
            Gk = perturbed(G, k)
            res = {}
            for c in (["parent", "change"] if k % 2 else ["change", "parent"]):
                with copies[c]():
                    res[c] = grade(kind, guesses=Gk, seed=k)
            f = {c: np.asarray(r["feasible"], bool) for c, r in res.items()}
            o = {c: np.asarray(r["optimal"], bool) for c, r in res.items()}
            row = {"repeat": k, **{f"feasible {c}": int(f[c].sum()) for c in f},
                   **{f"optimal {c}": int(o[c].sum()) for c in o},
                   "feasible gained": int((f["change"] & ~f["parent"]).sum()),
                   "feasible lost": int((f["parent"] & ~f["change"]).sum()),
                   "optimal net": int(o["change"].sum()) - int(o["parent"].sum())}
            row["feasible net"] = row["feasible gained"] - row["feasible lost"]
            rows.append(row)
            print(f"repeat {kind:<6s} {json.dumps(row)}", flush=True)
        nets = {m: np.array([r[f"{m} net"] for r in rows], float) for m in ("feasible", "optimal")}
        out[kind] = {"rows": rows, **{f"{m} net mean": float(v.mean()) for m, v in nets.items()},
                     **{f"{m} net sd": float(v.std(ddof=1)) if len(v) > 1 else 0.0
                        for m, v in nets.items()}}
        print(f"repeats {kind}: " + json.dumps({k: v for k, v in out[kind].items() if k != "rows"}),
              flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--precision", default="df32",
                   help="comma-separated precisions: df32, f32, hybrid")
    p.add_argument("--mbh_rounds", type=int, default=8)
    p.add_argument("--parent", default=None,
                   help="another copy of csrc/ whose shooting kernels grade in turns")
    p.add_argument("--repeats", type=int, default=0,
                   help="with --parent: float32 and hybrid gradings of both copies on this "
                        "many perturbed copies of the samples")
    args = p.parse_args(argv)
    kinds = args.precision.split(",")
    if set(kinds) - {"df32", "f32", "hybrid"}:
        raise SystemExit(f"profile_oracle: unknown precision in {args.precision!r}")
    physical = np.load(ROUND2)
    G, H = physical[:, 1:], physical[:, 0]

    def grade(kind, n=None, guesses=G, seed=0):
        kw = dict(mbh_rounds=args.mbh_rounds if n is None else 1, solver_mode="optimal",
                  mbh_seed=seed)
        if kind == "hybrid":
            return oracle.evaluate_warmstarts_hybrid(guesses[:n], H[:n], **kw)
        return refine_warmstarts_gpu(guesses[:n], H[:n], precision=kind, **kw)

    copies = {"change": contextlib.nullcontext}
    if args.parent:
        path = build_variants(["target_whole"], os.path.abspath(args.parent), OUT)["target_whole"]
        lib = ctypes.CDLL(path)
        lib.rdm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rdm_cuda_error_string.restype = ctypes.c_char_p
        copies["parent"] = lambda: bound_to(lib)
    turns = ["parent", "change", "change", "parent"] if args.parent else ["change"]
    out = {"n": len(G), "mbh_rounds": args.mbh_rounds,
           "device_name": torch.cuda.get_device_name(0), "gradings": {}}
    feasible, optimal = {}, {}
    for kind in kinds:
        for c in copies:
            with copies[c]():
                grade(kind, 16)                  # build and warm up
        for c in turns:
            with copies[c]():
                for f in KERNELS:
                    f.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = grade(kind)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rec = out["gradings"].setdefault(kind, {}).setdefault(c, {"wall_ms": []})
            rec["wall_ms"].append(wall_ms)
            rec.update(feasible=int(res["feasible"].sum()), optimal=int(res["optimal"].sum()),
                       mean_iters=float(np.mean(res["iters"])),
                       shooting_launches={f.__name__: f.launches for f in KERNELS})
            feasible[kind, c] = np.asarray(res["feasible"])
            optimal[kind, c] = np.asarray(res["optimal"])
            print(f"grading {kind:<6s} {c:<6s} wall {wall_ms / 1e3:8.3f} s, feasible "
                  f"{rec['feasible']}, optimal {rec['optimal']}", flush=True)
        for c in copies:
            widths = []
            with copies[c](), jvp_widths(widths):
                prof = trace_kernels(lambda: grade(kind), 1, top=10)
            rec = out["gradings"][kind][c]
            jvp_ms = sum(k["ms_per_step"] for k in prof["top_kernels"] if "shoot_jvp" in k["name"])
            rec.update(device_ms=prof["device_ms_per_step"],
                       idle_share=1.0 - prof["device_ms_per_step"] / min(rec["wall_ms"]),
                       kernel_launches=prof["kernel_launches_per_step"],
                       top_kernels=prof["top_kernels"], shoot_jvp_ms=jvp_ms,
                       shoot_jvp_share=jvp_ms / max(prof["device_ms_per_step"], 1e-9),
                       jvp_widths=buckets(widths))
            print(f"grading {kind:<6s} {c:<6s} device {rec['device_ms']:.1f} ms, shoot_jvp "
                  f"{jvp_ms:.1f} ms; jvp widths {json.dumps(rec['jvp_widths'])}", flush=True)
    if args.parent:
        out["differ"] = {}
        for kind in kinds:
            lanes = np.flatnonzero(feasible[kind, "parent"] != feasible[kind, "change"])
            out["differ"][kind] = {
                "lanes": [int(i) for i in lanes],
                **{f"{k} {c}": [bool(feasible[k, c][i]) for i in lanes]
                   for k in kinds for c in copies}}
            print(f"differ {kind}: {json.dumps(out['differ'][kind])}", flush=True)
            lanes = np.flatnonzero(optimal[kind, "parent"] != optimal[kind, "change"])
            out["differ"][kind]["optimal_lanes"] = [int(i) for i in lanes]
            print(f"optimal differs {kind}: {out['differ'][kind]['optimal_lanes']}", flush=True)
    if args.parent and args.repeats:
        out["repeats"] = repeats(grade, copies, [k for k in kinds if k != "df32"], G,
                                 args.repeats)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
