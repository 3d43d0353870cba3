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
precisions' verdicts on them.  Prints one JSON line: per precision and
copy the wall times, the grades, the device time (the sum of the kernels'
durations in the trace: one stream, so they do not overlap), the device's
idle share, kernel launches, the shooting kernels' launches, and the
kernels that take the most device time, grouped by name.
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
from ..physics.solver_gpu import refine_warmstarts_gpu
from .common import ROUND2, trace_kernels
from .knockouts import bound_to, build_variants

KERNELS = (shoot_ops.shoot_legs, shoot_ops.shoot_legs_fd, shoot_ops.manifold_target,
           shoot_ops.shoot_jvp)
OUT = os.path.join(_build.BUILD_DIR, "profile_oracle")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--precision", default="df32",
                   help="comma-separated precisions: df32, f32, hybrid")
    p.add_argument("--mbh_rounds", type=int, default=8)
    p.add_argument("--parent", default=None,
                   help="another copy of csrc/ whose shooting kernels grade in turns")
    args = p.parse_args(argv)
    kinds = args.precision.split(",")
    if set(kinds) - {"df32", "f32", "hybrid"}:
        raise SystemExit(f"profile_oracle: unknown precision in {args.precision!r}")
    physical = np.load(ROUND2)
    G, H = physical[:, 1:], physical[:, 0]

    def grade(kind, n=None):
        kw = dict(mbh_rounds=args.mbh_rounds if n is None else 1, solver_mode="optimal")
        if kind == "hybrid":
            return oracle.evaluate_warmstarts_hybrid(G[:n], H[:n], **kw)
        return refine_warmstarts_gpu(G[:n], H[:n], precision=kind, **kw)

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
    feasible = {}
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
            print(f"grading {kind:<6s} {c:<6s} wall {wall_ms / 1e3:8.3f} s, feasible "
                  f"{rec['feasible']}, optimal {rec['optimal']}", flush=True)
        for c in copies:
            with copies[c]():
                prof = trace_kernels(lambda: grade(kind), 1, top=10)
            rec = out["gradings"][kind][c]
            rec.update(device_ms=prof["device_ms_per_step"],
                       idle_share=1.0 - prof["device_ms_per_step"] / min(rec["wall_ms"]),
                       kernel_launches=prof["kernel_launches_per_step"],
                       top_kernels=prof["top_kernels"])
            print(f"grading {kind:<6s} {c:<6s} device {rec['device_ms']:.1f} ms", flush=True)
    if args.parent:
        out["differ"] = {}
        for kind in kinds:
            lanes = np.flatnonzero(feasible[kind, "parent"] != feasible[kind, "change"])
            out["differ"][kind] = {
                "lanes": [int(i) for i in lanes],
                **{f"{k} {c}": [bool(feasible[k, c][i]) for i in lanes]
                   for k in kinds for c in copies}}
            print(f"differ {kind}: {json.dumps(out['differ'][kind])}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
