"""Where the time of a GPU grading goes, on the card.

    python -m rdm_tpu_torch.benchmark.profile_oracle [--precision df32|f32] [--mbh_rounds 8]

Grades the 1024 in-tree round-2 physical samples
(``benchmark_results/round2_flagship_1024``) with
``solver_gpu.refine_warmstarts_gpu`` in optimal mode: once to build and warm
up, once timed on the host clock (ending in a synchronisation), once under
``torch.profiler``.  Prints one JSON line: the wall time, the device time
(the sum of the kernels' durations in the trace: one stream, so they do not
overlap), the device's idle share, kernel launches, the shooting kernels'
launches, and the kernels that take the most device time, grouped by name.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..ops import cr3bp as shoot_ops
from ..physics.solver_gpu import refine_warmstarts_gpu
from .common import trace_kernels

ROUND2 = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "benchmark_results", "round2_flagship_1024", "gto_halo",
    "generated_samples.npy")
KERNELS = (shoot_ops.shoot_legs, shoot_ops.manifold_target, shoot_ops.shoot_jvp)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--precision", default="df32", choices=["df32", "f32"])
    p.add_argument("--mbh_rounds", type=int, default=8)
    args = p.parse_args(argv)
    physical = np.load(ROUND2)
    G, H = physical[:, 1:], physical[:, 0]

    def grade():
        return refine_warmstarts_gpu(G, H, mbh_rounds=args.mbh_rounds, solver_mode="optimal",
                                     precision=args.precision)

    grade()                                      # build and warm up
    torch.cuda.synchronize()
    for f in KERNELS:
        f.launches = 0
    t0 = time.perf_counter()
    res = grade()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {f.__name__: f.launches for f in KERNELS}
    prof = trace_kernels(grade, 1, top=10)
    out = {
        "n": len(G), "precision": args.precision, "mbh_rounds": args.mbh_rounds,
        "device_name": torch.cuda.get_device_name(0),
        "feasible": int(res["feasible"].sum()), "optimal": int(res["optimal"].sum()),
        "mean_iters": float(np.mean(res["iters"])),
        "wall_ms": wall_ms, "idle_share": 1.0 - prof["device_ms_per_step"] / wall_ms,
        "shooting_launches": launches,
        "device_ms": prof["device_ms_per_step"], "kernel_launches": prof["kernel_launches_per_step"],
        "top_kernels": prof["top_kernels"],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
