"""The manifold chain on the card for two copies of the source in turns:
``manifold_target`` and ``shoot_jvp`` of ``csrc/cr3bp_shoot.cu`` as
``benchmark/knockouts.py`` cuts them, their registers, and each copy's
float64 verdicts against the native oracle's.

    python -m rdm_tpu_torch.benchmark.shoot_chain [--parent DIR] [--agreement]

It needs the card and ``nvcc``.  The variants are ``knockouts.py``'s
``target_*`` (``manifold_target`` whole, halo phase only, back-integration
only, at 1, 1024 and a grading's largest row count in each type: the 1-row
time is the chain's, the floor of a design that gives a row one thread)
and ``jvp_*`` (``shoot_jvp`` at L 1024 whole and by column group).  They
are built from this package's ``csrc/`` and, with ``--parent``, from
another copy of ``csrc/`` (e.g. a parent commit's), one nvcc each, all
started together, into ``rdm_tpu_torch/_build/shoot_chain/<copy>/``; the
package's wrappers call each build through ``knockouts.bound_to``.  With
``--parent`` the copies run in turns, parent, change, change, parent, and
the change's ``manifold_target`` at each type's largest row count is
compared with the parent's bit for bit.  Registers and spills come from
ptxas' report (``-Xptxas -v``).  ``--agreement`` holds each copy's float64
verdicts to the native oracle's lane by lane, as ``chip_smoke.py`` does
(at least 0.98), on the 1024 round-2 samples and phase ``datagen``'s first
256 uniform guesses.  The gradings' wall and device time by kernel for the
two copies: ``benchmark/profile_oracle.py --parent``.  The last line
printed is one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build
from ..ops import cr3bp as shoot_ops
from ..scripts.micro_cf import describe
from . import knockouts
from .common import ROUND2

OUT = os.path.join(_build.BUILD_DIR, "shoot_chain")
VARIANTS = ("target_whole", "target_halo_only", "target_back_only", "jvp_whole",
            "jvp_legs_only", "jvp_targets_only")
KERNELS = {"shoot_legs_kernelId": "shoot_legs<double>", "shoot_legs_kernelIf": "shoot_legs<float>",
           "manifold_target_kernelId": "manifold_target<double>",
           "manifold_target_kernelIf": "manifold_target<float>",
           "shoot_jvp_kernel": "shoot_jvp_f32"}


def registers(log: str) -> dict:
    """Registers, stack frame and spill stores (bytes) of each shooting
    kernel from ptxas' ``-v`` report."""
    out, name, frame = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = next((v for k, v in KERNELS.items() if k in m.group(1)), None)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            frame = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = {"registers": int(m.group(1)), "stack_frame": frame[0],
                         "spill_stores": frame[1]}
            name = None
    return out


def uniform_guesses(n: int):
    """The first n of ``chip_smoke.py``'s data-generation guesses (uniform
    draws, seeds 0 .. n-1) and their halo energies."""
    from .. import datagen
    gen = datagen.CR3BPInitGenerator("uniform_sample", 1.0, 408, 470, 5.0, 11.0)
    drawn = [gen.get_earth_initial_guess(s, 20, 40.0, 0.0) for s in range(n)]
    return np.stack([g[0] for _, g in drawn]), np.array([e for e, _ in drawn])


def agreement(libs) -> dict:
    """Each copy's float64 verdicts on the card against the native oracle's,
    lane by lane: the 1024 round-2 samples (8 hops, optimal; phase
    oracle_gpu) and the first 256 uniform guesses of phase datagen (30 LM
    iterations, optimal)."""
    from ..physics.oracle import evaluate_warmstarts_native
    from ..physics.solver_gpu import refine_warmstarts_gpu
    physical = np.load(ROUND2)
    sets = {"round2_1024": ((physical[:, 1:], physical[:, 0]), dict(mbh_rounds=8)),
            "uniform_256": (uniform_guesses(256), dict(max_iters=30))}
    native = {k: evaluate_warmstarts_native(*gh, solver_mode="optimal", **kw)["feasible"]
              for k, (gh, kw) in sets.items()}
    out = {}
    for copy, lib in libs.items():
        rec = out.setdefault(copy, {})
        for k, (gh, kw) in sets.items():
            with knockouts.bound_to(lib):
                f = refine_warmstarts_gpu(*gh, solver_mode="optimal", precision="df32",
                                          **kw)["feasible"]
            rec[k] = float((f == native[k]).mean())
            rec[k + "_differ"] = [int(i) for i in np.flatnonzero(f != native[k])]
        print(f"agreement {copy:<7s} " + ", ".join(f"{k} {rec[k]:.5f} {rec[k + '_differ']}"
                                                   for k in sets), flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None, help="another copy of csrc/ to time in turns")
    p.add_argument("--agreement", action="store_true", help="each copy's float64 verdicts "
                   "against the native oracle's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("shoot_chain: needs a CUDA card")
    device = torch.device("cuda")
    print(describe(device), flush=True)
    sources = {"change": _build.CSRC_DIR}
    if args.parent:
        sources["parent"] = os.path.abspath(args.parent)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        jobs = {c: pool.submit(knockouts.build_variants, VARIANTS, d, os.path.join(OUT, c))
                for c, d in sources.items()}
        paths = {c: j.result() for c, j in jobs.items()}
    out = {"build_s": time.perf_counter() - t0, "registers": {}, "ms": {}}
    libs = {}
    for c, built in paths.items():
        with open(built["target_whole"][:-3] + ".log") as f:
            out["registers"][c] = registers(f.read())
        libs[c] = {}
        for name, path in built.items():
            lib = ctypes.CDLL(path)
            lib.rdm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rdm_cuda_error_string.restype = ctypes.c_char_p
            libs[c][name] = lib
    print(json.dumps({"registers": out["registers"]}), flush=True)

    cases = knockouts.target_cases(device)
    jvp = knockouts.jvp_args(knockouts.JVP_L, device)
    turns = ["parent", "change", "change", "parent"] if args.parent else ["change"]
    for c in turns:
        times = dict(knockouts.target_times(libs[c], cases, f"{c} "),
                     **knockouts.jvp_times(libs[c], jvp, f"{c} "))
        for k, t in times.items():
            out["ms"].setdefault(k, {}).setdefault(c, []).append(t)
    if args.parent:
        # the change's targets at each type's largest launch against the parent's
        out["same_bits_as_parent"] = {}
        for dtype, counts in knockouts.TARGET_ROWS.items():
            key = knockouts.target_key(dtype, counts[-1])
            a = cases[key]
            got = []
            for c in ("parent", "change"):
                with knockouts.bound_to(libs[c]["target_whole"]):
                    got.append(shoot_ops.manifold_target(*a))
            out["same_bits_as_parent"][key] = bool(torch.equal(*got))
        print(json.dumps({"same_bits_as_parent": out["same_bits_as_parent"]}), flush=True)
    if args.agreement:
        out["agreement"] = agreement({c: libs[c]["target_whole"] for c in sources})
    print(json.dumps({"shoot_chain": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
