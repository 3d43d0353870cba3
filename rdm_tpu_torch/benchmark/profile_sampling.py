"""Where the time of one sampling step goes, on the card.

    python -m rdm_tpu_torch.benchmark.profile_sampling

Loads the flagship run with its EMA weights, warms up, then traces
``STEPS`` reflected Euler-Maruyama updates of ``BATCH`` trajectories with
``torch.profiler``.  Prints one JSON line: the wall time per step (host
clock, ending in a synchronisation), the device time per step (the sum of
the kernels' durations in the trace; one stream, so they do not overlap),
the device's idle share, kernel launches per step, and the kernels that
take the most device time, grouped by name.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from ..models.registry import get_cf_score_fn
from ..sampling import get_pc_sampler
from ..sde import RVESDE
from .common import LoadedModel, sample_shape

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "Training Runs", "2026.08.17_184657")
BATCH = 1024       # the flagship sampling batch
STEPS = 5


def main():
    lm = LoadedModel(FLAGSHIP)            # on the card, or raises
    sde = RVESDE(lm.sde.sigma_min, lm.sde.sigma_max, STEPS + 1)
    sampler = get_pc_sampler(sde, sample_shape(lm.cfg, BATCH), eps=1e-5)
    gen = torch.Generator(device=lm.device).manual_seed(0)
    labels = torch.rand((BATCH, 1), generator=gen, device=lm.device)
    score_fn = get_cf_score_fn(sde, lm.model, labels, 0.0)

    sampler(score_fn, gen)                       # warm-up: cuDNN plans, kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler(score_fn, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sampler(score_fn, gen)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e["name"]][0] += float(e["dur"])
        by_name[e["name"]][1] += 1
    device_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {
        "batch": BATCH, "steps": STEPS,
        "device_name": torch.cuda.get_device_name(lm.device),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_us / 1e3 / STEPS,
        "idle_share": 1.0 - device_us / 1e3 / STEPS / wall_ms,
        "kernel_launches_per_step": len(kernels) / STEPS,
        "top_kernels": [{"name": n[:90], "ms_per_step": v[0] / 1e3 / STEPS,
                         "share_of_device": v[0] / device_us,
                         "launches_per_step": v[1] / STEPS} for n, v in top],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
