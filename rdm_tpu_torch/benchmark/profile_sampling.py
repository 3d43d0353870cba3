"""Where the time of one sampling step goes, on the card.

    python -m rdm_tpu_torch.benchmark.profile_sampling [model.<key>=<value> ...]

Loads the flagship run with its EMA weights (``model.<key>=<value>``
replaces a key of its model config, e.g. ``model.resblock_pallas=true``),
warms up, then traces
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
import sys
import time

import torch

from ..config import parse_value
from ..models.registry import get_cf_score_fn
from ..sampling import get_pc_sampler
from ..sde import RVESDE
from .common import LoadedModel, sample_shape, trace_kernels

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "Training Runs", "2026.08.17_184657")
BATCH = 1024       # the flagship sampling batch
STEPS = 5


def main(argv=None):
    overrides = {}
    for arg in sys.argv[1:] if argv is None else argv:
        key, _, raw = arg.partition("=")
        if not key.startswith("model.") or not raw:
            raise SystemExit(f"expected model.<key>=<value>, got {arg!r}")
        overrides[key[len("model."):]] = parse_value(raw)
    lm = LoadedModel(FLAGSHIP, model_overrides=overrides)   # on the card, or raises
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

    prof = trace_kernels(lambda: sampler(score_fn, gen), STEPS)
    out = {
        "batch": BATCH, "steps": STEPS, "model_overrides": overrides,
        "device_name": torch.cuda.get_device_name(lm.device),
        "wall_ms_per_step": wall_ms,
        "idle_share": 1.0 - prof["device_ms_per_step"] / wall_ms,
        **prof,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
