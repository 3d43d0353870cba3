"""Headline benchmark of the port: 1000-step reflected PC sampling
throughput of the GTO NCSN++ on one card.

    python -m rdm_tpu_torch.bench --batch 1024 --steps 1000

NCSN++ at the flagship widths (configs/train.yaml with bfloat16 compute and
the CUDA attention kernel) with random weights from seed 0,
RVESDE(0.01, 5, N), Euler-Maruyama predictor, no corrector, uniform-random
labels.  Prints one JSON line: ``value`` (trajectories/s at w = 0),
``value_cfg_w0.1`` (guided, one forward over the doubled batch) and, at
1000 steps, ``value_pc250`` (the 250-step schedule), with the card's name
and power limit.  Each value is the best of ``--repeats`` timed runs after
a short warm-up; a run ends in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .config import load_config
from .device import resolve_device
from .models import NCSNpp
from .models.registry import get_cf_score_fn
from .sampling import get_pc_sampler
from .sde import RVESDE


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config("train")
    cfg.model.precision = "bfloat16"
    cfg.model.attn_pallas = True
    model = NCSNpp.from_config(cfg).init_weights(torch.Generator().manual_seed(0))
    model.to(device).eval().requires_grad_(False)
    sigma_min, sigma_max = cfg.sde.sigma_min, cfg.sde.sigma_max

    def run(batch, weight, steps, seed):
        sde = RVESDE(sigma_min, sigma_max, steps)
        sampler = get_pc_sampler(sde, (batch, 1, 9, 9), predictor="euler_maruyama",
                                 corrector="none", denoiser="none", eps=1e-5)
        gen = torch.Generator(device=device).manual_seed(seed)
        labels = torch.rand((batch, 1), generator=gen, device=device)
        x, _ = sampler(get_cf_score_fn(sde, model, labels, weight), gen)
        return x

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def throughput(batch, weight, steps):
        run(batch, weight, 10, 0)
        sync()
        times = []
        for i in range(args.repeats):
            t0 = time.perf_counter()
            x = run(batch, weight, steps, i + 1)
            sync()
            times.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError("non-finite samples")
        best = min(times)
        print(f"batch {batch} w={weight} steps {steps}: {times} s -> "
              f"{batch / best:.1f} traj/s", file=sys.stderr)
        return batch / best

    out = {"metric": "pc1000_sampling_throughput",
           "value": throughput(args.batch, 0.0, args.steps),
           "unit": "traj/s/chip",
           "value_cfg_w0.1": throughput(args.batch, 0.1, args.steps)}
    if args.steps == 1000:
        out["value_pc250"] = throughput(args.batch, 0.0, 250)
    out.update(batch=args.batch, steps=args.steps, device=str(device))
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
