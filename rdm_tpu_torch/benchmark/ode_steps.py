"""How many score evaluations the probability-flow ODE sampler takes.

    python -m rdm_tpu_torch.benchmark.ode_steps --batch 1024 --seeds 0,1,2 \\
        --precision bfloat16,float32

For each working type and seed: the flagship run's EMA weights (its latest
checkpoint, ``checkpoint_10.pth``) sample one batch with the ODE sampler
(Dormand-Prince, rtol = atol = 1e-5, one step size for the batch) through
``generate_raw_samples``, and a forward hook counts the model's evaluations
(NFE).  One JSON line a run, then the mean and the spread over the seeds of
each working type.  The error norm is a mean over the whole batch, so NFE
depends on the batch: compare counts only at one batch.  Float32 runs with
TF32 off (matmuls and cuDNN).  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .common import REPO_ROOT, LoadedModel, generate_raw_samples

FLAGSHIP_RUN = os.path.join(REPO_ROOT, "Training Runs", "2026.08.17_184657")


def count_nfe(model_path: str, batch: int, seed: int, precision: str, device=None) -> dict:
    lm = LoadedModel(model_path, device=device, model_overrides={"precision": precision})
    lm.cfg.sampling.method = "ode"
    forwards = []
    hook = lm.model.register_forward_pre_hook(lambda module, inputs: forwards.append(1))
    try:
        samples, times = generate_raw_samples(lm, batch, batch, guidance_weight=0.0, seed=seed)
    finally:
        hook.remove()
    return {"precision": precision, "seed": seed, "batch": batch, "nfe": len(forwards),
            "steps": len(forwards) // 7, "wall_s": sum(times), "device": str(lm.device),
            "finite": bool(np.isfinite(samples).all())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_path", default=FLAGSHIP_RUN)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--precision", default="bfloat16,float32")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device is None or args.device.startswith("cuda"):
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    runs = []
    for precision in args.precision.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            res = count_nfe(args.model_path, args.batch, seed, precision, args.device)
            res["total_s"] = time.perf_counter() - t0
            print(json.dumps(res), flush=True)
            runs.append(res)
    summary = {}
    for precision in args.precision.split(","):
        nfe = np.array([r["nfe"] for r in runs if r["precision"] == precision], float)
        summary[precision] = {"nfe": nfe.astype(int).tolist(), "mean": float(nfe.mean()),
                              "sd": float(nfe.std(ddof=1)) if nfe.size > 1 else None,
                              "min": int(nfe.min()), "max": int(nfe.max())}
    out = {"batch": args.batch, "device": kind, "by_precision": summary}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
