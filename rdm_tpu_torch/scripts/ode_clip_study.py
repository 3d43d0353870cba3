"""Where the ODE sampler's clipped control triples come from.

    python -m rdm_tpu_torch.scripts.ode_clip_study [run_dir] [n] [--grade] [--out PATH]

The probability-flow ODE clips more control triples at |u| > 1 than the PC
sampler on the same weights.  Two knobs of the ODE path could cause it:
the mollifier ``bump`` on the reverse drift near the cube's faces
(``moll``) and the inset of the uniform initial state (``side_eps``).
This samples n trajectories from the run's EMA model under nine
configurations (three PC schedules as controls, six ODE settings) and
records for each: the inverse pipeline's spherical clip rate, the share of
model-space components within 1e-3 and 1e-2 of a face, the MSE and mean
per-component Wasserstein distance to the first n training rows, and with
``--grade`` the float64 LM-``--max_iters`` cold feasible ratio on the card
(``--backend native``: on the host's C++ oracle).

The ``moll = 0`` row does not turn the mollifier off: with ``moll = 0``
the sampler multiplies the drift by x (``sampling/ode.py``: ``make_bump``,
the reference's behaviour that the JAX package keeps), so that row
measures a drift scaled by the state, not an undamped baseline.

Default artifact: ``benchmark_results/torch/ode_clip_study.json``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..benchmark.gto_halo import GTOHaloBenchmarkConfig, GTOHaloBenchmarker
from ..models.registry import get_cf_score_fn
from ..sampling import get_pc_sampler
from ..sampling.ode import get_ode_sampler
from ..sde import RVESDE
from .study_common import FLAGSHIP_RUN, GT_PKL, default_out, grade, load_rows, write_json

CONFIGS = [
    {"sampler": "pc", "label": "pc1000 (control)"},
    {"sampler": "pc", "steps": 250, "label": "pc250 (production schedule)"},
    {"sampler": "pc", "steps": 100, "label": "pc100"},
    {"sampler": "ode", "moll": 200, "side_eps": 1e-2, "label": "ode default (moll=200)"},
    {"sampler": "ode", "moll": 50, "side_eps": 1e-2, "label": "ode sharper damping (moll=50)"},
    {"sampler": "ode", "moll": 800, "side_eps": 1e-2, "label": "ode gentler damping (moll=800)"},
    {"sampler": "ode", "moll": 0, "side_eps": 1e-2,
     "label": "ode moll=0 (drift multiplied by x, not undamped)"},
    {"sampler": "ode", "moll": 200, "side_eps": 1e-3, "label": "ode smaller init inset"},
    {"sampler": "ode", "moll": 200, "side_eps": 5e-2, "label": "ode larger init inset"},
]


def face_mass(raw: np.ndarray, delta: float = 1e-3) -> float:
    """Share of model-space components within ``delta`` of a cube face."""
    return float(((raw < delta) | (raw > 1 - delta)).mean())


def ml_stats(samples: np.ndarray, ref_rows: np.ndarray) -> dict:
    from scipy.stats import wasserstein_distance
    n = min(len(samples), len(ref_rows))
    a, b = samples[:n], ref_rows[:n]
    return {"mse": round(float(np.mean((a - b) ** 2)), 5),
            "wasserstein_mean": round(float(np.mean([
                wasserstein_distance(a[:, j], b[:, j]) for j in range(a.shape[1])])), 5)}


def sample(lm, c: dict, B: int, seed: int = 0):
    """(model-space samples [B, 67], NFE) of configuration ``c``."""
    gen = torch.Generator(device=lm.device).manual_seed(seed)
    labels = torch.rand((B, 1), generator=gen, device=lm.device)
    shape = (B, 1, 9, 9)
    if c["sampler"] == "pc":
        sde = lm.sde
        if c.get("steps"):
            sde = RVESDE(lm.cfg.sde.sigma_min, lm.cfg.sde.sigma_max, int(c["steps"]))
        sampler = get_pc_sampler(sde, shape, eps=1e-5)
    else:
        sde = lm.sde
        sampler = get_ode_sampler(sde, shape, moll=c["moll"], side_eps=c["side_eps"])
    x, nfe = sampler(get_cf_score_fn(sde, lm.model, labels, 0.0), gen)
    return x.reshape(B, -1)[:, :67].float().cpu().numpy(), int(nfe)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir", nargs="?", default=FLAGSHIP_RUN)
    p.add_argument("n", nargs="?", type=int, default=1024)
    p.add_argument("--grade", action="store_true",
                   help="also grade each configuration on the card (float64, cold)")
    p.add_argument("--max_iters", type=int, default=30)
    p.add_argument("--backend", default="tpu", choices=["tpu", "native"],
                   help="native: grade on the host's C++ oracle instead")
    p.add_argument("--gt_pkl", default=GT_PKL)
    p.add_argument("--out", default=default_out("ode_clip_study.json"))
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    bench = GTOHaloBenchmarker(GTOHaloBenchmarkConfig(
        model_path=args.run_dir, num_samples=args.n, batch_size=args.n,
        enable_physical_validation=False, device=args.device,
        output_dir=os.path.join(tempfile.gettempdir(), "ode_clip")))
    lm, B = bench.lm, args.n
    # the training rows are model-space unit-cube 67-vectors, comparable
    # with the raw samples as they are
    gt = load_rows(args.gt_pkl, B).astype(np.float64)[:, :67]

    rows = []
    for c in CONFIGS:
        t0 = time.time()
        raw, nfe = sample(lm, c, B)
        dt = time.time() - t0
        bench.total_spherical_clips = bench.total_spherical_elements = 0
        phys = bench._inverse_pipeline(raw)
        clip_rate = bench.total_spherical_clips / max(1, bench.total_spherical_elements)
        row = {**c, "n": B, "nfe": nfe, "clip_rate": round(float(clip_rate), 5),
               "face_mass_1e-3": round(face_mass(raw, 1e-3), 5),
               "face_mass_1e-2": round(face_mass(raw, 1e-2), 5),
               **ml_stats(raw, gt), "wall_s": round(dt, 1)}
        if args.grade:
            res = grade(phys[:, 1:].astype(np.float32), phys[:, 0].astype(np.float32),
                        args.backend, lm.device, max_iters=args.max_iters, precision="df32")
            row["feasible_cold_df32"] = round(float(res["feasible"].mean()), 4)
        rows.append(row)
        print(row, flush=True)

    out = {"run_dir": args.run_dir, "rows": rows}
    write_json(args.out, out)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
