"""How far the clipped control triples exceed |u| = 1.

    python -m rdm_tpu_torch.scripts.clip_excess [run_dir] [steps] [n] [--out PATH]

The benchmark's inverse pipeline clips each control triple's magnitude at 1
(``benchmark/gto_halo.py``), so the stored artifacts cannot show by how
much a sample overshoots.  This regenerates the PC stream of the run
(``steps`` steps, seed 0, batch n), de-standardises it with the run's
``data.gto_std`` and ``data.gto_mean`` (the pipeline's ``GTO_STD`` and
``GTO_MEAN`` where the run records none), rescales the controls with the
pipeline's ``THRUST`` and reports the share of triples above 1 and the
excess's median, 90th percentile and maximum.  Writes them to ``--out``
(default ``benchmark_results/torch/clip_excess.json``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..benchmark.common import generate_raw_samples
from ..benchmark.gto_halo import (GTO_MEAN, GTO_STD, THRUST, GTOHaloBenchmarkConfig,
                                  GTOHaloBenchmarker)
from ..sde import RVESDE
from .study_common import FLAGSHIP_RUN, default_out, write_json


def control_magnitudes(raw: np.ndarray, data_cfg) -> np.ndarray:
    """|u| of every control triple [N, 20] of model-space samples [N, 67],
    before the pipeline's clip."""
    out = raw[:, 1:].astype(np.float64)
    out = out * float(data_cfg.get("gto_std", GTO_STD)) + float(data_cfg.get("gto_mean", GTO_MEAN))
    ctrl = (out[:, 3:-3] * 2 * THRUST - THRUST).reshape(-1, 20, 3)
    return np.sqrt((ctrl ** 2).sum(-1))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir", nargs="?", default=FLAGSHIP_RUN)
    p.add_argument("steps", nargs="?", type=int, default=250)
    p.add_argument("n", nargs="?", type=int, default=1024)
    p.add_argument("--out", default=default_out("clip_excess.json"))
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    bench = GTOHaloBenchmarker(GTOHaloBenchmarkConfig(
        model_path=args.run_dir, num_samples=args.n, batch_size=args.n,
        enable_physical_validation=False, device=args.device,
        output_dir=os.path.join(tempfile.gettempdir(), "clip_excess")))
    cfg = bench.lm.cfg
    sde = RVESDE(cfg.sde.sigma_min, cfg.sde.sigma_max, args.steps)
    raw, _ = generate_raw_samples(bench.lm, args.n, args.n, sde_override=sde, seed=0)
    u = control_magnitudes(raw, cfg.data)
    exc = u[u > 1] - 1
    out = {"run_dir": args.run_dir, "steps": args.steps, "n": args.n,
           "triples": int(u.size), "clipped": int((u > 1).sum()),
           "clipped_share": float((u > 1).mean()),
           "excess_median": float(np.median(exc)) if exc.size else None,
           "excess_p90": float(np.percentile(exc, 90)) if exc.size else None,
           "excess_max": float(exc.max()) if exc.size else None,
           "u_median": float(np.median(u)), "u_p90": float(np.percentile(u, 90))}
    print(f"triples: {u.size}, clipped: {out['clipped']} ({100 * out['clipped_share']:.2f}%)")
    if exc.size:
        print(f"excess over 1: median {out['excess_median']:.4f}, "
              f"p90 {out['excess_p90']:.4f}, max {out['excess_max']:.4f}")
    print(f"|u|: median {out['u_median']:.3f}, p90 {out['u_p90']:.3f}")
    write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
