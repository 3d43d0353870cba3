"""Sampling / visualisation CLI.

    python -m rdm_tpu_torch.run_vis load_dir="Training Runs/<run>" eval.batch_size=100

Reads the run's ``.hydra/config.yaml`` manifest, replaces its sampling
block with the one from ``configs/vis.yaml`` (and the CLI), restores the
requested (or latest) checkpoint with its EMA weights and writes
``eval.rounds`` batches as ``vis/<date>/<time>/images/samples_{r}.npz``
(uint8, NHWC) plus a PNG grid when matplotlib is installed.  It runs on the
card; ``+device=cpu`` runs it on the CPU.  ``model.<key>=<value>`` replaces
a key of the run's model config: ``model.resblock_pallas=true`` samples
with the fused resblock kernel.  ``sampling.method=ode`` samples with the
probability-flow ODE; ``sampling.denoiser=network
denoiser_path="Training Runs/<run>"`` ends sampling with that run's EMA
model (``checkpoints/checkpoint.pth``) as the trained denoiser.
"""
from __future__ import annotations

import io
import os
import sys
from datetime import datetime

import numpy as np
import torch

from .benchmark.common import SAMPLING_EPS, LoadedModel, sample_shape
from .config import load_config
from .models.registry import get_cf_score_fn, get_score_fn
from .sampling import get_sampling_fn
from .training import checkpoints


def save_grid(sample: np.ndarray, path: str, max_tiles: int = 64) -> None:
    """PNG grid of NHWC samples; skipped when matplotlib is missing."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    n = min(sample.shape[0], max_tiles)
    nrow = int(np.sqrt(n)) or 1
    ncol = -(-n // nrow)
    fig, axes = plt.subplots(nrow, ncol, figsize=(ncol, nrow))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(sample[i, :, :, 0], cmap="viridis", vmin=0, vmax=1)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def main(argv=None, out_root: str = "vis") -> str:
    """Run the CLI; returns the output directory."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config("vis", overrides=argv)

    ckpt_dir = os.path.join(cfg.load_dir, "checkpoints")
    if cfg.eval.ckpt == -1:
        path = checkpoints.latest_checkpoint(ckpt_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    else:
        path = os.path.join(ckpt_dir, f"checkpoint_{cfg.eval.ckpt}.pth")
    lm = LoadedModel(cfg.load_dir, checkpoint_file=path, device=cfg.get("device"),
                     model_overrides=cfg.get("model"))
    load_cfg = lm.cfg
    load_cfg.sampling = cfg.sampling  # the vis config's sampling instructions
    # the trained denoiser: a run's EMA model called on (x, t)
    denoiser_fn = None
    if cfg.sampling.denoiser == "network" and cfg.get("denoiser_path"):
        dn = LoadedModel(cfg.denoiser_path, device=lm.device,
                         checkpoint_file=os.path.join(cfg.denoiser_path, "checkpoints",
                                                      "checkpoint.pth"))
        denoiser_fn = dn.model

    now = datetime.now()
    log_dir = os.path.join(out_root, now.strftime("%Y.%m.%d"), now.strftime("%H%M%S"))
    img_dir = os.path.join(log_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    print(f"Generating samples for checkpoint {path}")

    B = cfg.eval.batch_size
    sampling_fn = get_sampling_fn(load_cfg, lm.sde, sample_shape(load_cfg, B), SAMPLING_EPS)
    if bool(load_cfg.data.get("classes", False)):
        labels = torch.full((B, load_cfg.model.get("num_classes", 1)),
                            float(cfg.get("label", 0)), device=lm.device)
        score_fn = get_cf_score_fn(lm.sde, lm.model, labels, float(cfg.get("w", 0)))
    else:
        score_fn = get_score_fn(lm.sde, lm.model)
    generator = torch.Generator(device=lm.device).manual_seed(0)
    for r in range(cfg.eval.rounds):
        print(f"Round {r}")
        x, _ = sampling_fn(score_fn, generator, denoiser_fn=denoiser_fn)
        samples = x.float().permute(0, 2, 3, 1).cpu().numpy()    # NHWC
        samples_u8 = np.round(np.clip(samples, 0, 1) * 255).astype(np.uint8)
        save_grid(samples, os.path.join(img_dir, f"samples_{r}.png"))
        with open(os.path.join(img_dir, f"samples_{r}.npz"), "wb") as fout:
            buf = io.BytesIO()
            np.savez_compressed(buf, samples=samples_u8)
            fout.write(buf.getvalue())
    print("Finished generating samples.")
    return log_dir


if __name__ == "__main__":
    main()
