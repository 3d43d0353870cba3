"""Sample warm starts from a trained legacy 1-D diffusion model, with the
root ``sample_1d.py``'s flags and ``--device``:

    python -m rdm_tpu_torch.sample_1d --checkpoint results/.../model-epoch-N.pt

Draws ``sample_num`` trajectories with classifier-free guidance
(``--diffusion_w``, cond_scale 5 by default) from the checkpoint's EMA
weights (its live weights when it has none), conditioned on halo energies
drawn from ``numpy.random.default_rng(seed)`` (as the JAX package's CLI
draws them), applies the physical un-normalisation (times,
cartesian -> spherical controls, fuel mass, manifold length; the halo
period stays normalised), prepends the physical halo energy and pickles
the [N, 67] float64 warm-start array.  Either package's checkpoint loads.
It prints the sampling's wall seconds (host clock, each batch read back)
and trajectories per second.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np


def convert_to_spherical(ux, uy, uz):
    u = np.sqrt(ux**2 + uy**2 + uz**2)
    theta = np.zeros_like(u)
    nz = u != 0
    theta[nz] = np.arcsin(np.clip(uz[nz] / u[nz], -1, 1))
    alpha = np.arctan2(uy, ux)
    alpha = np.where(alpha >= 0, alpha, 2 * np.pi + alpha)
    theta = np.where(theta >= 0, theta, 2 * np.pi + theta)
    u = np.minimum(u, 1.0)
    return alpha, theta, u


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True, help="model-epoch-N.pt of a 1-D training run")
    p.add_argument("--sample_num", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=1000)
    p.add_argument("--diffusion_w", type=float, default=5.0,
                   help="classifier-free guidance cond_scale")
    p.add_argument("--fixed_alpha", type=float, default=None)
    p.add_argument("--unet_dim", type=int, default=128)
    p.add_argument("--unet_dim_mults", type=str, default="4,4,8")
    p.add_argument("--embed_class_layers_dims", type=str, default="256,512")
    p.add_argument("--timesteps", type=int, default=500)
    p.add_argument("--objective", type=str, default="pred_noise")
    p.add_argument("--seq_length", type=int, default=66)
    p.add_argument("--class_dim", type=int, default=1)
    p.add_argument("--cond_drop_prob", type=float, default=0.1)
    p.add_argument("--mask_val", type=float, default=-1.0)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--seed", type=int, default=1000000)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def unnormalize(full: np.ndarray, alpha_norm: np.ndarray) -> np.ndarray:
    """[N, 66] samples in [0, 1] and their normalised energies -> the [N, 67]
    physical warm starts."""
    full = full.astype(np.float64)
    full[:, 0] = full[:, 0] * 40.0
    full[:, 1] = full[:, 1] * 15.0
    full[:, 2] = full[:, 2] * 15.0
    full[:, 3:-3] = full[:, 3:-3] * 2.0 - 1.0
    ux, uy, uz = full[:, 3:-3:3], full[:, 4:-3:3], full[:, 5:-3:3]
    a, b, r = convert_to_spherical(ux, uy, uz)
    full[:, 3:-3:3], full[:, 4:-3:3], full[:, 5:-3:3] = a, b, r
    full[:, -3] = full[:, -3] * (470 - 408) + 408
    full[:, -1] = full[:, -1] * (11 - 5) + 5
    halo_energies = alpha_norm * (0.095 - 0.008) + 0.008
    return np.hstack((halo_energies.astype(np.float64), full))


def main(argv=None):
    args = parse_args(argv)

    import torch

    from .device import resolve_device
    from .diffusion1d import GaussianDiffusion1D
    from .models.unet1d import UNet1D
    from .training.checkpoints import restore_unet1d_checkpoint

    device = resolve_device(args.device)
    with torch.device(device):
        model = UNet1D(
            dim=args.unet_dim, channels=1,
            dim_mults=tuple(map(int, args.unet_dim_mults.split(","))),
            embed_class_layers_dims=tuple(map(int, args.embed_class_layers_dims.split(","))),
            class_dim=args.class_dim, cond_drop_prob=args.cond_drop_prob,
            mask_val=args.mask_val, seq_length=args.seq_length, legacy=True)
    diffusion = GaussianDiffusion1D(model=model, seq_length=args.seq_length,
                                    timesteps=args.timesteps, objective=args.objective)
    ck = restore_unet1d_checkpoint(args.checkpoint)
    model.load_state_dict(ck.ema if ck.ema is not None else ck.model, strict=True)
    diffusion.to(device).eval()

    rng = np.random.default_rng(args.seed)
    if args.fixed_alpha is not None:
        alpha_norm = np.full((args.sample_num, 1), args.fixed_alpha, np.float32)
    else:
        alpha_norm = rng.uniform(0, 1, (args.sample_num, 1)).astype(np.float32)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    chunks = []
    start = time.perf_counter()
    for i in range(0, args.sample_num, args.batch_size):
        cls = torch.from_numpy(alpha_norm[i:i + args.batch_size]).to(device)
        out = diffusion.sample(cls, cond_scale=args.diffusion_w, generator=generator)
        chunks.append(out[:, 0, :].cpu().numpy())          # (B, L) in [0, 1]
    seconds = time.perf_counter() - start
    full = unnormalize(np.concatenate(chunks, 0)[:args.sample_num], alpha_norm)

    out_path = args.output or (
        f"generated_initializations/cr3bp_diffusion_boundary_w_{args.diffusion_w}"
        f"_num_{args.sample_num}"
        + (f"_alpha_{args.fixed_alpha}" if args.fixed_alpha is not None else "")
        + ".pkl")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(full, f)
    print(f"{out_path} is saved!  shape={full.shape}")
    print(f"sampled {args.sample_num} trajectories in {seconds} s "
          f"({args.sample_num / seconds} trajectories/s)")
    return full


if __name__ == "__main__":
    main()
