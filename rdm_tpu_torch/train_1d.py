"""Training CLI of the legacy 1-D DDPM pipeline (the legacy U-Net, the
Gaussian diffusion and ``Trainer1D``), with the root ``train_1d.py``'s flags
and ``--device``:

    python -m rdm_tpu_torch.train_1d --data_path data.pkl --unet_dim 128 \\
        --unet_dim_mults 4,4,8 --embed_class_layers_dims 256,512 \\
        --timesteps 500 --batch_size 512 --max_epoch 200

Data: an [N, class_dim + seq_length] pickle; column 0 is the conditioning
(the normalised halo energy), the rest the 66-dim trajectory vector.  Every
``N // training_data_num``-th row is used.  The run writes
``metrics.jsonl`` and the best two ``model-epoch-N.pt`` under
``<result_folder>/unet_<dim>_mults_..._batch_size_<B>``.
"""
from __future__ import annotations

import argparse
import os
import pickle
import random

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Hyperparameter tuning for diffusion models")
    p.add_argument("--machine", type=str, default="tpu")
    p.add_argument("--unet_dim", type=int, default=20)
    p.add_argument("--unet_dim_mults", type=str, default="4,4,8")
    p.add_argument("--embed_class_layers_dims", type=str, default="40,80")
    p.add_argument("--cond_drop_prob", type=float, default=0.1)
    p.add_argument("--channel_num", type=int, default=1)
    p.add_argument("--mask_val", type=float, default=-1.0)
    p.add_argument("--timesteps", type=int, default=500)
    p.add_argument("--objective", type=str, default="pred_noise",
                   choices=["pred_v", "pred_noise"])
    p.add_argument("--seq_length", type=int, default=66)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--wandb_project_name", type=str, default="diffusion_for_cr3bp")
    p.add_argument("--class_dim", type=int, default=1)
    p.add_argument("--training_data_type", type=str,
                   default="cr3bp_cond_time_mass_alpha_data_control")
    p.add_argument("--training_data_range", type=str, default="0_1")
    p.add_argument("--training_data_num", type=int, default=26000)
    p.add_argument("--max_epoch", type=int, default=200)
    p.add_argument("--result_folder", type=str, default="results/checkpoint_result/")
    p.add_argument("--constraint_violation_weight", type=float, default=0.01)
    p.add_argument("--constraint_condscale", type=float, default=6.0)
    p.add_argument("--training_random_seed", type=int, default=0)
    p.add_argument("--max_sample_step_with_constraint_loss", type=int, default=500)
    p.add_argument("--constraint_loss_type", type=str, default="NA",
                   choices=["one_over_t", "gt_threshold", "gt_scaled", "gt_std",
                            "gt_std_absolute", "gt_std_threshold",
                            "gt_log_likelihood", "NA"])
    p.add_argument("--task_type", type=str, default="cr3bp",
                   choices=["car", "tabletop", "cr3bp"])
    p.add_argument("--constraint_gt_sample_num", type=int, default=100)
    p.add_argument("--normalize_xt_by_mean_sigma", type=str, default="False",
                   choices=["False", "True"])
    p.add_argument("--train_lr", type=float, default=1e-4)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def set_seed(seed: int = 42) -> None:
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    print(f"Random seed set as {seed}")


def results_folder(args) -> str:
    return os.path.join(
        args.result_folder,
        f"unet_{args.unet_dim}_mults_{args.unet_dim_mults.replace(',', '_')}"
        f"_embed_class_{args.embed_class_layers_dims.replace(',', '_')}"
        f"_timesteps_{args.timesteps}_objective_{args.objective}"
        f"_batch_size_{args.batch_size}")


def main(argv=None):
    args = parse_args(argv)
    set_seed(args.training_random_seed)

    import torch

    from .device import resolve_device
    from .diffusion1d import GaussianDiffusion1D
    from .diffusion1d.trainer1d import Trainer1D
    from .models.unet1d import UNet1D

    device = resolve_device(args.device)
    with torch.device(device):
        model = UNet1D(
            dim=args.unet_dim, channels=args.channel_num,
            dim_mults=tuple(map(int, args.unet_dim_mults.split(","))),
            embed_class_layers_dims=tuple(map(int, args.embed_class_layers_dims.split(","))),
            class_dim=args.class_dim, cond_drop_prob=args.cond_drop_prob,
            mask_val=args.mask_val, seq_length=args.seq_length, legacy=True)
    diffusion = GaussianDiffusion1D(
        model=model, seq_length=args.seq_length, timesteps=args.timesteps,
        objective=args.objective,
        constraint_violation_weight=args.constraint_violation_weight,
        constraint_condscale=args.constraint_condscale,
        max_sample_step_with_constraint_loss=args.max_sample_step_with_constraint_loss,
        constraint_loss_type=args.constraint_loss_type, task_type=args.task_type,
        constraint_gt_sample_num=args.constraint_gt_sample_num,
        normalize_xt_by_mean_sigma=args.normalize_xt_by_mean_sigma)

    with open(args.data_path, "rb") as f:
        data = np.asarray(pickle.load(f), np.float32)
    x = data[:, args.class_dim:].reshape(data.shape[0], args.channel_num, args.seq_length)
    c = data[:, :args.class_dim].reshape(data.shape[0], args.class_dim)
    step_size = max(len(x) // args.training_data_num, 1)
    x, c = x[::step_size], c[::step_size]

    class _DS:
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], c[i]

    epochs_steps = (len(x) // args.batch_size) * args.max_epoch
    trainer = Trainer1D(diffusion, _DS(), train_batch_size=args.batch_size,
                        train_lr=args.train_lr, train_num_steps=max(epochs_steps, 1),
                        results_folder=results_folder(args),
                        training_random_seed=args.training_random_seed, device=device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
