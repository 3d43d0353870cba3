"""Where the time of one training step goes, on the card.

    python -m rdm_tpu_torch.benchmark.profile_train

Loads the flagship run (its config, and the weights, EMA and Adam state of
``checkpoint_10.pth``), puts its training set on the card, warms up, then
times ``STEPS`` training steps of ``BATCH`` samples (bfloat16, the attention
kernels forward and backward, dropout and label drop on) with the host
clock, and traces as many more with ``torch.profiler``.  Prints one JSON
line: ms per step and samples per second (host clock, ending in a
synchronisation), device busy ms per step and the device's idle share,
kernel launches per step (all, and the attention kernels'), and the kernels
that take the most device time.
"""
from __future__ import annotations

import json
import os
import time

import torch

from ..ops import attention as attn_ops
from ..sde import get_sde
from ..training.losses import make_train_step_on_device
from .common import REPO_ROOT, load_training_run, trace_kernels

FLAGSHIP = os.path.join(REPO_ROOT, "Training Runs", "2026.08.17_184657")
BATCH = 4096       # the flagship training batch
STEPS = 20


def main():
    cfg, state, images, labels = load_training_run(FLAGSHIP)   # on the card, or raises
    step = make_train_step_on_device(get_sde(cfg), use_labels=True, batch_size=BATCH,
                                     reduce_mean=cfg.training.reduce_mean,
                                     likelihood_weighting=cfg.training.likelihood_weighting)
    gen = torch.Generator(device=images.device).manual_seed(0)

    def run():
        for _ in range(STEPS):
            step(state, images, labels, gen)

    for _ in range(3):                            # warm-up: cuDNN plans, kernel builds
        step(state, images, labels, gen)
    torch.cuda.synchronize()
    fwd0, bwd0 = attn_ops.fused_attn_block.launches, attn_ops.fused_attn_block_bwd.launches
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    fwd = (attn_ops.fused_attn_block.launches - fwd0) / STEPS
    bwd = (attn_ops.fused_attn_block_bwd.launches - bwd0) / STEPS

    prof = trace_kernels(run, STEPS)
    print(json.dumps({
        "batch": BATCH, "steps": STEPS,
        "device_name": torch.cuda.get_device_name(images.device),
        "wall_ms_per_step": wall_ms,
        "samples_per_second": BATCH / wall_ms * 1e3,
        "idle_share": 1.0 - prof["device_ms_per_step"] / wall_ms,
        "attn_fwd_launches_per_step": fwd, "attn_bwd_launches_per_step": bwd,
        **prof,
    }))


if __name__ == "__main__":
    main()
