"""Record a ``torch.profiler`` trace of the hot paths on the card.

    python -m rdm_tpu_torch.benchmark.trace --what sample --outdir traces/
    python -m rdm_tpu_torch.benchmark.trace --what train --outdir traces/

The program is the flagship configuration (``configs/train.yaml``) in
bfloat16 with the attention kernel, weights drawn from seed 0:

* ``sample``: reflected PC sampling (Euler-Maruyama, no corrector) of
  ``--batch`` trajectories with ``--steps`` steps, labels 0 and the
  unguided fast path (w = 0: one forward a step);
* ``train``: five training steps (default loss settings) on a uniform batch
  of ``--batch`` whose labels are its first pixel (``batch[:, :, 0, 0]``).

One run warms up (kernel builds, cuDNN plans), one is timed with the host
clock (ending in a synchronisation), and one is recorded with CPU and CUDA
activities into ``<outdir>/trace_<what>.json``, a Chrome trace (open it in
``chrome://tracing`` or Perfetto).  Prints one JSON line: the trace's path
and bytes, the device ms and idle share per step, kernel launches per step,
the attention kernels' launches in the trace and by their wrappers' counts,
and the kernels that take the most device time.  ``--device cpu`` runs on
the CPU (host activity only).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from ..config import load_config
from ..device import resolve_device
from ..models import NCSNpp
from ..models.registry import get_cf_score_fn
from ..ops import attention as attn_ops
from ..sampling import get_pc_sampler
from ..sde import RVESDE
from ..training.losses import make_train_step
from ..training.state import init_train_state
from .common import trace_kernels

TRAIN_STEPS = 5


def is_attn_fwd(name: str) -> bool:
    return "fused_attn_block" in name and "_bwd" not in name


def is_attn_bwd(name: str) -> bool:
    return "fused_attn_block_bwd" in name


def flagship_model(device, train: bool) -> NCSNpp:
    """The flagship NCSN++ in bfloat16 with the attention kernel, weights
    from seed 0, on ``device``."""
    cfg = load_config("train")
    cfg.model.precision = "bfloat16"
    cfg.model.attn_pallas = True
    model = NCSNpp.from_config(cfg).init_weights(torch.Generator().manual_seed(0))
    model.to(device).train(train).requires_grad_(train)
    return cfg, model


def sample_program(device, batch: int, steps: int):
    """``run(seed) -> samples``: the traced sampling call."""
    cfg, model = flagship_model(device, train=False)
    sde = RVESDE(cfg.sde.sigma_min, cfg.sde.sigma_max, steps)
    sampler = get_pc_sampler(sde, (batch, 1, 9, 9), eps=1e-5)
    labels = torch.zeros((batch, 1), device=device)
    score_fn = get_cf_score_fn(sde, model, labels, 0.0)   # w = 0: the conditional half only

    def run(seed):
        with torch.no_grad():
            return sampler(score_fn, torch.Generator(device=device).manual_seed(seed))[0]

    return run, steps - 1


def train_program(device, batch: int, steps: int):
    """``run(seed) -> loss``: five training steps of the traced program."""
    cfg, model = flagship_model(device, train=True)
    state = init_train_state(model, cfg)
    sde = RVESDE(cfg.sde.sigma_min, cfg.sde.sigma_max, steps)
    step = make_train_step(sde)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((batch, 1, 9, 9), generator=gen, device=device)
    labels = x[:, :, 0, 0]

    def run(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        for _ in range(TRAIN_STEPS):
            loss = step(state, x, labels, g)
        return loss

    return run, TRAIN_STEPS


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--what", default="sample", choices=["sample", "train"])
    p.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(), "rdm-torch-trace"))
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    program = sample_program if args.what == "sample" else train_program
    run, per_call = program(device, args.batch, args.steps)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run(0)                                        # warm-up: kernel builds, cuDNN plans
    sync()
    t0 = time.perf_counter()
    run(1)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / per_call

    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, f"trace_{args.what}.json")
    before = (attn_ops.fused_attn_block.launches, attn_ops.fused_attn_block_bwd.launches)
    held = {}

    def traced():
        held["out"] = run(1)

    prof = trace_kernels(traced, per_call, path=path,
                         count={"attn_fwd": is_attn_fwd, "attn_bwd": is_attn_bwd})
    result = {
        "what": args.what, "batch": args.batch, "steps": args.steps,
        "steps_traced": per_call, "path": path,
        "wall_ms_per_step": wall_ms,
        "idle_share": 1.0 - prof["device_ms_per_step"] / wall_ms if device.type == "cuda"
        else None,
        "attn_launches_in_trace": {"fwd": prof["counted"]["attn_fwd"],
                                   "bwd": prof["counted"]["attn_bwd"]},
        "attn_launches_by_wrapper": {
            "fwd": attn_ops.fused_attn_block.launches - before[0],
            "bwd": attn_ops.fused_attn_block_bwd.launches - before[1]},
        **{k: v for k, v in prof.items() if k != "counted"},
        "device": str(device),
    }
    if device.type == "cuda":
        result["device_name"] = torch.cuda.get_device_name(device)
    print(json.dumps(result))
    result["output"] = held["out"]
    return result


if __name__ == "__main__":
    main()
