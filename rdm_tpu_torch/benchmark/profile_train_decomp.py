"""Decompose the training step's time and memory traffic by component.

    python -m rdm_tpu_torch.benchmark.profile_train_decomp [--batch 4096]

The program is the flagship configuration (``configs/train.yaml``) in
bfloat16 with the attention kernels forward and backward, weights drawn
from seed 0, on a uniform batch in [0.05, 0.95] from numpy seed 0 whose
labels are its first pixel.  Components:

* ``full``: the production step (loss, gradients, clip/Adam/EMA update);
* ``loss``: the loss value alone (the draws, the train-mode forward and the
  ``score_hk`` target; no backward);
* ``fwd``: the score network's train-mode forward alone (dropout and label
  drop on) at the time conditioning of t = 0.5;
* ``target+draws``: the t and z draws, ``marginal_prob``, ``reflect`` and
  ``score_hk``;
* ``opt``: the guarded clip/Adam/EMA update on frozen gradients of 1e-4.

Each component runs eagerly as a loop of K iterations that ends in one
``torch.cuda.synchronize()``, timed at K = 2 and K = 10 (the least of three
runs after a warm-up); its time per iteration is the slope.  No CUDA graph:
the update reads its finiteness and norm back to the host every step.
Every slope, the scaling rows' too, is timed before any component is
counted or profiled, so that neither can bear on a slope.  Beside each
slope, ``torch.profiler``'s device ms and idle share per iteration (the
K = 10 loop traced once), and the costs of one iteration
from ``benchmark.costs``: operations (the products and convolutions that
torch's flop counter sees, plus the attention kernels' by formula) and
bytes (every aten operation's inputs and outputs, plus the attention
kernels' by formula); ``counted`` and ``modeled`` say which part is which.
Then the full step's per-sample scaling at ``--batches``.

``--skip_rbg`` is accepted for the command lines of the TPU script, whose
last section compared two PRNG implementations: PyTorch on CUDA has one
generator (Philox), so there is nothing to compare.  ``--override`` takes
configuration overrides (``model.nf=16``) for small runs; ``--device cpu``
runs on the CPU (host times, no device sums).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import load_config
from ..device import resolve_device
from ..models import NCSNpp
from ..ops import cube
from ..sde import get_sde
from ..training.losses import _bcast, get_loss_fn, guarded_update, make_train_step
from ..training.state import init_train_state
from .common import trace_kernels
from .costs import count_costs

COMPONENTS = ("full", "loss", "fwd", "target+draws", "opt")
K1, K2, REPEATS = 2, 10, 3
T_FWD = 0.5
FROZEN_GRAD = 1e-4


class Setup:
    """The program at one batch: config, model, training state, SDE, batch,
    labels and a generator on ``device``."""

    def __init__(self, batch: int, device, overrides=()):
        self.device = torch.device(device)
        cfg = load_config("train", overrides=["model.precision=bfloat16",
                                              "model.attn_pallas=true", *overrides])
        model = NCSNpp.from_config(cfg).init_weights(torch.Generator().manual_seed(0))
        model.to(self.device).train()
        self.cfg, self.model = cfg, model
        self.state = init_train_state(model, cfg)
        self.sde = get_sde(cfg)
        rng = np.random.default_rng(0)
        x = rng.uniform(0.05, 0.95, (batch, 9, 9, 1)).astype(np.float32)
        self.x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(self.device)
        self.labels = self.x[:, :, 0, 0].contiguous()
        self.gen = torch.Generator(device=self.device).manual_seed(0)


def target(sde, h, t, z):
    """``score_hk`` of the perturbed batch: ``reflect(mean + std z)`` from
    ``marginal_prob(h, t)``, the loss's target."""
    mean, std = sde.marginal_prob(h, t)
    perturbed = cube.reflect(mean + _bcast(std, h) * z)
    return cube.score_hk(perturbed, mean, std)


def components(s: Setup) -> dict:
    """``name -> body()``: one iteration of each component, carrying its
    state (parameters, generator, h) from one iteration to the next."""
    cfg, sde, x, labels, gen = s.cfg, s.sde, s.x, s.labels, s.gen
    kw = dict(reduce_mean=cfg.training.reduce_mean,
              likelihood_weighting=cfg.training.likelihood_weighting)
    step = make_train_step(sde, **kw)
    loss_fn = get_loss_fn(sde, train=True, **kw)
    B = x.shape[0]
    _, time_cond = sde.marginal_prob(torch.zeros_like(x),
                                     torch.full((B,), T_FWD, device=x.device))
    carry = {"fwd": x}
    grads = [torch.full_like(p, FROZEN_GRAD) for p in s.state.params]
    one = torch.ones((), device=x.device)

    def full():
        step(s.state, x, labels, gen)

    @torch.no_grad()
    def loss():
        loss_fn(s.model, x, labels, gen)

    @torch.no_grad()
    def fwd():
        h = carry["fwd"]
        carry["fwd"] = s.model(h, time_cond, labels, train=True, generator=gen).to(h.dtype)

    @torch.no_grad()
    def target_and_draws():     # eager: the unused result is computed all the same
        t = torch.rand((B,), generator=gen, device=x.device) * (sde.T - 1e-5) + 1e-5
        z = torch.randn(x.shape, generator=gen, device=x.device)
        target(sde, x, t, z)

    def opt():
        guarded_update(s.state, one, grads)

    return {"full": full, "loss": loss, "fwd": fwd, "target+draws": target_and_draws,
            "opt": opt}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loop(body, k: int, device):
    def run():
        for _ in range(k):
            body()
        _sync(device)
    return run


def timed(run, repeats: int = REPEATS) -> float:
    """The least wall s of ``repeats`` calls after a warm-up."""
    run()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def time_body(body, device) -> dict:
    """Slope ms per iteration and the K = 10 loop's wall per iteration."""
    t1 = timed(loop(body, K1, device))
    t2 = timed(loop(body, K2, device))
    return {"ms": (t2 - t1) / (K2 - K1) * 1e3, "wall_ms_k10": t2 / K2 * 1e3}


def add_costs(body, device, out: dict) -> dict:
    """The costs of one iteration, and the effective rate at ``out``'s slope."""
    c = count_costs(body)
    _sync(device)
    out.update(gflop=c["flops"] / 1e9, gb=c["bytes"] / 1e9,
               effective_gb_per_s=c["bytes"] / 1e9 / (out["ms"] / 1e3) if out["ms"] > 0
               else None,
               costs={"counted": c["counted"], "modeled": c["modeled"]})
    return out


def add_profile(body, device, out: dict) -> dict:
    """The traced device ms, idle share (against the timed K = 10 wall),
    launches and top kernels per iteration (on the card only)."""
    if device.type == "cuda":
        prof = trace_kernels(loop(body, K2, device), K2, top=5)
        out["device_ms"] = prof["device_ms_per_step"]
        out["idle_share"] = 1.0 - prof["device_ms_per_step"] / out["wall_ms_k10"]
        out["launches"] = prof["kernel_launches_per_step"]
        out["top_kernels"] = prof["top_kernels"]
    return out


def peak_memory_gb(device) -> float | None:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--batches", default="4096,8192,16384")
    p.add_argument("--skip_scaling", action="store_true")
    p.add_argument("--skip_rbg", action="store_true",
                   help="accepted for the TPU script's command lines; there is no PRNG "
                        "section here")
    p.add_argument("--override", action="append", default=[],
                   help="a configuration override, e.g. model.nf=16 (repeatable)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    s = Setup(args.batch, device, args.override)
    bodies = components(s)
    result = {"batch": args.batch, "device": str(device), "components": {},
              "costs_note": "gflop: the products and convolutions torch's flop counter sees "
                            "(elementwise work, reductions and normalisations count 0) plus "
                            "the attention kernels' by formula; gb: every aten operation's "
                            "inputs and outputs plus the attention kernels' by formula (no "
                            "L2 or HBM counter is readable); counted and modeled split them",
              "timing_note": "every slope is taken before any cost count or profiler "
                             "session; device ms from one traced K=10 loop afterwards"}
    # all timing first, so that no count or profiler session precedes a slope
    for name in COMPONENTS:
        result["components"][name] = time_body(bodies[name], device)

    if not args.skip_scaling:
        result["scaling"] = []
        for b in [int(v) for v in args.batches.split(",")]:
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            row = {"batch": b}
            try:
                sb = Setup(b, device, args.override)
                full = components(sb)["full"]
                row.update(time_body(full, device), peak_memory_gb=peak_memory_gb(device))
                add_costs(full, device, row)
                row["us_per_sample"] = row["ms"] / b * 1e3
                del sb, full
            except torch.OutOfMemoryError:
                row.update(out_of_memory=True, peak_memory_gb=peak_memory_gb(device))
            result["scaling"].append(row)

    print(f"== component decomposition at batch {args.batch} (slope of K={K1} and K={K2} "
          "eager iterations; costs of one iteration) ==", flush=True)
    for name in COMPONENTS:
        m = add_costs(bodies[name], device, add_profile(bodies[name], device,
                                                        result["components"][name]))
        print(f"{name:13s} {m['ms']:8.2f} ms/iter   {m['gflop']:8.1f} GF   "
              f"{m['gb']:8.2f} GB   -> {m['effective_gb_per_s'] or 0:6.0f} GB/s eff   "
              f"device {m.get('device_ms', float('nan')):8.2f} ms   "
              f"idle {m.get('idle_share', float('nan')):.3f}", flush=True)
    if not args.skip_scaling:
        print("== per-sample scaling (full step) ==", flush=True)
        for row in result["scaling"]:
            print(f"batch {row['batch']:6d}: " + (
                "out of memory" if row.get("out_of_memory") else
                f"{row['ms']:8.2f} ms/step  {row['us_per_sample']:6.2f} us/sample  "
                f"{row['gb']:7.2f} GB  -> {row['effective_gb_per_s'] or 0:6.0f} GB/s eff")
                + f"  peak {row['peak_memory_gb']} GB", flush=True)

    print("== PRNG implementations: none to compare (PyTorch on CUDA has one generator, "
          "Philox) ==", flush=True)
    if device.type == "cuda":
        result["device_name"] = torch.cuda.get_device_name(device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
