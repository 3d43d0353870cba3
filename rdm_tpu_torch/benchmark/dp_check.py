"""Data-parallel checks, run as rank processes (``parallel.launch``).

    python -m rdm_tpu_torch.benchmark.dp_check step SPEC OUT_DIR [--backend gloo]
    python -m rdm_tpu_torch.benchmark.dp_check sample RUN N OUT_DIR [--backend gloo]

``step`` takes one training step (``losses.make_train_step``) on this rank's
rows of a global batch and writes ``OUT_DIR/rank{r}.pt``: the loss, the
averaged gradients, the parameters, the Adam moments and counts, the EMA,
the attention kernels' launches in the step, and ms per step of
``--time_steps`` more steps on the trainer's on-device path.  ``SPEC`` is a
``torch.save``'d dict, one of

* ``{"overrides": [...], "model_state": state_dict, "batch", "labels", "t",
  "z"}``: a model of ``configs/train.yaml`` with the overrides and the given
  weights, on the CPU unless ``"device"`` names another;
* ``{"run": dir, "batch": B, "batch_seed": s, "draw_seed": d}``: a training
  run's latest checkpoint and training set (``load_training_run``), B rows
  drawn with a generator seeded ``s``, and t, z and the forward's masks
  drawn for the whole batch with one seeded ``d``, as ``get_loss_fn`` draws
  them.

Every rank builds the whole batch, t, z and masks and takes its contiguous
share, so the ranks' step is the one-process step of the same global batch
but for the order in which its gradient is summed.  ``"nan_rank": r``
poisons rank r's rows (the guarded update must then skip on every rank);
``"deterministic": True`` takes the step under cuDNN's deterministic
algorithms and ``"allow_tf32": False`` turns TF32 off, as a caller that
compares bits sets them in its own process.

``sample`` draws N trajectories a rank from a run's EMA weights (1000-step
PC, w = 0, a seed per rank) and rank 0 writes the gathered samples to
``OUT_DIR/samples.npy``, with each rank's launches and wall in
``OUT_DIR/rank{r}.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import load_config
from ..models import create_model, layers
from ..ops import attention as attn_ops
from ..parallel import mesh
from ..sde import get_sde
from ..training import losses
from ..training.state import init_train_state

LOSS_EPS = 1e-5   # get_loss_fn's default t floor


def record_draws(model, batch, labels, generator) -> list:
    """The uniform draws (``layers.uniform_draw``) one training forward of
    ``batch`` makes from ``generator``: the label drop and each dropout mask,
    in order."""
    draws = []
    draw = layers.uniform_draw

    def recording(shape, gen, device=None):
        draws.append(draw(shape, gen, device))
        return draws[-1]

    layers.uniform_draw = recording
    try:
        with torch.no_grad():
            sigma = torch.ones(batch.shape[0], device=batch.device)
            model(batch, sigma, labels, train=True, generator=generator)
    finally:
        layers.uniform_draw = draw
    return draws


@contextlib.contextmanager
def replay_draws(draws, rows):
    """The training forward takes ``draws[k][rows]`` for its k-th draw
    instead of drawing from its generator."""
    draw, calls = layers.uniform_draw, [0]

    def replaying(shape, gen, device=None):
        d = draws[calls[0]][rows]
        calls[0] += 1
        if tuple(d.shape) != tuple(shape):
            raise ValueError(f"draw {calls[0] - 1}: recorded {tuple(d.shape)}, asked {shape}")
        return d

    layers.uniform_draw = replaying
    try:
        yield
    finally:
        layers.uniform_draw = draw


@contextlib.contextmanager
def captured_grads():
    """The gradients the training step hands to the guarded update (after the
    all-reduce), appended to the yielded list."""
    update, seen = losses.guarded_update, []

    def capturing(state, loss, grads):
        seen.extend(g.detach().clone() for g in grads)
        return update(state, loss, grads)

    losses.guarded_update = capturing
    try:
        yield seen
    finally:
        losses.guarded_update = update


def load_step_spec(spec: dict, device):
    """``(cfg, state, batch, labels, t, z, draws)`` of a step spec (see the
    module's docstring)."""
    if "run" in spec:
        from .common import load_training_run
        cfg, state, images, labels = load_training_run(spec["run"], device)
        B = int(spec["batch"])
        idx = torch.randint(0, images.shape[0], (B,), device=device,
                            generator=torch.Generator(device=device)
                            .manual_seed(int(spec["batch_seed"])))
        batch, labels = images[idx], labels[idx]
        gen = torch.Generator(device=device).manual_seed(int(spec["draw_seed"]))
        sde = get_sde(cfg)
        t = torch.rand((B,), generator=gen, dtype=batch.dtype,
                       device=device) * (sde.T - LOSS_EPS) + LOSS_EPS
        z = torch.randn(batch.shape, generator=gen, dtype=batch.dtype, device=device)
        draws = record_draws(state.model, batch, labels, gen)
        return cfg, state, batch, labels, t, z, draws
    cfg = load_config("train", list(spec["overrides"]))
    model = create_model(cfg)
    model.load_state_dict(spec["model_state"], strict=True)
    state = init_train_state(model.to(device), cfg)
    put = lambda k: spec[k].to(device) if spec.get(k) is not None else None
    return cfg, state, put("batch"), put("labels"), put("t"), put("z"), []


def train_step_rows(cfg, state, batch, labels, t, z, draws, rows):
    """One ``make_train_step`` step on ``batch[rows]`` (with its labels, t, z
    and masks); returns the loss and the gradients the update took."""
    step = losses.make_train_step(get_sde(cfg), reduce_mean=cfg.training.reduce_mean,
                                  likelihood_weighting=cfg.training.likelihood_weighting)
    gen = torch.Generator(device=batch.device).manual_seed(0)   # every draw is given
    with replay_draws(draws, rows), captured_grads() as grads:
        loss = step(state, batch[rows], labels[rows] if labels is not None else None, gen,
                    t=t[rows], z=z[rows])
    return float(loss), grads


def ms_per_step(cfg, state, batch_size, steps: int, seed: int = 13) -> float:
    """Wall ms per step of ``steps`` steps on the trainer's on-device path
    (the run's training set, ``batch_size`` rows a rank), after one warm-up;
    the slowest rank's."""
    from ..data import load_arrays
    images, labels = (torch.from_numpy(a).to(state.params[0].device) for a in load_arrays(cfg))
    step = losses.make_train_step_on_device(
        get_sde(cfg), use_labels=bool(cfg.data.get("classes", False)),
        reduce_mean=cfg.training.reduce_mean,
        likelihood_weighting=cfg.training.likelihood_weighting, batch_size=batch_size)
    gen = torch.Generator(device=images.device).manual_seed(mesh.rank_seed(seed))
    step(state, images, labels, gen)
    _sync(images.device)
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, images, labels, gen)
    _sync(images.device)
    wall = time.perf_counter() - t0
    mesh.barrier()
    return mesh.max_over_ranks(wall) * 1e3 / steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_result(state, loss, grads, fwd, bwd) -> dict:
    host = lambda ts: [t.detach().float().cpu() for t in ts]
    return {"loss": loss, "grads": host(grads), "params": host(state.params),
            "mu": host(state.optimizer.mu), "nu": host(state.optimizer.nu),
            "shadow": host(state.ema.shadow_params), "step": state.step,
            "count": state.optimizer.count, "ema_updates": state.ema.num_updates,
            "fwd_launches": fwd, "bwd_launches": bwd}


def run_step(spec_path: str, out_dir: str, backend, time_steps: int) -> None:
    spec = torch.load(spec_path, weights_only=False)
    device = mesh.setup(spec.get("device"), backend=backend)
    rank, world = mesh.rank(), mesh.world_size()
    if spec.get("allow_tf32") is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, state, batch, labels, t, z, draws = load_step_spec(spec, device)
    n = mesh.per_rank(batch.shape[0])
    rows = slice(rank * n, (rank + 1) * n)
    if spec.get("nan_rank") == rank:
        batch = batch.clone()
        batch[rows] = float("nan")
    torch.backends.cudnn.deterministic = bool(spec.get("deterministic"))
    attn_ops.fused_attn_block.launches = attn_ops.fused_attn_block_bwd.launches = 0
    loss, grads = train_step_rows(cfg, state, batch, labels, t, z, draws, rows)
    _sync(device)
    torch.backends.cudnn.deterministic = False
    out = step_result(state, loss, grads, attn_ops.fused_attn_block.launches,
                      attn_ops.fused_attn_block_bwd.launches)
    out.update(rank=rank, world=world, backend=dist.get_backend() if world > 1 else None,
               device=str(device))
    if time_steps:
        out["ms_per_step"] = ms_per_step(cfg, state, n, time_steps)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_sample(run: str, n: int, out_dir: str, backend) -> None:
    from .common import LoadedModel, generate_raw_samples
    device = mesh.setup(None, backend=backend)
    rank = mesh.rank()
    lm = LoadedModel(run, device=device)
    attn_ops.fused_attn_block.launches = 0
    mesh.barrier()
    t0 = time.perf_counter()
    samples, _ = generate_raw_samples(lm, n, n, guidance_weight=0.0, seed=mesh.rank_seed(0))
    wall = time.perf_counter() - t0
    launches = attn_ops.fused_attn_block.launches
    gathered = mesh.gather_rows(torch.from_numpy(samples).to(device)).cpu().numpy()
    slowest = mesh.max_over_ranks(wall)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "n": int(samples.shape[0]), "launches": launches,
                   "wall_s": wall, "slowest_wall_s": slowest, "steps": lm.sde.N,
                   "device": str(device)}, f)
    if rank == 0:
        np.save(os.path.join(out_dir, "samples.npy"), gathered)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("step")
    s.add_argument("spec")
    s.add_argument("out_dir")
    s.add_argument("--time_steps", type=int, default=0)
    s.add_argument("--backend", default=None)
    m = sub.add_parser("sample")
    m.add_argument("run")
    m.add_argument("n", type=int)
    m.add_argument("out_dir")
    m.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    try:
        if args.cmd == "step":
            run_step(args.spec, args.out_dir, args.backend, args.time_steps)
        else:
            run_sample(args.run, args.n, args.out_dir, args.backend)
    finally:
        mesh.teardown()


if __name__ == "__main__":
    main()
