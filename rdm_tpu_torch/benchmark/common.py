"""Model loading from a training run directory and batched sampling, the
scaffolding the GTO halo benchmarks share."""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import List, Tuple

import numpy as np
import torch

from ..config import load_hydra_config_from_run
from ..data import load_arrays
from ..device import resolve_device
from ..models import create_model
from ..models.registry import get_cf_score_fn
from ..sampling import get_sampling_fn
from ..sde import get_sde
from ..training import checkpoints
from ..training.state import init_train_state

SAMPLING_EPS = 1e-5
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_checkpoint(model_path: str):
    """``checkpoints-meta/checkpoint.pth`` if present, else the latest
    ``checkpoints/checkpoint_k.pth``."""
    meta = os.path.join(model_path, "checkpoints-meta", "checkpoint.pth")
    if os.path.exists(meta):
        return meta
    return checkpoints.latest_checkpoint(os.path.join(model_path, "checkpoints"))


class LoadedModel:
    """A run directory's model with its EMA weights, on ``device`` (the card
    unless the caller names another), read through the run's
    ``.hydra/config.yaml`` manifest; ``model_overrides`` replace keys of its
    ``model`` section (e.g. ``{"resblock_pallas": True}``)."""

    def __init__(self, model_path: str, config_path: str | None = None,
                 checkpoint_file: str | None = None, device=None,
                 model_overrides: dict | None = None):
        self.device = resolve_device(device)
        self.cfg = load_hydra_config_from_run(config_path or model_path)
        for key, value in (model_overrides or {}).items():
            self.cfg.model[key] = value
        self.sde = get_sde(self.cfg)
        if checkpoint_file is None:
            checkpoint_file = find_checkpoint(model_path)
        if checkpoint_file is None:
            raise FileNotFoundError(f"no checkpoint under {model_path}")
        ckpt = checkpoints.restore_checkpoint(checkpoint_file)
        if ckpt is None:
            raise FileNotFoundError(checkpoint_file)
        self.model = create_model(self.cfg)
        self.model.load_state_dict(ckpt.ema if ckpt.ema is not None else ckpt.model,
                                   strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        self.checkpoint_file = checkpoint_file
        self.step = ckpt.step


def load_training_run(model_path: str, device=None):
    """A run directory set up to train on: its config, a ``TrainState`` with
    the weights, EMA and optimizer state of its latest checkpoint, and its
    training set resident on ``device`` as (images, labels).  A relative
    ``data.pkl_path`` that does not exist from the working directory is
    taken from the repository's root."""
    device = resolve_device(device)
    cfg = load_hydra_config_from_run(model_path)
    if not os.path.isabs(cfg.data.pkl_path) and not os.path.exists(cfg.data.pkl_path):
        cfg.data.pkl_path = os.path.join(REPO_ROOT, cfg.data.pkl_path)
    ckpt = checkpoints.restore_checkpoint(find_checkpoint(model_path))
    state = init_train_state(create_model(cfg).to(device), cfg)
    checkpoints.load_into_state(state, ckpt)
    images, labels = load_arrays(cfg)
    return cfg, state, torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)


def sample_shape(cfg, batch_size: int) -> tuple:
    """NCHW shape of one sampling batch."""
    return (batch_size, cfg.data.num_channels, cfg.data.image_size,
            cfg.data.get("image_width", cfg.data.image_size))


def generate_raw_samples(lm: LoadedModel, num_samples: int, batch_size: int,
                         guidance_weight: float = 0.0, seed: int = 0,
                         sde_override=None) -> Tuple[np.ndarray, List[float]]:
    """Batched EMA sampling with uniform-random class labels in [0, 1].
    Returns flattened (N, 67) samples in model space and the wall time of
    each batch (ending in a device synchronisation)."""
    cfg = lm.cfg
    sde = sde_override or lm.sde
    sampling_fn = get_sampling_fn(cfg, sde, sample_shape(cfg, batch_size), SAMPLING_EPS)
    generator = torch.Generator(device=lm.device).manual_seed(seed)
    num_classes = cfg.model.get("num_classes", 1)

    num_batches = -(-num_samples // batch_size)
    chunks, times = [], []
    for i in range(num_batches):
        t0 = time.perf_counter()
        labels = torch.rand((batch_size, num_classes), generator=generator, device=lm.device)
        # a Python scalar 0 evaluates only the conditional half
        score_fn = get_cf_score_fn(sde, lm.model, labels, float(guidance_weight))
        x, _ = sampling_fn(score_fn, generator)
        if lm.device.type == "cuda":
            torch.cuda.synchronize(lm.device)
        times.append(time.perf_counter() - t0)
        # (B, 1, 9, 9) -> (B, 81) -> the first 67 values (the rest is padding);
        # position 0 is the generated value, not the conditioning label.
        chunks.append(x.reshape(x.shape[0], -1)[:, :67].float().cpu().numpy())
        print(f"Batch {i + 1}/{num_batches}: Generated {x.shape[0]} samples "
              f"in {times[-1]:.2f}s")

    return np.concatenate(chunks, axis=0)[:num_samples], times


def sampling_efficiency_metrics(sampling_times: List[float]) -> dict:
    return {
        "total_sampling_time": float(sum(sampling_times)),
        "average_sampling_time_per_sample": float(np.mean(sampling_times)),
        "sampling_time_std": float(np.std(sampling_times)),
        "samples_per_second": float(len(sampling_times) / sum(sampling_times)),
        "min_sampling_time": float(min(sampling_times)),
        "max_sampling_time": float(max(sampling_times)),
    }


def parts_ms(fn, reps=3) -> dict:
    """Mean ms by part of ``fn()`` (a dict of part -> ms, as a tiled body's
    ``launch_ms`` gives it) over ``reps`` calls after one warm-up, the L2
    flushed and the card kept busy first, so every launch is queued before
    the first event.  Needs the card."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        for k, v in fn().items():
            out[k] = out.get(k, 0.0) + v / reps
    return out


def trace_kernels(fn, steps: int, top: int = 12, path: str | None = None,
                  count: dict | None = None) -> dict:
    """Run ``fn()`` (``steps`` steps of work) under ``torch.profiler`` and
    sum the device kernels of the trace: device ms per step (one stream, so
    the kernels do not overlap), kernel launches per step, and the ``top``
    kernels by device time, grouped by name.  With ``path`` the Chrome trace
    is kept there (its size is ``trace_bytes``).  ``count`` maps a key to a
    test on a kernel's name; ``counted`` gives each key's kernel launches in
    the whole trace.  Without a card only the host's activity is recorded
    and the device sums are 0."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        out = path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(out)
        with open(out) as f:
            trace = json.load(f)
        trace_bytes = os.path.getsize(out)
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e["name"]][0] += float(e["dur"])
        by_name[e["name"]][1] += 1
    device_us = sum(v[0] for v in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_ms_per_step": device_us / 1e3 / steps,
        "kernel_launches_per_step": len(kernels) / steps,
        "top_kernels": [{"name": n[:90], "ms_per_step": v[0] / 1e3 / steps,
                         "share_of_device": v[0] / device_us if device_us else 0.0,
                         "launches_per_step": v[1] / steps} for n, v in ranked],
        "trace_bytes": trace_bytes,
        **({"counted": {k: sum(v[1] for n, v in by_name.items() if test(n))
                        for k, test in count.items()}} if count else {}),
    }
