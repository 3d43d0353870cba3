#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

1. env        torch/CUDA versions, the card, nvidia-smi's name and power limit
2. build      nvcc builds every CUDA source of the sampling path
3. kernel     each CUDA kernel against its plain PyTorch version on the same
              seeded inputs, with the stated tolerance, timed with CUDA events
              beside its bound
4. golden     the reference NCSN++ weights of tests/golden/ncsnpp_golden.npz,
              float32 with the attention kernel, against the stored outputs
5. flagship   the flagship run (Training Runs/2026.08.17_184657, EMA weights,
              bfloat16, attention kernel) samples 1024 trajectories with
              1000-step reflected Euler-Maruyama; the samples must lie in the
              unit cube and match the JAX package's samples of the same
              checkpoint by per-dimension two-sample KS statistic
6. cfg        guided sampling (w = 0.1) at batch 256 with N = 100
7. kernels    one line {"kernels": [...]} with each kernel's launches on the
              flagship run, error, times and bound

The last line is {"ok": true, "device": {...}}.  A failed check raises, and
the script then exits non-zero without that line.  It needs a CUDA card and
the repository around it.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import rdm_tpu_torch
from rdm_tpu_torch.benchmark.common import LoadedModel, generate_raw_samples
from rdm_tpu_torch.models import NCSNpp
from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops import attention as attn_ops
from rdm_tpu_torch.sde import RVESDE

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_RUN = os.path.join(ROOT, "Training Runs", "2026.08.17_184657")
JAX_SAMPLES = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024",
                           "ml_statistics", "generated_samples.npy")
GOLDEN = os.path.join(ROOT, "tests", "golden", "ncsnpp_golden.npz")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Bonferroni critical value of the two-sample KS statistic for
# alpha = 0.001 / 67 at n = m = 1024.
KS_LIMIT = 0.11
ATTN_BLOCKS_PER_FORWARD = 5

T_START = time.perf_counter()


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic sup |F_a - F_b|."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.max(np.abs(fa - fb)))


# ---------------------------------------------------------------------------
# fused attention block: inputs, bound, comparison

def attn_inputs(B, C, L, groups, dtype, seed, device):
    rng = np.random.default_rng(seed)
    side = int(math.isqrt(L))
    H, W = (side, side) if side * side == L else (8, L // 8)
    x = rng.normal(size=(B, C, H, W)).astype(np.float32)
    gamma = 1.0 + 0.1 * rng.normal(size=C)
    beta = 0.1 * rng.normal(size=C)
    ws = [rng.normal(size=(C, C)) / math.sqrt(C) for _ in range(4)]
    bs = [0.1 * rng.normal(size=C) for _ in range(4)]
    params = [gamma, beta, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3]]
    to = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return to(x).to(dtype), [to(p).to(dtype) for p in params]


def attn_bound_ms(B, C, L, dtype) -> tuple:
    """Least time for the block: each input read once, the output written
    once, against the card's peak rates; and which of the two bounds it."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * C * L + 4 * C * C + 6 * C) * elt
    flops = B * (4 * 2 * L * C * C + 2 * 2 * L * L * C)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_case(B, C, L, groups, dtype, seed, device, timed):
    x, params = attn_inputs(B, C, L, groups, dtype, seed, device)
    kw = dict(groups=groups, skip_rescale=True)
    out = attn_ops.fused_attn_block(x, *params, **kw)
    ref = attn_ops.fused_attn_block_reference(x, *params, **kw)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype, "kernel output shape/type")
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    # float32: the two differ only in summation order.  bfloat16: the same
    # rounding points, but a sum that lands on a rounding boundary may round
    # the other way and carry one bf16 step (2^-8 relative) through the
    # later products, so allow 4 steps at the output's largest magnitude.
    tol = (1e-4 if dtype == torch.float32 else 4 * 2.0 ** -8) * scale
    res = {"B": B, "C": C, "L": L, "groups": groups, "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "tol": tol}
    check(bool(torch.isfinite(out.float()).all()), f"kernel output not finite {res}")
    check(err <= tol, f"kernel disagrees with its plain version: {res}")
    if timed:
        res["ms"] = cuda_time_ms(lambda: attn_ops.fused_attn_block(x, *params, **kw), 50)
        res["plain_ms"] = cuda_time_ms(
            lambda: attn_ops.fused_attn_block_reference(x, *params, **kw), 10)
        res["bound_ms"], res["bound_by"] = attn_bound_ms(B, C, L, dtype)
    return res


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, package=rdm_tpu_torch.__name__)

    t0 = time.perf_counter()
    lib = _build.build("fused_attn_block")
    with open(lib[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit("build", t0, library=lib, ptxas=ptxas)

    t0 = time.perf_counter()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(attn_case(1024, 64, 81, 16, dtype, 0, device, timed=True))
        cases.append(attn_case(1024, 128, 81, 32, dtype, 1, device, timed=False))
        cases.append(attn_case(3, 64, 81, 16, dtype, 2, device, timed=False))
        cases.append(attn_case(64, 128, 128, 32, dtype, 3, device, timed=False))
    for c in cases:
        print(json.dumps({"attn_case": c}), flush=True)
    emit("kernel", t0, cases=len(cases),
         rows_per_chunk_c128_l128=attn_ops.rows_per_chunk(128, 128))
    main_case = next(c for c in cases if c["B"] == 1024 and c["C"] == 64
                     and c["dtype"] == "bfloat16")
    f32_case = next(c for c in cases if c["B"] == 1024 and c["C"] == 64
                    and c["dtype"] == "float32")

    t0 = time.perf_counter()
    g = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd.")}
    model = NCSNpp(attn_kernel=True)
    model.load_state_dict(sd, strict=True)
    model.to(device).eval().requires_grad_(False)
    x = torch.from_numpy(g["x"]).to(device)
    sigma = torch.from_numpy(g["sigma"]).to(device)
    labels = torch.from_numpy(g["labels"]).to(device)
    before = attn_ops.fused_attn_block.launches
    with torch.no_grad():
        out_cond = model(x, sigma, labels).cpu().numpy()
        out_uncond = model(x, sigma, torch.zeros_like(labels)).cpu().numpy()
    golden_launches = attn_ops.fused_attn_block.launches - before
    check(golden_launches == 2 * ATTN_BLOCKS_PER_FORWARD,
          f"golden forwards launched the kernel {golden_launches} times")
    np.testing.assert_allclose(out_cond, g["out_cond"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out_uncond, g["out_uncond"], rtol=1e-4, atol=1e-5)
    emit("golden", t0, launches=golden_launches,
         max_abs_err_cond=float(np.abs(out_cond - g["out_cond"]).max()),
         max_abs_err_uncond=float(np.abs(out_uncond - g["out_uncond"]).max()),
         rtol=1e-4, atol=1e-5)
    del model

    t0 = time.perf_counter()
    lm = LoadedModel(FLAGSHIP_RUN)
    check(lm.model.dtype == torch.bfloat16, "flagship model is not bfloat16")
    load_s = time.perf_counter() - t0
    attn_ops.fused_attn_block.launches = 0
    samples, times = generate_raw_samples(lm, 1024, 1024, guidance_weight=0.0, seed=0)
    launches = attn_ops.fused_attn_block.launches
    steps = lm.sde.N - 1
    check(launches == ATTN_BLOCKS_PER_FORWARD * steps,
          f"flagship sampling launched the kernel {launches} times")
    check(samples.shape == (1024, 67), f"samples shape {samples.shape}")
    check(bool(np.isfinite(samples).all()), "non-finite samples")
    check(float(samples.min()) >= 0.0 and float(samples.max()) <= 1.0,
          "samples leave the unit cube")
    ref = np.load(JAX_SAMPLES).reshape(-1, 67)
    ks = np.array([ks_statistic(samples[:, d], ref[:, d]) for d in range(67)])
    mean_gap = np.abs(samples.mean(0) - ref.mean(0))
    std_gap = np.abs(samples.std(0) - ref.std(0))
    check(float(ks.max()) < KS_LIMIT, f"max per-dimension KS {ks.max()} >= {KS_LIMIT}")
    emit("flagship", t0, checkpoint=os.path.relpath(lm.checkpoint_file, ROOT),
         step=lm.step, load_seconds=load_s, n=int(samples.shape[0]), steps=lm.sde.N,
         launches=launches, batch_seconds=times,
         trajectories_per_second=samples.shape[0] / sum(times),
         ks_max=float(ks.max()), ks_argmax=int(ks.argmax()), ks_limit=KS_LIMIT,
         ks_mean=float(ks.mean()), n_reference=int(ref.shape[0]),
         mean_gap_max=float(mean_gap.max()), mean_gap_mean=float(mean_gap.mean()),
         std_gap_max=float(std_gap.max()), std_gap_mean=float(std_gap.mean()),
         ks_per_dim=[round(float(v), 5) for v in ks],
         mean_gap_per_dim=[round(float(v), 5) for v in mean_gap],
         std_gap_per_dim=[round(float(v), 5) for v in std_gap])

    t0 = time.perf_counter()
    sde100 = RVESDE(lm.cfg.sde.sigma_min, lm.cfg.sde.sigma_max, 100)
    before = attn_ops.fused_attn_block.launches
    cfg_samples, cfg_times = generate_raw_samples(lm, 256, 256, guidance_weight=0.1,
                                                  seed=1, sde_override=sde100)
    cfg_launches = attn_ops.fused_attn_block.launches - before
    check(cfg_launches == ATTN_BLOCKS_PER_FORWARD * 99,
          f"guided sampling launched the kernel {cfg_launches} times")
    check(bool(np.isfinite(cfg_samples).all()), "non-finite guided samples")
    check(float(cfg_samples.min()) >= 0.0 and float(cfg_samples.max()) <= 1.0,
          "guided samples leave the unit cube")
    emit("cfg", t0, n=int(cfg_samples.shape[0]), steps=100, w=0.1,
         forward_batch=512, launches=cfg_launches, batch_seconds=cfg_times)

    kernels = [{
        "name": "fused_attn_block",
        "route": "cuda",
        "source": "rdm_tpu_torch/csrc/fused_attn_block.cu",
        "replaces": "rdm_tpu/ops/pallas/attention.py:42::_fused_block_kernel",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "max_err_f32": f32_case["max_abs_err"],
        "max_err_bf16": main_case["max_abs_err"],
        "kernel_us": main_case["ms"] * 1e3,
        "plain_us": main_case["plain_ms"] * 1e3,
        "bound_us": main_case["bound_ms"] * 1e3,
        "shape": "B=1024 C=64 L=81 groups=16 bfloat16",
    }]
    print(json.dumps({"phase": "total", "seconds": round(time.perf_counter() - T_START, 3)}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
