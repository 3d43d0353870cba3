#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

1. env        torch/CUDA versions, the card, nvidia-smi's name and power limit
2. build      nvcc builds every CUDA source of the sampling and training paths,
              one nvcc per source, all at once, with each one's ptxas report
3. kernel     the attention kernel against its plain PyTorch version on the
              same seeded inputs, with the stated tolerance, timed with CUDA
              events beside its bound
4. kernel_bwd the attention backward kernel against the plain backward on the
              same seeded x, g and parameters, each against its stated
              tolerance, two runs bit for bit, timed beside its bound
5. golden     the reference NCSN++ weights of tests/golden/ncsnpp_golden.npz,
              float32 with the attention kernel, against the stored outputs
6. flagship   the flagship run (Training Runs/2026.08.17_184657, EMA weights,
              bfloat16, attention kernel) samples 1024 trajectories with
              1000-step reflected Euler-Maruyama; the samples must lie in the
              unit cube and match the JAX package's samples of the same
              checkpoint by per-dimension two-sample KS statistic
7. cfg        guided sampling (w = 0.1) at batch 256 with N = 100
8. train      the flagship run trains on the card: checkpoint_10.pth with its
              weights, EMA and Adam state, its training set resident on the
              card, batch 4096, bfloat16, the attention kernels forward and
              backward.  One step with the kernels against one through the
              plain versions (same batch, t, z and masks); twenty steps with
              5 + 5 kernel launches each and a mean loss inside the flagship's
              logged range; the EMA evaluation loss at batch 16384; a
              checkpoint round trip; ms per step
9. run_train  python -m rdm_tpu_torch.run_train for four steps at batch 4096
              from a temporary directory: log lines, a checkpoint the port
              restores, snapshot samples
10. kernels   one line {"kernels": [...]} with each kernel's launches on its
              path (sampling for the forward, training for the backward),
              error, times and bound

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
import tempfile
import time

import numpy as np
import torch

import rdm_tpu_torch
from rdm_tpu_torch.benchmark.common import (LoadedModel, generate_raw_samples,
                                            load_training_run)
from rdm_tpu_torch.config import ConfigDict
from rdm_tpu_torch.data import get_dataset
from rdm_tpu_torch.models import NCSNpp, create_model
from rdm_tpu_torch.models.layers import AttnBlockpp
from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops import attention as attn_ops
from rdm_tpu_torch.sde import RVESDE, get_sde
from rdm_tpu_torch.training import checkpoints
from rdm_tpu_torch.training.losses import (get_loss_fn, make_eval_step,
                                           make_train_step_on_device)
from rdm_tpu_torch.training.state import init_train_state

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
SOURCES = ("fused_attn_block", "fused_attn_block_bwd")
BF16_STEP = 2.0 ** -8
PARAM_NAMES = ("gamma", "beta", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp")
# The flagship's logged losses at batch 4096 (Training Runs/2026.08.17_184657/
# logs, steps 90k-100k: training 10.61-11.47 over 51 lines, evaluation
# 10.19-10.35), widened: a twenty-step mean and one evaluation batch.
TRAIN_LOSS_RANGE = (10.1, 12.0)
EVAL_LOSS_RANGE = (9.7, 10.9)
TRAIN_STEPS = 20

T_START = time.perf_counter()
CARD = {"card": None}   # nvidia-smi's name and power limit, beside every time printed


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **CARD, **fields}), flush=True)


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


def attn_bwd_bound_ms(B, C, L, dtype) -> tuple:
    """Least time for the backward: x and g read once, dx written once (the
    parameters and their float32 gradients beside them), against the card's
    peak rates; the operations are those the backward needs: the recomputed
    q, k, v, scores and p.v (6 L C^2 + 4 L^2 C per sample) and the backward
    products (16 L C^2 + 8 L^2 C)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = 3 * B * C * L * elt + (4 * C * C + 6 * C) * (elt + 4)
    flops = B * (22 * L * C * C + 12 * L * L * C)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_bwd_case(B, C, L, groups, dtype, seed, device, timed):
    x, params = attn_inputs(B, C, L, groups, torch.float32, seed, device)
    x = x.to(dtype)
    g = torch.randn(x.shape, generator=torch.Generator(device=device).manual_seed(seed),
                    device=device).to(dtype)
    kw = dict(groups=groups, skip_rescale=True)
    out = attn_ops.fused_attn_block_bwd(x, g, *params, **kw)
    again = attn_ops.fused_attn_block_bwd(x, g, *params, **kw)
    ref = attn_ops.fused_attn_block_bwd_reference(x, g, *params, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"two backward runs differ (B={B}, C={C}, L={L}, {dtype})")
    errs = {}
    for name, a, b in zip(("dx",) + PARAM_NAMES, out, ref):
        check(a.shape == b.shape and a.dtype == b.dtype, f"backward {name} shape/type")
        check(bool(torch.isfinite(a.float()).all()), f"backward {name} not finite")
        errs[name] = (float((a.float() - b.float()).abs().max()),
                      max(1.0, float(b.float().abs().max())))
    # float32: summation order only, 1e-4 of each output's scale.  bfloat16:
    # the same rounding points; a sum next to a rounding boundary may round
    # the other way and carry a bf16 step on: dx within 4 steps of its scale,
    # the float32 parameter gradients (sums of such values) within one step.
    # dbk is zero in exact arithmetic (softmax ignores a shift that all keys
    # share): both versions return the summed rounding noise of B*L values of
    # dk, whose size is that of dq, so it is held to the scale of dbq.
    errs["bk"] = (errs["bk"][0], max(errs["bk"][1], errs["bq"][1]))
    dx_err, dx_scale = errs.pop("dx")
    f32 = dtype == torch.float32
    dx_tol = (1e-4 if f32 else 4 * BF16_STEP) * dx_scale
    worst = max(errs, key=lambda n: errs[n][0] / errs[n][1])
    p_err, p_scale = errs[worst]
    p_tol = (1e-4 if f32 else BF16_STEP) * p_scale
    res = {"B": B, "C": C, "L": L, "groups": groups, "dtype": str(dtype).split(".")[-1],
           "dx_max_abs_err": dx_err, "dx_tol": dx_tol, "worst_param": worst,
           "param_max_abs_err": p_err, "param_tol": p_tol, "bitwise_repeatable": True}
    check(dx_err <= dx_tol, f"backward dx disagrees with the plain version: {res}")
    for name, (err, scale) in errs.items():
        tol = (1e-4 if f32 else BF16_STEP) * scale
        check(err <= tol, f"backward d{name} disagrees with the plain version: {res}")
    if timed:
        res["ms"] = cuda_time_ms(lambda: attn_ops.fused_attn_block_bwd(x, g, *params, **kw), 20)
        res["plain_ms"] = cuda_time_ms(
            lambda: attn_ops.fused_attn_block_bwd_reference(x, g, *params, **kw), 5)
        res["bound_ms"], res["bound_by"] = attn_bwd_bound_ms(B, C, L, dtype)
    return res


def set_attn_kernel(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, AttnBlockpp):
            m.use_kernel = on


def loss_and_grads(cfg, model, batch, labels, seed):
    """The training loss and the gradients of the trainable parameters, with
    t, z and the dropout and label-drop masks drawn from a generator seeded
    with ``seed``."""
    loss_fn = get_loss_fn(get_sde(cfg), train=True, reduce_mean=cfg.training.reduce_mean,
                          likelihood_weighting=cfg.training.likelihood_weighting)
    gen = torch.Generator(device=batch.device).manual_seed(seed)
    loss = loss_fn(model, batch, labels, gen)
    params = [p for p in model.parameters() if p.requires_grad]
    return float(loss.detach()), [g.float() for g in torch.autograd.grad(loss, params)]


def train_phase(device) -> dict:
    """The flagship trains on the card; returns the fields of the phase."""
    cfg, state, images, labels = load_training_run(FLAGSHIP_RUN, device)
    check(cfg.model.precision == "bfloat16" and cfg.model.attn_pallas is True,
          "flagship config is not bfloat16 with the attention kernel")
    check(state.optimizer.count == 100000 and state.ema.num_updates == 100000,
          "flagship Adam/EMA state not restored")
    B = cfg.training.batch_size
    out = {"batch": B, "train_rows": int(images.shape[0]), "start_step": state.step}

    # 1. kernel against plain: one loss and gradient with the same batch, t,
    #    z and masks; float32 (plain) gives the yardstick
    idx = torch.randint(0, images.shape[0], (B,), device=device,
                        generator=torch.Generator(device=device).manual_seed(11))
    batch, blabels = images[idx], labels[idx]
    loss_k, g_k = loss_and_grads(cfg, state.model, batch, blabels, seed=12)
    set_attn_kernel(state.model, False)
    loss_p, g_p = loss_and_grads(cfg, state.model, batch, blabels, seed=12)
    set_attn_kernel(state.model, True)
    cfg32 = with_precision(cfg, "float32")
    m32 = create_model(cfg32).to(device)
    m32.load_state_dict(state.model.state_dict(), strict=True)
    set_attn_kernel(m32, False)
    loss_f, g_f = loss_and_grads(cfg32, m32, batch, blabels, seed=12)
    del m32
    flat = lambda gs: torch.cat([g.flatten() for g in gs])
    diff_kp = float((flat(g_k) - flat(g_p)).norm())
    spread = float((flat(g_p) - flat(g_f)).norm())
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    kp = {n: float((a - b).norm()) for a, b, n in zip(g_k, g_p, names)}
    pf = {n: float((b - c).norm()) for b, c, n in zip(g_p, g_f, names)}
    # The attention's k bias has a gradient of zero in exact arithmetic
    # (softmax ignores a shift that all keys share): kernel and plain version
    # each return the summed rounding noise of its dk, so its own bf16-f32
    # distance is noise of the same size as the kernel-plain one.  As in
    # phase kernel_bwd it is held to the q bias's scale instead: here that
    # block's q-bias distance from float32.
    kbias = {f"{m}.NIN_1.b": f"{m}.NIN_0.b" for m, mod in state.model.named_modules()
             if isinstance(mod, AttnBlockpp)}
    ratios = sorted(((kp[n] / max(pf[n], 1e-30), n) for n in names if n not in kbias),
                    reverse=True)
    kratios = sorted(((kp[n] / max(pf[q], 1e-30), n) for n, q in kbias.items()), reverse=True)
    # Outside the attention blocks both runs round at the same points; inside,
    # kernel and plain version sum in another order and now and then round a
    # bfloat16 value the other way, which the later layers carry on.  So the
    # kernel run must stay closer to the plain run than bfloat16 moves the
    # plain run from float32: as one gradient vector within half of that,
    # and each parameter's gradient within its own distance.  The loss (a
    # mean over 4096 samples) agrees within half a bfloat16 step, relative.
    out.update(loss_kernel=loss_k, loss_plain=loss_p, loss_f32=loss_f,
               grad_diff_kernel_plain=diff_kp, grad_spread_bf16_f32=spread,
               grad_ratio=diff_kp / spread, worst_param_ratios=ratios[:6],
               k_bias_ratios=kratios, loss_tol_rel=BF16_STEP / 2)
    print(json.dumps({"train_kernel_vs_plain": out}), flush=True)
    check(math.isfinite(loss_k) and abs(loss_k - loss_p) <= BF16_STEP / 2 * abs(loss_p),
          f"training loss kernel {loss_k} vs plain {loss_p}")
    check(diff_kp <= 0.5 * spread, f"gradients: kernel-plain {diff_kp} vs spread {spread}")
    check(ratios[0][0] <= 1.0, f"a parameter's gradient: kernel-plain / spread {ratios[0]}")
    check(len(kratios) == ATTN_BLOCKS_PER_FORWARD and kratios[0][0] <= 1.0,
          f"a k bias's gradient: kernel-plain / q-bias spread {kratios}")

    # 2. twenty steps with the kernels, on the training path
    step = make_train_step_on_device(get_sde(cfg), use_labels=True,
                                     reduce_mean=cfg.training.reduce_mean,
                                     likelihood_weighting=cfg.training.likelihood_weighting,
                                     batch_size=B)
    gen = torch.Generator(device=device).manual_seed(13)
    step(state, images, labels, gen)                       # warm-up
    torch.cuda.synchronize()
    attn_ops.fused_attn_block.launches = 0
    attn_ops.fused_attn_block_bwd.launches = 0
    t0 = time.perf_counter()
    losses = [float(step(state, images, labels, gen)) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    fwd, bwd = attn_ops.fused_attn_block.launches, attn_ops.fused_attn_block_bwd.launches
    out.update(steps=TRAIN_STEPS, fwd_launches=fwd, bwd_launches=bwd, losses=losses,
               mean_loss=float(np.mean(losses)), loss_range=TRAIN_LOSS_RANGE,
               ms_per_step=ms, samples_per_second=B / ms * 1e3)
    check(fwd == ATTN_BLOCKS_PER_FORWARD * TRAIN_STEPS
          and bwd == ATTN_BLOCKS_PER_FORWARD * TRAIN_STEPS,
          f"training launched the kernels {fwd} + {bwd} times in {TRAIN_STEPS} steps")
    check(all(math.isfinite(v) for v in losses), "non-finite training loss")
    check(TRAIN_LOSS_RANGE[0] <= out["mean_loss"] <= TRAIN_LOSS_RANGE[1],
          f"mean training loss {out['mean_loss']} outside {TRAIN_LOSS_RANGE}")

    # 3. EMA evaluation at the evaluation batch
    eimgs, elabels = next(get_dataset(cfg)[1])
    eval_loss = float(make_eval_step(get_sde(cfg))(
        state, torch.from_numpy(eimgs).to(device), torch.from_numpy(elabels).to(device),
        torch.Generator(device=device).manual_seed(14)))
    out.update(eval_batch=int(eimgs.shape[0]), eval_loss=eval_loss, eval_range=EVAL_LOSS_RANGE)
    check(EVAL_LOSS_RANGE[0] <= eval_loss <= EVAL_LOSS_RANGE[1],
          f"EMA evaluation loss {eval_loss} outside {EVAL_LOSS_RANGE}")

    # 4. checkpoint round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.pth")
        checkpoints.save_checkpoint(path, state, config=cfg)
        fresh = init_train_state(create_model(cfg).to(device), cfg)
        checkpoints.load_into_state(fresh, checkpoints.restore_checkpoint(path))
    same = (fresh.step == state.step and fresh.optimizer.count == state.optimizer.count
            and fresh.ema.num_updates == state.ema.num_updates
            and all(torch.equal(a, b) for a, b in zip(fresh.params, state.params))
            and all(torch.equal(a, b) for a, b in zip(fresh.ema.shadow_params,
                                                      state.ema.shadow_params))
            and all(torch.equal(a, b) for a, b in zip(fresh.optimizer.mu + fresh.optimizer.nu,
                                                      state.optimizer.mu + state.optimizer.nu)))
    out["checkpoint_round_trip_equal"] = same
    check(same, "checkpoint round trip changed the state")
    return out


def with_precision(cfg, precision):
    plain = cfg.to_plain()
    plain["model"]["precision"] = precision
    return ConfigDict.wrap(plain)


def run_train_phase() -> dict:
    """The training CLI on the card, from a temporary working directory."""
    pkl = os.path.join(ROOT, "datasets", "training_data_boundary_80073.pkl")
    args = ["model.precision=bfloat16", "model.attn_pallas=true", f"data.pkl_path={pkl}",
            "data.gto_mean=0", "data.gto_std=1", "training.n_iters=3",
            "training.snapshot_freq=3", "training.eval_freq=1000", "training.log_freq=1",
            "training.snapshot_freq_for_preemption=1000", "sde.num_scales=100",
            "eval.batch_size=4096"]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.run([sys.executable, "-m", "rdm_tpu_torch.run_train", *args],
                              cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"run_train failed:\n{proc.stderr[-3000:]}")
        runs = os.listdir(os.path.join(tmp, "Training Runs"))
        check(len(runs) == 1, f"run_train made {runs}")
        run = os.path.join(tmp, "Training Runs", runs[0])
        with open(os.path.join(run, "logs")) as f:
            log = f.read()
        steps = [int(ln.split("step: ")[1].split(",")[0]) for ln in log.splitlines()
                 if "training_loss" in ln]
        evals = [ln for ln in log.splitlines() if "evaluation_loss" in ln]
        ck = checkpoints.restore_checkpoint(os.path.join(run, "checkpoints", "checkpoint_1.pth"))
        sample = np.load(os.path.join(run, "samples", "iter_3", "sample_0.npy"))
    check(steps == [0, 1, 2, 3] and len(evals) == 1, f"log lines: steps {steps}, evals {evals}")
    check(ck is not None and ck.step == 4 and ck.optimizer["count"] == 4,
          "run_train checkpoint does not restore")
    check(sample.dtype == np.uint8 and sample.shape == (4096, 1, 9, 9),
          f"snapshot samples {sample.dtype} {sample.shape}")
    return {"steps": steps, "eval_lines": len(evals), "checkpoint_step": ck.step,
            "sample_shape": list(sample.shape), "sample_min": int(sample.min()),
            "sample_max": int(sample.max())}


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
    CARD["card"] = smi
    emit("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, package=rdm_tpu_torch.__name__)

    t0 = time.perf_counter()
    libs = _build.build(*SOURCES)
    ptxas = {}
    for name, lib in zip(SOURCES, libs):
        with open(lib[:-3] + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit("build", t0, libraries=libs, ptxas=ptxas)

    t0 = time.perf_counter()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(attn_case(1024, 64, 81, 16, dtype, 0, device, timed=True))
        cases.append(attn_case(1024, 128, 81, 32, dtype, 1, device, timed=False))
        cases.append(attn_case(3, 64, 81, 16, dtype, 2, device, timed=False))
        cases.append(attn_case(64, 128, 128, 32, dtype, 3, device, timed=False))
    # the forward at the training shape
    cases.append(attn_case(4096, 64, 81, 16, torch.bfloat16, 8, device, timed=True))
    for c in cases:
        print(json.dumps({"attn_case": c}), flush=True)
    emit("kernel", t0, cases=len(cases),
         rows_per_chunk_c128_l128=attn_ops.rows_per_chunk(128, 128))
    main_case = next(c for c in cases if c["B"] == 1024 and c["C"] == 64
                     and c["dtype"] == "bfloat16")
    f32_case = next(c for c in cases if c["B"] == 1024 and c["C"] == 64
                    and c["dtype"] == "float32")

    t0 = time.perf_counter()
    bwd_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        bwd_cases.append(attn_bwd_case(4096, 64, 81, 16, dtype, 4, device, timed=True))
        bwd_cases.append(attn_bwd_case(1024, 128, 81, 32, dtype, 5, device, timed=False))
        bwd_cases.append(attn_bwd_case(3, 64, 81, 16, dtype, 6, device, timed=False))
        bwd_cases.append(attn_bwd_case(64, 128, 128, 32, dtype, 7, device, timed=False))
    for c in bwd_cases:
        print(json.dumps({"attn_bwd_case": c}), flush=True)
    emit("kernel_bwd", t0, cases=len(bwd_cases))
    bwd_main = next(c for c in bwd_cases if c["B"] == 4096 and c["dtype"] == "bfloat16")
    bwd_f32 = next(c for c in bwd_cases if c["B"] == 4096 and c["dtype"] == "float32")

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

    t0 = time.perf_counter()
    train = train_phase(device)
    emit("train", t0, **train)

    t0 = time.perf_counter()
    emit("run_train", t0, **run_train_phase())

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
    }, {
        "name": "fused_attn_block_bwd",
        "route": "cuda",
        "source": "rdm_tpu_torch/csrc/fused_attn_block_bwd.cu",
        "replaces": "rdm_tpu/ops/pallas/attention.py:101::_fused_block_bwd_kernel",
        "launches": train["bwd_launches"],
        "max_abs_err": max(bwd_main["dx_max_abs_err"], bwd_main["param_max_abs_err"]),
        "ms": bwd_main["ms"],
        "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": None,
        "max_err_f32": max(bwd_f32["dx_max_abs_err"], bwd_f32["param_max_abs_err"]),
        "max_err_bf16": max(bwd_main["dx_max_abs_err"], bwd_main["param_max_abs_err"]),
        "kernel_us": bwd_main["ms"] * 1e3,
        "plain_us": bwd_main["plain_ms"] * 1e3,
        "bound_us": bwd_main["bound_ms"] * 1e3,
        "shape": "B=4096 C=64 L=81 groups=16 bfloat16",
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
