#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

1. env        torch/CUDA versions, the card, nvidia-smi's name and power limit
2. build      nvcc builds every CUDA source of the sampling, training and
              grading paths,
              one nvcc per source, all at once, with each one's ptxas
              register and spill lines under the (mangled) name of their
              kernel
3. kernel     the attention kernel against its plain PyTorch version on the
              same seeded inputs, with the stated tolerance (bfloat16 at
              B 1024, 1025, 3 and 4096 through the tensor-core body, C 128
              and L 128 and float32 through the scalar one); timed cold and
              warm as CUDA-graph slopes beside its bound, the kernel alone
              (parameters prepared once) and the plain version, with the
              weight bytes its launch plan reads from L2 (modeled, not
              measured)
4. kernel_bwd the attention backward kernel against the plain backward on the
              same seeded x, g and parameters, each against its stated
              tolerance, two runs bit for bit (bfloat16 at B 4096, 1024,
              4097, 3 and 1 and at L 49 and 96 through the tensor-core body,
              C 128, L 128 and float32 through the scalar one; the library's
              plan names the body); at B 4096 and 1024 timed cold and warm
              as CUDA-graph slopes, the wrapper and the kernel alone
              (parameters prepared once), beside its bound and the plain
              version
5. kernel_resblock  the fused resblock kernel against its plain version at
              the eight block shapes of the flagship at batch 1024, 3 and
              1025 in bfloat16 (the tensor-core body), one float32 case at
              1024 and three at batch 3 (the scalar body); each bfloat16
              shape at 1024 timed cold and warm as CUDA-graph slopes beside
              its bound, the kernel alone (parameters prepared once), the
              plain version and the unfused module (cuDNN convolutions),
              with its launch plan and the weight bytes the plan reads from
              L2 (modeled, not measured)
6. kernel_attn_core  the attention-core kernel against its plain version at
              batch 1024, 81 tokens, 64 channels, float32 and bfloat16 (both
              softmax settings), and at batch 1025, 4096, 3 and 16 (128 x 128);
              timed cold (inputs rotating over more than twice the L2) and
              warm beside its bound, its plain version and PyTorch's
              scaled_dot_product_attention; one call through its entry point
7. golden     the reference NCSN++ weights of tests/golden/ncsnpp_golden.npz,
              float32 with the attention kernel, against the stored outputs
8. flagship   the flagship run (Training Runs/2026.08.17_184657, EMA weights,
              bfloat16, attention kernel) samples 1024 trajectories with
              1000-step reflected Euler-Maruyama; the samples must lie in the
              unit cube and match the JAX package's samples of the same
              checkpoint by per-dimension two-sample KS statistic; no
              resblock kernel launches
9. flagship_resblock  the same with model.resblock_pallas on: every resblock
              through the resblock kernel (17 per forward), the attention
              blocks through theirs; the same checks, and trajectories/s
              beside phase 8's
10. resblock_routing  an NCSN++ at nf 32 with model.resblock_pallas and
              model.attn_pallas on, bfloat16: every resblock and attention
              block keeps its kernel when the model is built; one forward on
              the card launches the resblock kernel 17 times and the attention
              kernel 5 times (C 32, L 81), all through the tiled bodies
11. cfg       guided sampling (w = 0.1) at batch 256 with N = 100
12. ode       the flagship samples 1024 trajectories at batch 1024 with the
              probability-flow ODE (Dormand-Prince, rtol = atol = 1e-5, one
              step size for the batch) through generate_raw_samples: NFE
              (the model's forwards, counted by a hook) under 7 x 20,000,
              5 attention-kernel launches per NFE and no resblock launch,
              samples finite in the unit cube, and through the port's
              inverse pipeline a max per-dimension KS under 0.11 against the
              JAX package's ODE samples of the same checkpoint
              (benchmark_results/flagship_ode_1024, physical units); NFE,
              wall s, trajectories/s, the clip rate and the samples' sha256
13. ode_resblock  the same with model.resblock_pallas on: 17 resblock-kernel
              launches per NFE beside the attention kernel's 5
14. kernel_cr3bp  the three shooting kernels of csrc/cr3bp_shoot.cu at the
              shapes of one 1024-lane LM iteration on seeded round-2 lanes,
              each against its plain PyTorch version on the same inputs:
              shoot_legs float64 on 67,584 rows (66 forward-difference
              columns a lane) and float32 on 8,192 (8 ladder rungs a lane)
              and on the whole forward arc, manifold_target float64 on 10,240
              rows and float32 on 8,192, shoot_jvp on 1024 lanes; the
              quantiles of the per-row error and the mass against SHOOT_TOL
              (the reasons are stated there), two runs bit for bit, cold
              times (the L2 flushed) beside the operation-count bound; the
              manifold chain by width: manifold_target at 1 row (the
              chain's own time), 1024 and the full count, shoot_jvp at 1
              and 33 lanes, a slice launched alone bit-equal to the same
              rows of the full launch, the lanes a row and the registers
15. oracle_native  the port's native CR3BP oracle (its own C++ copy, built
              with g++ at first use) grades the 1024 in-tree round-2 physical
              samples (8 basin hops, optimal mode): feasible 1012 +- 3 and
              certified optimal 990 +- 3, the JAX package's counts; wall s,
              the host's cores and s per sample (a host number, not a card one)
16. oracle_gpu  refine_warmstarts_gpu grades the same samples on the card
              (8 hops, optimal mode) in float64 (precision df32): feasible
              1012 +- 10 and certified optimal 998 +- 15 (the JAX package's
              df32 record, three binomial standard errors), per-lane
              feasibility agreeing with phase 15's on at least 0.98 of the
              lanes, every shooting kernel launched; wall s, s per sample
              and mean iterations beside the native oracle's wall; then
              float32, hybrid (at least float32's feasible count) and the
              defect check (tier counts), and the automatic backend (hybrid)
17. run_benchmark  python -m rdm_tpu_torch.run_benchmark --benchmark_type both
              --num_samples 1024 --batch_size 1024 --sampling_method ode
              --oracle_backend tpu as a subprocess into a temporary
              directory: both JSON and both summary.txt files, no NaN or inf,
              float64 grading on the card, and a feasible ratio of the port's
              own ODE samples of at least 0.965 (the JAX ODE record 0.982
              less 3 binomial standard errors)
18. train     the flagship run trains on the card: checkpoint_10.pth with its
              weights, EMA and Adam state, its training set resident on the
              card, batch 4096, bfloat16, the attention kernels forward and
              backward.  One step with the kernels against one through the
              plain versions (same batch, t, z and masks); twenty steps with
              5 + 5 kernel launches each and a mean loss inside the flagship's
              logged range; the EMA evaluation loss at batch 16384, also with
              the resblock kernel (17 launches); a checkpoint round trip; ms
              per step
19. run_train python -m rdm_tpu_torch.run_train for four steps at batch 4096
              from a temporary directory, through the stall supervisor
              rdm_tpu_torch/launch/train_with_resume.sh ("completed after 0
              restart(s)"): log lines, a checkpoint the port restores,
              snapshot samples (NHWC)
20. trace     python -m rdm_tpu_torch.benchmark.trace in process at its
              defaults: 50-step PC sampling at batch 1024, then 5 training
              steps at batch 1024, each recorded by torch.profiler into a
              Chrome trace: 245 attention-forward launches in the sampling
              trace (5 a forward), 25 forward and 25 backward launches in the
              training trace, the same by the wrappers' counts; the trace's
              bytes, device ms and idle share per step, the top kernels
21. train_decomp  python -m rdm_tpu_torch.benchmark.profile_train_decomp
              --batch 4096 --skip_scaling in process: the five components'
              slopes (finite, positive, full above loss), GFLOP and GB of one
              iteration (counted and modeled), effective GB/s, device ms and
              idle share
22. dp_train  data parallelism of the flagship's training step (checkpoint_10.pth,
              phase train's batch of 4096 rows with its t, z and masks, bf16,
              both attention kernels; cuDNN's deterministic algorithms for the
              checked step): one process gives phase train's gradients bit for
              bit; (i) under a process group of one on NCCL the step is the
              same, bit for bit, and ms per step beside phase train's; (ii) two
              ranks on this card over gloo (NCCL refuses two ranks on one card;
              gloo moves the gradients through the host), 2048 rows each: the
              ranks' states bit for bit alike after the step, 5 + 5 attention
              launches in each, and the averaged gradient held to phase train's
              kernel-against-plain rule against one process's (the only
              difference is the order of the batch's sum); ms per step,
              time-sliced, not a speed figure; (iii) the same over NCCL with a
              rank a card when there are two cards, else one line saying so
23. dp_sample  two ranks on the card sample 512 trajectories each from the
              flagship's EMA weights (1000 steps, w = 0, a seed a rank); the 1024
              gathered lie in the unit cube, within KS 0.11 of the JAX package's
              samples, 4,995 attention launches a rank
24. dp_oracle  phase oracle_gpu's float64 grading with each tile split over
              [cuda:0, cuda:0] (a thread a part; with two cards also over
              [cuda:0, cuda:1]): the result equals phase oracle_gpu's, lane for
              lane; wall s beside phase oracle_gpu's
25. run_train_torchrun  phase run_train's command under python -m
              torch.distributed.run --standalone --nproc_per_node 1 (NCCL)
26. kernel_micro_cf  the channels-first kernels of csrc/micro_cf.cu at the
              TPU script's shapes (C 64, N 20,736 = 81 x 256, bfloat16), each
              against its plain version on the same seeded inputs: both
              transposes and the roll sum bit for bit, the dots at K 64 and
              K 192 within one bf16 step (plus the float32 allowance of two
              sums in another order), also at N = 64 x 132 x 3 + 8 and
              64 x 132 x 10 + 8 (more tiles than three a block, ragged), and
              the roll sum's library yardstick
              (one F.conv1d) within the same; the roll sum's general body
              (a second shift table) bit for bit; the copy floor (a cold
              copy of the same bytes) beside each; then the entry point
              python -m rdm_tpu_torch.scripts.micro_cf once, in process, as
              its path, with its chained and cold times, bounds and library
              times, and the plain versions' cold times beside them
27. kernels_per_card  each model kernel (attention forward and backward,
              resblock, attention core, the channels-first dots) launched on
              every card after the first from this one process, against its
              plain version (each launcher sets its shared-memory limit once
              per card); with one card, one line saying so
28. datagen   python -m rdm_tpu_torch.generate_data --backend tpu on 4096
              uniform guesses (seeds 0-4095, optimal mode, float32) as a
              subprocess, then prepare_training_data on its folder: every
              shooting kernel launched; the native oracle on all 4096
              guesses: the float32 verdicts recall its feasible seeds no worse
              than the JAX package's float32 verdicts on the same seeds
              (JAX_F32_FEASIBLE) less three standard errors; the first 256
              guesses solved in float64 on the card agree with it per lane on
              at least 0.98 of the lanes (phase 16's rule); every feasible row
              inside the float64 defect check's feasible tier (0.15, the only
              bar; the shares below 1e-3, 1e-2 and 0.05 printed), the [N, 67]
              pickle equal to normalize_result of the files and finite; the
              yield, ms per sample beside the native oracle's s per sample (a
              host number) and the launches
29. datagen_fleet  python -m rdm_tpu_torch.scripts.generate_dataset --batch
              4096 --target 1100 --max_minutes 4 --optimal_pass --n_devices 0
              into a temporary directory: all 11 alpha bins filled, 256 rows
              of its state file at least 0.98 inside the float64 defect
              check's feasible tier (the shares below the tighter bounds
              printed), the pickle [N, 67] and finite; rows per second
30. studies   the card-side study scripts of rdm_tpu_torch/scripts in
              process at n = 64 into a temporary directory: nfe_sweep (10 and
              20 steps, 5 LM iterations, no basin hops; the JAX artifact's
              keys), clip_excess (250 steps), regrade_benchmark on a 64-row
              copy of the round-2 record (float64 on the card) and
              gt_roundtrip_control on the card: finite JSON, the shooting
              kernels launched by each grading
31. launch    rdm_tpu_torch/launch/datagen_fanout.sh with 2 workers of 64
              seeds (--backend tpu, infeasible results kept): the merged
              pickle [N, 67], finite, equal to prepare_training_data of the
              folder; beside it the supervisor's line from phase run_train
32. family_golden  tests/golden/adm_golden.npz and vdm_golden.npz in the
              port's ADM and VDM (strict=True, float32 on the card) against
              the stored outputs at the JAX package's tolerance
33. family_adm  model=adm data=imagenet64c at the config's full width
              (bfloat16): the JAX package's parameter count, one training
              step twice from the same state and generator bit for bit, ten
              steps at batch 64 on seeded 64 x 64 images with dropout, label
              dropout and EMA, guided PC sampling (w = 1, one-hot labels) at
              batch 64 with N 50 in the unit cube; ms per step, samples/s,
              peak memory; the checkpoint round trip on a narrow ADM
              (model_channels 32, one block a level, two steps: the
              full-width state is a 7.1 GB file)
34. family_vdm  the same for model=vdm data=cifar10 (float32, unguided; the
              round trip of its full-width state)
35. run_train_families  python -m rdm_tpu_torch.run_train data=cifar10
              model=ddpmpp (full width, float32 as the config ships, no
              kernels) for four steps at batch 64 on seeded CIFAR-10 pickles:
              log lines, a checkpoint the run's model loads strictly,
              snapshot samples
36. run_train_ddpmpp_kernels  the same with model.precision=bfloat16
              model.attn_pallas=true model.resblock_pallas=true (the tiled
              kernels)
37. kernel_tiled  the tiled bodies against their plain versions, bfloat16:
              attention forward and backward (the backward twice bit for bit)
              at C 256, L 256 (DDPM++) and C 32, L 81 (nf 32), each at B 64
              and a ragged B; the resblock at DDPM++'s ten block shapes at
              B 64, three of them at B 3, and the nf-32 NCSN++'s eight at
              B 64, each twice bit for bit; each output within 4 bf16 steps
              of its scale and more than 99 % of its elements within one; at
              B 64 timed cold beside the plain versions, the unfused library
              block or cuDNN module and the bound: the wrapper (ms), the
              kernels alone with their parameters prepared once (kernel_ms)
              and each launch of the body (launch_ms: GroupNorm 0, conv0,
              GroupNorm 1, NIN, conv1; GroupNorm, q/k/v, attention, output;
              the attention backward's bwd_launch_ms: recompute, gs, do, ds,
              dq, dk, dv, dh, GroupNorm's backward, the two weight products,
              the sums), and their sums over one DDPM++ forward
38. ddpmpp_attn_routing  model=ddpmpp with both kernels on, bfloat16: every
              block keeps its kernel, no routing log line; one evaluation
              forward on the card launches the attention kernel 17 times and
              the resblock kernel 70 times, all tiled
39. ddpmpp    model=ddpmpp at full width (104,701,571 parameters, bf16, both
              kernels, random weights from a seed, the config's zero-scale
              layers drawn at scale 1): for two seeds one training loss and
              gradient through the attention kernels against the plain
              versions under phase train's rule (within half of the bf16-f32
              spread as a vector; every parameter within its own), beside a
              witness (the plain versions on permuted channels: the same
              rounding points, another summation order); three training
              steps at batch 64 twice from one state bit for bit (102
              forward and 102 backward launches), ten PC steps with the EMA
              weights and all three kernels twice bit for bit, samples finite
40. legacy_1d the legacy 1-D pipeline at the published width (dim 128, mults
              4-4-8, class MLP 256-512, 500 timesteps; 73,802,497 parameters):
              tests/golden/unet1d_golden.npz loaded with strict=True against
              its outputs; the full-width U-Net's guided forward (w 5) on the
              card against the same module on the CPU at batch 8; python -m
              rdm_tpu_torch.train_1d (in process) for one epoch on the 80,073-row pickle
              (every third row: 52 steps at batch 512), run twice with one
              seed (ms a step, falling and finite losses, the two loss
              sequences compared); rdm_tpu_torch.sample_1d (in process) on
              its model-epoch-1.pt at w 5 with 500 ancestral steps, 64
              samples at batch 64 (cut from the CLI's 1000), run twice (bit for bit,
              the physical ranges, trajectories/s); the checkpoint restored
              on the card and written and restored again (the EMA forward
              bit for bit); no hand-written kernel runs on this path
41. kernels   one line {"kernels": [...]} with each kernel's launches on its
              path (sampling for the forward kernels, with the ODE path's
              count beside the attention forward's and the DP paths' counts a
              rank beside both attention kernels'; training for the
              backward, one entry-point call for the attention core, the
              micro_cf script for its three kernels: the wrappers' counts,
              and beside them the kernel runs of the script's CUDA-graph
              replays, and phase trace's counts beside the attention
              kernels'; phase 16's float64 grading for the shooting kernels,
              the float32 grading's and phase 28's beside them; phase 39's
              training and sampling for the three tiled bodies), error, times
              and bound

The last line is {"ok": true, "device": {...}}.  A failed check raises, and
the script then exits non-zero without that line.  It needs a CUDA card and
the repository around it.
"""
from __future__ import annotations

import ast
import contextlib
import copy
import hashlib
import io
import json
import logging
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

import rdm_tpu_torch
from rdm_tpu_torch import datagen
from rdm_tpu_torch.benchmark import GTOHaloBenchmarker, GTOHaloBenchmarkConfig
from rdm_tpu_torch.benchmark import common as bench_common
from rdm_tpu_torch.benchmark import costs as cost_lib
from rdm_tpu_torch.benchmark import dp_check
from rdm_tpu_torch.benchmark import profile_train_decomp as decomp_lib
from rdm_tpu_torch.benchmark import shoot_chain as shoot_chain_lib
from rdm_tpu_torch.benchmark import tiled_attn_parts
from rdm_tpu_torch.benchmark import trace as trace_lib
from rdm_tpu_torch.benchmark.common import (SAMPLING_EPS, LoadedModel, generate_raw_samples,
                                            load_training_run, parts_ms)
from rdm_tpu_torch.config import ConfigDict, load_config, load_hydra_config_from_run
from rdm_tpu_torch.data import get_dataset
from rdm_tpu_torch.models import NCSNpp, create_model
from rdm_tpu_torch.models import adm as adm_lib
from rdm_tpu_torch.models import vdm as vdm_lib
from rdm_tpu_torch.models.layers import NIN, AttnBlockpp, ResnetBlockDDPMpp, default_init_
from rdm_tpu_torch.models.registry import get_cf_score_fn, get_score_fn
from rdm_tpu_torch.models.unet1d import UNet1D
from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops import attention as attn_ops
from rdm_tpu_torch.ops import cr3bp as shoot_ops
from rdm_tpu_torch.ops import micro_cf
from rdm_tpu_torch.ops import resblock as rb_ops
from rdm_tpu_torch.parallel import launch as dp_launch
from rdm_tpu_torch.parallel import mesh as dp_mesh
from rdm_tpu_torch.physics import oracle as oracle_lib
from rdm_tpu_torch.physics import solver_gpu
from rdm_tpu_torch.physics.oracle import evaluate_warmstarts_native
from rdm_tpu_torch.sampling import get_sampling_fn
from rdm_tpu_torch import sample_1d as sample_1d_cli
from rdm_tpu_torch import train_1d as train_1d_cli
from rdm_tpu_torch.scripts import (clip_excess, gt_roundtrip_control, nfe_sweep,
                                   regrade_benchmark)
from rdm_tpu_torch.scripts import micro_cf as micro_cf_script
from rdm_tpu_torch.sde import RVESDE, get_sde
from rdm_tpu_torch.training import checkpoints
from rdm_tpu_torch.training.checkpoints import (restore_unet1d_checkpoint,
                                                save_unet1d_checkpoint)
from rdm_tpu_torch.training.losses import (get_loss_fn, make_eval_step,
                                           make_train_step_on_device)
from rdm_tpu_torch.training.state import init_train_state

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_RUN = os.path.join(ROOT, "Training Runs", "2026.08.17_184657")
JAX_SAMPLES = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024",
                           "ml_statistics", "generated_samples.npy")
GOLDEN = os.path.join(ROOT, "tests", "golden", "ncsnpp_golden.npz")
# the JAX package's ODE samples of the flagship (physical units, 1024 x 67)
JAX_ODE_SAMPLES = os.path.join(ROOT, "benchmark_results", "flagship_ode_1024", "gto_halo",
                               "generated_samples.npy")
ROUND2_PHYSICAL = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024", "gto_halo",
                               "generated_samples.npy")
# the JAX package's native grading of ROUND2_PHYSICAL (8 hops, optimal mode)
ORACLE_FEASIBLE, ORACLE_OPTIMAL, ORACLE_SLACK = 1012, 990, 3
ODE_MAX_NFE = 7 * 20_000
# the JAX package's df32 grading of ROUND2_PHYSICAL (round2_flagship_1024/
# gto_halo/gto_halo_results.json: 8 hops, optimal mode), with three binomial
# standard errors at n = 1024 as slack; its float32 record (0.766 of 1024,
# BENCH_NOTES.md), printed beside the port's and not a gate
SOLVER_FEASIBLE, SOLVER_FEASIBLE_SLACK = 1012, 10
SOLVER_OPTIMAL, SOLVER_OPTIMAL_SLACK = 998, 15
SOLVER_AGREEMENT_MIN = 0.98
SOLVER_F32_JAX = 784
PEAK_FLOPS_F64 = 34e12   # H100 SXM float64 outside the tensor cores (data sheet)
# the JAX ODE record's feasible ratio, 0.982 (flagship_ode_1024), less three
# binomial standard errors at n = 1024
ODE_FEASIBLE_MIN = 0.965

# H100 SXM peaks (NVIDIA data sheet), kept with the cost formulas
PEAK_FLOPS = cost_lib.PEAK_FLOPS
# Bonferroni critical value of the two-sample KS statistic for
# alpha = 0.001 / 67 at n = m = 1024.
KS_LIMIT = 0.11
ATTN_BLOCKS_PER_FORWARD = 5
RESBLOCKS_PER_FORWARD = 17
# (H, C_in, C_out) of the flagship's resblocks and how many blocks of a
# forward have each
RESBLOCK_SHAPES = {(9, 64, 64): 2, (4, 64, 128): 1, (4, 128, 128): 1, (2, 128, 128): 4,
                   (2, 256, 128): 3, (4, 256, 128): 3, (9, 192, 64): 1, (9, 128, 64): 2}
SOURCES = ("fused_attn_block", "fused_attn_block_bwd", "fused_resblock", "attention_core",
           "micro_cf", "cr3bp_shoot", "fused_attn_block_tiled", "fused_resblock_tiled")
BF16_STEP = 2.0 ** -8
PARAM_NAMES = ("gamma", "beta", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp")
# The flagship's logged losses at batch 4096 (Training Runs/2026.08.17_184657/
# logs, steps 90k-100k: training 10.61-11.47 over 51 lines, evaluation
# 10.19-10.35), widened: a twenty-step mean and one evaluation batch.
TRAIN_LOSS_RANGE = (10.1, 12.0)
EVAL_LOSS_RANGE = (9.7, 10.9)
TRAIN_STEPS = 20
# Parameters of the other families at their configs' full width (ImageNet64C
# ADM, CIFAR-10 VDM, CIFAR-10 DDPM++): the JAX package's counts, which
# tests/test_torch_families.py takes from its shape evaluation.
FAMILY_PARAMS = {"adm": 295_899_267, "vdm": 30_577_667, "ddpmpp": 104_701_571}

T_START = time.perf_counter()
CARD = {"card": None}   # nvidia-smi's name and power limit, beside every time printed


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **CARD, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


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
    once, against the card's peak rates; and which of the two bounds it
    (the bytes and operations of ``benchmark.costs.attn_fwd_cost``)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return cost_lib.bound_ms(*cost_lib.attn_fwd_cost(B, C, L, elt), PEAK_FLOPS[dtype])


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
           "body": attn_ops.attn_body(C, L, dtype), "max_abs_err": err, "tol": tol}
    check(bool(torch.isfinite(out.float()).all()), f"kernel output not finite {res}")
    check(err <= tol, f"kernel disagrees with its plain version: {res}")
    if timed:
        # CUDA-graph slopes as attn_core_case takes them.  cold: x rotates
        # over more than twice the L2 (the time compared with the bound);
        # warm: the same x each call.  ms is the wrapper call the model
        # makes (it casts the ten parameters every call); kernel_ms the
        # kernel alone, its parameters prepared once.
        launch = attn_ops._launcher(*params, C=C, L=L, dtype=dtype, **kw)
        wrapper = lambda t: attn_ops.fused_attn_block(t, *params, **kw)
        make = lambda i: torch.randn(x.shape, generator=torch.Generator(device=device)
                                     .manual_seed(100 + i), device=device).to(dtype)
        nbytes = x.numel() * x.element_size()
        fns = {"": wrapper, "kernel_": launch,
               "plain_": lambda t: attn_ops.fused_attn_block_reference(t, *params, **kw)}
        for key, fn in fns.items():
            ks = (5, 50) if key == "plain_" else micro_cf_script.KS
            res[key + "ms"] = micro_cf_script.cold_us(fn, make, nbytes, device, ks) / 1e3
        res["warm_ms"] = micro_cf_script.slope_us(
            lambda n: [wrapper(x) for _ in range(n)], device) / 1e3
        res["bound_ms"], res["bound_by"] = attn_bound_ms(B, C, L, dtype)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["modeled_weight_bytes"] = modeled_weight_bytes_attn(B, C, L, dtype)
    return res


def modeled_weight_bytes_attn(B, C, L, dtype) -> int:
    """Arithmetic, not a measurement: bytes of the four C x C weights the
    launch reads from L2 if the tensor-core body stages them once per
    persistent block and the scalar one once per sample (it reads them
    inside every product's loop, so more)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    blocks = min(B, torch.cuda.get_device_properties(0).multi_processor_count)
    per_block = 4 * C * C * elt
    return (blocks if attn_ops.attn_body(C, L, dtype) == "tensor_cores" else B) * per_block


def attn_bwd_bound_ms(B, C, L, dtype) -> tuple:
    """Least time for the backward: x and g read once, dx written once (the
    parameters and their float32 gradients beside them), against the card's
    peak rates; the operations are those the backward needs: the recomputed
    q, k, v, scores and p.v and the backward products
    (``benchmark.costs.attn_bwd_cost``)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return cost_lib.bound_ms(*cost_lib.attn_bwd_cost(B, C, L, elt), PEAK_FLOPS[dtype])


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
    plan = attn_ops.bwd_plan(C, L, dtype)
    check(plan.body == attn_ops.attn_body(C, L, dtype), f"backward body {plan}")
    res = {"B": B, "C": C, "L": L, "groups": groups, "dtype": str(dtype).split(".")[-1],
           "body": plan.body, "threads": plan.threads, "stages": plan.stages,
           "smem_bytes": plan.smem_bytes,
           "dx_max_abs_err": dx_err, "dx_tol": dx_tol, "worst_param": worst,
           "param_max_abs_err": p_err, "param_tol": p_tol, "bitwise_repeatable": True}
    check(dx_err <= dx_tol, f"backward dx disagrees with the plain version: {res}")
    for name, (err, scale) in errs.items():
        tol = (1e-4 if f32 else BF16_STEP) * scale
        check(err <= tol, f"backward d{name} disagrees with the plain version: {res}")
    if timed:
        # CUDA-graph slopes as attn_case takes them, over fewer calls (each
        # graph keeps every call's dx): cold, x and g rotate over more than
        # twice the L2 (the time compared with the bound); warm, the same x
        # and g each call.  ms is the wrapper call the model makes (it casts
        # the ten parameters every call); kernel_ms the kernel alone, its
        # parameters prepared once.
        launch = attn_ops._bwd_launcher(*params, C=C, L=L, dtype=dtype, **kw)
        wrapper = lambda t: attn_ops.fused_attn_block_bwd(*t, *params, **kw)
        gen = torch.Generator(device=device)
        make = lambda i: tuple(torch.randn(x.shape, generator=gen.manual_seed(200 + 2 * i + j),
                                           device=device).to(dtype) for j in range(2))
        nbytes = 2 * x.numel() * x.element_size()
        ks = (5, 50) if plan.body == "tensor_cores" else (2, 6)
        fns = {"": wrapper, "kernel_": lambda t: launch(*t),
               "plain_": lambda t: attn_ops.fused_attn_block_bwd_reference(*t, *params, **kw)}
        for key, fn in fns.items():
            res[key + "ms"] = micro_cf_script.cold_us(
                fn, make, nbytes, device, (2, 6) if key == "plain_" else ks) / 1e3
            if key != "plain_":
                res[key + "warm_ms"] = micro_cf_script.slope_us(
                    lambda n, fn=fn: [fn((x, g)) for _ in range(n)], device, ks) / 1e3
        res["bound_ms"], res["bound_by"] = attn_bwd_bound_ms(B, C, L, dtype)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return res


# ---------------------------------------------------------------------------
# fused resblock and attention core: inputs, bounds, comparisons

def resblock_inputs(B, H, ci, co, dtype, seed, device):
    """x, tembv and the block's float32 parameters (module layouts) from a
    seeded generator."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32), device=device)
    params = [1 + 0.1 * f(ci), 0.1 * f(ci), f(co, ci, 3, 3) / math.sqrt(9 * ci), 0.1 * f(co),
              1 + 0.1 * f(co), 0.1 * f(co), f(co, co, 3, 3) / math.sqrt(9 * co), 0.1 * f(co)]
    params += [f(ci, co) / math.sqrt(ci), 0.1 * f(co)] if ci != co else [None, None]
    return f(B, ci, H, H).to(dtype), (0.5 * f(B, co)).to(dtype), params


def resblock_bound_ms(B, H, ci, co, dtype) -> tuple:
    """Least time for one launch: x, tembv and the parameters read once, the
    output written once; the operations of the two 3x3 convolutions and the
    NIN shortcut (``benchmark.costs.resblock_cost``)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return cost_lib.bound_ms(*cost_lib.resblock_cost(B, H, ci, co, elt), PEAK_FLOPS[dtype])


def resblock_module(params, ci, co, dtype, device):
    """The unfused ResnetBlockDDPMpp (cuDNN convolutions) carrying the same
    parameters, and a time embedding whose dense layer gives tembv-sized
    input."""
    blk = ResnetBlockDDPMpp(torch.nn.functional.silu, ci, co, temb_dim=4 * 64, dropout=0.0,
                            skip_rescale=True, dtype=dtype)
    names = ["GroupNorm_0.weight", "GroupNorm_0.bias", "Conv_0.weight", "Conv_0.bias",
             "GroupNorm_1.weight", "GroupNorm_1.bias", "Conv_1.weight", "Conv_1.bias",
             "NIN_0.W", "NIN_0.b"]
    sd = blk.state_dict()
    sd.update({n: p.cpu() for n, p in zip(names, params) if p is not None})
    blk.load_state_dict(sd, strict=True)
    return blk.to(device).eval().requires_grad_(False)


def resblock_case(B, H, ci, co, dtype, seed, device, timed):
    x, tembv, params = resblock_inputs(B, H, ci, co, dtype, seed, device)
    kw = dict(groups0=min(ci // 4, 32), groups1=min(co // 4, 32), skip_rescale=True)
    out = rb_ops.fused_resblock(x, tembv, *params, **kw)
    ref = rb_ops.fused_resblock_reference(x, tembv, *params, **kw)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype, "resblock output shape/type")
    check(bool(torch.isfinite(out.float()).all()), f"resblock output not finite {B, H, ci, co}")
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    # float32: the two differ in summation order only.  bfloat16: the same
    # rounding points, but a sum next to a rounding boundary may round the
    # other way and carry a step on through the later layers of the block:
    # 4 bf16 steps at the output's largest magnitude.
    tol = (1e-4 if dtype == torch.float32 else 4 * BF16_STEP) * scale
    res = {"B": B, "H": H, "C_in": ci, "C_out": co, "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "tol": tol,
           "frac_differ": float((out != ref).float().mean())}
    check(err <= tol, f"resblock kernel disagrees with its plain version: {res}")
    if timed:
        # CUDA-graph slopes as attn_core_case takes them.  cold: x and tembv
        # rotate over more than twice the L2 (the time compared with the
        # bound); warm: the same inputs each call.  ms is the wrapper call
        # the model makes (it casts and re-lays the weights every call);
        # kernel_ms the kernel alone, its parameters prepared once.
        launch = rb_ops._launcher(*params, H=H, dtype=dtype, **kw)
        wrapper = lambda t: rb_ops.fused_resblock(*t, *params, **kw)
        blk = resblock_module(params, ci, co, dtype, device)
        temb = torch.randn((B, 4 * 64), generator=torch.Generator(device=device).manual_seed(seed),
                           device=device)

        def make(i):
            gen = torch.Generator(device=device).manual_seed(100 + i)
            return (torch.randn((B, ci, H, H), generator=gen, device=device).to(dtype),
                    (0.5 * torch.randn((B, co), generator=gen, device=device)).to(dtype))

        nbytes = (x.numel() + tembv.numel()) * x.element_size()
        fns = {"": wrapper, "kernel_": lambda t: launch(*t),
               "plain_": lambda t: rb_ops.fused_resblock_reference(*t, *params, **kw),
               "module_": lambda t: blk(t[0], temb)}
        with torch.no_grad():
            for key, fn in fns.items():
                ks = (5, 50) if key in ("plain_", "module_") else micro_cf_script.KS
                res[key + "ms"] = micro_cf_script.cold_us(fn, make, nbytes, device, ks) / 1e3
            res["warm_ms"] = micro_cf_script.slope_us(
                lambda n: [wrapper((x, tembv)) for _ in range(n)], device) / 1e3
        res["bound_ms"], res["bound_by"] = resblock_bound_ms(B, H, ci, co, dtype)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        if dtype == torch.bfloat16:
            plan = rb_ops.resblock_plan(H, ci, co)
            res["plan"] = plan._asdict()
            res["modeled_weight_bytes"] = modeled_weight_bytes_resblock(plan, B)
    return res


def modeled_weight_bytes_resblock(plan, B) -> int:
    """Arithmetic on the launch plan, not a measurement: the weight bytes
    the launch reads from L2 if every persistent block (one an SM) loads
    each stage once where they stay resident, and every group streams them
    once where they do not."""
    groups = -(-B // plan.samples)
    blocks = min(groups, torch.cuda.get_device_properties(0).multi_processor_count)
    return (blocks if plan.resident else groups) * plan.weight_stages * plan.stage_bytes


def attn_core_bound_ms(B, L, C, dtype) -> tuple:
    """Least time: q, k, v read once and o written once; the two products
    (q k^T and p v, 4 L^2 C a sample).  float32 runs them on the tensor
    cores as a 3xTF32 split: three TF32 products at TF32's peak."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes, flops = 4 * B * L * C * elt, 4 * B * L * L * C
    if dtype == torch.float32:
        return cost_lib.bound_ms(nbytes, 3 * flops, cost_lib.PEAK_FLOPS_TF32)
    return cost_lib.bound_ms(nbytes, flops, PEAK_FLOPS[dtype])


def attn_core_inputs(B, L, C, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((B, L, C), generator=gen, device=device).to(dtype) for _ in range(3))


def attn_core_case(B, L, C, dtype, softmax_f32, seed, device, timed):
    q, k, v = attn_core_inputs(B, L, C, dtype, seed, device)
    out = attn_ops.attention_core(q, k, v, softmax_f32)
    ref = attn_ops.attention_core_reference(q, k, v, softmax_f32)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype, "attention core shape/type")
    check(bool(torch.isfinite(out.float()).all()), "attention core output not finite")
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    # float32: summation order only; bfloat16: the same rounding points, a
    # sum next to a boundary may round the other way: 2 bf16 steps
    tol = (1e-5 if dtype == torch.float32 else 2 * BF16_STEP) * scale
    res = {"B": B, "L": L, "C": C, "dtype": str(dtype).split(".")[-1],
           "softmax_f32": softmax_f32, "max_abs_err": err, "tol": tol}
    check(err <= tol, f"attention core kernel disagrees with its plain version: {res}")
    if timed:
        # one head, (B, 1, L, C), the layout PyTorch's fused attention kernels take
        sdpa = lambda t: torch.nn.functional.scaled_dot_product_attention(
            *(x.unsqueeze(1) for x in t))
        fns = {"": lambda t: attn_ops.attention_core(*t, softmax_f32),
               "plain_": lambda t: attn_ops.attention_core_reference(*t, softmax_f32),
               "library_": sdpa}
        # Both as the micro_cf script times: the slope over CUDA graphs of 50
        # and 500 calls, so no host launch cost enters.  cold: q, k, v rotate
        # over more than twice the L2 (the time compared with the bound);
        # warm: the same inputs each call, nearly all in the 50 MB L2.
        make = lambda i: attn_core_inputs(B, L, C, dtype, 100 + i, device)
        nbytes = 3 * q.numel() * q.element_size()
        for key, fn in fns.items():
            res[key + "ms"] = micro_cf_script.cold_us(fn, make, nbytes, device) / 1e3
            res[key + "warm_ms"] = micro_cf_script.slope_us(
                lambda n, fn=fn: [fn((q, k, v)) for _ in range(n)], device) / 1e3
        res["bound_ms"], res["bound_by"] = attn_core_bound_ms(B, L, C, dtype)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return res


def per_launch(cases, key) -> float:
    """The mean of ``key`` over the 17 resblock launches of one forward."""
    total = sum(c[key] * RESBLOCK_SHAPES[(c["H"], c["C_in"], c["C_out"])] for c in cases)
    return total / RESBLOCKS_PER_FORWARD


def set_attn_kernel(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, AttnBlockpp):
            m.use_kernel = on


def set_resblock_kernel(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, ResnetBlockDDPMpp):
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


def train_phase(device):
    """The flagship trains on the card; returns the fields of the phase and
    the yardstick of its kernel-against-plain rule (the gradients through
    the kernels, the bf16-f32 spread as one vector and per parameter), which
    phase dp_train holds its ranks to."""
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
    yardstick = {"loss": loss_k, "grads": g_k, "spread": spread, "per_param": pf,
                 "kbias": kbias, "names": names}

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
    # the same evaluation (batch, t, z) with every resblock through its kernel;
    # it rounds at the kernel's points, not the module's: the mean over
    # 16384 samples agrees within half a bfloat16 step, relative
    set_resblock_kernel(state.model, True)
    rb_ops.fused_resblock.launches = 0
    eval_rb = float(make_eval_step(get_sde(cfg))(
        state, torch.from_numpy(eimgs).to(device), torch.from_numpy(elabels).to(device),
        torch.Generator(device=device).manual_seed(14)))
    eval_rb_launches = rb_ops.fused_resblock.launches
    set_resblock_kernel(state.model, False)
    out.update(eval_loss_resblock_kernel=eval_rb, eval_resblock_launches=eval_rb_launches,
               eval_rel_diff=abs(eval_rb - eval_loss) / eval_loss)
    check(eval_rb_launches == RESBLOCKS_PER_FORWARD,
          f"EMA evaluation launched the resblock kernel {eval_rb_launches} times")
    check(EVAL_LOSS_RANGE[0] <= eval_rb <= EVAL_LOSS_RANGE[1]
          and abs(eval_rb - eval_loss) <= BF16_STEP / 2 * eval_loss,
          f"EMA evaluation loss with the resblock kernel {eval_rb} against {eval_loss}")

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
    return out, yardstick


def flagship_sampling(run, model_overrides, t0) -> dict:
    """The flagship samples 1024 trajectories with 1000-step reflected
    Euler-Maruyama through ``LoadedModel`` (EMA weights, the run's config
    with ``model_overrides``); the samples must lie in the unit cube and
    match the JAX package's samples by per-dimension KS.  Every kernel count
    is set to 0 just before and read just after.  The samples' sha256 lets
    two trees' runs be compared bit for bit."""
    lm = LoadedModel(run, model_overrides=model_overrides)
    check(lm.model.dtype == torch.bfloat16, "flagship model is not bfloat16")
    load_s = time.perf_counter() - t0
    attn_ops.fused_attn_block.launches = 0
    rb_ops.fused_resblock.launches = 0
    samples, times = generate_raw_samples(lm, 1024, 1024, guidance_weight=0.0, seed=0)
    launches = attn_ops.fused_attn_block.launches
    rb_launches = rb_ops.fused_resblock.launches
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
    return dict(checkpoint=os.path.relpath(lm.checkpoint_file, ROOT), overrides=model_overrides,
                step=lm.step, load_seconds=load_s, n=int(samples.shape[0]), steps=lm.sde.N,
                launches=launches, resblock_launches=rb_launches, batch_seconds=times,
                samples_sha256=hashlib.sha256(samples.tobytes()).hexdigest(),
                trajectories_per_second=samples.shape[0] / sum(times),
                ms_per_step=sum(times) / steps * 1e3,
                ks_max=float(ks.max()), ks_argmax=int(ks.argmax()), ks_limit=KS_LIMIT,
                ks_mean=float(ks.mean()), n_reference=int(ref.shape[0]),
                mean_gap_max=float(mean_gap.max()), mean_gap_mean=float(mean_gap.mean()),
                std_gap_max=float(std_gap.max()), std_gap_mean=float(std_gap.mean()),
                ks_per_dim=[round(float(v), 5) for v in ks],
                mean_gap_per_dim=[round(float(v), 5) for v in mean_gap],
                std_gap_per_dim=[round(float(v), 5) for v in std_gap])


def ode_phase(model_overrides) -> dict:
    """The flagship (the run's config with ``model_overrides``) samples 1024
    trajectories with the probability-flow ODE through
    ``generate_raw_samples``; a forward hook counts the model's evaluations
    (NFE), and every kernel count is set to 0 just before."""
    t0 = time.perf_counter()
    lm = LoadedModel(FLAGSHIP_RUN, model_overrides=model_overrides)
    load_s = time.perf_counter() - t0
    lm.cfg.sampling.method = "ode"
    forwards = []
    hook = lm.model.register_forward_pre_hook(lambda module, inputs: forwards.append(1))
    attn_ops.fused_attn_block.launches = 0
    rb_ops.fused_resblock.launches = 0
    samples, times = generate_raw_samples(lm, 1024, 1024, guidance_weight=0.0, seed=0)
    launches = attn_ops.fused_attn_block.launches
    rb_launches = rb_ops.fused_resblock.launches
    hook.remove()
    nfe = len(forwards)
    check(0 < nfe < ODE_MAX_NFE and nfe % 7 == 0, f"ODE NFE {nfe}")
    check(launches == ATTN_BLOCKS_PER_FORWARD * nfe,
          f"ODE sampling launched the attention kernel {launches} times for NFE {nfe}")
    rb_per_forward = RESBLOCKS_PER_FORWARD if model_overrides.get("resblock_pallas") else 0
    check(rb_launches == rb_per_forward * nfe,
          f"ODE sampling launched the resblock kernel {rb_launches} times for NFE {nfe}")
    check(samples.shape == (1024, 67) and bool(np.isfinite(samples).all()),
          "ODE samples are not finite (1024, 67)")
    check(float(samples.min()) >= 0.0 and float(samples.max()) <= 1.0,
          "ODE samples leave the unit cube")
    bench = GTOHaloBenchmarker.__new__(GTOHaloBenchmarker)
    bench.lm = lm
    bench.total_spherical_clips = bench.total_spherical_elements = 0
    physical = bench._inverse_pipeline(samples)
    ref = np.load(JAX_ODE_SAMPLES)
    check(ref.shape == (1024, 67), f"JAX ODE samples {ref.shape}")
    ks = np.array([ks_statistic(physical[:, d], ref[:, d]) for d in range(67)])
    check(float(ks.max()) < KS_LIMIT, f"ODE max per-dimension KS {ks.max()} >= {KS_LIMIT}")
    return dict(overrides=model_overrides, nfe=nfe, jax_nfe_at_batch_1024=1491, launches=launches,
                resblock_launches=rb_launches, wall_s=sum(times), load_s=load_s,
                trajectories_per_second=samples.shape[0] / sum(times),
                ms_per_nfe=sum(times) / nfe * 1e3,
                clip_rate=bench.total_spherical_clips / bench.total_spherical_elements,
                clips=bench.total_spherical_clips,
                samples_sha256=hashlib.sha256(samples.tobytes()).hexdigest(),
                ks_max=float(ks.max()), ks_argmax=int(ks.argmax()), ks_mean=float(ks.mean()),
                ks_limit=KS_LIMIT, ks_per_dim=[round(float(v), 5) for v in ks])


def oracle_native_phase():
    """The port's native oracle grades the in-tree round-2 physical samples
    as the JAX package's did (8 basin hops, optimal mode); returns the
    phase's fields and the per-lane feasible flags."""
    from rdm_tpu_torch import native

    t0 = time.perf_counter()
    check(native.available(), f"native oracle: {native.build_error()}")
    build_s = time.perf_counter() - t0
    physical = np.load(ROUND2_PHYSICAL)
    t0 = time.perf_counter()
    res = evaluate_warmstarts_native(physical[:, 1:], physical[:, 0], mbh_rounds=8,
                                     solver_mode="optimal")
    wall = time.perf_counter() - t0
    feasible, optimal = int(res["feasible"].sum()), int(res["optimal"].sum())
    check(abs(feasible - ORACLE_FEASIBLE) <= ORACLE_SLACK,
          f"native oracle: {feasible} feasible, the JAX package's {ORACLE_FEASIBLE}")
    check(abs(optimal - ORACLE_OPTIMAL) <= ORACLE_SLACK,
          f"native oracle: {optimal} optimal, the JAX package's {ORACLE_OPTIMAL}")
    return dict(n=len(physical), feasible=feasible, optimal=optimal,
                feasible_ratio=feasible / len(physical), optimal_ratio=optimal / len(physical),
                jax_feasible=ORACLE_FEASIBLE, jax_optimal=ORACLE_OPTIMAL,
                mean_final_mass_feasible=float(res["final_mass"][res["feasible"]].mean()),
                wall_s=wall, s_per_sample=wall / len(physical), host_cores=os.cpu_count(),
                build_s=build_s, library=native.library_path()), res["feasible"]


# ---------------------------------------------------------------------------
# the shooting kernels of the GPU solver and the solver itself

SHOOT_KERNELS = (shoot_ops.shoot_legs, shoot_ops.manifold_target, shoot_ops.shoot_jvp)
# Tolerances of the shooting kernels against their plain versions on the
# same inputs, on quantiles of the per-row error.  The kernels contract
# multiplies and adds into FMAs, and a CR3BP arc amplifies a difference of
# one rounding by its sensitivity kappa: 1e3-1e5 on most rows
# (rdm_tpu/physics/solver_tpu.py:416-420), far more on the few rows that
# pass close to the Earth or the Moon, where either version's digits are
# rounding noise.  On an H100 (700 W) this script measured, float64 legs:
# median 1.7e-14, 99 % 9.1e-10, max 7.8e-3 of max(1, |r|) over 67,584 rows;
# float32 legs: median 9.8e-6, 99 % 0.57; the float32 whole forward arc
# (twice a leg's horizon): median 3.9e-5, 99 % 4.6.  So the medians are held
# tightly, an upper quantile to the precision's kappa 2^-p, and on every row
# the parts that no chaos touches: the mass (it depends on the throttles and
# times only) and the finite flags.
SHOOT_TOL = {
    "legs_f64": {"q50": 1e-12, "q99": 1e-8, "mass": 1e-12},
    "target_f64": {"q50": 1e-12, "q99": 1e-8},
    # a float32 mass of ~700 kg is 4e-5 kg an ulp, and its 192 updates a
    # leg round differently under FMA: 1e-4 of the mass residual (kg / 100)
    # or of the whole arc's mass
    "legs_f32": {"q50": 1e-4, "q75": 1e-2, "mass": 1e-4},
    "arc_f32": {"q50": 1e-3, "mass": 1e-4},
    # the float32 target's own error against float64 reaches 3e-2
    # (tests/test_manifold.py)
    "target_f32": {"q50": 1e-4, "q99": 3e-2},
    # per lane, against the lane's largest entry; the phase column is a
    # second derivative through 1280 float32 steps
    "jvp_f32": {"q50": 1e-3, "q75": 2e-2},
}
QUANTILES = {"q50": 0.5, "q75": 0.75, "q99": 0.99}


def time_cold(fn, reps=5) -> float:
    """Mean ms of ``fn`` over ``reps`` launches, the L2 flushed (a 256 MB
    write) before each, after one warm-up; CUDA events."""
    return float(np.mean(bench_common.cold_ms(fn, reps)))


def time_once(fn):
    """(host ms of one call of ``fn``, ending in a synchronisation; its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def shoot_case(name, kernel, reference, args, row_err, tol, ops, peak, rows, dtype,
               mass_err=None):
    """One kernel against its plain version on the same inputs: the
    quantiles of ``row_err`` (one error per row) and, where given, the mass
    error within ``tol``; two runs bit for bit; cold time beside the bound."""
    a = kernel(*args)
    b = kernel(*args)
    torch.cuda.synchronize()
    a_t = a if isinstance(a, tuple) else (a,)
    b_t = b if isinstance(b, tuple) else (b,)
    check(all(torch.equal(x, y) for x, y in zip(a_t, b_t)), f"{name}: two runs differ")
    plain_ms, ref = time_once(lambda: reference(*args))
    r_t = ref if isinstance(ref, tuple) else (ref,)
    if len(a_t) > 1:
        check(torch.equal(a_t[1], r_t[1]), f"{name}: finite flags differ")
    e = row_err(a_t[0], r_t[0]).double().cpu()
    check(bool(torch.isfinite(e).all()), f"{name}: non-finite errors")
    q = {k: float(torch.quantile(e, v)) for k, v in QUANTILES.items()}
    q["max"] = float(e.max())
    for k in q.keys() & tol.keys():
        check(q[k] <= tol[k], f"{name}: {k} error {q[k]} > {tol[k]}")
    mass = None
    if mass_err is not None:
        mass = mass_err(a_t[0], r_t[0])
        check(mass <= tol["mass"], f"{name}: mass error {mass} > {tol['mass']}")
    x, r = a_t[0], r_t[0]
    both = torch.isfinite(x) & torch.isfinite(r)
    ms = time_cold(lambda: kernel(*args))
    bound = ops / peak * 1e3
    return dict(name=name, rows=rows, dtype=str(dtype).replace("torch.", ""), err_quantiles=q,
                mass_err=mass, max_abs_err=float((x - r).abs()[both].max()), tol=tol, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="operations", gflop=ops / 1e9,
                share_of_bound=bound / ms)


def rel_rows(a, b):
    """Per row: max |a - b| / max(1, |b|) over the row's finite entries."""
    f = torch.isfinite(a) & torch.isfinite(b)
    e = (a - b).abs() / b.abs().clamp(min=1.0)
    return torch.where(f, e, torch.zeros_like(e)).amax(-1)


def abs_rows(a, b):
    return (a - b).abs().amax(-1)


def mass_rel(a, b):
    """The mass entry (index 6) on every finite row, relative to max(1, |b|)."""
    f = torch.isfinite(a[:, 6]) & torch.isfinite(b[:, 6])
    return float(((a[:, 6] - b[:, 6]).abs() / b[:, 6].abs().clamp(min=1.0))[f].max())


def jvp_rows(a, b):
    """Per lane: max |a - b| over the lane's largest |b|."""
    scale = b.abs().amax(dim=(1, 2)).clamp(min=1e-6)
    return (a - b).abs().amax(dim=(1, 2)) / scale


def cr3bp_kernel_phase(device, L=1024) -> dict:
    """The three shooting kernels at the shapes of one 1024-lane LM
    iteration against their plain versions on seeded round-2 lanes."""
    theta, d64, d32, sp64 = bench_common.shoot_inputs(L, 30, device)
    sp32 = sp64.float()
    th32 = theta.float()
    cases = {}
    # float64 forward-difference columns: 66 variants a lane against the
    # lane's target, and the target at 10 variants a lane (2 FD columns + 8
    # ladder rungs), tau and length moved
    tgt64 = shoot_ops.manifold_target(*d64, theta[:, 64].contiguous(),
                                      theta[:, 65].contiguous())
    h = 1e-6 * (theta.abs() + 1.0)
    trial = (theta[:, None, :] + torch.diag_embed(h)).reshape(-1, 66).contiguous()
    tg = tgt64[:, None, :].expand(L, 66, 6).reshape(-1, 6).contiguous()
    cases["legs_f64"] = shoot_case(
        "shoot_legs f64", shoot_ops.shoot_legs, shoot_ops.shoot_legs_reference,
        (trial, tg, sp64, 1.0, 20), rel_rows, SHOOT_TOL["legs_f64"],
        shoot_ops.shoot_legs_ops(trial.shape[0]), PEAK_FLOPS_F64, trial.shape[0], torch.float64,
        mass_err=mass_rel)
    gen = torch.Generator(device=device).manual_seed(31)
    rep = lambda x, k: x.repeat_interleave(k, 0).contiguous()
    tau10 = (rep(theta[:, 64], 10) + 0.01 * torch.randn(L * 10, generator=gen, device=device,
                                                         dtype=torch.float64)).clamp(0, 1)
    len10 = (rep(theta[:, 65], 10) + 0.1 * torch.randn(L * 10, generator=gen, device=device,
                                                        dtype=torch.float64)).clamp(5, 11)
    d64_10 = tuple(rep(x, 10) for x in d64)
    cases["target_f64"] = shoot_case(
        "manifold_target f64", shoot_ops.manifold_target, shoot_ops.manifold_target_reference,
        (*d64_10, tau10, len10), abs_rows, SHOOT_TOL["target_f64"], shoot_ops.manifold_target_ops(L * 10, torch.float64),
        PEAK_FLOPS_F64, L * 10, torch.float64)
    # float32 ladder trials: 8 variants a lane, their targets, the whole
    # forward arc of every lane, and the Jacobian at every lane
    d32_8 = tuple(rep(x, 8) for x in d32)
    th8 = solver_gpu._clamp_vars(
        rep(th32, 8) + 1e-3 * torch.randn(L * 8, 66, generator=gen, device=device), 20, 40.0,
        15.0)
    cases["target_f32"] = shoot_case(
        "manifold_target f32", shoot_ops.manifold_target, shoot_ops.manifold_target_reference,
        (*d32_8, th8[:, 64].contiguous(), th8[:, 65].contiguous()), abs_rows,
        SHOOT_TOL["target_f32"],
        shoot_ops.manifold_target_ops(L * 8, torch.float32), PEAK_FLOPS[torch.float32], L * 8,
        torch.float32)
    tgt8 = shoot_ops.manifold_target(*d32_8, th8[:, 64].contiguous(), th8[:, 65].contiguous())
    cases["legs_f32"] = shoot_case(
        "shoot_legs f32", shoot_ops.shoot_legs, shoot_ops.shoot_legs_reference,
        (th8, tgt8, sp32, 1.0, 20), rel_rows, SHOOT_TOL["legs_f32"],
        shoot_ops.shoot_legs_ops(L * 8), PEAK_FLOPS[torch.float32], L * 8, torch.float32,
        mass_err=mass_rel)
    cases["arc_f32"] = shoot_case(
        "shoot_legs f32 whole arc", lambda *a: shoot_ops.shoot_legs(*a, full=True),
        lambda *a: shoot_ops.shoot_legs_reference(*a, full=True), (th32, None, sp32, 1.0, 20),
        rel_rows, SHOOT_TOL["arc_f32"], shoot_ops.shoot_legs_ops(L), PEAK_FLOPS[torch.float32],
        L, torch.float32, mass_err=mass_rel)
    tgt32 = shoot_ops.manifold_target(*d32, th32[:, 64].contiguous(), th32[:, 65].contiguous())

    cases["jvp_f32"] = shoot_case(
        "shoot_jvp f32", shoot_ops.shoot_jvp, shoot_ops.shoot_jvp_reference,
        (th32, tgt32, *d32, sp32, 1.0, 20, 5.0, 11.0), jvp_rows, SHOOT_TOL["jvp_f32"],
        shoot_ops.shoot_jvp_ops(L), PEAK_FLOPS[torch.float32], L, torch.float32)
    for c in cases.values():
        print(json.dumps({"shoot_case": c}), flush=True)
    cases["chain"] = chain_case(
        {"f64": ((*d64_10, tau10, len10), (1, L, L * 10)),
         "f32": ((*d32_8, th8[:, 64].contiguous(), th8[:, 65].contiguous()), (1, L, L * 8))},
        (th32, tgt32, *d32), (sp32, 1.0, 20, 5.0, 11.0), (1, 33))
    print(json.dumps({"shoot_chain": cases["chain"]}), flush=True)
    return cases


def chain_case(targets, jvp_args, jvp_tail, jvp_lanes) -> dict:
    """The manifold chain by width: ``manifold_target`` cold at each row
    count of ``targets`` (dtype tag -> (arguments, row counts)), 1 row being
    the chain's own time, and ``shoot_jvp`` at each of ``jvp_lanes``; the
    first rows and a slice from the middle launched alone equal the same
    rows of the full launch bit for bit (a row's result does not depend on
    its launch); the lanes a row and each kernel's registers as built."""
    out = {"lanes_a_row": {str(k).replace("torch.", ""): v for k, v in shoot_ops.LANES.items()},
           "manifold_target_ms": {}, "shoot_jvp_ms": {}}
    for tag, (args, rows) in targets.items():
        full = shoot_ops.manifold_target(*args)
        for m in rows:
            k = (len(full) - m) // 2
            mid = tuple(a[k:k + m].contiguous() for a in args)
            check(torch.equal(shoot_ops.manifold_target(*mid), full[k:k + m]),
                  f"manifold_target {tag}: rows {k}..{k + m} alone differ from the full launch")
            part = tuple(a[:m].contiguous() for a in args)
            out["manifold_target_ms"][f"{tag} {m} rows"] = time_cold(
                lambda: shoot_ops.manifold_target(*part))
    full = shoot_ops.shoot_jvp(*jvp_args, *jvp_tail)
    for n in jvp_lanes:
        k = (len(full) - n) // 2
        mid = tuple(a[k:k + n].contiguous() for a in jvp_args)
        check(torch.equal(shoot_ops.shoot_jvp(*mid, *jvp_tail), full[k:k + n]),
              f"shoot_jvp: lanes {k}..{k + n} alone differ from the full launch")
        part = tuple(a[:n].contiguous() for a in jvp_args)
        out["shoot_jvp_ms"][f"{n} lanes"] = time_cold(lambda: shoot_ops.shoot_jvp(*part, *jvp_tail))
    with open(_build.library_path("cr3bp_shoot")[:-3] + ".log") as f:
        out["registers"] = shoot_chain_lib.registers(f.read())
    return out


def oracle_gpu_phase(native_feasible) -> dict:
    """``refine_warmstarts_gpu`` grades the 1024 round-2 physical samples at
    8 basin hops, optimal mode: float64 (precision df32) against the JAX
    package's df32 record and lane by lane against the native oracle of
    this call; then float32, hybrid and the defect check."""
    physical = np.load(ROUND2_PHYSICAL)
    G, H = physical[:, 1:], physical[:, 0]
    n = len(physical)
    out = {}
    for f in SHOOT_KERNELS:
        f.launches = 0
    t0 = time.perf_counter()
    res = solver_gpu.refine_warmstarts_gpu(G, H, mbh_rounds=8, solver_mode="optimal",
                                           precision="df32")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in SHOOT_KERNELS}
    feasible, optimal = int(res["feasible"].sum()), int(res["optimal"].sum())
    agree = float((res["feasible"] == native_feasible).mean())
    out["f64"] = dict(feasible=feasible, optimal=optimal, agreement_with_native=agree,
                      wall_s=wall, s_per_sample=wall / n,
                      mean_iters=float(np.mean(res["iters"])),
                      mean_final_mass_feasible=float(res["final_mass"][res["feasible"]].mean()),
                      launches=launches)
    check(all(v > 0 for v in launches.values()),
          f"the f64 grading did not launch every shooting kernel: {launches}")
    check(abs(feasible - SOLVER_FEASIBLE) <= SOLVER_FEASIBLE_SLACK,
          f"GPU solver f64: {feasible} feasible, the JAX package's df32 {SOLVER_FEASIBLE}")
    check(abs(optimal - SOLVER_OPTIMAL) <= SOLVER_OPTIMAL_SLACK,
          f"GPU solver f64: {optimal} optimal, the JAX package's df32 {SOLVER_OPTIMAL}")
    check(agree >= SOLVER_AGREEMENT_MIN,
          f"GPU solver f64: feasibility agrees with the native oracle on {agree} of lanes")

    for f in SHOOT_KERNELS:
        f.launches = 0
    t0 = time.perf_counter()
    r32 = solver_gpu.refine_warmstarts_gpu(G, H, mbh_rounds=8, solver_mode="optimal",
                                           precision="f32")
    torch.cuda.synchronize()
    out["f32"] = dict(feasible=int(r32["feasible"].sum()), optimal=int(r32["optimal"].sum()),
                      wall_s=time.perf_counter() - t0, mean_iters=float(np.mean(r32["iters"])),
                      jax_f32_feasible=SOLVER_F32_JAX,
                      launches={f.__name__: f.launches for f in SHOOT_KERNELS})
    t0 = time.perf_counter()
    hyb = oracle_lib.evaluate_warmstarts_hybrid(G, H, mbh_rounds=8, solver_mode="optimal")
    out["hybrid"] = dict(feasible=int(hyb["feasible"].sum()), optimal=int(hyb["optimal"].sum()),
                         wall_s=time.perf_counter() - t0)
    check(out["hybrid"]["feasible"] >= out["f32"]["feasible"],
          f"hybrid {out['hybrid']['feasible']} feasible < f32 {out['f32']['feasible']}")
    t0 = time.perf_counter()
    dft = oracle_lib.evaluate_warmstarts(G.astype(np.float32), H.astype(np.float32))
    tiers = {str(k): int(v) for k, v in zip(*np.unique(dft["inform"], return_counts=True))}
    check(bool(np.isfinite(dft["cost"]).all()) and sum(tiers.values()) == n,
          f"defect check: {tiers}")
    out["defect_check"] = dict(tiers=tiers, wall_s=time.perf_counter() - t0,
                               median_defect=float(np.median(dft["cost"])))
    bench = GTOHaloBenchmarker.__new__(GTOHaloBenchmarker)
    bench.config = GTOHaloBenchmarkConfig(model_path="")
    out["auto_backend"] = bench.oracle_backend()
    check(out["auto_backend"] == "hybrid", f"the automatic backend is {out['auto_backend']}")
    return out, res


def run_benchmark_phase() -> dict:
    """``python -m rdm_tpu_torch.run_benchmark`` on the flagship with the ODE
    sampler and the native oracle, into a temporary directory."""
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=ROOT)
        cmd = [sys.executable, "-m", "rdm_tpu_torch.run_benchmark",
               "--model_path", os.path.relpath(FLAGSHIP_RUN, ROOT), "--benchmark_type", "both",
               "--num_samples", "1024", "--batch_size", "1024", "--sampling_method", "ode",
               "--oracle_backend", "tpu", "--output_dir", out]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=900)
        check(proc.returncode == 0, f"run_benchmark failed:\n{proc.stderr[-3000:]}")
        for sub, name in (("ml_statistics", "ml_statistics_results.json"),
                          ("ml_statistics", "summary.txt"), ("gto_halo", "gto_halo_results.json"),
                          ("gto_halo", "summary.txt")):
            check(os.path.exists(os.path.join(out, sub, name)), f"run_benchmark wrote no {sub}/{name}")
        with open(os.path.join(out, "ml_statistics", "ml_statistics_results.json")) as f:
            ml = json.load(f)
        with open(os.path.join(out, "gto_halo", "gto_halo_results.json")) as f:
            gto = json.load(f)
    metrics, pv = gto["gto_halo_metrics"], gto["physical_validation"]
    check("standard_metrics" in ml, "run_benchmark computed no ML statistics")
    check(not metrics["has_nan"] and not metrics["has_inf"], "run_benchmark samples have NaN/inf")
    check(pv["oracle_backend"] == "tpu" and pv["total_tested"] == 1024
          and pv["oracle_grading_precision"] == "f64",
          f"run_benchmark graded {pv['total_tested']} samples with {pv['oracle_backend']}")
    check(pv["feasible_ratio"] >= ODE_FEASIBLE_MIN,
          f"feasible ratio {pv['feasible_ratio']} < {ODE_FEASIBLE_MIN}")
    return dict(ml_standard_metrics=ml["standard_metrics"],
                feasible_ratio=pv["feasible_ratio"], feasible_min=ODE_FEASIBLE_MIN,
                local_optimal_ratio=pv["local_optimal_ratio"],
                avg_final_mass_feasible=pv["avg_final_mass_feasible"],
                ml_sampling_s=ml["sampling_efficiency"]["total_sampling_time"],
                gto_sampling_s=gto["sampling_efficiency"]["total_sampling_time"],
                oracle_s=pv["oracle_wall_time_with_compile_s"], host_cores=os.cpu_count(),
                gto_halo_metrics=metrics)


def with_precision(cfg, precision):
    plain = cfg.to_plain()
    plain["model"]["precision"] = precision
    return ConfigDict.wrap(plain)


SUPERVISOR = os.path.join(ROOT, "rdm_tpu_torch", "launch", "train_with_resume.sh")


def run_train_phase(launcher=(), supervised=False) -> dict:
    """The training CLI on the card, from a temporary working directory,
    started by ``launcher`` (a torchrun command line), through the stall
    supervisor ``rdm_tpu_torch/launch/train_with_resume.sh`` (``supervised``)
    or as one process."""
    pkl = os.path.join(ROOT, "datasets", "training_data_boundary_80073.pkl")
    args = ["model.precision=bfloat16", "model.attn_pallas=true", f"data.pkl_path={pkl}",
            "data.gto_mean=0", "data.gto_std=1", "training.n_iters=3",
            "training.snapshot_freq=3", "training.eval_freq=1000", "training.log_freq=1",
            "training.snapshot_freq_for_preemption=1000", "sde.num_scales=100",
            "eval.batch_size=4096"]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=ROOT, PYTHON=sys.executable)
        command = (["bash", SUPERVISOR] if supervised else
                   [sys.executable, *launcher, "-m", "rdm_tpu_torch.run_train"])
        proc = subprocess.run([*command, *args], cwd=tmp, env=env, capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0, f"run_train failed:\n{proc.stderr[-3000:]}")
        supervisor = [ln for ln in proc.stdout.splitlines() if "[train_with_resume]" in ln]
        check(not supervised or supervisor == [
            "[train_with_resume] completed after 0 restart(s)"],
            f"the supervisor said {supervisor}")
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
    check(sample.dtype == np.uint8 and sample.shape == (4096, 9, 9, 1),
          f"snapshot samples {sample.dtype} {sample.shape}")
    return {"steps": steps, "eval_lines": len(evals), "checkpoint_step": ck.step,
            "sample_shape": list(sample.shape), "sample_min": int(sample.min()),
            "sample_max": int(sample.max()),
            **({"supervisor": SUPERVISOR[len(ROOT) + 1:], "supervisor_lines": supervisor}
               if supervised else {})}


# ---------------------------------------------------------------------------
# data parallelism: ranks on the card against one process

# torchrun with one process: the run_train phase's CLI under the launcher (NCCL)
TORCHRUN_1 = ("-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1")
DP_SPEC = {"run": FLAGSHIP_RUN, "batch": 4096, "batch_seed": 11, "draw_seed": 12,
           "deterministic": True, "allow_tf32": False}
DP_TIMED_STEPS = 5


def dp_ranks(argv, local_ranks, timeout=300):
    """``python -m rdm_tpu_torch.benchmark.dp_check *argv`` as one rank per
    entry of ``local_ranks`` (the card each uses)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return dp_launch.run_ranks(["-m", "rdm_tpu_torch.benchmark.dp_check", *argv],
                               len(local_ranks), local_ranks=local_ranks, env=env,
                               timeout=timeout)


def step_results_equal(a, b) -> bool:
    return a["loss"] == b["loss"] and all(
        all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
        for k in ("grads", "params", "mu", "nu", "shadow"))


def one_process_dp_step(device, fields=None):
    """One ``make_train_step`` step of DP_SPEC on the whole batch in this
    process (cuDNN's deterministic algorithms, so two runs agree bit for
    bit), with the attention kernels' launches in it."""
    cfg, state, batch, labels, t, z, draws = dp_check.load_step_spec(DP_SPEC, device)
    torch.backends.cudnn.deterministic = True
    try:
        attn_ops.fused_attn_block.launches = attn_ops.fused_attn_block_bwd.launches = 0
        loss, grads = dp_check.train_step_rows(cfg, state, batch, labels, t, z, draws,
                                               slice(None))
        torch.cuda.synchronize()
        res = dp_check.step_result(state, loss, grads, attn_ops.fused_attn_block.launches,
                                   attn_ops.fused_attn_block_bwd.launches)
    finally:
        torch.backends.cudnn.deterministic = False
    return cfg, state, res


def dp_grad_rule(ranked, one, yardstick) -> dict:
    """Phase train's kernel-against-plain rule for the ranks' averaged
    gradient against one process's: as one vector within half the bf16-f32
    spread, each parameter within its own bf16-f32 distance (a k bias within
    its block's q bias's)."""
    names = yardstick["names"]
    flat = lambda gs: torch.cat([g.flatten() for g in gs])
    diff = float((flat(ranked["grads"]) - flat(one["grads"])).norm())
    per = {n: float((a - b).norm()) for a, b, n in zip(ranked["grads"], one["grads"], names)}
    pf, kbias = yardstick["per_param"], yardstick["kbias"]
    ratios = sorted(((per[n] / max(pf[kbias.get(n, n)], 1e-30), n) for n in names),
                    reverse=True)
    params_diff = max(float((a - b).abs().max()) for a, b in zip(ranked["params"],
                                                                 one["params"]))
    return {"grad_diff": diff, "grad_spread_bf16_f32": yardstick["spread"],
            "grad_ratio": diff / yardstick["spread"], "worst_param_ratios": ratios[:4],
            "loss": ranked["loss"], "loss_one_process": one["loss"],
            "param_max_abs_diff": params_diff,
            "ok": (diff <= 0.5 * yardstick["spread"] and ratios[0][0] <= 1.0
                   and abs(ranked["loss"] - one["loss"]) <= BF16_STEP / 2 * abs(one["loss"]))}


def dp_two_ranks(tmp, local_ranks, backend, one, yardstick, tag) -> dict:
    """DP_SPEC's step in two ranks on ``local_ranks``' cards over
    ``backend``: both ranks bit for bit alike, each launching 5 + 5
    attention kernels, and phase train's rule against one process."""
    spec_path = os.path.join(tmp, "spec.pt")
    out_dir = os.path.join(tmp, tag)
    os.makedirs(out_dir)
    torch.save(DP_SPEC, spec_path)
    dp_ranks(["step", spec_path, out_dir, "--backend", backend,
              "--time_steps", str(DP_TIMED_STEPS)], local_ranks)
    r0, r1 = (torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
              for r in range(2))
    same = step_results_equal(r0, r1)
    check(same, f"dp_train {tag}: the two ranks' states differ after the step")
    check(all(r["fwd_launches"] == ATTN_BLOCKS_PER_FORWARD
              and r["bwd_launches"] == ATTN_BLOCKS_PER_FORWARD for r in (r0, r1)),
          f"dp_train {tag}: attention launches {[(r['fwd_launches'], r['bwd_launches']) for r in (r0, r1)]}")
    rule = dp_grad_rule(r0, one, yardstick)
    check(rule["ok"], f"dp_train {tag}: against one process {rule}")
    return {"backend": r0["backend"], "devices": [r0["device"], r1["device"]],
            "ranks_bit_equal": same, "rows_per_rank": DP_SPEC["batch"] // 2,
            "launches": [[r["fwd_launches"], r["bwd_launches"]] for r in (r0, r1)],
            "count": r0["count"], "ms_per_step": r0["ms_per_step"], **rule}


def dp_train_phase(device, train, yardstick) -> dict:
    """The flagship's training step from checkpoint_10.pth on phase train's
    batch (4096 rows, t, z and masks) in one process, under a process group
    of one (NCCL), and in two ranks; see the module's docstring."""
    cfg, _, one = one_process_dp_step(device)
    # the same gradients as phase train's kernel run of that step, recomputed
    # with phase train's own function under the deterministic algorithms
    _, state0, images, labels = load_training_run(FLAGSHIP_RUN, device)
    idx = torch.randint(0, images.shape[0], (DP_SPEC["batch"],), device=device,
                        generator=torch.Generator(device=device).manual_seed(11))
    torch.backends.cudnn.deterministic = True
    try:
        loss_t, g_t = loss_and_grads(cfg, state0.model, images[idx], labels[idx], seed=12)
    finally:
        torch.backends.cudnn.deterministic = False
    del state0, images, labels
    same_as_train = loss_t == one["loss"] and all(
        torch.equal(a.cpu(), b) for a, b in zip(g_t, one["grads"]))
    check(same_as_train, "the one-process DP step's gradients differ from phase train's "
                         "loss_and_grads on the same batch, t, z and masks")
    check(one["fwd_launches"] == ATTN_BLOCKS_PER_FORWARD
          and one["bwd_launches"] == ATTN_BLOCKS_PER_FORWARD,
          f"one-process step launched {one['fwd_launches']} + {one['bwd_launches']}")
    out = {"batch": DP_SPEC["batch"], "one_process": {
        "loss": one["loss"], "launches": [one["fwd_launches"], one["bwd_launches"]],
        "grads_equal_phase_train": same_as_train}}

    # (i) a process group of one on NCCL: the step is today's, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            check(dp_mesh.world_size() == 1 and dist.get_backend() == "nccl",
                  "dp_train (i): no NCCL group of one")
            cfg, state, res = one_process_dp_step(device)
            same = step_results_equal(res, one)
            check(same, "dp_train (i): the NCCL world of one changed the step")
            ms = dp_check.ms_per_step(cfg, state, DP_SPEC["batch"], TRAIN_STEPS)
        finally:
            dist.destroy_process_group()
        del state
    out["nccl_world_1"] = {"bit_equal_one_process": same,
                           "launches": [res["fwd_launches"], res["bwd_launches"]],
                           "ms_per_step": ms, "steps_timed": TRAIN_STEPS,
                           "train_phase_ms_per_step": train["ms_per_step"]}

    # (ii) two ranks on this card over gloo (time-sliced; a correctness path)
    with tempfile.TemporaryDirectory() as tmp:
        out["gloo_2_ranks_1_card"] = dp_two_ranks(tmp, [0, 0], "gloo", one, yardstick,
                                                  "gloo_1_card")
        out["gloo_2_ranks_1_card"]["timing"] = (
            f"{DP_TIMED_STEPS} steps of 2048 rows a rank, the two ranks time-sliced on one "
            "card, gradients through the host: not a speed figure")
        # (iii) one rank a card over NCCL, when there are two cards
        if torch.cuda.device_count() >= 2:
            out["nccl_2_cards"] = dp_two_ranks(tmp, [0, 1], "nccl", one, yardstick,
                                               "nccl_2_cards")
        else:
            print("dp_train (iii): not run, this machine has one card (NCCL over two "
                  "cards needs two)", flush=True)
            out["nccl_2_cards"] = None
    return out


def dp_sample_phase(flag) -> dict:
    """Two ranks on the card sample 512 trajectories each from the flagship's
    EMA weights (1000 steps, w = 0, a seed a rank); the 1024 gathered on
    rank 0 lie in the unit cube and within KS 0.11 of the JAX package's."""
    n = 512
    with tempfile.TemporaryDirectory() as tmp:
        dp_ranks(["sample", FLAGSHIP_RUN, str(n), tmp, "--backend", "gloo"], [0, 0])
        samples = np.load(os.path.join(tmp, "samples.npy"))
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    check(samples.shape == (2 * n, 67) and bool(np.isfinite(samples).all()),
          f"dp_sample: gathered {samples.shape}")
    check(float(samples.min()) >= 0.0 and float(samples.max()) <= 1.0,
          "dp_sample: samples leave the unit cube")
    check(not np.array_equal(samples[:n], samples[n:]), "dp_sample: the ranks drew alike")
    steps = ranks[0]["steps"] - 1
    check(all(r["launches"] == ATTN_BLOCKS_PER_FORWARD * steps for r in ranks),
          f"dp_sample: launches {[r['launches'] for r in ranks]}")
    ref = np.load(JAX_SAMPLES).reshape(-1, 67)
    ks = np.array([ks_statistic(samples[:, d], ref[:, d]) for d in range(67)])
    check(float(ks.max()) < KS_LIMIT, f"dp_sample: max per-dimension KS {ks.max()}")
    slowest = ranks[0]["slowest_wall_s"]
    return {"n": int(samples.shape[0]), "per_rank": n, "launches": [r["launches"] for r in ranks],
            "ks_max": float(ks.max()), "ks_argmax": int(ks.argmax()), "ks_limit": KS_LIMIT,
            "wall_s": [r["wall_s"] for r in ranks], "slowest_wall_s": slowest,
            "trajectories_per_second": samples.shape[0] / slowest,
            "one_process_trajectories_per_second": flag["trajectories_per_second"],
            "timing": "two ranks time-sliced on one card: not a speed figure"}


def dp_oracle_phase(gpu_res, gpu_wall) -> dict:
    """The float64 grading of phase oracle_gpu (8 hops, optimal mode) with
    each tile split over [cuda:0, cuda:0] (a thread a part): the result
    equals phase oracle_gpu's, lane for lane; with two cards also over
    [cuda:0, cuda:1]."""
    physical = np.load(ROUND2_PHYSICAL)
    G, H = physical[:, 1:], physical[:, 0]
    out = {"one_card_wall_s": gpu_wall}
    splits = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() >= 2:
        splits.append(["cuda:0", "cuda:1"])
    else:
        print("dp_oracle: [cuda:0, cuda:1] not run, this machine has one card", flush=True)
    for devices in splits:
        for f in SHOOT_KERNELS:
            f.launches = 0
        t0 = time.perf_counter()
        res = solver_gpu.refine_warmstarts_gpu(G, H, mbh_rounds=8, solver_mode="optimal",
                                               precision="df32", device=devices)
        for d in set(devices):
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        differ = [k for k in gpu_res if not np.array_equal(np.asarray(res[k]),
                                                           np.asarray(gpu_res[k]))]
        check(not differ, f"dp_oracle over {devices}: {differ} differ from phase oracle_gpu's")
        out["+".join(devices)] = {
            "lane_for_lane_equal": True, "wall_s": wall, "feasible": int(res["feasible"].sum()),
            "optimal": int(res["optimal"].sum()),
            "launches": {f.__name__: f.launches for f in SHOOT_KERNELS}}
    return out


def resblock_routing_phase(device) -> dict:
    """An nf-32 NCSN++ with both kernels on, bfloat16: every resblock keeps
    the kernel when the model is built (the tiled body takes its shapes) and
    every attention block too (C 32, L 81); one forward on the card launches
    the resblock kernel 17 times and the attention kernel 5 times, all
    through the tiled bodies."""
    cfg = load_config("train", ["model.nf=32", "model.precision=bfloat16",
                                "model.resblock_pallas=true", "model.attn_pallas=true"])
    model = create_model(cfg).init_weights(torch.Generator().manual_seed(0))
    model.to(device).eval().requires_grad_(False)
    blocks = [m for m in model.modules() if isinstance(m, ResnetBlockDDPMpp)]
    attn = [m for m in model.modules() if isinstance(m, AttnBlockpp)]
    check(len(blocks) == RESBLOCKS_PER_FORWARD
          and all(b.use_kernel and b.fused_forward is rb_ops.fused_resblock for b in blocks)
          and len(attn) == NF32_ATTN_BLOCKS and all(m.use_kernel for m in attn),
          "nf-32 blocks are not all routed to their kernels")
    gen = torch.Generator(device=device).manual_seed(50)
    x = torch.rand((64, 1, 9, 9), generator=gen, device=device)
    sigma = torch.exp(torch.empty(64, device=device).uniform_(math.log(0.01), math.log(5.0),
                                                              generator=gen))
    labels = torch.rand((64, 1), generator=gen, device=device)
    zero_tiled_launches()
    with torch.no_grad():
        out = model(x, sigma, labels)
    torch.cuda.synchronize()
    launches = tiled_launch_counts()
    check(out.shape == (64, 1, 9, 9) and bool(torch.isfinite(out.float()).all()),
          "nf-32 forward output")
    check(launches["fused_resblock"] == launches["fused_resblock_tiled"] == RESBLOCKS_PER_FORWARD
          and launches["fused_attn_block"] == launches["fused_attn_block_tiled"]
          == NF32_ATTN_BLOCKS, f"nf-32 forward launches {launches}")
    return {"nf": 32, "batch": 64, "resblocks_on_kernel": len(blocks),
            "attention_blocks_on_kernel": len(attn), "launches": launches,
            "out_abs_max": float(out.float().abs().max())}


# ---------------------------------------------------------------------------
# channels-first microbenchmark kernels (csrc/micro_cf.cu)

MICRO_TB = 256
MICRO_C = 64


def bf16_ulp(t):
    """One bfloat16 step at each element's magnitude (float32 tensor in)."""
    mag = t.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def micro_cf_cases(device) -> dict:
    """Each kernel of csrc/micro_cf.cu against its plain version on the same
    seeded inputs at the TPU script's shapes, and the plain versions' cold
    times (inputs rotating over more than twice the L2, as the script's)."""
    C, N = MICRO_C, micro_cf.L_TOKENS * MICRO_TB
    rnd, cold_us = micro_cf_script.randn, micro_cf_script.cold_us
    floor = micro_cf_script.copy_floor_us(2 * 2 * C * N, device)
    out = {}
    for key, shape in (("transpose_nc_to_cn", (N, C)), ("transpose_cn_to_nc", (C, N))):
        x = rnd(shape, 40, device)
        y, ref = micro_cf.cf_transpose(x), micro_cf.cf_transpose_reference(x)
        torch.cuda.synchronize()
        check(torch.equal(y, ref), f"{key}: the kernel differs from its plain version")
        out[key] = {"shape": list(shape), "max_abs_err": float((y.float() - ref.float()).abs().max()),
                    "tol": 0.0, "plan": micro_cf.transpose_plan(*shape)._asdict(),
                    "plain_cold_us": cold_us(micro_cf.cf_transpose_reference,
                                             lambda i: rnd(shape, 41 + i, device), 2 * C * N, device),
                    "copy_floor_us": floor}
    x = rnd((C, N), 42, device)
    y, ref = micro_cf.cf_masked_roll_sum(x), micro_cf.cf_masked_roll_sum_reference(x)
    conv = micro_cf_script.roll_sum_conv1d(x)
    lib = conv(x).float()
    torch.cuda.synchronize()
    check(torch.equal(y.view(torch.int16), ref.view(torch.int16)),
          "roll sum: the kernel differs from its plain version")
    # The library yardstick sums the same n = 8 exact terms in another order
    # and rounds once: within one bf16 step plus the float32 allowance
    # 2 n u sum|terms| <= 2 n u n max|x|.
    n = len(micro_cf.SHIFTS)
    allow = 2 * n * 2.0 ** -24 * n * x.float().abs().max()
    lib_err = (lib - ref.float()).abs()
    check(bool((lib_err <= bf16_ulp(ref.float()) + allow).all()),
          f"roll sum: F.conv1d differs from the plain version by {float(lib_err.max())}")
    make = lambda i: rnd((C, N), 43 + i, device)
    out["roll"] = {"shape": [C, N], "max_abs_err": float((y.float() - ref.float()).abs().max()),
                   "tol": 0.0, "body": micro_cf.roll_sum_body(micro_cf.L_TOKENS, micro_cf.SHIFTS),
                   "plan": micro_cf.roll_sum_plan(C, N)._asdict(), "copy_floor_us": floor,
                   "plain_cold_us": cold_us(micro_cf.cf_masked_roll_sum_reference, make,
                                            2 * C * N, device),
                   "library": "F.conv1d", "library_cold_us": cold_us(conv, make, 2 * C * N, device),
                   "library_max_abs_err": float(lib_err.max()),
                   "library_bit_equal_share": float((lib == ref.float()).float().mean())}
    check(out["roll"]["body"] == "script", f"roll sum: the script's table took {out['roll']['body']}")
    second = (-16, -3, 2, 16)
    y = micro_cf.cf_masked_roll_sum(x, micro_cf.L_TOKENS, second)
    ref = micro_cf.cf_masked_roll_sum_reference(x, micro_cf.L_TOKENS, second)
    torch.cuda.synchronize()
    check(torch.equal(y.view(torch.int16), ref.view(torch.int16)),
          "roll sum, second table: the kernel differs from its plain version")
    out["roll_second_table"] = {"shape": [C, N], "shifts": list(second), "tol": 0.0,
                                "body": micro_cf.roll_sum_body(micro_cf.L_TOKENS, second),
                                "max_abs_err": float((y.float() - ref.float()).abs().max())}
    # the script's N (324 tiles: 2 or 3 a block), then more than 3 tiles a
    # block with a ragged last tile, and 10 or 11 tiles a block (ring stages
    # reused often)
    edges = (64 * 132 * 3 + 8, 64 * 132 * 10 + 8)
    for K, n in [(C, N), (3 * C, N)] + [(k, n) for n in edges for k in (C, 3 * C)]:
        taps = micro_cf.dots_taps(C, K)
        w, x = rnd((taps, C, K), 44, device), rnd((K, n), 45, device)
        y = micro_cf.cf_dots(w, x, K).float()
        ref = micro_cf.cf_dots_reference(w, x, K).float()
        torch.cuda.synchronize()
        # Both sum the same exact float32 products in another order and round
        # once: within one bf16 step at each element, plus the float32
        # allowance of two sums of n = taps * K terms (2 n u sum |terms|,
        # u = 2^-24), about a tenth of a step for a typical element.
        allow = 2 * taps * K * 2.0 ** -24 * (w.float().abs().sum(0) @ x.float().abs())
        err = (y - ref).abs()
        ulp = bf16_ulp(ref)
        res = {"K": K, "taps": taps, "shape": [C, n], "max_abs_err": float(err.max()),
               "max_err_bf16_steps": float((err / ulp).max()),
               "bit_equal_share": float((y == ref).float().mean()),
               "tol": "one bf16 step at each element + 2 n u sum|terms|"}
        check(bool(torch.isfinite(y).all()) and bool((err <= ulp + allow).all()),
              f"dots: the kernel differs from its plain version {res}")
        if n != N:
            out[f"dots_k{K}_n{n}"] = res
            continue
        res["plain_cold_us"] = cold_us(lambda xx: micro_cf.cf_dots_reference(w, xx, K),
                                       lambda i: rnd((K, N), 46 + i, device), 2 * K * N, device)
        res["copy_floor_us"] = micro_cf_script.copy_floor_us(2 * (taps * C * K + K * N + C * N),
                                                             device)
        out[f"dots_k{K}"] = res
    return out


def micro_cf_entry(name, source_line, mcf, wrapper, case, timing):
    """One entry of the kernels line for a kernel of csrc/micro_cf.cu: ms is
    the cold time (inputs out of L2), the one compared with the bound;
    launches is the wrapper's count in the script's run (a call captured
    into a CUDA graph counts once), kernel_runs what the card ran (each
    captured call once per replay)."""
    return {"name": name, "route": "cuda", "source": "rdm_tpu_torch/csrc/micro_cf.cu",
            "replaces": f"scripts/micro_pallas_cf.py:{source_line}",
            "launches": mcf["launches"][wrapper], "kernel_runs": mcf["kernel_runs"][wrapper],
            "launches_note": "a call captured into a CUDA graph counts once; kernel_runs "
                             "counts each replay",
            "max_abs_err": case["max_abs_err"], "ms": timing["cold_us"] / 1e3,
            "plain_ms": case["plain_cold_us"] / 1e3, "bound_ms": timing["bound_us"] / 1e3,
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_us"] / 1e3,
            "copy_floor_ms": timing["copy_floor_us"] / 1e3,
            "chained_ms": timing["chained_us"] / 1e3,
            "share_of_bound": timing["bound_us"] / timing["cold_us"],
            "path": "python -m rdm_tpu_torch.scripts.micro_cf (in process)",
            "shape": f"C=64 N={micro_cf.L_TOKENS * MICRO_TB} bfloat16"}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# data generation on the card

GEN_SEEDS = 4096          # phase datagen: seeds of the uniform guesses
GEN_COMPARE = 256         # of them, solved in float64 on the card too
# The JAX package's float32 verdicts on the same GEN_SEEDS uniform guesses:
# the seeds refine_warmstarts_tpu finds feasible at its defaults (float32,
# tol 1e-3, 30 LM iterations, optimal mode), run on the CPU in tiles of
# 1024; tests/test_torch_datagen_uniform.py::test_jax_float32_feasible_seeds
# recomputes them.  A float32 solve from a uniform guess stalls above the
# tolerance where a float64 one converges, so it finds a small share of the
# seeds the native oracle finds (20 of its 387 in that run),
# and which ones its rounding decides: the JAX package's own verdict on a
# seed can change with its tile size.  The card's float32 verdicts are held
# to that share: their recall of the native oracle's feasible seeds, no
# lower than the JAX package's on the same seeds less three binomial
# standard errors.  The same first GEN_COMPARE guesses solved in float64 on
# the card are held per lane to phase oracle_gpu's rule.
JAX_F32_FEASIBLE = (
    111, 334, 348, 350, 358, 443, 467, 518, 637, 705, 846, 932, 1020, 1032, 1162, 1575, 1618,
    1758, 1875, 1884, 1962, 1998, 2186, 2192, 2199, 2207, 2302, 2322, 2392, 2408, 2804, 3006,
    3056, 3365, 3433, 3505, 3667, 3713, 3753, 3809, 3835, 4082)
FLEET_GRADED = 256        # phase datagen_fleet: state rows re-graded in float64


def run_module(args, cwd, timeout) -> str:
    """``python -m *args`` from ``cwd`` with the repository on the path; its
    standard output."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)
    check(proc.returncode == 0,
          f"{args[0]} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def f64_defect(rows, energies):
    """The float64 defect check of solved rows (halo phase as a fraction):
    the defect (the residual norm before any iteration, in float64 on the
    card) and whether it lies in the defect check's feasible tier.  That
    tier (_DEFECT_TOL_LOOSE, 0.15) is the only bar the rows are held to: a
    float32 solve stops at a float32 residual below the feasibility
    tolerance (_FEAS_TOL, 1e-3), and on sensitive lanes its float64 residual
    lies well above that.  defect_shares says how far."""
    cost = solver_gpu.refine_warmstarts_gpu(rows, np.asarray(energies, np.float64), max_iters=0,
                                            solver_mode="feasible", precision="f64")["cost"]
    return cost, cost < oracle_lib._DEFECT_TOL_LOOSE


def defect_shares(cost) -> dict:
    """The share of rows whose float64 defect lies below the feasibility
    tolerance, below 1e-2 (the float32 residual's distance from the float64
    one on benign lanes, PR 13's float32 tests), below the defect check's
    tight tier and below its feasible tier."""
    return {f"below_{name}": float((cost < bound).mean()) for name, bound in (
        ("feas_tol_1e-3", oracle_lib._FEAS_TOL), ("1e-2", 1e-2),
        ("tight_tier_0.05", oracle_lib._DEFECT_TOL_TIGHT),
        ("feasible_tier_0.15", oracle_lib._DEFECT_TOL_LOOSE))}


def datagen_phase() -> dict:
    """``python -m rdm_tpu_torch.generate_data --backend tpu`` on GEN_SEEDS
    uniform guesses (optimal mode, float32 on the card) as a subprocess, then
    ``prepare_training_data`` on its folder.  A file per feasible seed, so a
    seed's file tells its verdict."""
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "results")
        t = time.perf_counter()
        out = run_module(["rdm_tpu_torch.generate_data", "--backend", "tpu", "--seed", "0",
                          "--seed_step", str(GEN_SEEDS), "--result_folder", folder], tmp, 900)
        wall = time.perf_counter() - t
        done = next(ln for ln in out.splitlines() if ln.startswith("done (tpu, batched)"))
        ms_per_sample = float(re.search(r"\(([\d.]+) ms/sample\)", done).group(1))
        launches = ast.literal_eval(out.split("shooting kernel launches: ")[1].splitlines()[0])
        check(all(v > 0 for v in launches.values()), f"datagen launched {launches}")
        fields = check_datagen_folder(folder, tmp)
    return {"seeds": GEN_SEEDS, "feasible_yield": fields["feasible"] / GEN_SEEDS,
            "ms_per_sample": ms_per_sample, "subprocess_wall_s": wall, "launches": launches,
            **fields}


def check_datagen_folder(folder, tmp) -> dict:
    """The checks of phase datagen on generate_data's folder (a file per
    feasible seed, so a seed's file tells its verdict); the training pickle
    is written to ``tmp``."""
    names = sorted(os.listdir(folder))
    check(len(names) > 0, "datagen found no feasible seed")
    results = {}
    for name in names:
        with open(os.path.join(folder, name), "rb") as f:
            results[name] = pickle.load(f)[0]
    feasible = np.zeros(GEN_SEEDS, bool)
    for name in names:
        feasible[int(name.rsplit("_seed_", 1)[1][:-4])] = True
    check(all(n.startswith("feasible_") and results[n]["feasibility"] for n in names),
          "generate_data wrote a file for an infeasible seed")
    n = datagen.prepare_training_data(folder, tmp)
    with open(os.path.join(tmp, f"training_data_boundary_{n}.pkl"), "rb") as f:
        data = np.asarray(pickle.load(f))

    # against the native oracle on every guess
    gen = datagen.CR3BPInitGenerator("uniform_sample", 1.0, 408, 470, 5.0, 11.0)
    drawn = [gen.get_earth_initial_guess(s, 20, 40.0, 0.0) for s in range(GEN_SEEDS)]
    G = np.stack([g[0] for _, g in drawn])
    H = np.array([e for e, _ in drawn])
    t = time.perf_counter()
    native = evaluate_warmstarts_native(G, H, max_iters=30, solver_mode="optimal")["feasible"]
    native_s = time.perf_counter() - t
    jax_f32 = np.zeros(GEN_SEEDS, bool)
    jax_f32[list(JAX_F32_FEASIBLE)] = True
    n_native = int(native.sum())
    recall = float((feasible & native).sum() / n_native)
    recall_jax = float((jax_f32 & native).sum() / n_native)
    recall_min = recall_jax - 3 * math.sqrt(recall_jax * (1 - recall_jax) / n_native)
    check(recall >= recall_min,
          f"datagen: the float32 verdicts recall {recall} of the native oracle's feasible "
          f"seeds, the JAX package's {recall_jax} (at least {recall_min})")
    # the first GEN_COMPARE guesses solved on the card in float64: phase oracle_gpu's rule
    f64 = solver_gpu.refine_warmstarts_gpu(G[:GEN_COMPARE], H[:GEN_COMPARE], max_iters=30,
                                           solver_mode="optimal", precision="df32")["feasible"]
    agree_f64 = float((native[:GEN_COMPARE] == f64).mean())
    check(agree_f64 >= SOLVER_AGREEMENT_MIN,
          f"datagen: the card's float64 verdicts agree with the native oracle on {agree_f64}")

    # every feasible row, re-graded by the float64 defect check
    rows = np.stack([results[n]["results.control"] for n in names])
    energies = [results[n]["cost_alpha"] for n in names]
    rows[:, -2] /= [datagen.get_halo_period(e) for e in energies]     # TU -> phase fraction
    cost, ok = f64_defect(rows, energies)
    check(bool(ok.all()), f"datagen: {int((~ok).sum())} feasible rows fail the float64 "
                          f"defect check (max defect {float(cost.max())})")

    # the training pickle is normalize_result of the files, in file order
    want = [v for v in (datagen.normalize_result(results[n]) for n in names) if v is not None]
    check(data.shape == (len(want), 67) and n == len(want)
          and np.array_equal(data, np.asarray(want)) and bool(np.isfinite(data).all()),
          f"datagen: training pickle {data.shape} is not the files' normalised rows")
    return {"feasible": len(names), "f32_feasible_seeds": np.flatnonzero(feasible).tolist(),
            "native_s_per_sample_host": native_s / GEN_SEEDS, "native_feasible": n_native,
            "jax_f32_feasible": len(JAX_F32_FEASIBLE),
            "f32_and_jax_f32": int((feasible & jax_f32).sum()),
            "native_recall_f32": recall, "native_recall_jax_f32": recall_jax,
            "native_recall_min": recall_min,
            "f32_only": int((feasible & ~native).sum()),
            "jax_f32_only": int((jax_f32 & ~native).sum()),
            "per_lane_agreement_f32": float((native == feasible).mean()),
            "per_lane_agreement_jax_f32": float((native == jax_f32).mean()),
            "f64_lanes": GEN_COMPARE, "native_feasible_of_those": int(native[:GEN_COMPARE].sum()),
            "card_f64_feasible": int(f64.sum()),
            "per_lane_agreement_f64": agree_f64, "agreement_min_f64": SOLVER_AGREEMENT_MIN,
            "f64_defect_max": float(cost.max()), "f64_defect_shares": defect_shares(cost),
            "training_rows": int(n),
            "host_cores": os.cpu_count()}


def datagen_fleet_phase() -> dict:
    """``python -m rdm_tpu_torch.scripts.generate_dataset`` (explore and amplify
    rounds, then the optimal pass) into a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        out = run_module(["rdm_tpu_torch.scripts.generate_dataset", "--batch", "4096",
                          "--target", "1100", "--max_minutes", "4", "--optimal_pass",
                          "--n_devices", "0", "--out_dir", tmp], tmp, 900)
        state = np.load(os.path.join(tmp, "datagen_state.npz"))
        pools = [state[f"bin{b}"].reshape(-1, 66) for b in range(11)]
        pkls = [f for f in os.listdir(tmp) if f.startswith("training_data_boundary_")]
        check(len(pkls) == 1, f"generate_dataset wrote {pkls}")
        with open(os.path.join(tmp, pkls[0]), "rb") as f:
            data = np.asarray(pickle.load(f))
    wrote = next(ln for ln in out.splitlines() if ln.startswith("wrote "))
    rate = re.search(r"\(([\d.]+) rows/s over ([\d.]+) s\)", wrote)
    rounds = [ln for ln in out.splitlines() if ln.startswith("round ")]
    bins = [len(p) for p in pools]
    check(min(bins) > 0, f"generate_dataset left an alpha bin empty: {bins}")
    check(data.ndim == 2 and data.shape[1] == 67 and len(data) > 0
          and bool(np.isfinite(data).all()), f"generate_dataset wrote {data.shape}")
    rows = np.concatenate(pools)
    he = np.concatenate([np.full(len(p), 0.008 + a * (0.095 - 0.008))
                         for p, a in zip(pools, np.linspace(0.0, 1.0, 11))])
    pick = np.random.default_rng(0).choice(len(rows), min(FLEET_GRADED, len(rows)), replace=False)
    cost, ok = f64_defect(rows[pick], he[pick])
    share = float(ok.mean())
    check(share >= SOLVER_AGREEMENT_MIN,
          f"generate_dataset: {share} of the state's rows pass the float64 defect check")
    return {"bins": bins, "state_rows": int(len(rows)), "training_rows": int(len(data)),
            "rows_per_second": float(rate.group(1)), "wall_s": float(rate.group(2)),
            "progress_lines": rounds[-3:], "graded_rows": int(len(pick)),
            "f64_defect_feasible_share": share, "f64_defect_max": float(cost.max()),
            "f64_defect_shares": defect_shares(cost),
            "optimal_pass": [ln for ln in out.splitlines() if ln.startswith("optimal pass done")]}


# ---------------------------------------------------------------------------
# the other model families

def family_golden_phase(device) -> dict:
    """The reference goldens of ADM and VDM in the port, float32 on the card,
    loaded with ``strict=True``, at the JAX package's tolerance."""
    out = {}
    for name, make, inputs in (
            ("adm", lambda: adm_lib.ADM(img_resolution=16, label_dim=10, model_channels=32,
                                        channel_mult=(1, 2), channel_mult_emb=2, num_blocks=1,
                                        attn_resolutions=(8,), dropout=0.0),
             ("x", "noise_labels", "onehot")),
            ("vdm", lambda: vdm_lib.VDM(channels=32, num_blocks=2, attention=True, dropout=0.0,
                                        num_channels=3, sigma_min=0.01, sigma_max=5.0),
             ("x", "sigma"))):
        g = np.load(os.path.join(ROOT, "tests", "golden", f"{name}_golden.npz"))
        model = make()
        model.load_state_dict({k[3:]: torch.from_numpy(g[k]) for k in g.files
                               if k.startswith("sd.")}, strict=True)
        model.to(device).eval()
        with torch.no_grad():
            got = model(*(torch.from_numpy(g[k]).to(device) for k in inputs)).cpu().numpy()
        np.testing.assert_allclose(got, g["out"], rtol=5e-4, atol=5e-5)
        out[name] = {"max_abs_err": float(np.abs(got - g["out"]).max()),
                     "params": int(g["n_params"])}
    return {**out, "rtol": 5e-4, "atol": 5e-5}


FAMILY_BATCH = 64
FAMILY_STEPS = 10
FAMILY_SAMPLING_STEPS = 50
# The narrow ADM whose checkpoint round trip phase family_adm runs (the
# full-width ADM state is a 7.1 GB file: 38.7 s of the phase's 57.2).
NARROW_ADM = ["model.model_channels=32", "model.num_blocks=1"]


def _state_tensors(state):
    return state.params + state.optimizer.mu + state.optimizer.nu + state.ema.shadow_params


def _counts(state):
    return (state.step, state.optimizer.count, state.optimizer.schedule_count,
            state.ema.num_updates)


def family_phase(device, data: str, model_name: str) -> dict:
    """One family at its config's full width on the card: the parameter
    count, one training step run twice from the same state and generator
    (bit for bit, cuDNN's deterministic algorithms), FAMILY_STEPS steps at
    FAMILY_BATCH on seeded images (dropout, label dropout where the data has
    classes, EMA), a checkpoint round trip, and PC sampling at FAMILY_BATCH
    with N FAMILY_SAMPLING_STEPS (guided, w = 1, with one-hot labels where
    the data has classes)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    cfg = load_config("train", [f"data={data}", f"model={model_name}",
                                f"training.batch_size={FAMILY_BATCH}",
                                f"sde.num_scales={FAMILY_SAMPLING_STEPS}"])
    model = create_model(cfg).to(device).init_weights(
        torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == FAMILY_PARAMS[model_name],
          f"{model_name}: {n_params} parameters, the JAX package's count is "
          f"{FAMILY_PARAMS[model_name]}")
    state = init_train_state(model, cfg)
    classes = bool(cfg.data.get("classes", False))
    S, C = cfg.data.image_size, cfg.data.num_channels
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.uniform(size=(4 * FAMILY_BATCH, C, S, S)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.data.get("num_classes", 1),
                                           size=(4 * FAMILY_BATCH, 1)).astype(np.float32))
    images, labels = images.to(device), labels.to(device)
    sde = get_sde(cfg)
    step = make_train_step_on_device(sde, use_labels=classes, batch_size=FAMILY_BATCH,
                                     reduce_mean=cfg.training.reduce_mean,
                                     likelihood_weighting=cfg.training.likelihood_weighting)
    dropout = {"dropout": cfg.model.dropout,
               "label_dropout": cfg.training.drop_label if classes else None}

    # one step twice from the same state and generator
    saved, counts = [t.detach().clone() for t in _state_tensors(state)], _counts(state)
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, s in zip(_state_tensors(state), saved):
                t.copy_(s)
        state.step, state.optimizer.count, state.optimizer.schedule_count, \
            state.ema.num_updates = counts
        loss = float(step(state, images, labels, torch.Generator(device=device).manual_seed(7)))
        runs.append((loss, [t.detach().clone() for t in _state_tensors(state)]))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    bit_equal = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    check(bit_equal, f"{model_name}: two runs of one step differ")
    del saved, runs

    # training steps
    gen = torch.Generator(device=device).manual_seed(8)
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = [float(step(state, images, labels, gen)) for _ in range(FAMILY_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / FAMILY_STEPS
    check(all(math.isfinite(v) for v in losses), f"{model_name}: non-finite losses {losses}")
    check(state.ema.num_updates == FAMILY_STEPS + 1 and any(
        not torch.equal(s, p) for s, p in zip(state.ema.shadow_params, state.params)),
        f"{model_name}: the EMA did not move")

    # checkpoint round trip: of this state, or (ADM, whose full-width state
    # is a 7.1 GB file) of a narrow model of the family after two steps, the
    # same checkpoint code
    rt_cfg, rt_state = cfg, state
    if model_name == "adm":
        rt_cfg = load_config("train", [f"data={data}", f"model={model_name}",
                                       f"training.batch_size={FAMILY_BATCH}", *NARROW_ADM])
        rt_state = init_train_state(create_model(rt_cfg).to(device).init_weights(
            torch.Generator(device=device).manual_seed(0)), rt_cfg)
        rt_gen = torch.Generator(device=device).manual_seed(10)
        for _ in range(2):
            step(rt_state, images, labels, rt_gen)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.pth")
        checkpoints.save_checkpoint(path, rt_state, config=rt_cfg)
        size = os.path.getsize(path)
        fresh = init_train_state(create_model(rt_cfg).to(device), rt_cfg)
        checkpoints.load_into_state(fresh, checkpoints.restore_checkpoint(path))
    round_trip_s = time.perf_counter() - t
    same = _counts(fresh) == _counts(rt_state) and all(
        torch.equal(a, b) for a, b in zip(_state_tensors(fresh), _state_tensors(rt_state)))
    check(same, f"{model_name}: the checkpoint round trip changed the state")
    del fresh
    if rt_state is not state:
        del rt_state

    # PC sampling with the EMA weights
    shape = (FAMILY_BATCH, C, S, S)
    sampling_fn = get_sampling_fn(cfg, sde, shape, SAMPLING_EPS)
    sgen = torch.Generator(device=device).manual_seed(9)
    with torch.no_grad(), state.ema.average_parameters(state.params):
        if classes:
            ids = torch.randint(0, cfg.data.num_classes, (FAMILY_BATCH,), generator=sgen,
                                device=device)
            onehot = torch.nn.functional.one_hot(ids, cfg.data.num_classes).float()
            score_fn = get_cf_score_fn(sde, state.model, onehot, 1.0)
        else:
            score_fn = get_score_fn(sde, state.model)
        torch.cuda.synchronize()
        t = time.perf_counter()
        samples = sampling_fn(score_fn, sgen)[0].float()
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t
    check(bool(torch.isfinite(samples).all()) and float(samples.min()) >= 0.0
          and float(samples.max()) <= 1.0, f"{model_name}: samples not finite in the unit cube")
    return {"data": data, "model": model_name, "params": n_params,
            "jax_params": FAMILY_PARAMS[model_name], "dtype": str(model.dtype), **dropout,
            "batch": FAMILY_BATCH, "one_step_bit_equal": bit_equal, "steps": FAMILY_STEPS,
            "losses": losses, "ms_per_step": ms,
            "train_samples_per_second": FAMILY_BATCH / ms * 1e3,
            "checkpoint_bytes": size, "checkpoint_round_trip_s": round_trip_s,
            "checkpoint_of": " ".join(NARROW_ADM) if model_name == "adm" else "the full state",
            "sampling": {"n": FAMILY_BATCH, "steps": FAMILY_SAMPLING_STEPS,
                         "guided_w": 1.0 if classes else None, "seconds": sample_s,
                         "samples_per_second": FAMILY_BATCH / sample_s,
                         "min": float(samples.min()), "max": float(samples.max())},
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device)}


def write_cifar10(root: str, per_batch: int = 128, seed: int = 0) -> None:
    """Seeded ``cifar-10-batches-py`` pickles: five training batches and the
    test batch."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name, n in [(f"data_batch_{i}", per_batch) for i in range(1, 6)] + [("test_batch", 64)]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)


def run_train_families_phase(extra=()) -> dict:
    """``python -m rdm_tpu_torch.run_train data=cifar10 model=ddpmpp`` (full
    width; ``extra`` overrides) for four steps at batch 64 on seeded
    CIFAR-10 pickles, as a subprocess from a temporary directory.  Phase
    run_train_families runs the config as it ships (float32, no kernels),
    phase run_train_ddpmpp_kernels with ``DDPMPP_KERNEL_ARGS`` (bfloat16,
    both tiled kernels)."""
    args = ["data=cifar10", "model=ddpmpp", *extra, "training.n_iters=3",
            "training.snapshot_freq=3", "training.eval_freq=1000", "training.log_freq=1",
            "training.snapshot_freq_for_preemption=1000", "training.batch_size=64",
            "eval.batch_size=64", "sde.num_scales=50"]
    with tempfile.TemporaryDirectory() as tmp:
        write_cifar10(os.path.join(tmp, "data"))
        run_module(["rdm_tpu_torch.run_train", f"dataroot={os.path.join(tmp, 'data')}", *args],
                   tmp, 900)
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
        model = create_model(load_hydra_config_from_run(run))
    check(steps == [0, 1, 2, 3] and len(evals) == 1, f"log lines: steps {steps}, evals {evals}")
    check(ck is not None and ck.step == 4 and ck.optimizer["count"] == 4,
          "run_train checkpoint does not restore")
    model.load_state_dict(ck.model, strict=True)
    check(sample.dtype == np.uint8 and sample.shape == (64, 32, 32, 3),
          f"snapshot samples {sample.dtype} {sample.shape}")
    return {"steps": steps, "eval_lines": len(evals), "checkpoint_step": ck.step,
            "params": sum(v.numel() for v in ck.model.values()),
            "sample_shape": list(sample.shape)}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def ddpmpp_attn_routing_phase(device) -> dict:
    """``model=ddpmpp`` with both kernels on, bfloat16: every attention block
    (16 x 16, C 256) and every resblock keeps its kernel when the model is
    built, with no routing log line; one evaluation forward on the card (no
    dropout) launches the attention kernel 17 times and the resblock kernel
    70 times, all through the tiled bodies."""
    records = _Records()
    log = logging.getLogger("rdm_tpu_torch")
    log.addHandler(records)
    try:
        _, model = ddpmpp_model(device)
    finally:
        log.removeHandler(records)
    blocks = [m for m in model.modules() if isinstance(m, AttnBlockpp)]
    widths = sorted({b.NIN_0.W.shape[0] for b in blocks})
    check(len(blocks) == DDPMPP_ATTN_BLOCKS and all(b.use_kernel for b in blocks)
          and widths == [256], f"ddpmpp attention blocks: {len(blocks)}, widths {widths}")
    check(not [ln for ln in records.lines if "kernel" in ln], f"routing log lines {records.lines}")
    model.eval().requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.rand((4, 3, 32, 32), generator=gen, device=device)
    zero_tiled_launches()
    with torch.no_grad():
        out = model(x, torch.full((4,), 0.5, device=device))
    torch.cuda.synchronize()
    launches = tiled_launch_counts()
    check(launches["fused_attn_block"] == launches["fused_attn_block_tiled"] == DDPMPP_ATTN_BLOCKS
          and launches["fused_resblock"] == launches["fused_resblock_tiled"] == DDPMPP_RESBLOCKS
          and bool(torch.isfinite(out.float()).all()),
          f"ddpmpp evaluation forward launches {launches}")
    del model
    torch.cuda.empty_cache()
    return {"attention_blocks": len(blocks), "channels": widths[0], "tokens": 16 * 16,
            "resblocks": DDPMPP_RESBLOCKS, "routed_to_plain": 0, "log_lines": len(records.lines),
            "launches": launches}


# ---------------------------------------------------------------------------
# the tiled bodies: DDPM++ on CIFAR-10 and the nf-32 NCSN++

DDPMPP_KERNEL_ARGS = ["model.precision=bfloat16", "model.attn_pallas=true",
                      "model.resblock_pallas=true"]
DDPMPP_OVERRIDES = ["data=cifar10", "model=ddpmpp", *DDPMPP_KERNEL_ARGS]
# (H, C_in, C_out) -> blocks a forward: DDPM++'s 70 resblocks, the nf-32 NCSN++'s 17
DDPMPP_RESBLOCK_SHAPES = {(32, 128, 128): 8, (32, 256, 128): 8, (32, 384, 128): 1,
                          (16, 128, 256): 1, (16, 256, 256): 7, (16, 512, 256): 9,
                          (8, 256, 256): 8, (8, 512, 256): 9, (4, 256, 256): 10,
                          (4, 512, 256): 9}
NF32_RESBLOCK_SHAPES = {(9, 32, 32): 2, (9, 64, 32): 2, (9, 96, 32): 1, (4, 32, 64): 1,
                        (4, 64, 64): 1, (4, 128, 64): 3, (2, 64, 64): 4, (2, 128, 64): 3}
DDPMPP_ATTN_BLOCKS = 17
DDPMPP_RESBLOCKS = 70
NF32_ATTN_BLOCKS = 5
TILED_BATCH = 64
DDPMPP_TRAIN_STEPS = 3
DDPMPP_SAMPLING_STEPS = 10
DDPMPP_GRAD_SEEDS = (21, 31)


# the card tests' second gate on a tiled body's output: more than this share
# of the elements within one bf16 step of max(|plain|, 1)
WITHIN_STEP_MIN = 0.99


def within_step(out, ref) -> float:
    """Share of the elements of ``out`` within one bf16 step of max(|ref|, 1)
    of ``ref``."""
    err = (out.float() - ref.float()).abs()
    return float((err <= BF16_STEP * ref.float().abs().clamp(min=1.0)).float().mean())


def tiled_launch_counts() -> dict:
    return {f.__name__: f.launches for f in (
        attn_ops.fused_attn_block, attn_ops.fused_attn_block_bwd, rb_ops.fused_resblock,
        attn_ops.fused_attn_block_tiled, attn_ops.fused_attn_block_bwd_tiled,
        rb_ops.fused_resblock_tiled)}


def zero_tiled_launches() -> None:
    for f in (attn_ops.fused_attn_block, attn_ops.fused_attn_block_bwd, rb_ops.fused_resblock,
              attn_ops.fused_attn_block_tiled, attn_ops.fused_attn_block_bwd_tiled,
              rb_ops.fused_resblock_tiled):
        f.launches = 0


def tiled_attn_case(B, C, L, groups, seed, device, timed):
    """The tiled attention forward and backward against their plain versions
    (bfloat16 activations, float32 parameters as the model passes them),
    the backward twice bit for bit; timed cold beside the plain versions,
    the unfused library block and the bounds."""
    x, params = attn_inputs(B, C, L, groups, torch.float32, seed, device)
    x = x.to(torch.bfloat16)
    g = torch.randn(x.shape, generator=torch.Generator(device=device).manual_seed(seed),
                    device=device).to(torch.bfloat16)
    kw = dict(groups=groups, skip_rescale=True)
    check(attn_ops.attn_body(C, L, torch.bfloat16) == "tiled", f"C {C}, L {L} is not tiled")
    before = attn_ops.fused_attn_block_tiled.launches, attn_ops.fused_attn_block_bwd_tiled.launches
    out = attn_ops.fused_attn_block(x, *params, **kw)
    ref = attn_ops.fused_attn_block_reference(x, *params, **kw)
    d1 = attn_ops.fused_attn_block_bwd(x, g, *params, **kw)
    d2 = attn_ops.fused_attn_block_bwd(x, g, *params, **kw)
    dref = attn_ops.fused_attn_block_bwd_reference(x, g, *params, **kw)
    torch.cuda.synchronize()
    check((attn_ops.fused_attn_block_tiled.launches - before[0],
           attn_ops.fused_attn_block_bwd_tiled.launches - before[1]) == (1, 2),
          "the tiled wrappers did not launch")
    check(bool(torch.isfinite(out.float()).all()), f"tiled attention output not finite {B, C, L}")
    err = float((out.float() - ref.float()).abs().max())
    # the same rounding points; a sum next to a bf16 rounding boundary may
    # round the other way and carry a step on: 4 bf16 steps at the scale,
    # and as the card tests more than WITHIN_STEP_MIN of the elements within
    # one step
    tol = 4 * BF16_STEP * max(1.0, float(ref.float().abs().max()))
    check(all(torch.equal(a, b) for a, b in zip(d1, d2)),
          f"two tiled backward runs differ (B={B}, C={C}, L={L})")
    errs = {}
    for name, a, b in zip(("dx",) + PARAM_NAMES, d1, dref):
        check(a.shape == b.shape and a.dtype == b.dtype and bool(torch.isfinite(a.float()).all()),
              f"tiled backward {name} shape, type or finiteness")
        errs[name] = (float((a.float() - b.float()).abs().max()),
                      max(1.0, float(b.float().abs().max())))
    # as phase kernel_bwd: dx within 4 bf16 steps of its scale, the float32
    # parameter gradients within one step of theirs, dbk (zero in exact
    # arithmetic: the summed rounding noise of dk) at the scale of dbq
    errs["bk"] = (errs["bk"][0], max(errs["bk"][1], errs["bq"][1]))
    dx_err, dx_scale = errs.pop("dx")
    worst = max(errs, key=lambda n: errs[n][0] / errs[n][1])
    res = {"B": B, "C": C, "L": L, "groups": groups, "body": "tiled",
           "plan": attn_ops.tiled_plan(B, C, L)._asdict(), "max_abs_err": err, "tol": tol,
           "frac_differ": float((out != ref).float().mean()),
           "frac_within_step": within_step(out, ref), "frac_within_step_min": WITHIN_STEP_MIN,
           "dx_max_abs_err": dx_err, "dx_tol": 4 * BF16_STEP * dx_scale, "worst_param": worst,
           "param_max_abs_err": errs[worst][0], "param_tol": BF16_STEP * errs[worst][1],
           "bwd_bitwise_repeatable": True}
    check(err <= tol and res["frac_within_step"] > WITHIN_STEP_MIN,
          f"tiled attention disagrees with its plain version: {res}")
    check(dx_err <= res["dx_tol"], f"tiled backward dx disagrees: {res}")
    for name, (e, scale) in errs.items():
        check(e <= BF16_STEP * scale, f"tiled backward d{name} disagrees: {res}")
    if timed:
        # cold: x (and g) rotate over more than twice the L2, CUDA-graph slopes
        gen = torch.Generator(device=device)
        make = lambda i: torch.randn(x.shape, generator=gen.manual_seed(300 + i),
                                     device=device).to(torch.bfloat16)
        make2 = lambda i: (make(2 * i), make(2 * i + 1))
        nbytes = x.numel() * x.element_size()
        lib_params = [p.to(torch.bfloat16) for p in params]

        def library_fwd_bwd(t):
            xx = t[0].detach().requires_grad_(True)
            ps = [p.detach().requires_grad_(True) for p in lib_params]
            return torch.autograd.grad(tiled_attn_parts.library_block(xx, ps, groups),
                                       [xx, *ps], t[1])

        launcher = attn_ops._tiled_fwd_launcher(*params, **kw)
        bwd_launcher = attn_ops._tiled_bwd_launcher(*params, **kw)
        fwd = {"": lambda t: attn_ops.fused_attn_block(t, *params, **kw),
               "kernel_": launcher,
               "plain_": lambda t: attn_ops.fused_attn_block_reference(t, *params, **kw),
               "library_": lambda t: tiled_attn_parts.library_block(t, lib_params, groups)}
        bwd = {"bwd_": lambda t: attn_ops.fused_attn_block_bwd(*t, *params, **kw),
               "bwd_kernel_": lambda t: bwd_launcher(*t),
               "bwd_plain_": lambda t: attn_ops.fused_attn_block_bwd_reference(*t, *params, **kw),
               "bwd_library_": library_fwd_bwd}
        for key, fn in fwd.items():
            with torch.no_grad():
                res[key + "ms"] = micro_cf_script.cold_us(fn, make, nbytes, device, (2, 8)) / 1e3
        for key, fn in bwd.items():
            res[key + "ms"] = micro_cf_script.cold_us(fn, make2, 2 * nbytes, device, (2, 6)) / 1e3
        res["launch_ms"] = parts_ms(lambda: attn_ops.tiled_attn_launch_ms(
            x, *params, **kw, launcher=launcher))
        res["bwd_launch_ms"] = parts_ms(
            lambda: attn_ops.tiled_attn_bwd_launch_ms(x, g, *params, **kw, launcher=bwd_launcher))
        res["bound_ms"], res["bound_by"] = attn_bound_ms(B, C, L, torch.bfloat16)
        res["bwd_bound_ms"], res["bwd_bound_by"] = attn_bwd_bound_ms(B, C, L, torch.bfloat16)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["bwd_share_of_bound"] = res["bwd_bound_ms"] / res["bwd_ms"]
    return res


def tiled_resblock_case(B, H, ci, co, seed, device, timed):
    """The tiled resblock against its plain version in bfloat16, two runs bit
    for bit; timed cold beside the plain version, the unfused module (cuDNN
    convolutions) and the bound."""
    x, tembv, params = resblock_inputs(B, H, ci, co, torch.bfloat16, seed, device)
    kw = dict(groups0=min(ci // 4, 32), groups1=min(co // 4, 32), skip_rescale=True)
    check(rb_ops.resblock_body(H, H, ci, co, torch.bfloat16) == "tiled",
          f"({H}, {ci}, {co}) is not tiled")
    before = rb_ops.fused_resblock_tiled.launches
    out = rb_ops.fused_resblock(x, tembv, *params, **kw)
    again = rb_ops.fused_resblock(x, tembv, *params, **kw)
    ref = rb_ops.fused_resblock_reference(x, tembv, *params, **kw)
    torch.cuda.synchronize()
    check(rb_ops.fused_resblock_tiled.launches - before == 2, "the tiled resblock did not launch")
    check(out.shape == ref.shape and out.dtype == ref.dtype and bool(torch.isfinite(
        out.float()).all()), f"tiled resblock output {B, H, ci, co}")
    err = float((out.float() - ref.float()).abs().max())
    # as phase kernel_resblock: 4 bf16 steps at the output's largest
    # magnitude, and as the card tests more than WITHIN_STEP_MIN of the
    # elements within one step
    tol = 4 * BF16_STEP * max(1.0, float(ref.float().abs().max()))
    res = {"B": B, "H": H, "C_in": ci, "C_out": co, "body": "tiled",
           "plan": list(rb_ops.tiled_resblock_plan(B, H, ci, co, kw["groups0"],
                                                   kw["groups1"]).flat()),
           "max_abs_err": err, "tol": tol, "frac_differ": float((out != ref).float().mean()),
           "frac_within_step": within_step(out, ref), "frac_within_step_min": WITHIN_STEP_MIN,
           "bitwise_repeatable": bool(torch.equal(out, again))}
    check(err <= tol and res["frac_within_step"] > WITHIN_STEP_MIN and res["bitwise_repeatable"],
          f"tiled resblock disagrees with its plain version or itself: {res}")
    if timed:
        blk = resblock_module(params, ci, co, torch.bfloat16, device)
        temb = torch.randn((B, 4 * 64), generator=torch.Generator(device=device).manual_seed(seed),
                           device=device)

        def make(i):
            gen = torch.Generator(device=device).manual_seed(400 + i)
            return (torch.randn((B, ci, H, H), generator=gen, device=device).to(torch.bfloat16),
                    (0.5 * torch.randn((B, co), generator=gen, device=device)).to(torch.bfloat16))

        nbytes = (x.numel() + tembv.numel()) * x.element_size()
        launcher = rb_ops._tiled_launcher(*params, H=H, **kw)
        fns = {"": lambda t: rb_ops.fused_resblock(*t, *params, **kw),
               "kernel_": lambda t: launcher(*t),
               "plain_": lambda t: rb_ops.fused_resblock_reference(*t, *params, **kw),
               "module_": lambda t: blk(t[0], temb)}
        with torch.no_grad():
            for key, fn in fns.items():
                res[key + "ms"] = micro_cf_script.cold_us(fn, make, nbytes, device, (2, 6)) / 1e3
            res["launch_ms"] = parts_ms(lambda: rb_ops.tiled_resblock_launch_ms(
                x, tembv, *params, **kw, launcher=launcher))
        res["bound_ms"], res["bound_by"] = resblock_bound_ms(B, H, ci, co, torch.bfloat16)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return res


def kernel_tiled_phase(device) -> tuple:
    """Each tiled body against its plain version at the configs' shapes:
    attention at C 256, L 256 (DDPM++) and C 32, L 81 (nf 32), each at B 64
    (timed) and a ragged B; the resblock at DDPM++'s ten shapes at B 64
    (timed), three of them at B 3, and the nf-32 NCSN++'s eight at B 64."""
    attn = [tiled_attn_case(TILED_BATCH, 256, 256, 32, 70, device, True),
            tiled_attn_case(3, 256, 256, 32, 71, device, False),
            tiled_attn_case(TILED_BATCH, 32, 81, 8, 72, device, True),
            tiled_attn_case(5, 32, 81, 8, 73, device, False)]
    rb = [tiled_resblock_case(TILED_BATCH, H, ci, co, 80 + i, device, True)
          for i, (H, ci, co) in enumerate(DDPMPP_RESBLOCK_SHAPES)]
    rb += [tiled_resblock_case(3, H, ci, co, 95 + i, device, False)
           for i, (H, ci, co) in enumerate([(32, 384, 128), (16, 128, 256), (4, 512, 256)])]
    rb += [tiled_resblock_case(TILED_BATCH, H, ci, co, 100 + i, device, False)
           for i, (H, ci, co) in enumerate(NF32_RESBLOCK_SHAPES)]
    for c in attn:
        print(json.dumps({"tiled_attn_case": c}), flush=True)
    for c in rb:
        print(json.dumps({"tiled_resblock_case": c}), flush=True)
    return attn, rb


def ddpmpp_forward_sum(cases, key, part=None) -> float:
    """Sum of ``key`` (of its ``part`` where given) over DDPM++'s 70
    resblocks of one forward at B 64."""
    return sum((c[key] if part is None else c[key][part])
               * DDPMPP_RESBLOCK_SHAPES[(c["H"], c["C_in"], c["C_out"])]
               for c in cases if c["B"] == TILED_BATCH and (c["H"], c["C_in"], c["C_out"])
               in DDPMPP_RESBLOCK_SHAPES and key in c)


def ddpmpp_forward_sums(cases) -> dict:
    """The DDPM++ forward's resblock sums at B 64: the wrapper, the kernels
    alone, the plain version, the cuDNN module, the bound, and each launch
    of the body (the kernels alone, as the card runs them)."""
    out = {k: ddpmpp_forward_sum(cases, k) for k in ("ms", "kernel_ms", "plain_ms",
                                                     "module_ms", "bound_ms")}
    out["launch_ms"] = {p: ddpmpp_forward_sum(cases, "launch_ms", p) for p in rb_ops.TILED_PARTS}
    return out


def ddpmpp_model(device, overrides=()):
    cfg = load_config("train", DDPMPP_OVERRIDES + [f"training.batch_size={TILED_BATCH}",
                                                   f"sde.num_scales={DDPMPP_SAMPLING_STEPS}",
                                                   *overrides])
    model = create_model(cfg).to(device).init_weights(
        torch.Generator(device=device).manual_seed(0))
    # The config's init_scale of 0 draws every resblock's Conv_1, every
    # attention block's output NIN and the output convolution at a variance
    # scale of 1e-10 (weights near 1e-6): the network is then close to the
    # identity and the gradients inside its blocks close to zero.  Draw them
    # at scale 1, as the other layers, so the comparison below sees every
    # gradient at its working size.
    gen = torch.Generator(device=device).manual_seed(1)
    for mod in model.modules():
        if isinstance(mod, NIN) and mod.init_scale == 0:
            default_init_(mod.W, 1.0, *mod.W.shape, gen)
        elif isinstance(mod, torch.nn.Conv2d) and getattr(mod, "init_scale", 1.0) == 0:
            w = mod.weight
            default_init_(w, 1.0, w[0].numel(), w.shape[0] * w[0, 0].numel(), gen)
    return cfg, model


def channel_permutation(C, groups, seed, device):
    """A permutation of C channels that maps each GroupNorm group onto a
    group: the groups in a random order, each one's channels shuffled."""
    rng = np.random.default_rng(seed)
    cg = C // groups
    return torch.from_numpy(np.concatenate(
        [g * cg + rng.permutation(cg) for g in rng.permutation(groups)])).to(device)


class PermutedPlainAttention:
    """Inside ``with``, the plain attention versions (the model's path with
    its kernels off) run on channel-permuted inputs and parameters and
    permute their results back: the same operations, rounded at the same
    points, that sum their products and statistics in another order.  What
    this moves a gradient by is bfloat16's noise under a change of summation
    order alone, the witness the kernel's own differences are read against."""

    def __init__(self, seed):
        self.seed, self.perms = seed, {}

    def perm(self, C, groups, device):
        if (C, groups) not in self.perms:
            pi = channel_permutation(C, groups, self.seed + C, device)
            self.perms[(C, groups)] = pi, torch.argsort(pi)
        return self.perms[(C, groups)]

    @staticmethod
    def params(raw, pi):
        gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp = raw
        mat = lambda w: w[pi][:, pi]
        return (gamma[pi], beta[pi], mat(wq), bq[pi], mat(wk), bk[pi], mat(wv), bv[pi],
                mat(wp), bp[pi])

    def __enter__(self):
        fwd, bwd = attn_ops.fused_attn_block_reference, attn_ops.fused_attn_block_bwd_reference
        self.saved = fwd, bwd

        def fwd_p(x, *raw, groups, skip_rescale=True):
            pi, inv = self.perm(x.shape[1], groups, x.device)
            return fwd(x[:, pi].contiguous(), *self.params(raw, pi), groups=groups,
                       skip_rescale=skip_rescale)[:, inv].contiguous()

        def bwd_p(x, g, *raw, groups, skip_rescale=True):
            pi, inv = self.perm(x.shape[1], groups, x.device)
            dx, dgamma, dbeta, dwq, dbq, dwk, dbk, dwv, dbv, dwp, dbp = bwd(
                x[:, pi].contiguous(), g[:, pi].contiguous(), *self.params(raw, pi),
                groups=groups, skip_rescale=skip_rescale)
            mat = lambda w: w[inv][:, inv]
            return (dx[:, inv].contiguous(), dgamma[inv], dbeta[inv], mat(dwq), dbq[inv],
                    mat(dwk), dbk[inv], mat(dwv), dbv[inv], mat(dwp), dbp[inv])

        attn_ops.fused_attn_block_reference = fwd_p
        attn_ops.fused_attn_block_bwd_reference = bwd_p
        return self

    def __exit__(self, *exc):
        attn_ops.fused_attn_block_reference, attn_ops.fused_attn_block_bwd_reference = self.saved
        return False


def ddpmpp_grad_rule(cfg, model, batch, seed, device) -> dict:
    """One loss and gradient of ``model`` (bfloat16, both kernels on; the
    config's dropout keeps the resblocks on the module path, as in the JAX
    package) with t, z and masks from ``seed``: through the tiled attention
    kernels (k), the plain versions (p), the plain versions on permuted
    channels (w, ``PermutedPlainAttention``) and float32 through the plain
    versions (f).  Per parameter, ``kernel`` is |k - p| and ``witness``
    |w - p|, each over the bf16-f32 distance |p - f| (the k biases over their
    block's q bias's, as in phase train); as vectors the same over the whole
    gradient."""
    loss_k, g_k = loss_and_grads(cfg, model, batch, None, seed=seed)
    set_attn_kernel(model, False)
    loss_p, g_p = loss_and_grads(cfg, model, batch, None, seed=seed)
    with PermutedPlainAttention(seed):
        loss_w, g_w = loss_and_grads(cfg, model, batch, None, seed=seed)
    set_attn_kernel(model, True)
    plain32 = with_precision(cfg, "float32").to_plain()
    plain32["model"].update(attn_pallas=False, resblock_pallas=False)
    cfg32 = ConfigDict.wrap(plain32)
    m32 = create_model(cfg32).to(device)
    m32.load_state_dict(model.state_dict(), strict=True)
    loss_f, g_f = loss_and_grads(cfg32, m32, batch, None, seed=seed)
    del m32
    flat = lambda gs: torch.cat([g.flatten() for g in gs])
    spread = float((flat(g_p) - flat(g_f)).norm())
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    dists = lambda x, y: {n: float((a - b).norm()) for a, b, n in zip(x, y, names)}
    kp, wp, pf = dists(g_k, g_p), dists(g_w, g_p), dists(g_p, g_f)
    kbias = {f"{m}.NIN_1.b": f"{m}.NIN_0.b" for m, mod in model.named_modules()
             if isinstance(mod, AttnBlockpp)}
    blocks = tuple(k[:-len("NIN_1.b")] for k in kbias)
    attn = {n for n in names if n.startswith(blocks)}
    rk = {n: kp[n] / max(pf[kbias.get(n, n)], 1e-30) for n in names}
    rw = {n: wp[n] / max(pf[kbias.get(n, n)], 1e-30) for n in names}
    top = lambda r, o, sel: sorted(((r[n], o[n], n) for n in names if sel(n)), reverse=True)[:6]
    res = {"seed": seed, "loss_kernel": loss_k, "loss_plain": loss_p, "loss_permuted": loss_w,
           "loss_f32": loss_f, "grad_spread_bf16_f32": spread,
           "grad_ratio": float((flat(g_k) - flat(g_p)).norm()) / spread,
           "witness_grad_ratio": float((flat(g_w) - flat(g_p)).norm()) / spread,
           "worst_ratios": top(rk, rw, lambda n: True),
           "worst_witness_ratios": top(rw, rk, lambda n: True),
           "worst_attention_ratios": top(rk, rw, lambda n: n in attn),
           "worst_other_ratios": top(rk, rw, lambda n: n not in attn),
           "worst_other_witness_ratios": top(rw, rk, lambda n: n not in attn),
           "params_over_1": sum(v > 1 for v in rk.values()),
           "witness_params_over_1": sum(v > 1 for v in rw.values()),
           "k_bias_worst": max((rk[n], rw[n], n) for n in kbias),
           "attention_params": len(attn), "attention_params_nonzero_grads": sum(
               bool(g.any()) for g, n in zip(g_k, names) if n in attn)}
    del g_k, g_p, g_w, g_f
    torch.cuda.empty_cache()
    return res


def ddpmpp_phase(device) -> dict:
    """model=ddpmpp at its full width (104,701,571 parameters) in bfloat16
    with both kernels on, random weights from a seed: (1) for each of two
    seeds, one training loss and gradient through the tiled attention
    kernels (forward and backward; the config's dropout keeps the resblocks
    on the module path, as in the JAX package) against the same through the
    plain versions, under phase train's rule (float32 through the plain
    versions gives the yardstick; ``ddpmpp_grad_rule``); (2) DDPMPP_TRAIN_STEPS steps at batch 64 twice from the same state and
    generator, bit for bit (cuDNN's deterministic algorithms); (3) PC
    sampling with the EMA weights at batch 64 with N = 10, all three
    kernels, twice, bit for bit; launches counted over (2) and (3)."""
    torch.cuda.empty_cache()
    cfg, model = ddpmpp_model(device)
    check(sum(p.numel() for p in model.parameters()) == FAMILY_PARAMS["ddpmpp"],
          "ddpmpp parameter count")
    attn = [m for m in model.modules() if isinstance(m, AttnBlockpp)]
    rbs = [m for m in model.modules() if isinstance(m, ResnetBlockDDPMpp)]
    check(len(attn) == DDPMPP_ATTN_BLOCKS and all(m.use_kernel for m in attn)
          and len(rbs) == DDPMPP_RESBLOCKS
          and all(m.use_kernel and m.fused_forward is rb_ops.fused_resblock for m in rbs),
          "ddpmpp blocks are not all on their kernels")
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.uniform(size=(2 * TILED_BATCH, 3, 32, 32))
                              .astype(np.float32)).to(device)
    labels = torch.zeros((2 * TILED_BATCH, 1), device=device)   # CIFAR-10 here: no classes
    batch = images[:TILED_BATCH]
    out = {"params": FAMILY_PARAMS["ddpmpp"], "batch": TILED_BATCH}

    # (1) kernel against plain under phase train's rule, for each seed of
    #     DDPMPP_GRAD_SEEDS: the gradient vector within half of the bf16-f32
    #     spread, every parameter within its own (the k biases within their
    #     block's q bias's), the loss within half a bf16 step, relative.
    #     The witness (the plain versions summing in another order) is
    #     printed beside each reading: it moves the gradients as far as the
    #     kernels do, so these limits are the noise floor of bf16 rounding.
    for seed in DDPMPP_GRAD_SEEDS:
        rule = ddpmpp_grad_rule(cfg, model, batch, seed, device)
        print(json.dumps({"ddpmpp_kernel_vs_plain": rule}), flush=True)
        out.setdefault("grad_rule", []).append(rule)
        check(rule["attention_params_nonzero_grads"] == rule["attention_params"],
              "a DDPM++ attention parameter has a zero gradient")
        check(math.isfinite(rule["loss_kernel"]) and abs(rule["loss_kernel"] - rule["loss_plain"])
              <= BF16_STEP / 2 * abs(rule["loss_plain"]),
              f"ddpmpp loss kernel {rule['loss_kernel']} vs plain {rule['loss_plain']}")
        check(rule["grad_ratio"] <= 0.5, f"ddpmpp gradients: kernel-plain {rule}")
        check(rule["worst_ratios"][0][0] <= 1.0,
              f"a ddpmpp parameter's gradient: kernel-plain / spread {rule['worst_ratios']}")

    # (2) training steps twice from the same state, bit for bit
    state = init_train_state(model, cfg)
    step = make_train_step_on_device(get_sde(cfg), use_labels=False, batch_size=TILED_BATCH,
                                     reduce_mean=cfg.training.reduce_mean,
                                     likelihood_weighting=cfg.training.likelihood_weighting)
    saved, counts = [t.detach().clone() for t in _state_tensors(state)], _counts(state)
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    zero_tiled_launches()
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, s in zip(_state_tensors(state), saved):
                t.copy_(s)
        state.step, state.optimizer.count, state.optimizer.schedule_count, \
            state.ema.num_updates = counts
        gen = torch.Generator(device=device).manual_seed(22)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(step(state, images, labels, gen)) for _ in range(DDPMPP_TRAIN_STEPS)]
        torch.cuda.synchronize()
        runs.append((losses, [t.detach().clone() for t in _state_tensors(state)],
                     (time.perf_counter() - t0) * 1e3 / DDPMPP_TRAIN_STEPS))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    train_launches = tiled_launch_counts()
    bit_equal = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    out.update(train_steps=DDPMPP_TRAIN_STEPS, losses=runs[0][0], train_bit_equal=bit_equal,
               ms_per_step=[r[2] for r in runs], train_launches=train_launches)
    del saved, runs
    n = 2 * DDPMPP_TRAIN_STEPS * DDPMPP_ATTN_BLOCKS
    check(bit_equal and all(math.isfinite(v) for v in out["losses"]),
          f"ddpmpp training: finite and bit for bit {out['losses']}")
    check(train_launches["fused_attn_block_tiled"] == n
          and train_launches["fused_attn_block_bwd_tiled"] == n
          and train_launches["fused_resblock_tiled"] == 0,
          f"ddpmpp training launches {train_launches}")

    # (3) PC sampling with the EMA weights, all three kernels, twice
    sde = get_sde(cfg)
    sampling_fn = get_sampling_fn(cfg, sde, (TILED_BATCH, 3, 32, 32), SAMPLING_EPS)
    zero_tiled_launches()
    samples = []
    with torch.no_grad(), state.ema.average_parameters(state.params):
        score_fn = get_score_fn(sde, state.model)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples.append(sampling_fn(score_fn, torch.Generator(device=device)
                                       .manual_seed(23))[0].float())
            torch.cuda.synchronize()
            out.setdefault("sampling_s", []).append(time.perf_counter() - t0)
    sample_launches = tiled_launch_counts()
    forwards = sample_launches["fused_attn_block_tiled"] // (2 * DDPMPP_ATTN_BLOCKS)
    out.update(sampling_steps=DDPMPP_SAMPLING_STEPS, sampling_forwards=forwards,
               sampling_launches=sample_launches,
               samples_bit_equal=bool(torch.equal(samples[0], samples[1])),
               sample_min=float(samples[0].min()), sample_max=float(samples[0].max()))
    check(out["samples_bit_equal"] and bool(torch.isfinite(samples[0]).all()),
          "ddpmpp samples not finite or not repeatable")
    check(forwards >= DDPMPP_SAMPLING_STEPS - 1
          and sample_launches["fused_attn_block_tiled"] == 2 * DDPMPP_ATTN_BLOCKS * forwards
          and sample_launches["fused_resblock_tiled"] == 2 * DDPMPP_RESBLOCKS * forwards,
          f"ddpmpp sampling launches {sample_launches}")
    out["launches"] = {k: train_launches[k] + sample_launches[k] for k in train_launches}
    del state, model
    torch.cuda.empty_cache()
    return out


def kernels_per_card_phase() -> dict:
    """Each model kernel launched on every card after the first, from this one
    process, against its plain version: the per-card table of each launcher's
    shared-memory attribute.  With one card it says so."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"kernels_per_card: {n} card visible; no second card to launch on", flush=True)
        return {"cards": n, "ran": False}
    cards = []
    for i in range(1, n):
        dev = torch.device("cuda", i)
        with torch.cuda.device(dev):
            res = {"card": i}
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[1]
                res[f"attn_{name}"] = attn_case(64, 64, 81, 16, dtype, 60 + i, dev,
                                                timed=False)["max_abs_err"]
                res[f"attn_bwd_{name}"] = attn_bwd_case(64, 64, 81, 16, dtype, 61 + i, dev,
                                                        timed=False)["dx_max_abs_err"]
                res[f"resblock_{name}"] = resblock_case(64, 9, 64, 64, dtype, 62 + i, dev,
                                                        timed=False)["max_abs_err"]
                res[f"attn_core_{name}"] = attn_core_case(64, 81, 64, dtype, True, 63 + i, dev,
                                                          timed=False)["max_abs_err"]
            taps = micro_cf.dots_taps(64, 64)
            w = micro_cf_script.randn((taps, 64, 64), 64 + i, dev)
            x = micro_cf_script.randn((64, 64 * 132), 65 + i, dev)
            y = micro_cf.cf_dots(w, x, 64).float()
            ref = micro_cf.cf_dots_reference(w, x, 64).float()
            allow = 2 * taps * 64 * 2.0 ** -24 * (w.float().abs().sum(0) @ x.float().abs())
            check(bool(((y - ref).abs() <= bf16_ulp(ref) + allow).all()),
                  f"cf_dots on card {i} differs from its plain version")
            res["dots_bf16"] = float((y - ref).abs().max())
            torch.cuda.synchronize()
        cards.append(res)
    return {"cards": n, "ran": True, "per_card": cards}


# ---------------------------------------------------------------------------
# the trace, the training step's decomposition, the studies and the launchers

TRACE_STEPS = 50                  # trace.main's defaults: batch 1024, 50 PC steps
TRACE_BATCH = 1024


def trace_phase() -> dict:
    """``benchmark.trace`` at its defaults, sampling then training: the
    trace holds 5 attention-forward launches for each of the sampler's
    forwards, and 5 forward and 5 backward launches a training step, as do
    the wrappers' counts."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for what in ("sample", "train"):
            r = trace_lib.main(["--what", what, "--outdir", tmp])
            r.pop("output")
            per = r["steps_traced"]
            want = {"fwd": ATTN_BLOCKS_PER_FORWARD * per,
                    "bwd": ATTN_BLOCKS_PER_FORWARD * per if what == "train" else 0}
            check(r["attn_launches_in_trace"] == want == r["attn_launches_by_wrapper"],
                  f"trace {what}: {r['attn_launches_in_trace']} in the trace, "
                  f"{r['attn_launches_by_wrapper']} by the wrappers, expected {want}")
            check(r["device_ms_per_step"] > 0 and r["idle_share"] < 1,
                  f"trace {what}: device {r['device_ms_per_step']} ms, idle {r['idle_share']}")
            r["path"] = os.path.basename(r["path"])
            out[what] = r
    return out


def train_decomp_phase() -> dict:
    """``benchmark.profile_train_decomp`` at batch 4096 (its scaling runs
    in a measuring call): every slope finite and positive, the full step
    slower than the loss alone; a cost count of one step at batch 64 adds
    to the attention wrappers' counts the launches it modeled, 5 a
    direction."""
    r = decomp_lib.main(["--batch", "4096", "--skip_scaling"])
    comps = r["components"]
    check(list(comps) == list(decomp_lib.COMPONENTS), f"components {list(comps)}")
    check(all(math.isfinite(c["ms"]) and c["ms"] > 0 for c in comps.values()),
          f"decomposition slopes {[c['ms'] for c in comps.values()]}")
    check(comps["full"]["ms"] > comps["loss"]["ms"],
          f"full {comps['full']['ms']} ms is not above loss {comps['loss']['ms']} ms")
    # a cost count leaves the wrappers' launch counts as the launches made
    full = decomp_lib.components(decomp_lib.Setup(64, "cuda"))["full"]
    wrappers = (attn_ops.fused_attn_block, attn_ops.fused_attn_block_bwd)
    before = [w.launches for w in wrappers]
    modeled = cost_lib.count_costs(full)["modeled"]
    torch.cuda.synchronize()
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    want = [ATTN_BLOCKS_PER_FORWARD] * 2
    check(launched == [modeled.get(w.__name__) for w in wrappers] == want,
          f"count_costs: {launched} launched, {modeled} modeled, expected {want}")
    keys = ("ms", "gflop", "gb", "effective_gb_per_s", "device_ms", "idle_share", "launches")
    return {"batch": r["batch"], "costs_note": r["costs_note"],
            "count_costs_launches": launched,
            "components": {n: {**{k: c.get(k) for k in keys}, "costs": c["costs"],
                               "top_kernels": c.get("top_kernels", [])[:3]}
                           for n, c in comps.items()}}


STUDY_N = 64
NFE_SWEEP_KEYS = ("run_dir", "n", "sampler", "oracle", "row_key", "timing_note", "rows")


def _finite_json(blob) -> bool:
    if isinstance(blob, dict):
        return all(_finite_json(v) for v in blob.values())
    if isinstance(blob, list):
        return all(_finite_json(v) for v in blob)
    return not isinstance(blob, float) or math.isfinite(blob)


def _shooting_launches() -> dict:
    return {f.__name__: f.launches for f in SHOOT_KERNELS}


def studies_phase() -> dict:
    """The card-side study scripts in process at n = 64 in a temporary
    directory: nfe_sweep (10 and 20 steps, 5 LM iterations, no basin hops),
    clip_excess (250 steps), regrade_benchmark on a 64-row copy of the
    round-2 record (float64 on the card, no basin hops) and
    gt_roundtrip_control on the card.  Each JSON finite; nfe_sweep's with the
    JAX artifact's keys; the shooting kernels launched by every grading."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        before = _shooting_launches()
        nfe = nfe_sweep.main([FLAGSHIP_RUN, str(STUDY_N), "--steps", "10,20", "--max_iters",
                              "5", "--mbh_rounds", "0", "--out", os.path.join(tmp, "nfe.json")])
        launched = {k: v - before[k] for k, v in _shooting_launches().items()}
        check(tuple(nfe) == NFE_SWEEP_KEYS and _finite_json(nfe)
              and [r["steps"] for r in nfe["rows"]] == [10, 20],
              f"nfe_sweep wrote {list(nfe)}")
        check(all(v > 0 for v in launched.values()), f"nfe_sweep launched {launched}")
        out["nfe_sweep"] = {"rows": nfe["rows"], "launches": launched,
                            "wall_s": time.perf_counter() - t}

        t = time.perf_counter()
        ce = clip_excess.main([FLAGSHIP_RUN, "250", str(STUDY_N),
                               "--out", os.path.join(tmp, "ce.json")])
        check(_finite_json(ce) and ce["triples"] == 20 * STUDY_N, f"clip_excess {ce}")
        out["clip_excess"] = {**ce, "wall_s": time.perf_counter() - t}

        t = time.perf_counter()
        src = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024", "gto_halo")
        gto = os.path.join(tmp, "regrade", "gto_halo")
        os.makedirs(gto)
        np.save(os.path.join(gto, "generated_samples.npy"),
                np.load(os.path.join(src, "generated_samples.npy"))[:STUDY_N])
        shutil.copy(os.path.join(src, "gto_halo_results.json"), gto)
        before = _shooting_launches()
        (new,) = regrade_benchmark.main([os.path.join(tmp, "regrade"), "--mbh_rounds", "0"])
        launched = {k: v - before[k] for k, v in _shooting_launches().items()}
        with open(os.path.join(gto, "gto_halo_results.json")) as f:
            updated = json.load(f)
        check(math.isfinite(new["feasible_ratio"]) and math.isfinite(new["local_optimal_ratio"])
              and new["total_tested"] == STUDY_N
              and updated["physical_validation_pre_regrade"]["feasible_ratio"]
              == new["regraded_from"]["feasible_ratio"]
              and all(v > 0 for v in launched.values()), f"regrade {new}, launched {launched}")
        out["regrade"] = {k: new.get(k) for k in ("feasible_ratio", "local_optimal_ratio",
                                                   "oracle_backend", "regraded_from")}
        out["regrade"].update(launches=launched, wall_s=time.perf_counter() - t)

        t = time.perf_counter()
        before = _shooting_launches()
        gt = gt_roundtrip_control.main([os.path.join(ROOT, "datasets",
                                                     "training_data_boundary_80073.pkl"),
                                        str(STUDY_N), "tpu",
                                        "--out", os.path.join(tmp, "gt.json")])
        launched = {k: v - before[k] for k, v in _shooting_launches().items()}
        check(_finite_json(gt) and gt["n"] == STUDY_N and all(v > 0 for v in launched.values()),
              f"gt_roundtrip_control {gt}, launched {launched}")
        out["gt_roundtrip_control"] = {**gt, "launches": launched,
                                       "wall_s": time.perf_counter() - t}
    return out


FANOUT = os.path.join(ROOT, "rdm_tpu_torch", "launch", "datagen_fanout.sh")
FANOUT_WORKERS, FANOUT_SEEDS = 2, 64


def launch_phase(worker_args=("--backend", "tpu", "--save_infeasible")) -> dict:
    """``rdm_tpu_torch/launch/datagen_fanout.sh`` with 2 workers of 64
    seeds on the card (``--backend tpu``, infeasible results kept so that
    the merge has rows): the merged pickle [N, 67], finite, equal to
    prepare_training_data of the workers' result files."""
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "fan")
        env = dict(os.environ, PYTHONPATH=ROOT, PYTHON=sys.executable,
                   WORKERS=str(FANOUT_WORKERS), SEEDS_PER_WORKER=str(FANOUT_SEEDS),
                   RESULT_FOLDER=folder)
        t = time.perf_counter()
        proc = subprocess.run(["bash", FANOUT, *worker_args], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        check(proc.returncode == 0, f"datagen_fanout failed:\n{proc.stderr[-3000:]}")
        (name,) = [f for f in os.listdir(folder) if f.startswith("training_data_boundary_")]
        with open(os.path.join(folder, name), "rb") as f:
            merged = np.asarray(pickle.load(f))
        # the workers' result files alone (the folder also holds the merge)
        results = [f for f in os.listdir(folder) if f.endswith(".pkl") and f != name]
        feasible = sum(f.startswith("feasible_") for f in results)
        again = os.path.join(tmp, "again")
        os.makedirs(again)
        for f in results:
            shutil.copy(os.path.join(folder, f), again)
        n = datagen.prepare_training_data(again)
        with open(os.path.join(again, f"training_data_boundary_{n}.pkl"), "rb") as f:
            want = np.asarray(pickle.load(f))
    check(merged.ndim == 2 and merged.shape[1] == 67 and bool(np.isfinite(merged).all())
          and np.array_equal(merged, want),
          f"the fan-out's pickle {merged.shape} against prepare_training_data's {want.shape}")
    check(len(results) == FANOUT_WORKERS * FANOUT_SEEDS,
          f"{len(results)} result files from {FANOUT_WORKERS} x {FANOUT_SEEDS} seeds")
    return {"workers": FANOUT_WORKERS, "seeds_per_worker": FANOUT_SEEDS,
            "worker_args": list(worker_args),
            "result_files": len(results), "feasible": feasible, "rows": int(merged.shape[0]),
            "wall_s": wall}


# ---------------------------------------------------------------------------
# the legacy 1-D pipeline at the published width

# the flagship's training pickle, which four earlier phases read too (the
# legacy set of 76,668 rows has the same [N, 67] rows; the smoke keeps to one)
LEGACY_1D_PKL = os.path.join(ROOT, "datasets", "training_data_boundary_80073.pkl")
UNET1D_GOLDEN = os.path.join(ROOT, "tests", "golden", "unet1d_golden.npz")
# the published configuration (root train_1d.py's docstring, sample_1d.py's
# defaults): the U-Net's flags of both CLIs
LEGACY_1D_NET = dict(dim=128, channels=1, dim_mults=(4, 4, 8), embed_class_layers_dims=(256, 512),
                     class_dim=1, cond_drop_prob=0.1, mask_val=-1.0, seq_length=66, legacy=True)
LEGACY_1D_FLAGS = ["--unet_dim", "128", "--unet_dim_mults", "4,4,8",
                   "--embed_class_layers_dims", "256,512", "--timesteps", "500"]
LEGACY_1D_PARAMS = 73_802_497
LEGACY_1D_ROWS = 26_691         # the CLI's stride: 80,073 // 26,000 = 3
LEGACY_1D_STEPS = 52            # one epoch: 26,691 // 512
LEGACY_1D_SAMPLES = 64          # cut from the CLI's 1000 for time, at batch 64
# the card's guided forward against the CPU's, float32, TF32 off: of the CPU
# output's largest magnitude
LEGACY_1D_CARD_TOL = 1e-4
# the two training runs of one seed are not bit-equal: cuDNN's default
# backward algorithms and the nearest resize's backward add with atomics,
# so the gradients differ from the first step in the last bits.  The early
# loss spikes of this configuration (1.9 at step 1, then up to 294 by step
# 4) amplify that: the runs drift apart about tenfold every ten steps and,
# after a later spike, by tens of percent.  Held: each of the first 10
# steps' losses within 1e-3 of the other run's; the whole drift is printed.
LEGACY_1D_RERUN_STEPS = 10
LEGACY_1D_RERUN_TOL = 1e-3


@contextlib.contextmanager
def _cli_defaults():
    """PyTorch's own TF32 settings (cuDNN on, matmuls off), which the 1-D
    CLIs leave as they are, for a CLI run in this process (the smoke turns
    TF32 off for its comparisons)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _legacy_1d_train(tmp, tag) -> dict:
    out = os.path.join(tmp, tag)
    with _cli_defaults():
        trainer = train_1d_cli.main(["--data_path", LEGACY_1D_PKL, *LEGACY_1D_FLAGS,
                                     "--batch_size", "512", "--max_epoch", "1",
                                     "--result_folder", out])
    del trainer
    torch.cuda.empty_cache()
    (sub,) = os.listdir(out)
    run = os.path.join(out, sub)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    steps = [m for m in metrics if "train_loss" in m]
    times = [m["time_s"] for m in steps]
    return {"run": run, "losses": [m["train_loss"] for m in steps],
            "val_loss": [m["val_loss"] for m in metrics if "val_loss" in m],
            "ms_per_step": 1e3 * (times[-1] - times[0]) / (len(times) - 1),
            "first_step_ms": 1e3 * times[0]}


def _legacy_1d_sample(tmp, ckpt, tag):
    path = os.path.join(tmp, f"{tag}.pkl")
    said = io.StringIO()
    with _cli_defaults(), contextlib.redirect_stdout(said):
        sample_1d_cli.main(["--checkpoint", ckpt, "--sample_num", str(LEGACY_1D_SAMPLES),
                            "--batch_size", str(LEGACY_1D_SAMPLES), "--diffusion_w", "5.0",
                            *LEGACY_1D_FLAGS, "--output", path])
    torch.cuda.empty_cache()
    rate = float(re.search(r"\(([0-9.eE+-]+) trajectories/s\)", said.getvalue()).group(1))
    with open(path, "rb") as f:
        return pickle.load(f), rate


def _ema_forward(ck, device):
    with torch.device(device):
        model = UNet1D(**LEGACY_1D_NET)
    model.load_state_dict(ck.ema, strict=True)
    model.eval()
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.rand((16, 1, 66), generator=gen, device=device) * 2 - 1
    t = torch.randint(0, 500, (16,), generator=gen, device=device).float()
    c = torch.rand((16, 1), generator=gen, device=device)
    with torch.no_grad():
        return model.forward_with_cond_scale(x, t, c, cond_scale=5.0, rescaled_phi=0.7)


def all_kernel_launches() -> dict:
    """The launch count of every hand-written kernel's wrapper."""
    return {**tiled_launch_counts(), **{f.__name__: f.launches for f in (
        attn_ops.attention_core, micro_cf.cf_transpose, micro_cf.cf_masked_roll_sum,
        micro_cf.cf_dots, *SHOOT_KERNELS)}}


def legacy_1d_phase(device) -> dict:
    before = all_kernel_launches()
    # the reference golden on the card
    g = np.load(UNET1D_GOLDEN)
    golden = UNet1D(dim=16, channels=1, dim_mults=(1, 2, 4), embed_class_layers_dims=(16, 16),
                    class_dim=1, cond_drop_prob=0.0, mask_val=-1.0, seq_length=66, legacy=True)
    golden.load_state_dict({k[3:]: torch.from_numpy(g[k]) for k in g.files
                            if k.startswith("sd.")}, strict=True)
    golden.to(device).eval()
    x, t, c = (torch.from_numpy(g[k]).to(device) for k in ("x", "t", "classes"))
    with torch.no_grad():
        out = golden(x, t, c, cond_drop_prob=0.0).cpu().numpy()
        out_cfg = golden.forward_with_cond_scale(x, t, c, cond_scale=5.0).cpu().numpy()
    np.testing.assert_allclose(out, g["out"], rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(out_cfg, g["out_cfg"], rtol=5e-4, atol=5e-4)
    fields = {"golden_max_abs_err": float(np.abs(out - g["out"]).max()),
              "golden_cfg_max_abs_err": float(np.abs(out_cfg - g["out_cfg"]).max())}

    # the full-width guided forward, card against CPU (weights drawn on the card)
    with torch.device(device):
        card_model = UNet1D(**LEGACY_1D_NET)
    card_model.init_weights(torch.Generator(device=device).manual_seed(0)).eval()
    cpu_model = copy.deepcopy(card_model).cpu()
    n_params = sum(p.numel() for p in cpu_model.parameters())
    check(n_params == LEGACY_1D_PARAMS, f"the published U-Net has {n_params} parameters")
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((8, 1, 66), generator=gen) * 2 - 1
    t = torch.randint(0, 500, (8,), generator=gen).float()
    c = torch.rand((8, 1), generator=gen)
    with torch.no_grad():
        ref = cpu_model.forward_with_cond_scale(x, t, c, cond_scale=5.0, rescaled_phi=0.7)
        with FlopCounterMode(display=False) as flops:
            card = card_model.forward_with_cond_scale(
                x.to(device), t.to(device), c.to(device), cond_scale=5.0, rescaled_phi=0.7).cpu()
    err = float((card - ref).abs().max())
    scale = float(ref.abs().max())
    check(err <= LEGACY_1D_CARD_TOL * scale, f"card against CPU: {err} of {scale}")
    fields["card_vs_cpu"] = {"max_abs_err": err, "scale": scale, "tol": LEGACY_1D_CARD_TOL,
                             "batch": 8, "cond_scale": 5.0, "rescaled_phi": 0.7}
    # the products' operations of one sample's forward (convolutions, linears,
    # attention products; torch's flop counter over the 16-row guided forward)
    fields["gflop_per_sample_forward"] = flops.get_total_flops() / 16 / 1e9
    del cpu_model, card_model

    with tempfile.TemporaryDirectory() as tmp:
        # training: one epoch, twice with one seed
        runs = [_legacy_1d_train(tmp, tag) for tag in ("a", "b")]
        for r in runs:
            losses = np.asarray(r["losses"])
            check(len(losses) == LEGACY_1D_STEPS and bool(np.isfinite(losses).all()),
                  f"train_1d: {len(losses)} losses, finite {np.isfinite(losses).all()}")
            check(losses[-10:].mean() < losses[:10].mean(),
                  f"train_1d losses do not fall: {losses[:10].mean()} -> {losses[-10:].mean()}")
            check(len(r["val_loss"]) == 1, "train_1d ran no validation")
        a, b = (np.asarray(r["losses"]) for r in runs)
        drift = np.abs(a - b) / np.abs(b)
        head = float(drift[:LEGACY_1D_RERUN_STEPS].max())
        check(head <= LEGACY_1D_RERUN_TOL,
              f"train_1d reruns differ by {head} of a loss in their first "
              f"{LEGACY_1D_RERUN_STEPS} steps")
        ckpt = os.path.join(runs[0]["run"], "model-epoch-1.pt")
        fields["train"] = {
            "steps": len(a), "batch": 512, "rows": LEGACY_1D_ROWS,
            "ms_per_step": [r["ms_per_step"] for r in runs],
            "first_step_ms": [r["first_step_ms"] for r in runs],
            "loss_first10_mean": float(a[:10].mean()), "loss_last10_mean": float(a[-10:].mean()),
            "val_loss": [r["val_loss"][0] for r in runs],
            "reruns_bit_equal": bool(np.array_equal(a, b)),
            "reruns_first_differing_step": int(np.argmax(drift > 0)) + 1 if (drift > 0).any()
            else None,
            "reruns_rel_diff_first_steps": head, "rerun_steps_held": LEGACY_1D_RERUN_STEPS,
            "rerun_tol": LEGACY_1D_RERUN_TOL, "reruns_rel_diff_max": float(drift.max()),
            "losses": [a.tolist(), b.tolist()],
            "timing": "host clock between the first and the last step's loss read-back"}

        # sampling from the checkpoint, twice
        (s1, rate1), (s2, rate2) = (_legacy_1d_sample(tmp, ckpt, tag) for tag in ("s1", "s2"))
        check(s1.shape == (LEGACY_1D_SAMPLES, 67) and bool(np.isfinite(s1).all()),
              f"sample_1d output {s1.shape}")
        check(np.array_equal(s1, s2), "sample_1d reruns differ")
        ctrl = s1[:, 4:64].reshape(-1, 20, 3)
        check(bool((s1[:, 0] >= 0.008).all() and (s1[:, 0] <= 0.095).all()
                   and (s1[:, 1] >= 0).all() and (s1[:, 1] <= 40).all()
                   and (ctrl[:, :, 2] >= 0).all() and (ctrl[:, :, 2] <= 1.0).all()
                   and (s1[:, 64] >= 408).all() and (s1[:, 64] <= 470).all()),
              "sample_1d leaves the physical ranges")
        fields["sample"] = {"n": LEGACY_1D_SAMPLES, "batch": LEGACY_1D_SAMPLES, "steps": 500,
                            "w": 5.0, "trajectories_per_second": [rate1, rate2],
                            "bit_equal": True,
                            "sha256": hashlib.sha256(s1.tobytes()).hexdigest(),
                            "cut": f"sample_num 1000 -> {LEGACY_1D_SAMPLES}, batch 1000 -> "
                                   f"{LEGACY_1D_SAMPLES}",
                            "cli": "in process, PyTorch's TF32 defaults"}

        # the checkpoint: restored on the card, written and restored again
        ck = restore_unet1d_checkpoint(ckpt)
        check(ck.step == LEGACY_1D_STEPS and ck.optimizer["count"] == LEGACY_1D_STEPS,
              f"model-epoch-1.pt: step {ck.step}, Adam count {ck.optimizer['count']}")
        first = _ema_forward(ck, device)
        again = os.path.join(tmp, "again.pt")
        save_unet1d_checkpoint(again, ck.step, ck.model, ck.ema, ck.optimizer)
        ck2 = restore_unet1d_checkpoint(again)
        check(all(torch.equal(ck.ema[k], ck2.ema[k]) and torch.equal(ck.model[k], ck2.model[k])
                  for k in ck.model), "the checkpoint's round trip moved a weight")
        check(torch.equal(first, _ema_forward(ck2, device)), "the restored EMA forward moved")
        fields["checkpoint"] = {"step": ck.step, "adam_count": ck.optimizer["count"],
                                "bytes": os.path.getsize(ckpt), "ema_forward_bit_equal": True}
    after = all_kernel_launches()
    check(after == before, f"the 1-D path launched a kernel: {before} -> {after}")
    fields["launches"] = {k: after[k] - before[k] for k in after}
    return fields


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
            ptxas[name] = [ln.strip() for ln in f
                           if "Function properties" in ln or "registers" in ln or "spill" in ln]
    emit("build", t0, libraries=libs, ptxas=ptxas)

    t0 = time.perf_counter()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(attn_case(1024, 64, 81, 16, dtype, 0, device, timed=True))
        cases.append(attn_case(1024, 128, 81, 32, dtype, 1, device, timed=False))
        cases.append(attn_case(3, 64, 81, 16, dtype, 2, device, timed=False))
        cases.append(attn_case(64, 128, 128, 32, dtype, 3, device, timed=False))
    # a batch that no grid of the persistent kernel divides, and the forward
    # at the training shape (about 31 samples a block: every ring stage refilled)
    cases.append(attn_case(1025, 64, 81, 16, torch.bfloat16, 9, device, timed=False))
    cases.append(attn_case(4096, 64, 81, 16, torch.bfloat16, 8, device, timed=True))
    for c in cases:
        print(json.dumps({"attn_case": c}), flush=True)
    emit("kernel", t0, cases=len(cases),
         rows_per_chunk_c128_l128=attn_ops.rows_per_chunk(128, 128))
    main_case = next(c for c in cases if c["B"] == 1024 and c["C"] == 64
                     and c["dtype"] == "bfloat16")
    f32_case = next(c for c in cases if c["B"] == 1024 and c["C"] == 64
                    and c["dtype"] == "float32")
    train_case = next(c for c in cases if c["B"] == 4096)

    t0 = time.perf_counter()
    bwd_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        bwd_cases.append(attn_bwd_case(4096, 64, 81, 16, dtype, 4, device, timed=True))
        bwd_cases.append(attn_bwd_case(1024, 128, 81, 32, dtype, 5, device, timed=False))
        bwd_cases.append(attn_bwd_case(3, 64, 81, 16, dtype, 6, device, timed=False))
        bwd_cases.append(attn_bwd_case(64, 128, 128, 32, dtype, 7, device, timed=False))
    # the tensor-core body also at B 1024, at batches no slot count divides,
    # at one sample, and at L 49 (four warps a block) and 96 (one stage)
    for B, L, seed in ((1024, 81, 10), (4097, 81, 11), (1, 81, 12), (300, 49, 13), (130, 96, 14)):
        bwd_cases.append(attn_bwd_case(B, 64, L, 16, torch.bfloat16, seed, device,
                                       timed=B == 1024))
    for c in bwd_cases:
        print(json.dumps({"attn_bwd_case": c}), flush=True)
    emit("kernel_bwd", t0, cases=len(bwd_cases))
    bwd_main = next(c for c in bwd_cases if c["B"] == 4096 and c["dtype"] == "bfloat16")
    bwd_1024 = next(c for c in bwd_cases if c["B"] == 1024 and c["C"] == 64)
    bwd_f32 = next(c for c in bwd_cases if c["B"] == 4096 and c["dtype"] == "float32")

    t0 = time.perf_counter()
    rb_cases = [resblock_case(1024, H, ci, co, torch.bfloat16, i, device, timed=True)
                for i, (H, ci, co) in enumerate(RESBLOCK_SHAPES)]
    # float32 (the scalar body) timed at the flagship's first shape, beside its bound
    rb_f32 = resblock_case(1024, 9, 64, 64, torch.float32, 20, device, timed=True)
    # ragged: B 3 (one partial group) and 1025 (no persistent grid divides
    # it) at every shape in bfloat16, B 3 at three shapes in float32
    rb_ragged = [resblock_case(B, H, ci, co, torch.bfloat16, 21 + i, device, timed=False)
                 for B in (3, 1025) for i, (H, ci, co) in enumerate(RESBLOCK_SHAPES)]
    rb_ragged += [resblock_case(3, H, ci, co, torch.float32, 41 + i, device, timed=False)
                  for i, (H, ci, co) in enumerate([(9, 64, 64), (4, 64, 128), (2, 256, 128)])]
    for c in rb_cases + [rb_f32] + rb_ragged:
        print(json.dumps({"resblock_case": c}), flush=True)
    rb_forward = {k: per_launch(rb_cases, k) * RESBLOCKS_PER_FORWARD
                  for k in ("ms", "warm_ms", "kernel_ms", "plain_ms", "module_ms", "bound_ms")}
    emit("kernel_resblock", t0, cases=len(rb_cases) + 1 + len(rb_ragged),
         per_forward_at_b1024=rb_forward,
         modeled_weight_bytes_per_forward=per_launch(rb_cases, "modeled_weight_bytes")
         * RESBLOCKS_PER_FORWARD)

    t0 = time.perf_counter()
    core_cases = [attn_core_case(1024, 81, 64, torch.float32, True, 30, device, timed=True),
                  attn_core_case(1024, 81, 64, torch.bfloat16, True, 31, device, timed=True),
                  attn_core_case(1024, 81, 64, torch.bfloat16, False, 32, device, timed=True),
                  attn_core_case(16, 128, 128, torch.bfloat16, True, 33, device, timed=False),
                  attn_core_case(3, 81, 64, torch.bfloat16, True, 34, device, timed=False),
                  # a batch that no grid of the persistent kernel divides
                  attn_core_case(1025, 81, 64, torch.bfloat16, True, 36, device, timed=False),
                  attn_core_case(1025, 81, 64, torch.bfloat16, False, 37, device, timed=False),
                  # the training batch: about 31 samples a block, ring stages reused often
                  attn_core_case(4096, 81, 64, torch.bfloat16, True, 38, device, timed=False)]
    for c in core_cases:
        print(json.dumps({"attn_core_case": c}), flush=True)
    core_main = core_cases[1]
    # attention_core is API only (no model path calls it): one call through
    # its entry point at the flagship attention shape is its path
    gen = torch.Generator(device=device).manual_seed(35)
    qkv = [torch.randn((1024, 81, 64), generator=gen, device=device).to(torch.bfloat16)
           for _ in range(3)]
    attn_ops.attention_core.launches = 0
    core_out = attn_ops.attention_core(*qkv)
    core_launches = attn_ops.attention_core.launches
    check(core_launches == 1 and core_out.shape == (1024, 81, 64)
          and bool(torch.isfinite(core_out.float()).all()), "attention core entry-point call")
    emit("kernel_attn_core", t0, cases=len(core_cases), launches=core_launches)

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
    flag = flagship_sampling(FLAGSHIP_RUN, {}, t0)
    launches = flag["launches"]
    check(flag["resblock_launches"] == 0,
          f"the default flagship path launched the resblock kernel {flag['resblock_launches']} times")
    emit("flagship", t0, **flag)

    t0 = time.perf_counter()
    flag_rb = flagship_sampling(FLAGSHIP_RUN, {"resblock_pallas": True}, t0)
    check(flag_rb["resblock_launches"] == RESBLOCKS_PER_FORWARD * (flag_rb["steps"] - 1),
          f"resblock sampling launched the resblock kernel {flag_rb['resblock_launches']} times")
    emit("flagship_resblock", t0, **flag_rb,
         default_trajectories_per_second=flag["trajectories_per_second"],
         default_ms_per_step=flag["ms_per_step"])

    t0 = time.perf_counter()
    emit("resblock_routing", t0, **resblock_routing_phase(device))

    t0 = time.perf_counter()
    lm = LoadedModel(FLAGSHIP_RUN)
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
    del lm

    t0 = time.perf_counter()
    ode = ode_phase({})
    emit("ode", t0, **ode)

    t0 = time.perf_counter()
    ode_rb = ode_phase({"resblock_pallas": True})
    emit("ode_resblock", t0, **ode_rb)

    t0 = time.perf_counter()
    shoot_cases = cr3bp_kernel_phase(device)
    emit("kernel_cr3bp", t0, cases=list(shoot_cases), tolerances=SHOOT_TOL)

    t0 = time.perf_counter()
    native_fields, native_feasible = oracle_native_phase()
    emit("oracle_native", t0, **native_fields)

    t0 = time.perf_counter()
    gpu, gpu_res = oracle_gpu_phase(native_feasible)
    emit("oracle_gpu", t0, **gpu, native_wall_s=native_fields["wall_s"],
         jax_df32_feasible=SOLVER_FEASIBLE, jax_df32_optimal=SOLVER_OPTIMAL)

    t0 = time.perf_counter()
    emit("run_benchmark", t0, **run_benchmark_phase())

    t0 = time.perf_counter()
    train, yardstick = train_phase(device)
    emit("train", t0, **train)

    t0 = time.perf_counter()
    run_train_fields = run_train_phase(supervised=True)
    emit("run_train", t0, **run_train_fields)

    t0 = time.perf_counter()
    traced = trace_phase()
    emit("trace", t0, **traced)

    t0 = time.perf_counter()
    emit("train_decomp", t0, **train_decomp_phase())

    t0 = time.perf_counter()
    dp = dp_train_phase(device, train, yardstick)
    emit("dp_train", t0, **dp)
    del yardstick

    t0 = time.perf_counter()
    dps = dp_sample_phase(flag)
    emit("dp_sample", t0, **dps)

    t0 = time.perf_counter()
    emit("dp_oracle", t0, **dp_oracle_phase(gpu_res, gpu["f64"]["wall_s"]))

    t0 = time.perf_counter()
    emit("run_train_torchrun", t0, launcher="torchrun --standalone --nproc_per_node 1 (NCCL)",
         **run_train_phase(TORCHRUN_1))

    t0 = time.perf_counter()
    mcf_cases = micro_cf_cases(device)
    for key, c in mcf_cases.items():
        print(json.dumps({"micro_cf_case": {"kernel": key, **c}}), flush=True)
    mcf_kernels = (micro_cf.cf_transpose, micro_cf.cf_masked_roll_sum, micro_cf.cf_dots)
    for f in mcf_kernels:
        f.launches = 0
    mcf = micro_cf_script.main(["--tb", str(MICRO_TB)])
    mcf_launches = {f.__name__: f.launches for f in mcf_kernels}
    check(all(n > 0 for n in mcf_launches.values()) and mcf_launches == mcf["launches"],
          f"the micro_cf entry point did not launch every kernel: {mcf_launches}")
    emit("kernel_micro_cf", t0, launches=mcf_launches, results=mcf)

    t0 = time.perf_counter()
    emit("kernels_per_card", t0, **kernels_per_card_phase())

    t0 = time.perf_counter()
    gen_fields = datagen_phase()
    emit("datagen", t0, **gen_fields)

    t0 = time.perf_counter()
    emit("datagen_fleet", t0, **datagen_fleet_phase())

    t0 = time.perf_counter()
    emit("studies", t0, **studies_phase())

    t0 = time.perf_counter()
    emit("launch", t0, supervisor=run_train_fields["supervisor_lines"],
         supervisor_phase="run_train", datagen_fanout=launch_phase())

    t0 = time.perf_counter()
    emit("family_golden", t0, **family_golden_phase(device))

    t0 = time.perf_counter()
    emit("family_adm", t0, **family_phase(device, "imagenet64c", "adm"))

    t0 = time.perf_counter()
    emit("family_vdm", t0, **family_phase(device, "cifar10", "vdm"))

    t0 = time.perf_counter()
    emit("run_train_families", t0, **run_train_families_phase())

    t0 = time.perf_counter()
    emit("run_train_ddpmpp_kernels", t0, **run_train_families_phase(DDPMPP_KERNEL_ARGS))

    t0 = time.perf_counter()
    tiled_attn, tiled_rb = kernel_tiled_phase(device)
    emit("kernel_tiled", t0, attn_cases=len(tiled_attn), resblock_cases=len(tiled_rb),
         ddpmpp_resblocks_per_forward_at_b64=ddpmpp_forward_sums(tiled_rb),
         attention_forward_at_b64={f"C{c['C']}_L{c['L']}": {
             k: c[k] for k in ("ms", "kernel_ms", "library_ms", "bound_ms", "launch_ms")}
             for c in tiled_attn if "launch_ms" in c},
         attention_backward_at_b64={f"C{c['C']}_L{c['L']}": {
             k: c[k] for k in ("bwd_ms", "bwd_kernel_ms", "bwd_library_ms", "bwd_bound_ms",
                               "bwd_launch_ms")}
             for c in tiled_attn if "bwd_launch_ms" in c})

    t0 = time.perf_counter()
    emit("ddpmpp_attn_routing", t0, **ddpmpp_attn_routing_phase(device))

    t0 = time.perf_counter()
    ddpmpp = ddpmpp_phase(device)
    emit("ddpmpp", t0, **ddpmpp)

    t0 = time.perf_counter()
    emit("legacy_1d", t0, **legacy_1d_phase(device))
    one_way = mcf["transpose_pair"]["one_way"]
    dots = {K: micro_cf_entry(f"cf_dots K={K}", 111, mcf, "cf_dots",
                              mcf_cases[f"dots_k{K}"], mcf[f"dots_k{K}"]) for K in (64, 192)}
    dots[64]["k192"] = {k: dots[192][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms", "copy_floor_ms",
                                                   "chained_ms", "share_of_bound")}

    kernels = [{
        "name": "fused_attn_block",
        "route": "cuda",
        "source": "rdm_tpu_torch/csrc/fused_attn_block.cu",
        "replaces": "rdm_tpu/ops/pallas/attention.py:42::_fused_block_kernel",
        "launches": launches,
        "launches_ode": ode["launches"],
        "launches_dp": {"dp_sample_per_rank": dps["launches"],
                        "dp_train_per_rank": [r[0] for r in
                                              dp["gloo_2_ranks_1_card"]["launches"]]},
        "launches_trace": {w: {"in_trace": traced[w]["attn_launches_in_trace"]["fwd"],
                               "by_wrapper": traced[w]["attn_launches_by_wrapper"]["fwd"]}
                           for w in ("sample", "train")},
        "launches_note": "launches: one 1000-step PC sampling call at batch 1024 (5 a "
                         "forward); launches_ode: one ODE sampling call at batch 1024 "
                         f"(NFE {ode['nfe']}, 5 a forward); launches_dp: each rank of "
                         "phase dp_sample (512 a rank) and of phase dp_train (ii); "
                         "launches_trace: phase trace's traced run (sample: 49 forwards at "
                         "batch 1024; train: 5 steps at batch 1024), kernels in the "
                         "profiler's trace and the wrapper's count",
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "timing": "CUDA-graph slopes; cold: x rotates over more than twice the L2; warm_ms: "
                  "the same x each call; ms: the wrapper call the model makes, kernel_ms: the "
                  "kernel alone, its parameters prepared once",
        "body": main_case["body"],
        "warm_ms": main_case["warm_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "share_of_bound": main_case["share_of_bound"],
        "b4096": {k: train_case[k] for k in ("ms", "kernel_ms", "warm_ms", "plain_ms",
                                             "bound_ms")},
        "max_err_f32": f32_case["max_abs_err"],
        "f32": {k: f32_case[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
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
        "launches_dp": {"dp_train_per_rank": [r[1] for r in
                                              dp["gloo_2_ranks_1_card"]["launches"]]},
        "launches_trace": {"train": {
            "in_trace": traced["train"]["attn_launches_in_trace"]["bwd"],
            "by_wrapper": traced["train"]["attn_launches_by_wrapper"]["bwd"]}},
        "launches_note": "launches: the 20 steps of phase train (5 a step); launches_dp: "
                         "each rank's step in phase dp_train (ii); launches_trace: phase "
                         "trace's 5 traced training steps at batch 1024",
        "max_abs_err": max(bwd_main["dx_max_abs_err"], bwd_main["param_max_abs_err"]),
        "ms": bwd_main["ms"],
        "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": None,
        "timing": "CUDA-graph slopes; cold: x and g rotate over more than twice the L2; "
                  "warm_*: the same x and g each call; ms: the wrapper call the model makes, "
                  "kernel_ms: the kernel alone, its parameters prepared once",
        "body": bwd_main["body"],
        "warm_ms": bwd_main["warm_ms"],
        "kernel_ms": bwd_main["kernel_ms"],
        "kernel_warm_ms": bwd_main["kernel_warm_ms"],
        "share_of_bound": bwd_main["share_of_bound"],
        "b1024": {k: bwd_1024[k] for k in ("ms", "kernel_ms", "warm_ms", "kernel_warm_ms",
                                            "plain_ms", "bound_ms")},
        "f32": {k: bwd_f32[k] for k in ("body", "ms", "kernel_ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        "max_err_f32": max(bwd_f32["dx_max_abs_err"], bwd_f32["param_max_abs_err"]),
        "max_err_bf16": max(bwd_main["dx_max_abs_err"], bwd_main["param_max_abs_err"]),
        "kernel_us": bwd_main["ms"] * 1e3,
        "plain_us": bwd_main["plain_ms"] * 1e3,
        "bound_us": bwd_main["bound_ms"] * 1e3,
        "shape": "B=4096 C=64 L=81 groups=16 bfloat16",
    }, {
        "name": "fused_resblock",
        "route": "cuda",
        "source": "rdm_tpu_torch/csrc/fused_resblock.cu",
        "replaces": "rdm_tpu/ops/pallas/resblock.py:51::_kernel",
        "launches": flag_rb["resblock_launches"],
        "launches_ode": ode_rb["resblock_launches"],
        "launches_note": "launches: one 1000-step PC sampling call at batch 1024 with "
                         "model.resblock_pallas (17 a forward); launches_ode: one ODE "
                         f"sampling call at batch 1024 with it (NFE {ode_rb['nfe']}, 17 a "
                         "forward); 0 on the default paths",
        "max_abs_err": max(c["max_abs_err"] for c in rb_cases),
        "ms": per_launch(rb_cases, "ms"),
        "plain_ms": per_launch(rb_cases, "plain_ms"),
        "bound_ms": per_launch(rb_cases, "bound_ms"),
        "bound_by": "operations" if all(c["bound_by"] == "operations" for c in rb_cases)
                    else "bytes",
        "library_ms": None,
        "timing": "CUDA-graph slopes; cold: x and tembv rotate over more than twice the L2; "
                  "warm_ms: the same inputs each call; ms: the wrapper call the model makes "
                  "(casts and re-lays the weights each call), kernel_ms: the kernel alone, "
                  "its parameters prepared once",
        "warm_ms": per_launch(rb_cases, "warm_ms"),
        "kernel_ms": per_launch(rb_cases, "kernel_ms"),
        "module_ms": per_launch(rb_cases, "module_ms"),
        "max_err_f32": rb_f32["max_abs_err"],
        "f32": {k: rb_f32[k] for k in ("ms", "kernel_ms", "plain_ms", "module_ms", "bound_ms",
                                       "bound_by")},
        "max_err_bf16": max(c["max_abs_err"] for c in rb_cases),
        "per_forward_ms": rb_forward,
        "shape": "mean per launch over the 17 blocks of one forward, B=1024 bfloat16 "
                 "(per shape: the resblock_case lines)",
    }, {
        "name": "attention_core",
        "route": "cuda",
        "source": "rdm_tpu_torch/csrc/attention_core.cu",
        "replaces": "rdm_tpu/ops/pallas/attention.py:26::_attn_kernel",
        "launches": core_launches,
        "max_abs_err": core_main["max_abs_err"],
        "ms": core_main["ms"],
        "plain_ms": core_main["plain_ms"],
        "bound_ms": core_main["bound_ms"],
        "bound_by": core_main["bound_by"],
        "library_ms": core_main["library_ms"],
        "timing": "CUDA-graph slopes; cold: q, k, v rotate over more than twice the L2; "
                  "warm_*: the same inputs each call",
        "warm_ms": core_main["warm_ms"],
        "plain_warm_ms": core_main["plain_warm_ms"],
        "library_warm_ms": core_main["library_warm_ms"],
        "share_of_bound": core_main["share_of_bound"],
        "bf16_scores_in_t": {k: core_cases[2][k] for k in ("max_abs_err", "ms", "warm_ms",
                                                           "library_ms")},
        "f32": {k: core_cases[0][k] for k in ("max_abs_err", "ms", "warm_ms", "plain_ms",
                                              "library_ms", "library_warm_ms", "bound_ms",
                                              "bound_by")},
        "max_err_f32": core_cases[0]["max_abs_err"],
        "max_err_bf16": core_main["max_abs_err"],
        "path": "one call through attention_core (no model path calls it)",
        "shape": "B=1024 L=81 C=64 bfloat16 softmax_f32",
    },
        micro_cf_entry("cf_transpose (N,C)->(C,N)", 49, mcf, "cf_transpose",
                       mcf_cases["transpose_nc_to_cn"], one_way["nc_to_cn"]),
        micro_cf_entry("cf_transpose (C,N)->(N,C)", 56, mcf, "cf_transpose",
                       mcf_cases["transpose_cn_to_nc"], one_way["cn_to_nc"]),
        micro_cf_entry("cf_masked_roll_sum", 85, mcf, "cf_masked_roll_sum",
                       mcf_cases["roll"], mcf["roll"]),
        dots[64],
    ]
    ta, ta32 = tiled_attn[0], tiled_attn[2]
    rb_main = [c for c in tiled_rb if c["B"] == TILED_BATCH and "ms" in c]
    rb_forward = ddpmpp_forward_sums(tiled_rb)
    tiled_note = (f"launches: phase ddpmpp (model=ddpmpp, bf16, both kernels): "
                  f"{DDPMPP_TRAIN_STEPS} training steps at batch {TILED_BATCH} run twice, then "
                  f"PC sampling (N {DDPMPP_SAMPLING_STEPS}) at batch {TILED_BATCH} run twice")
    kernels += [{
        "name": "fused_attn_block (tiled body)",
        "route": "cuda",
        "source": "rdm_tpu_torch/csrc/fused_attn_block_tiled.cu",
        "replaces": "rdm_tpu/ops/pallas/attention.py:42::_fused_block_kernel",
        "launches": ddpmpp["launches"]["fused_attn_block_tiled"],
        "launches_note": tiled_note + "; 17 a forward (C 256, L 256)",
        "max_abs_err": ta["max_abs_err"], "ms": ta["ms"], "kernel_ms": ta["kernel_ms"],
        "launch_ms": ta["launch_ms"], "plain_ms": ta["plain_ms"],
        "bound_ms": ta["bound_ms"], "bound_by": ta["bound_by"], "library_ms": None,
        "module_ms": ta["library_ms"],
        "module_note": "the unfused block from PyTorch calls: F.group_norm, the NINs as "
                       "matmuls, F.scaled_dot_product_attention (no single call)",
        "timing": "cold: x rotates over more than twice the L2, CUDA-graph slopes",
        "share_of_bound": ta["share_of_bound"],
        "nf32": {k: ta32[k] for k in ("B", "C", "L", "max_abs_err", "ms", "kernel_ms",
                                      "launch_ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")},
        "shape": "B=64 C=256 L=256 groups=32 bfloat16",
    }, {
        "name": "fused_attn_block_bwd (tiled body)",
        "route": "cuda",
        "source": "rdm_tpu_torch/csrc/fused_attn_block_tiled.cu",
        "replaces": "rdm_tpu/ops/pallas/attention.py:101::_fused_block_bwd_kernel",
        "launches": ddpmpp["launches"]["fused_attn_block_bwd_tiled"],
        "launches_note": tiled_note + "; 17 a training step",
        "max_abs_err": max(ta["dx_max_abs_err"], ta["param_max_abs_err"]),
        "ms": ta["bwd_ms"], "kernel_ms": ta["bwd_kernel_ms"], "launch_ms": ta["bwd_launch_ms"],
        "plain_ms": ta["bwd_plain_ms"], "bound_ms": ta["bwd_bound_ms"],
        "bound_by": ta["bwd_bound_by"], "library_ms": None,
        "module_ms": ta["bwd_library_ms"],
        "module_note": "autograd through the unfused library block (its forward included, "
                       "as the kernel recomputes the forward)",
        "timing": "cold: x and g rotate over more than twice the L2, CUDA-graph slopes",
        "share_of_bound": ta["bwd_share_of_bound"],
        "nf32": {k: ta32[k] for k in ("dx_max_abs_err", "param_max_abs_err", "bwd_ms",
                                      "bwd_kernel_ms", "bwd_launch_ms", "bwd_plain_ms",
                                      "bwd_library_ms", "bwd_bound_ms")},
        "shape": "B=64 C=256 L=256 groups=32 bfloat16",
    }, {
        "name": "fused_resblock (tiled body)",
        "route": "cuda",
        "source": "rdm_tpu_torch/csrc/fused_resblock_tiled.cu",
        "replaces": "rdm_tpu/ops/pallas/resblock.py:51::_kernel",
        "launches": ddpmpp["launches"]["fused_resblock_tiled"],
        "launches_note": tiled_note + "; 70 a forward (the training steps keep the module "
                         "path under the config's dropout)",
        "max_abs_err": max(c["max_abs_err"] for c in rb_main),
        "ms": rb_forward["ms"] / DDPMPP_RESBLOCKS,
        "kernel_ms": rb_forward["kernel_ms"] / DDPMPP_RESBLOCKS,
        "plain_ms": rb_forward["plain_ms"] / DDPMPP_RESBLOCKS,
        "bound_ms": rb_forward["bound_ms"] / DDPMPP_RESBLOCKS,
        "bound_by": "operations" if all(c["bound_by"] == "operations" for c in rb_main)
                    else "bytes",
        "library_ms": None, "module_ms": rb_forward["module_ms"] / DDPMPP_RESBLOCKS,
        "module_note": "the unfused ResnetBlockDDPMpp (cuDNN convolutions)",
        "timing": "cold: x and tembv rotate over more than twice the L2, CUDA-graph slopes",
        "per_forward_ms": rb_forward,
        "shape": "mean per launch over DDPM++'s 70 blocks of one forward, B=64 bfloat16 "
                 "(per shape: the tiled_resblock_case lines)",
    }]
    for k in kernels[4:6]:
        k["launches_note"] += "; one wrapper and one count for both directions"
    shoot_note = ("launches: one 1024-lane grading of the round-2 samples at 8 basin hops, "
                  "optimal mode, float64 (precision df32); launches_f32: the same in float32; "
                  f"launches_datagen: generate_data --backend tpu on {GEN_SEEDS} uniform "
                  "guesses, optimal mode, float32 (phase datagen)")
    for name, key, key32, replaces in (
            ("shoot_legs", "legs_f64", "legs_f32",
             "no Pallas kernel: rdm_tpu/physics/solver_tpu.py:150 (_shoot_forward, "
             "_shoot_backward: lax.scan legs)"),
            ("manifold_target", "target_f64", "target_f32",
             "no Pallas kernel: rdm_tpu/physics/manifold.py:137 (manifold_target_from_data) "
             "and dynamics_df.py:222"),
            ("shoot_jvp", "jvp_f32", None,
             "no Pallas kernel: rdm_tpu/physics/solver_tpu.py:252 (jacrev of _residual)")):
        c = shoot_cases[key]
        entry = {"name": name, "route": "cuda", "source": "rdm_tpu_torch/csrc/cr3bp_shoot.cu",
                 "replaces": replaces, "launches": gpu["f64"]["launches"][name],
                 "launches_f32": gpu["f32"]["launches"][name],
                 "launches_datagen": gen_fields["launches"][name], "launches_note": shoot_note,
                 "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
                 "err_quantiles": c["err_quantiles"], "mass_err": c["mass_err"],
                 "err_note": "max_abs_err: over every row, the few that pass close to a "
                             "primary included (there either version's digits are rounding "
                             "noise); err_quantiles: the per-row errors held to tol (SHOOT_TOL)",
                 "tol": c["tol"], "gflop": c["gflop"],
                 "share_of_bound": c["share_of_bound"],
                 "timing": "cold: a 256 MB write flushes the L2 before each of 5 launches, "
                           "CUDA events; plain_ms one call, host clock",
                 "shape": f"{c['rows']} rows, {c['dtype']}"}
        if key32:
            entry["f32"] = {k: shoot_cases[key32][k] for k in
                            ("rows", "max_abs_err", "err_quantiles", "mass_err", "tol", "ms",
                             "plain_ms", "bound_ms", "share_of_bound")}
        if name == "shoot_legs":
            entry["whole_arc_f32"] = {k: shoot_cases["arc_f32"][k] for k in
                                      ("rows", "max_abs_err", "err_quantiles", "mass_err", "ms",
                                       "plain_ms", "bound_ms")}
        chain = shoot_cases["chain"]
        entry["registers"] = {k: v for k, v in chain["registers"].items() if k.startswith(name)}
        if name == "manifold_target":
            entry["lanes_a_row"] = chain["lanes_a_row"]
            entry["ms_by_rows"] = chain["manifold_target_ms"]
        if name == "shoot_jvp":
            entry["lanes_a_row"] = chain["lanes_a_row"]["float32"]
            entry["ms_by_lanes"] = dict(chain["shoot_jvp_ms"], **{f"{c['rows']} lanes": c["ms"]})
        kernels.append(entry)
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
