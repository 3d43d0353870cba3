"""What bounds the hand-written tensor-core kernels: each kernel built again
with one part knocked out, and timed cold beside the whole one.

    python -m rdm_tpu_torch.benchmark.knockouts

It needs the card and ``nvcc``.  Each variant is ``csrc/`` copied into
``rdm_tpu_torch/_build/knockouts/<variant>/`` with one source edit; all of
them build at once (one ``nvcc`` each) and are called through the same C
interface as the package's wrappers (``ops.attention.attention_core``,
``ops.micro_cf.cf_dots``; the fused resblock and attention forward through
the launchers their wrappers build, bound to the variant's library).
Times are cold, as
``scripts/micro_cf.py`` takes them: the slope over CUDA graphs of 50 and
500 calls, inputs rotating over more than twice the L2.  The shapes are
the flagship attention's (B 1024, L 81, C 64, bfloat16, both softmax
settings for the core; the backward at B 4096), the TPU script's dots (C 64, N 20,736, K 64 and
192), transposes and roll sum (C 64, N 20,736) and the flagship's eight
resblock shapes at B 1024, bfloat16.  A
knocked-out variant computes wrong values: only its time means anything.

Variants:
* attention core: ``whole``; ``no_exp`` (the softmax's exps skipped);
  ``load_store`` (the TMA ring, the staging and the stores, no products and
  no softmax), the floor of moving the 42.5 MB through this kernel;
* dots: ``whole``; ``no_products`` (no wgmma); ``no_w`` (w neither loaded
  nor waited for);
* transpose (both directions): ``whole``; ``copy`` (the ldmatrix/stmatrix
  transposition replaced by a straight copy of the tile between the same
  stages: the same TMA loads and stores);
* roll sum: ``whole``; ``no_taps`` (each thread stores its own chunk: the
  loads, the staging and the stores, no taps);
* fused resblock (bfloat16): ``whole``; ``no_products`` (no wgmma; the A
  fragments are still loaded); ``no_groupnorm`` (no GroupNorm: neither the
  statistics nor the normalisation and SiLU passes); ``no_ring``
  (no weight stage loaded or waited for); ``mma_sync`` (not a knock-out:
  the products on mma.sync, each warp loading its B fragments by ldmatrix,
  instead of wgmma; its error against the plain version is printed beside
  ``whole``'s);
* fused attention forward (bfloat16): ``whole``; ``no_products`` (no NIN
  mma.sync, and no attention: neither products nor softmax);
  ``no_attention`` (the NINs run, the attention does not); ``no_staging``
  (the weights not staged into shared memory);
* fused attention backward (bfloat16, tensor-core body, at the training
  batch B 4096): ``whole`` (with its error against the plain version);
  ``no_products`` (each mma.sync replaced by an integer fold of its
  operands into one float: the operands are still loaded and built); ``no_weight_grads`` (the weight and bias gradient products and
  their accumulation skipped); ``load_store`` (everything between a
  sample's arrival and its dx store cut out: the TMA loads, the bulk
  stores, the weight staging and the slot writes are left);
* the solver's manifold target (``manifold_target`` of
  ``csrc/cr3bp_shoot.cu`` in both types at 1, 1024 and a grading's largest
  row count, round-2 rows): ``whole``; ``halo_only`` (the back-integration
  cut to no steps); ``back_only`` (the halo phase cut to no steps);
* its float32 Jacobian (``shoot_jvp`` at L 1024, round-2 lanes): ``whole``;
  ``legs_only`` (the target columns 64 and 65 return at once);
  ``targets_only`` (the 64 leg columns return at once).
  The shooting kernels' times are taken as ``chip_smoke.py`` takes them,
  in ms: the L2 flushed before each of five launches, CUDA events.

    python -m rdm_tpu_torch.benchmark.knockouts --only target,jvp

runs these alone (``--only`` takes prefixes of the variants' names);
``benchmark/shoot_chain.py`` times them for two copies of the source in
turns.

The edits match the sources' text; one that no longer matches raises and
names itself.  The last line printed is one JSON object of all the times.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops import attention as attn_ops
from ..ops import cr3bp as shoot_ops
from ..ops import micro_cf
from ..ops import resblock as rb_ops
from ..scripts.micro_cf import cold_us, describe, randn
from .common import cold_ms, shoot_inputs

OUT = os.path.join(_build.BUILD_DIR, "knockouts")
B, L, C = 1024, 81, 64
N = 81 * 256
# (H, C_in, C_out) of the flagship NCSN++'s 17 resblocks, and how many a
# forward has of each
FLAGSHIP_BLOCKS = {(9, 64, 64): 2, (4, 64, 128): 1, (4, 128, 128): 1, (2, 128, 128): 4,
                   (2, 256, 128): 3, (4, 256, 128): 3, (9, 192, 64): 1, (9, 128, 64): 2}

# (source file, text, replacement) per variant
EDITS = {
    "core_whole": ("attention_core.cu", None, None),
    "core_no_exp": ("attn_mma.cuh", "float2 e = make_float2(expf(d.x), expf(d.y));",
                    "float2 e = d;"),
    "core_load_store": ("attn_mma.cuh", "  // S = q k^T: 2 NT tiles of 8 keys.",
                        "  if (L > 0) {\n    for (int n = 0; n < 2 * CT; ++n) o[n][0] = o[n][1] = "
                        "o[n][2] = o[n][3] = 0.f;\n    return;\n  }\n"
                        "  // S = q k^T: 2 NT tiles of 8 keys."),
    "dots_whole": ("micro_cf.cu", None, None),
    "dots_no_products": ("micro_cf.cu", "        wgmma_64x64x16(acc, da, db);",
                         "        if (K < 0) wgmma_64x64x16(acc, da, db);"),
    "dots_no_w": ("micro_cf.cu", "      mbar_wait(wbar + t, 0);",
                  "      if (K < 0) mbar_wait(wbar + t, 0);"),
    "transpose_whole": ("micro_cf.cu", None, None),
    "transpose_copy": ("micro_cf.cu", "    transpose_tile<T, T>(in, out, lane);",
                       "    for (int c = lane; c < T * T / 8; c += 32)\n"
                       "      reinterpret_cast<uint4*>(out)[c] = reinterpret_cast<const uint4*>(in)[c];"),
    "roll_whole": ("micro_cf.cu", None, None),
    "roll_no_taps": ("micro_cf.cu",
                     "  y[g] = make_uint4(pack_bf16_rn(acc[0], acc[1]), pack_bf16_rn(acc[2], acc[3]),\n"
                     "                    pack_bf16_rn(acc[4], acc[5]), pack_bf16_rn(acc[6], acc[7]));",
                     "  y[g] = v;"),
}
EDITS.update({
    "resblock_whole": ("fused_resblock.cu", None, None),
    "resblock_no_products": (
        "fused_resblock.cu",
        "            wgmma_rs<NT>(acc[mt], a[k16][mt], sw128_desc(stage + n0 * 128 + 32 * k16, 16, 1024));",
        "            if (kc < 0) wgmma_rs<NT>(acc[mt], a[k16][mt], sw128_desc(stage + n0 * 128 + 32 * k16, 16, 1024));"),
    "resblock_no_groupnorm": ("fused_resblock.cu", "  for (int base = 0; base < pairs * P; base += nthreads) {",
                              "  for (int base = 0; base < 0; base += nthreads) {"),
    "resblock_no_ring": ("fused_resblock.cu",
                         "      mbar_wait(full + slot, resident ? 0 : rp.fill & 1);",
                         "      if (kc < 0) mbar_wait(full + slot, resident ? 0 : rp.fill & 1);"),
    "resblock_mma_sync": ("fused_resblock.cu", "constexpr bool kWgmma = true;",
                          "constexpr bool kWgmma = false;"),
    "attn_whole": ("fused_attn_block.cu", None, None),
    "attn_no_products": ("fused_attn_block.cu",
                         "      mma_bf16(acc[2 * j], a[kk], b[j][0], b[j][1]);\n"
                         "      mma_bf16(acc[2 * j + 1], a[kk], b[j][2], b[j][3]);",
                         "      if (lane < 0) mma_bf16(acc[2 * j], a[kk], b[j][0], b[j][1]);\n"
                         "      if (lane < 0) mma_bf16(acc[2 * j + 1], a[kk], b[j][2], b[j][3]);"),
    "attn_no_attention": ("fused_attn_block.cu",
                          "    attn_rows16<NT, 4, false>(qp, kp, vp, r0, L, scale, acc);",
                          "    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = "
                          "acc[n][3] = 0.f;"),
    "attn_no_staging": ("fused_attn_block.cu",
                        "      if (i < kItems)\n#pragma unroll",
                        "      if (i < 0)\n#pragma unroll"),
})
EDITS.update({
    "bwd_whole": ("fused_attn_block_bwd.cu", None, None),
    "bwd_no_products": ("fused_attn_block_bwd.cu", "  mma_bf16(d, a, b0, b1);",
                        "  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0xffu);"),
    "bwd_no_weight_grads": ("fused_attn_block_bwd.cu",
                            "    for (int u = w; u < kTcUnits; u += NT) {",
                            "    for (int u = w; u < 0; u += NT) {"),
    "bwd_load_store": ("fused_attn_block_bwd.cu",
                       "    // 0. GroupNorm statistics: group gi is cg * L contiguous values; a",
                       ""),
})
# the shooting Jacobian's column groups: each edit returns at the top of the
# other group's branch (the anchors are in the parent's source too)
JVP_TARGETS = "    // the target's columns: the phase (64) and the arc length (65)\n"
JVP_LEGS = "    // the legs against the fixed target, one variable seeded\n"
# the manifold target's two phases: the back-integration or the halo phase
# cut to no steps
EDITS.update({
    "target_whole": ("cr3bp_shoot.cu", None, None),
    "target_halo_only": ("cr3bp_shoot.cu", "constexpr int kManifoldSteps = 1024;",
                         "constexpr int kManifoldSteps = 0;"),
    "target_back_only": ("cr3bp_shoot.cu", "constexpr int kHaloSteps = 256;",
                         "constexpr int kHaloSteps = 0;"),
    "jvp_whole": ("cr3bp_shoot.cu", None, None),
    "jvp_legs_only": ("cr3bp_shoot.cu", JVP_TARGETS, JVP_TARGETS + "    if (L > 0) return;\n"),
    "jvp_targets_only": ("cr3bp_shoot.cu", JVP_LEGS, JVP_LEGS + "    if (L > 0) return;\n"),
})
# a variant that cuts its source from its edit's text up to this text
CUT_TO = {"bwd_load_store": "    fence_proxy_async();             // the bulk store reads these bytes"}
# further edits of four variants: the dots load no w, the resblock's
# producer loads nothing, its normalisation and SiLU passes are skipped, the
# attention forward skips attn_rows16 (its products and softmax)
NO_RING_LOAD = ("    if (lane == 0) {\n      const unsigned char* src",
                "    if (lane == 0 && B < 0) {\n      const unsigned char* src")
NO_NORM = ("  for (int i = tid; i < G::M * chunks; i += nthreads) {",
           "  for (int i = tid; i < 0; i += nthreads) {")
NO_ATTENTION = ("    attn_rows16<NT, 4, false>(qp, kp, vp, r0, L, scale, acc);",
                "    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;")
# the source each variant's library is built from, by prefix
MAIN_SOURCE = {"core": "attention_core.cu", "dots": "micro_cf.cu", "transpose": "micro_cf.cu",
               "roll": "micro_cf.cu",
               "resblock": "fused_resblock.cu", "attn": "fused_attn_block.cu",
               "bwd": "fused_attn_block_bwd.cu", "target": "cr3bp_shoot.cu",
               "jvp": "cr3bp_shoot.cu"}
NO_W_LOAD = ("      for (int t = 0; t < taps; ++t) {\n        mbar_expect_tx",
             "      for (int t = 0; t < 0; ++t) {\n        mbar_expect_tx")


def _edit(src: str, old: str, new: str, name: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"knockout {name}: the source has {old!r} "
                           f"{src.count(old)} times, not once")
    return src.replace(old, new)


def edited_source(name: str, csrc: str = _build.CSRC_DIR):
    """The file a variant edits and its edited text (of the copy of
    ``csrc/`` at ``csrc``)."""
    fname, old, new = EDITS[name]
    with open(os.path.join(csrc, fname)) as f:
        src = f.read()
    if name in CUT_TO:
        _edit(src, old, new, name)
        start = src.index(old)
        _edit(src[start:], CUT_TO[name], "", name)
        src = src[:start] + src[src.index(CUT_TO[name], start):]
    elif old is not None:
        src = _edit(src, old, new, name)
    more = {"dots_no_w": [NO_W_LOAD], "resblock_no_ring": [NO_RING_LOAD],
            "resblock_no_groupnorm": [NO_NORM],
            "attn_no_products": [NO_ATTENTION]}
    for old_text, new_text in more.get(name, []):
        src = _edit(src, old_text, new_text, name)
    return fname, src


def build_variants(names=None, csrc: str = _build.CSRC_DIR, out: str = OUT) -> dict:
    """Build the variants ``names`` (default: all) of the copy of ``csrc/``
    at ``csrc`` at once, one nvcc each, into ``out/<name>``; return each
    library's path by name.  Every edit is made before the first nvcc
    starts, so one that no longer applies leaves no compiler running.  The
    compiler's resource report (``-Xptxas -v``) is kept as ``lib.log``
    beside each library."""
    edited = {name: edited_source(name, csrc) for name in (names or EDITS)}
    jobs = {}
    for name, (fname, src) in edited.items():
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        with open(os.path.join(d, fname), "w") as f:
            f.write(src)
        main = MAIN_SOURCE[name.split("_")[0]]
        lib = os.path.join(d, "lib.so")
        jobs[name] = (lib, subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                                             os.path.join(d, main)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    failed = []
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{log[-3000:]}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: lib for name, (lib, _) in jobs.items()}


def core_fn(lib, softmax_f32: bool):
    lib.rdm_attention_core.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                       + [ctypes.c_float, ctypes.c_void_p])

    def fn(qkv):
        q, k, v = qkv
        out = torch.empty_like(q)
        err = lib.rdm_attention_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     B, L, C, 1, int(not softmax_f32), C ** -0.5,
                                     torch.cuda.current_stream().cuda_stream)
        _build.raise_on(lib, err, "attention_core knockout")
        return out
    return fn


def dots_fn(lib, w, K: int):
    lib.rdm_cf_dots.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    taps = w.shape[0]
    plan = micro_cf.dots_plan(taps, K)

    def fn(x):
        out = torch.empty((C, N), dtype=torch.bfloat16, device=x.device)
        err = lib.rdm_cf_dots(w.data_ptr(), x.data_ptr(), out.data_ptr(), taps, K, N,
                              plan.stages, plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
        _build.raise_on(lib, err, "cf_dots knockout")
        return out
    return fn


@contextlib.contextmanager
def bound_to(lib):
    """Inside, the package's wrappers load ``lib`` (a variant built from the
    same C interface) in place of their own library."""
    real = _build.library

    def library(name, fn_name, argtypes, extra=()):
        for fname, args, res in [(fn_name, argtypes, ctypes.c_int), *extra]:
            getattr(lib, fname).argtypes = args
            getattr(lib, fname).restype = res
        return lib

    _build.library = library
    try:
        yield
    finally:
        _build.library = real


def resblock_times(libs, device) -> dict:
    """Cold us of each resblock variant at the flagship's eight shapes (B
    1024), and the mean per launch over the 17 blocks of a forward; for
    ``whole`` and ``mma_sync`` also the largest error against the plain
    version in bf16 steps of the output's largest magnitude."""
    times = {}
    per_forward = sum(FLAGSHIP_BLOCKS.values())
    for name in ("resblock_whole", "resblock_mma_sync", "resblock_no_products",
                 "resblock_no_groupnorm", "resblock_no_ring"):
        mean = 0.0
        for (H, ci, co), count in FLAGSHIP_BLOCKS.items():
            g = torch.Generator(device=device).manual_seed(H + ci + co)
            f = lambda *shape: torch.randn(shape, generator=g, device=device)
            params = [1 + 0.1 * f(ci), 0.1 * f(ci), f(co, ci, 3, 3) / (9 * ci) ** 0.5,
                      0.1 * f(co), 1 + 0.1 * f(co), 0.1 * f(co), f(co, co, 3, 3) / (9 * co) ** 0.5,
                      0.1 * f(co)]
            params += [f(ci, co) / ci ** 0.5, 0.1 * f(co)] if ci != co else [None, None]
            kw = dict(groups0=min(ci // 4, 32), groups1=min(co // 4, 32))
            with bound_to(libs[name]):
                launch = rb_ops._launcher(*params, H=H, dtype=torch.bfloat16, **kw)
            make = lambda i: (randn((B, ci, H, H), 2 * i, device), randn((B, co), 2 * i + 1, device))
            us = cold_us(lambda t: launch(*t), make, 2 * B * (ci * H * H + co), device)
            times[f"{name} ({H},{ci},{co})"] = us
            mean += us * count / per_forward
            err = ""
            if name in ("resblock_whole", "resblock_mma_sync"):
                x, tembv = make(0)
                ref = rb_ops.fused_resblock_reference(x, tembv, *params, **kw).float()
                steps = float((launch(x, tembv).float() - ref).abs().max()
                              / (2.0 ** -8 * max(1.0, float(ref.abs().max()))))
                times[f"{name} ({H},{ci},{co}) err_bf16_steps"] = steps
                err = f", {steps:.2f} bf16 steps from plain"
            print(f"resblock ({H},{ci},{co}) {name[9:]:<12s}: cold {us:.2f} us{err}", flush=True)
        times[f"{name} mean"] = mean
        print(f"resblock mean per launch {name[9:]:<12s}: cold {mean:.2f} us", flush=True)
    return times


def attn_times(libs, device) -> dict:
    """Cold us of each attention-forward variant at B 1024, C 64, L 81."""
    times = {}
    g = torch.Generator(device=device).manual_seed(5)
    f = lambda *shape: torch.randn(shape, generator=g, device=device)
    params = [1 + 0.1 * f(C), 0.1 * f(C)]
    for _ in range(4):
        params += [f(C, C) / C ** 0.5, 0.1 * f(C)]
    for name in ("attn_whole", "attn_no_products", "attn_no_attention", "attn_no_staging"):
        with bound_to(libs[name]):
            launch = attn_ops._launcher(*params, C=C, L=L, dtype=torch.bfloat16, groups=16)
        us = cold_us(launch, lambda i: randn((B, C, 9, 9), i, device), 2 * B * C * L, device)
        times[name] = us
        print(f"attention forward {name[5:]:<12s}: cold {us:.2f} us", flush=True)
    return times


def bwd_times(libs, device) -> dict:
    """Cold us of each backward variant at B 4096, C 64, L 81 (the kernel
    alone, parameters prepared once), and the whole one's largest errors
    against the plain version in bf16 steps of each output's scale."""
    times = {}
    Bt = 4096
    g = torch.Generator(device=device).manual_seed(6)
    f = lambda *shape: torch.randn(shape, generator=g, device=device)
    params = [1 + 0.1 * f(C), 0.1 * f(C)]
    for _ in range(4):
        params += [f(C, C) / C ** 0.5, 0.1 * f(C)]
    make = lambda i: (randn((Bt, C, 9, 9), 2 * i, device), randn((Bt, C, 9, 9), 2 * i + 1, device))
    for name in ("bwd_whole", "bwd_no_products", "bwd_no_weight_grads", "bwd_load_store"):
        with bound_to(libs[name]):
            launch = attn_ops._bwd_launcher(*params, C=C, L=L, dtype=torch.bfloat16, groups=16)
        us = cold_us(lambda t: launch(*t), make, 2 * 2 * Bt * C * L, device)
        times[name] = us
        err = ""
        if name == "bwd_whole":
            x, gg = make(0)
            dx, grads = launch(x, gg)
            ref = attn_ops.fused_attn_block_bwd_reference(x, gg, *params, groups=16)
            flat = torch.cat([r.flatten() for r in ref[1:]])
            steps = max(float((dx.float() - ref[0].float()).abs().max())
                        / (2.0 ** -8 * max(1.0, float(ref[0].float().abs().max()))),
                        float((grads - flat).abs().max()) / (2.0 ** -8 * float(flat.abs().max())))
            times["bwd_whole err_bf16_steps"] = steps
            err = f", {steps:.2f} bf16 steps from plain"
        print(f"attention backward {name[4:]:<15s}: cold {us:.2f} us{err}", flush=True)
    return times


# manifold_target's row counts: 1 (the chain's own time), 1024, and the
# largest launch of a grading in each type
TARGET_ROWS = {torch.float64: (1, 1024, 10240), torch.float32: (1, 1024, 8192)}
JVP_L = 1024


def target_key(dtype, rows: int) -> str:
    return f"{'f64' if dtype == torch.float64 else 'f32'} {rows} rows"


def target_cases(device) -> dict:
    """manifold_target's arguments at each of ``TARGET_ROWS``, by name:
    round-2 lanes with tau and length moved a little, as the solver's ladder
    moves them."""
    cases = {}
    for dtype, counts in TARGET_ROWS.items():
        for rows in counts:
            theta, d64, d32, _ = shoot_inputs(rows, 40, device)
            gen = torch.Generator(device=device).manual_seed(41)
            tau = (theta[:, 64] + 0.01 * torch.randn(rows, generator=gen, device=device,
                                                     dtype=torch.float64)).clamp(0, 1)
            length = (theta[:, 65] + 0.1 * torch.randn(rows, generator=gen, device=device,
                                                       dtype=torch.float64)).clamp(5, 11)
            cases[target_key(dtype, rows)] = (*(d64 if dtype == torch.float64 else d32),
                                           tau.to(dtype).contiguous(),
                                           length.to(dtype).contiguous())
    return cases


def target_times(libs, cases, label: str = "") -> dict:
    """Cold ms (mean of five) of each manifold_target variant of ``libs`` on
    each of ``cases`` (``target_cases``), as ``chip_smoke.py`` takes the
    shooting kernels': the L2 flushed before each launch, CUDA events."""
    times = {}
    for name in ("target_whole", "target_halo_only", "target_back_only"):
        if name not in libs:
            continue
        for key, a in cases.items():
            with bound_to(libs[name]):
                t = float(np.mean(cold_ms(lambda: shoot_ops.manifold_target(*a))))
            times[f"{name} {key}"] = t
            print(f"manifold_target {key:<15s} {label}{name[7:]:<10s}: cold {t:.4f} ms",
                  flush=True)
    return times


def jvp_args(L: int, device):
    """shoot_jvp's arguments at L lanes: the float32 theta, each lane's
    float32 target and halo data, as one LM iteration of a float32 grading
    gives them."""
    theta, _, d32, sp = shoot_inputs(L, 30, device)
    th = theta.float()
    tgt = shoot_ops.manifold_target_reference(*d32, th[:, 64].contiguous(),
                                              th[:, 65].contiguous())
    return (th, tgt, *d32, sp.float(), 1.0, 20, 5.0, 11.0)


def jvp_times(libs, args, label: str = "") -> dict:
    """Cold ms (mean of five) of each shoot_jvp variant of ``libs`` on
    ``args`` (``jvp_args``), taken as ``target_times`` takes them."""
    times = {}
    for name in ("jvp_whole", "jvp_legs_only", "jvp_targets_only"):
        if name not in libs:
            continue
        with bound_to(libs[name]):
            times[name] = float(np.mean(cold_ms(lambda: shoot_ops.shoot_jvp(*args))))
        print(f"shoot_jvp L {len(args[0])} {label}{name[4:]:<13s}: cold {times[name]:.4f} ms",
              flush=True)
    return times


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", default="", help="comma-separated prefixes of the variants to run "
                   "(core, dots, transpose, roll, resblock, attn, bwd, target, jvp); default all")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("knockouts: needs a CUDA card")
    device = torch.device("cuda")
    print(describe(device), flush=True)
    only = tuple(x for x in args.only.split(",") if x)
    names = [n for n in EDITS if not only or n.split("_")[0] in only]
    libs = {name: ctypes.CDLL(path) for name, path in build_variants(names).items()}
    for lib in libs.values():
        lib.rdm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rdm_cuda_error_string.restype = ctypes.c_char_p
    times = {}
    have = lambda prefix: f"{prefix}_whole" in libs

    def make_qkv(i):
        return tuple(randn((B, L, C), 3 * i + t, device) for t in range(3))

    qkv_bytes = 3 * B * L * C * 2
    for softmax_f32 in ((True, False) if have("core") else ()):
        tag = "softmax_f32" if softmax_f32 else "scores_in_t"
        for name in ("core_whole", "core_no_exp", "core_load_store"):
            us = cold_us(core_fn(libs[name], softmax_f32), make_qkv, qkv_bytes, device)
            times[f"{name} {tag}"] = us
            print(f"attention core {name[5:]:<11s} {tag}: cold {us:.2f} us", flush=True)
    if have("core"):
        sdpa = lambda t: torch.nn.functional.scaled_dot_product_attention(
            *(x.unsqueeze(1) for x in t))
        times["sdpa"] = cold_us(sdpa, make_qkv, qkv_bytes, device)
        print(f"scaled_dot_product_attention: cold {times['sdpa']:.2f} us", flush=True)
    for K in ((C, 3 * C) if have("dots") else ()):
        w = randn((micro_cf.dots_taps(C, K), C, K), 0, device)
        make_x = lambda i, K=K: randn((K, N), 1 + i, device)
        for name in ("dots_whole", "dots_no_products", "dots_no_w"):
            us = cold_us(dots_fn(libs[name], w, K), make_x, 2 * K * N, device)
            times[f"{name} K={K}"] = us
            print(f"dots K={K} {name[5:]:<12s}: cold {us:.2f} us", flush=True)
    for name in (("transpose_whole", "transpose_copy") if have("transpose") else ()):
        for key, shape in (("nc_to_cn", (N, C)), ("cn_to_nc", (C, N))):
            with bound_to(libs[name]):
                us = cold_us(micro_cf.cf_transpose, lambda i: randn(shape, 1 + i, device),
                             2 * N * C, device)
            times[f"{name} {key}"] = us
            print(f"transpose {key} {name[10:]:<6s}: cold {us:.2f} us", flush=True)
    for name in (("roll_whole", "roll_no_taps") if have("roll") else ()):
        with bound_to(libs[name]):
            us = cold_us(micro_cf.cf_masked_roll_sum, lambda i: randn((C, N), 1 + i, device),
                         2 * N * C, device)
        times[name] = us
        print(f"roll sum {name[5:]:<8s}: cold {us:.2f} us", flush=True)
    if have("resblock"):
        times.update(resblock_times(libs, device))
    if have("attn"):
        times.update(attn_times(libs, device))
    if have("bwd"):
        times.update(bwd_times(libs, device))
    ms = {}
    if have("target"):
        ms["manifold_target"] = target_times(libs, target_cases(device))
    if have("jvp"):
        ms["shoot_jvp"] = jvp_times(libs, jvp_args(JVP_L, device))
    print(json.dumps({"knockouts_us": times, "knockouts_ms": ms}), flush=True)
    return dict(times, **ms)


if __name__ == "__main__":
    main()
