"""What bounds the attention core and the channels-first dots: each kernel
built again with one part knocked out, and timed cold beside the whole one.

    python -m rdm_tpu_torch.benchmark.knockouts

It needs the card and ``nvcc``.  Each variant is ``csrc/`` copied into
``rdm_tpu_torch/_build/knockouts/<variant>/`` with one source edit; all of
them build at once (one ``nvcc`` each) and are called through the same C
interface as ``ops.attention.attention_core`` and ``ops.micro_cf.cf_dots``.
Times are cold, as ``scripts/micro_cf.py`` takes them: the slope over CUDA
graphs of 50 and 500 calls, inputs rotating over more than twice the L2.
The shapes are the flagship attention's (B 1024, L 81, C 64, bfloat16, both
softmax settings) and the TPU script's dots (C 64, N 20,736, K 64 and 192).
A knocked-out variant computes wrong values: only its time means anything.

Variants:
* attention core: ``whole``; ``no_exp`` (the softmax's exps skipped);
  ``load_store`` (the TMA ring, the staging and the stores, no products and
  no softmax), the floor of moving the 42.5 MB through this kernel;
* dots: ``whole``; ``no_products`` (no wgmma); ``no_w`` (w neither loaded
  nor waited for).

The edits match the sources' text; one that no longer matches raises and
names itself.  The last line printed is one JSON object of all the times.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess

import torch

from ..ops import _build
from ..ops import micro_cf
from ..scripts.micro_cf import cold_us, describe, randn

OUT = os.path.join(_build.BUILD_DIR, "knockouts")
B, L, C = 1024, 81, 64
N = 81 * 256

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
}
NO_W_LOAD = ("      for (int t = 0; t < taps; ++t) {\n        mbar_expect_tx",
             "      for (int t = 0; t < 0; ++t) {\n        mbar_expect_tx")


def _edit(src: str, old: str, new: str, name: str) -> str:
    if old not in src:
        raise RuntimeError(f"knockout {name}: the source no longer has {old!r}")
    return src.replace(old, new)


def edited_source(name: str):
    """The file a variant edits and its edited text."""
    fname, old, new = EDITS[name]
    with open(os.path.join(_build.CSRC_DIR, fname)) as f:
        src = f.read()
    if old is not None:
        src = _edit(src, old, new, name)
    if name == "dots_no_w":
        src = _edit(src, *NO_W_LOAD, name)
    return fname, src


def build_variants() -> dict:
    """Build every variant at once; return its library path by name."""
    jobs = {}
    for name in EDITS:
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        fname, src = edited_source(name)
        with open(os.path.join(d, fname), "w") as f:
            f.write(src)
        main = "attention_core.cu" if name.startswith("core") else "micro_cf.cu"
        lib = os.path.join(d, "lib.so")
        jobs[name] = (lib, subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                                             os.path.join(d, main)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    failed = []
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{out[-3000:]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: lib for name, (lib, _) in jobs.items()}


def core_fn(lib, softmax_f32: bool):
    lib.rdm_attention_core.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                       + [ctypes.c_float, ctypes.c_void_p])

    def fn(qkv):
        q, k, v = qkv
        out = torch.empty_like(q)
        err = lib.rdm_attention_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     B, L, C, 0, 1, int(not softmax_f32), C ** -0.5,
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


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("knockouts: needs a CUDA card")
    device = torch.device("cuda")
    print(describe(device), flush=True)
    libs = {name: ctypes.CDLL(path) for name, path in build_variants().items()}
    for lib in libs.values():
        lib.rdm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rdm_cuda_error_string.restype = ctypes.c_char_p
    times = {}

    def make_qkv(i):
        return tuple(randn((B, L, C), 3 * i + t, device) for t in range(3))

    qkv_bytes = 3 * B * L * C * 2
    for softmax_f32 in (True, False):
        tag = "softmax_f32" if softmax_f32 else "scores_in_t"
        for name in ("core_whole", "core_no_exp", "core_load_store"):
            us = cold_us(core_fn(libs[name], softmax_f32), make_qkv, qkv_bytes, device)
            times[f"{name} {tag}"] = us
            print(f"attention core {name[5:]:<11s} {tag}: cold {us:.2f} us", flush=True)
    sdpa = lambda t: torch.nn.functional.scaled_dot_product_attention(*(x.unsqueeze(1) for x in t))
    times["sdpa"] = cold_us(sdpa, make_qkv, qkv_bytes, device)
    print(f"scaled_dot_product_attention: cold {times['sdpa']:.2f} us", flush=True)
    for K in (C, 3 * C):
        w = randn((micro_cf.dots_taps(C, K), C, K), 0, device)
        make_x = lambda i, K=K: randn((K, N), 1 + i, device)
        for name in ("dots_whole", "dots_no_products", "dots_no_w"):
            us = cold_us(dots_fn(libs[name], w, K), make_x, 2 * K * N, device)
            times[f"{name} K={K}"] = us
            print(f"dots K={K} {name[5:]:<12s}: cold {us:.2f} us", flush=True)
    print(json.dumps({"knockouts_us": times}), flush=True)
    return times


if __name__ == "__main__":
    main()
