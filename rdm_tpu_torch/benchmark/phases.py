"""Where the bf16 attention backward spends its cycles: a copy of
``csrc/fused_attn_block_bwd.cu`` with ``clock64()`` stamps after each block
barrier of the tensor-core body's sample loop, run once at the training
shape (B 4096, C 64, L 81), the cycles of each phase summed over block 0's
samples by its thread 0.

    python -m rdm_tpu_torch.benchmark.phases

It needs the card and ``nvcc``.  The card machine reads no profiler
counters, so this is the tool that splits the kernel's time by phase; the
knock-outs (``benchmark/knockouts.py``) say what a part costs when it is
gone.  A phase ends at its barrier, so it includes the wait for the
slowest warp.  The stamps are made where the source has its barriers; the
edit raises when the sample loop no longer has the seven it names.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess

import torch

from ..ops import _build
from ..ops import attention as attn_ops
from ..scripts.micro_cf import describe
from .knockouts import bound_to

OUT = os.path.join(_build.BUILD_DIR, "phases")
SOURCE = "fused_attn_block_bwd.cu"
LOOP = "  for (int m = 0, b = blockIdx.x; b < B; ++m, b += gridDim.x) {\n"
WAIT = "    mbar_wait(full + m % stages, (m / stages) & 1);\n"
# the phase that ends at each barrier of the sample loop, in order
PHASES = ("0 GroupNorm statistics", "1 h, gs; q, k, v, do", "2 query rows: p, o, dp, ds, dq",
          "3 key rows: dv, dk; dh", "3 o, dq, h, gs staged; column sums",
          "4 weight and bias gradients; m1, m2", "5 dx")
B, C, L = 4096, 64, 81
STAMP = """
__device__ unsigned long long g_phase_cycles[16];
#define PHASE_STAMP(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) {          \\
    const unsigned long long t_ = clock64();                                   \\
    if ((k) > 0) g_phase_cycles[k] += t_ - t_stamp;                            \\
    t_stamp = t_; } } while (0)
"""
READER = """
extern "C" int rdm_phase_cycles(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
"""


def stamped_source() -> str:
    """The backward's source with a stamp at the top of the sample loop
    (0), after the sample's arrival (8: the wait) and after each of its
    barriers (1 .. 7)."""
    with open(os.path.join(_build.CSRC_DIR, SOURCE)) as f:
        src = f.read()
    if src.count(LOOP) != 1 or src.count(WAIT) != 1:
        raise RuntimeError("phases: the sample loop of the tensor-core body was not found")
    i0 = src.index(LOOP) + len(LOOP)
    i1 = src.index("  if (leader) bulk_wait();", i0)
    body = src[i0:i1].replace(WAIT, "    PHASE_STAMP(0);\n" + WAIT + "    PHASE_STAMP(8);\n")
    n = iter(range(1, 100))
    body = re.sub(r"__syncthreads\(\);", lambda m: m.group(0) + f" PHASE_STAMP({next(n)});", body)
    if next(n) != len(PHASES) + 1:
        raise RuntimeError(f"phases: the sample loop no longer has {len(PHASES)} barriers")
    src = src[:i0] + body + src[i1:]
    src = src.replace("  const bool leader = threadIdx.x == 0;\n",
                      "  const bool leader = threadIdx.x == 0;\n  unsigned long long t_stamp = 0;\n", 1)
    return src.replace("namespace {", STAMP + "namespace {", 1) + READER


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("phases: needs a CUDA card")
    device = torch.device("cuda")
    print(describe(device), flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, OUT)
    path = os.path.join(OUT, SOURCE)
    with open(path, "w") as f:
        f.write(stamped_source())
    lib_path = os.path.join(OUT, "lib.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed for the stamped backward:\n" + proc.stdout[-3000:])
    lib = ctypes.CDLL(lib_path)
    lib.rdm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rdm_cuda_error_string.restype = ctypes.c_char_p
    gen = torch.Generator(device=device).manual_seed(6)
    f = lambda *shape: torch.randn(shape, generator=gen, device=device)
    params = [1 + 0.1 * f(C), 0.1 * f(C)]
    for _ in range(4):
        params += [f(C, C) / C ** 0.5, 0.1 * f(C)]
    with bound_to(lib):
        launch = attn_ops._bwd_launcher(*params, C=C, L=L, dtype=torch.bfloat16, groups=16)
    launch(f(B, C, 9, 9).to(torch.bfloat16), f(B, C, 9, 9).to(torch.bfloat16))
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * 16)()
    _build.raise_on(lib, lib.rdm_phase_cycles(cycles), "phases")
    samples = len(range(0, B, min(B, 128)))       # block 0's samples
    per = {"wait for the sample": cycles[8] / samples}
    per.update({name: cycles[i + 1] / samples for i, name in enumerate(PHASES)})
    total = sum(per.values())
    for name, c in per.items():
        print(f"{name:<40s} {c:10.0f} cycles a sample  {100 * c / total:5.1f} %", flush=True)
    out = {"B": B, "C": C, "L": L, "samples_of_block_0": samples,
           "cycles_per_sample": per, "total_cycles_per_sample": total}
    print(json.dumps({"phases": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
