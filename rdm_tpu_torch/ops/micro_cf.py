"""Channels-first primitives of a resblock redesign: a 2-D transpose, a
masked lane-roll sum (the shifted taps of a 3x3 convolution over 9x9
samples laid end to end) and wide channels-first products on the tensor
cores.  They are the Hopper twins of the TPU microbenchmark kernels of
``scripts/micro_pallas_cf.py`` and keep its layout: rows x lanes, the lane
axis last, bfloat16.

* ``cf_transpose(x)``: (R, S) -> (S, R), exact.  It serves both kernels of
  the script's transpose pair (:49 maps (N, C) -> (C, N), :56 maps
  (C, N) -> (N, C)).  Its kernel takes a 32 x 32 tile a warp
  (``transpose_plan``).
* ``cf_masked_roll_sum(x, L, shifts)`` on (C, N):
  ``out[c, n] = bf16(sum_s [0 <= n % L + s < L] * f32(x[c, n + s]))``, the
  sum in float32 in the order of ``shifts``, starting from 0.0 (the
  script's :69-82).  The mask tests only the position in the flattened
  L-token sample, so a +-1 tap wraps across image rows, as in the script.
  Its kernel takes one 16-byte chunk a thread (``roll_sum_plan``), with a
  body of its own for the script's table (``roll_sum_body``).
* ``cf_dots(w, x, K)`` with w (taps, C, K) and x (>= K, N):
  ``out = bf16(sum_t f32(w[t] @ x[:K]))`` of shape (C, N), every tap
  multiplying the same ``x[:K]`` (the script's :97-104: a throughput
  probe), with 9 taps for K = C and 3 otherwise.  Its kernel is persistent:
  TMA loads into a ring of x tiles, ``wgmma`` products (``dots_plan``).

Each function has its plain PyTorch version (``*_reference``) and a
wrapper that runs the plain version for a CPU tensor and, for a CUDA
tensor, launches the hand-written kernel of ``csrc/micro_cf.cu`` or raises;
it never falls back.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

L_TOKENS = 81
SHIFTS = (-10, -9, -8, -1, 1, 8, 9, 10)
# a tap reaches at most two 16-byte chunks to either side of its own
MAX_SHIFT = 16
MAX_SHIFTS = 16
ROLL_THREADS = 256      # chunks a block of the roll sum, one a thread
TRANSPOSE_TILE = 32     # rows and columns of x in a tile of the transpose
TRANSPOSE_WARPS = 2     # warps a block of the transpose, a tile each
DOTS_ROWS = 64          # C: the rows of w and of the output
DOTS_TILE = 64          # output columns of a tile
DOTS_MAX_K = 256        # a TMA box of the x tile has at most 256 rows
DOTS_CONSUMERS = 3      # consumer warpgroups, four warps each
DOTS_MAX_STAGES_PER_CONSUMER = 2
_CHUNK = 8              # bfloat16 values in 16 bytes


def dots_taps(C: int, K: int) -> int:
    """Taps of the script's product: 9 (one per 3x3 tap) for K = C, 3 (one
    per dy-slice of width 3C) otherwise."""
    return 9 if K == C else 3


class DotsPlan(NamedTuple):
    """Launch plan of the dots kernel (``csrc/micro_cf.cu``: dots_smem_needed)."""
    stages: int             # x tiles of K x 64 in the ring, the same number for each consumer
    smem_bytes: int         # 1024 of alignment slack, w, the ring, output stages, barriers


def dots_plan(taps: int, K: int):
    """The ring and shared memory of one block: all of w as taps x
    ceil(K / 64) panels of 64 x 64 bf16, one or two K x 64 x tiles for each
    consumer warpgroup (as many as fit), a 16 x 64 bf16 output stage for
    each consumer warp and one 8-byte barrier per stage (two) and per tap.
    None where K exceeds a TMA box or not one x tile a consumer fits."""
    out_stages = DOTS_CONSUMERS * 4 * 16 * DOTS_TILE * 2
    fixed = 1024 + taps * (-(-K // 64)) * DOTS_ROWS * 128 + out_stages + 8 * taps
    tile = K * DOTS_TILE * 2 + 16
    per_consumer = min(DOTS_MAX_STAGES_PER_CONSUMER,
                       (_build.SMEM_LIMIT - fixed) // (DOTS_CONSUMERS * tile))
    if K > DOTS_MAX_K or per_consumer < 1:
        return None
    stages = DOTS_CONSUMERS * per_consumer
    return DotsPlan(stages, fixed + stages * tile)


class TransposePlan(NamedTuple):
    """Launch plan of the transpose kernel (``csrc/micro_cf.cu``:
    rdm_cf_transpose): warp w of block b takes tiles w * blocks + b,
    then every warps * blocks further on."""
    tile: int               # rows and columns of x in a tile
    warps: int              # warps a block
    blocks: int


def transpose_tiles(R: int, S: int) -> int:
    return -(-R // TRANSPOSE_TILE) * -(-S // TRANSPOSE_TILE)


def transpose_plan(R: int, S: int) -> TransposePlan:
    """Enough blocks of ``TRANSPOSE_WARPS`` warps for a tile a warp."""
    return TransposePlan(TRANSPOSE_TILE, TRANSPOSE_WARPS,
                         -(-transpose_tiles(R, S) // TRANSPOSE_WARPS))


class RollSumPlan(NamedTuple):
    """Launch plan of the roll-sum kernel: one thread per 16-byte chunk."""
    threads: int            # a block's threads, one per chunk
    blocks: int
    chunks: int             # C * N / 8


def roll_sum_plan(C: int, N: int) -> RollSumPlan:
    """Blocks of ``ROLL_THREADS`` chunks over all C * N / 8 of them; only
    the last block may be partial."""
    chunks = C * (N // _CHUNK)
    return RollSumPlan(ROLL_THREADS, -(-chunks // ROLL_THREADS), chunks)


def roll_sum_body(L: int, shifts) -> str:
    """The body the roll-sum kernel runs for these arguments: ``"script"``,
    L and the shifts as constants, for the script's L = 81 and table;
    ``"general"`` for any other."""
    return "script" if L == L_TOKENS and tuple(shifts) == SHIFTS else "general"


# ---------------------------------------------------------------------------
# plain versions

def cf_transpose_reference(x):
    """Plain version of ``cf_transpose``."""
    return x.t().contiguous()


def cf_masked_roll_sum_reference(x, L: int = L_TOKENS, shifts=SHIFTS):
    """Plain version of ``cf_masked_roll_sum``: each shift as a roll of the
    whole lane axis (``roll(x, -s)[:, n] = x[:, (n + s) % N]``), masked to 0
    where ``n % L + s`` leaves the sample, added in float32 in order."""
    C, N = x.shape
    pos = torch.arange(N, device=x.device) % L
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = torch.zeros((C, N), dtype=torch.float32, device=x.device)
    for s in shifts:
        q = pos + s
        acc = acc + torch.where((q >= 0) & (q < L), torch.roll(x, -s, dims=1), zero).float()
    return acc.to(x.dtype)


def cf_dots_reference(w, x, K: int):
    """Plain version of ``cf_dots``: each tap's product in float32, added to
    one float32 sum in tap order, rounded once."""
    xk = x[:K].float()
    acc = torch.zeros((w.shape[1], x.shape[1]), dtype=torch.float32, device=x.device)
    for t in range(w.shape[0]):
        acc = acc + torch.matmul(w[t].float(), xk)
    return acc.to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers

def _on_cpu(name, *tensors):
    """Raise unless every tensor is a bfloat16 tensor on one device, the
    CPU or a card; on a card they must be contiguous and start on a 16-byte
    boundary (the kernels move 16 bytes at a time).  Returns whether they
    lie on the CPU."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: unsupported dtype {t.dtype} (bfloat16 only)")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start on a 16-byte boundary")
    return False


def _check_dims(name, t, dims):
    if t.dim() != dims:
        raise ValueError(f"{name}: expected {dims} dimensions, got {tuple(t.shape)}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def cf_transpose(x):
    """(R, S) -> (S, R) of a bfloat16 matrix.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, which takes R and S that are
    multiples of 8 (16-byte rows) and raises on anything else."""
    _check_dims("cf_transpose", x, 2)
    if _on_cpu("cf_transpose", x):
        return cf_transpose_reference(x)
    R, S = x.shape
    if R % _CHUNK or S % _CHUNK:
        raise ValueError(f"cf_transpose: R={R} and S={S} must be multiples of {_CHUNK}")
    if x.numel() == 0:
        return torch.empty((S, R), dtype=x.dtype, device=x.device)
    out = _launch_transpose(x, transpose_plan(R, S))
    cf_transpose.launches += 1
    return out


def _launch_transpose(x, plan: TransposePlan):
    """The transpose kernel on contiguous bfloat16 (R, S) ``x`` on a card,
    R and S multiples of 8, with the given plan (the card tests also hand
    it other plans)."""
    R, S = x.shape
    out = torch.empty((S, R), dtype=x.dtype, device=x.device)
    lib = _build.library("micro_cf", "rdm_cf_transpose",
                   [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = lib.rdm_cf_transpose(x.data_ptr(), out.data_ptr(), R, S, *plan, _stream(x))
    _build.raise_on(lib, err, "cf_transpose")
    return out


cf_transpose.launches = 0


def cf_masked_roll_sum(x, L: int = L_TOKENS, shifts=SHIFTS):
    """The masked lane-roll sum on bfloat16 (C, N) ``x`` (see the module
    docstring).  CPU tensors take the plain version; CUDA tensors launch the
    kernel, which takes N a multiple of 8 and of L (whole samples: the
    kernel does not wrap a tap around the lane axis), at most 16 shifts with
    |s| <= 16, and raises on anything else."""
    shifts = tuple(int(s) for s in shifts)
    if L < 1:
        raise ValueError(f"cf_masked_roll_sum: L={L}")
    _check_dims("cf_masked_roll_sum", x, 2)
    if _on_cpu("cf_masked_roll_sum", x):
        return cf_masked_roll_sum_reference(x, L, shifts)
    C, N = x.shape
    if N % _CHUNK or N % L:
        raise ValueError(f"cf_masked_roll_sum: N={N} must be a multiple of {_CHUNK} and L={L}")
    if len(shifts) > MAX_SHIFTS or any(abs(s) > MAX_SHIFT for s in shifts):
        raise ValueError(f"cf_masked_roll_sum: shifts {shifts}: at most {MAX_SHIFTS}, "
                         f"each |s| <= {MAX_SHIFT}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = roll_sum_plan(C, N)
    if plan.chunks > 2 ** 31 - 1 - ROLL_THREADS:
        raise ValueError(f"cf_masked_roll_sum: C={C}, N={N} exceed the kernel's grid")
    lib = _build.library("micro_cf", "rdm_cf_masked_roll_sum",
                   [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    table = (ctypes.c_int * max(1, len(shifts)))(*shifts)
    with torch.cuda.device(x.device):
        err = lib.rdm_cf_masked_roll_sum(x.data_ptr(), out.data_ptr(), C, N, L, table,
                                         len(shifts), int(roll_sum_body(L, shifts) == "script"),
                                         plan.blocks, _stream(x))
    _build.raise_on(lib, err, "cf_masked_roll_sum")
    cf_masked_roll_sum.launches += 1
    return out


cf_masked_roll_sum.launches = 0


def cf_dots(w, x, K: int):
    """``bf16(sum_t f32(w[t] @ x[:K]))`` for bfloat16 w (taps, C, K) and x
    (>= K, N), taps = ``dots_taps(C, K)``.  CPU tensors take the plain
    version; CUDA tensors launch the persistent tensor-core kernel, which
    takes C = 64, K a multiple of 16 with a plan (``dots_plan``: K <= 256),
    N a multiple of 8, and raises on anything else."""
    _check_dims("cf_dots", w, 3)
    _check_dims("cf_dots", x, 2)
    taps, C, k_w = w.shape
    if k_w != K or x.shape[0] < K or taps != dots_taps(C, K):
        raise ValueError(f"cf_dots: w {tuple(w.shape)} and x {tuple(x.shape)} do not fit K={K} "
                         f"with {dots_taps(C, K)} taps")
    if _on_cpu("cf_dots", w, x):
        return cf_dots_reference(w, x, K)
    N = x.shape[1]
    plan = dots_plan(taps, K)
    if C != DOTS_ROWS or K % 16 or N % _CHUNK or plan is None:
        raise ValueError(f"cf_dots: unsupported C={C}, K={K}, N={N} (C = {DOTS_ROWS}, "
                         f"K % 16 == 0 and K <= {DOTS_MAX_K}, N % {_CHUNK} == 0)")
    out = torch.empty((C, N), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    lib = _build.library("micro_cf", "rdm_cf_dots",
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = lib.rdm_cf_dots(w.data_ptr(), x.data_ptr(), out.data_ptr(), taps, K, N,
                              plan.stages, plan.smem_bytes, _stream(x))
    _build.raise_on(lib, err, "cf_dots")
    cf_dots.launches += 1
    return out


cf_dots.launches = 0
