"""Fused NCSN++ attention block: GroupNorm -> q, k, v NINs -> softmax
attention over the L = H*W tokens -> output NIN -> residual (times 1/sqrt 2),
and its backward; and the bare attention core softmax(q k^T / sqrt(C)) v.

``FusedAttnBlockFn`` is the differentiable block the model calls.  It takes
the activations in the working type and the ten float32 master parameters,
casts the parameters inside, and returns float32 parameter gradients that
were never rounded to the working type.  Its backward recomputes the
forward, as the TPU kernel does.

``fused_attn_block`` and ``fused_attn_block_bwd`` launch the hand-written
CUDA kernels ``csrc/fused_attn_block.cu`` and ``csrc/fused_attn_block_bwd.cu``
on CUDA tensors and run the plain PyTorch versions
``fused_attn_block_reference`` and ``fused_attn_block_bwd_reference`` on CPU
tensors; on a CUDA tensor they launch the kernel or raise, they never fall
back.

The forward kernel replaces the TPU kernel
``rdm_tpu/ops/pallas/attention.py::_fused_block_kernel``.  At the sampling
shape (B = 1024, L = 81, C = 64, bf16) it must move 21.2 MB (x in, out out)
and do about 4.4 GFLOP, so device memory bounds it (about 6.3 us at
3.35 TB/s, against 4.5 us at 989 TFLOP/s).  Its design keeps every
intermediate of one sample on the chip, so device memory sees x, out and
the weights once.  In bfloat16 at C 64 and L <= 96 (the flagship's every
attention block) it runs on the tensor cores with the weights staged once
per block and the samples arriving through a TMA ring; every other shape
and float32 take its scalar body (``attn_body``; see the source for both
layouts).  The backward kernel
replaces ``_fused_block_bwd_kernel`` of the same file; operations bound it.
It takes the same body for a shape: in bfloat16 at C 64 and L <= 96 its 17
products a sample run on the tensor cores, one block of warps per gradient
slot stages the weights once and keeps float32 weight and bias gradients on
the chip for all of its samples (``bwd_plan``; see its source).

In bfloat16 at the widths a sample does not fit a block at (C in {32, 64,
128, 256} up to 256 tokens, outside the two bodies above: DDPM++'s C 256,
L 256 and the nf-32 NCSN++'s C 32, L 81) both directions take the tiled body,
``csrc/fused_attn_block_tiled.cu`` (``fused_attn_block_tiled`` and
``fused_attn_block_bwd_tiled``): a few launches that meet in global memory,
each intermediate stored in bfloat16 where the TPU kernel rounds it, the
softmax exact in float32 over every key, and the parameter gradients as
float32 partials summed in a fixed order (``tiled_plan``; see the source).
``attn_body`` states the envelope of all three bodies, the one place that
decides which body a shape takes.

``attention_core`` launches ``csrc/attention_core.cu`` on CUDA tensors
and runs ``attention_core_reference`` on CPU tensors.  It replaces the TPU
kernel ``_attn_kernel`` of the same file; memory bounds it.  Both types run
on the tensor cores with the scores in registers (``core_plan``): bfloat16
fed by a TMA ring of staged samples, float32 a sample a block on a 3xTF32
split of every product, whose arithmetic ``attention_core_3xtf32`` models.

Both block directions take the model's NCHW activations and the NIN weights as
(C_in, C_out) matrices, cast every parameter to the activations' type
first, and round at the TPU kernels' points: forward, h, each NIN product
(before its bias is added in the working type), the softmax probabilities
and p.v are rounded to the working type, statistics, scores and softmax are
float32; backward, see ``fused_attn_block_bwd_reference``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .wg_gemm import GemmPlan, gemm_plan, gemm_plan_rows

# the scalar body: float32 or bfloat16 at these widths and up to MAX_TOKENS
SUPPORTED_CHANNELS = (64, 128)
MAX_TOKENS = 128
# the tiled body: bfloat16 at these widths and up to TILED_MAX_TOKENS
TILED_CHANNELS = (32, 64, 128, 256)
TILED_MAX_TOKENS = 256
CORE_MAX_CHANNELS = 128
# ring stages of each consumer group of the bfloat16 attention-core kernel
CORE_STAGES_PER_GROUP = 2
# the tensor-core body of the bfloat16 forward kernel: C and the most tokens
TC_CHANNELS = 64
TC_MAX_TOKENS = 96
GN_EPS = 1e-6
# the ten parameters of the block, in the order of every function here
PARAM_NAMES = ("gamma", "beta", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def round_to(value: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype`` (how a weakly typed scalar enters
    arithmetic in the working type)."""
    return float(torch.tensor(value, dtype=dtype))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Where the kernels accumulate in float32, the plain versions do too;
    float64 inputs (gradient checks) stay in float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rescale(skip_rescale: bool) -> float:
    return 1.0 / math.sqrt(2.0) if skip_rescale else 1.0


def fused_attn_block_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                               *, groups: int, skip_rescale: bool = True):
    """Plain PyTorch version of the fused block, same inputs and rounding."""
    dt = x.dtype
    B, C, H, W = x.shape
    L = H * W
    f32 = _acc_dtype(dt)
    gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp = (
        p.to(dt) for p in (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp))

    xg = x.reshape(B, groups, (C // groups) * L).to(f32)
    inv_n = 1.0 / ((C // groups) * L)
    mu = xg.sum(-1, keepdim=True) * inv_n
    var = (xg * xg).sum(-1, keepdim=True) * inv_n - mu * mu
    h = ((xg - mu) * torch.rsqrt(var + GN_EPS)).reshape(B, C, L)
    h = h * gamma.to(f32)[None, :, None] + beta.to(f32)[None, :, None]
    h = h.to(dt).transpose(1, 2)                                   # (B, L, C)

    def nin(t, w, b):
        return torch.matmul(t.to(f32), w.to(f32)).to(dt) + b

    q, k, v = nin(h, wq, bq), nin(h, wk, bk), nin(h, wv, bv)
    s = torch.matmul(q.to(f32), k.to(f32).transpose(1, 2)) * float(C) ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(dt).to(f32), v.to(f32)).to(dt)
    o2 = nin(o, wp, bp)
    out = (x.reshape(B, C, L).transpose(1, 2) + o2) * round_to(_rescale(skip_rescale), dt)
    return out.transpose(1, 2).reshape(B, C, H, W)


def fused_attn_block_bwd_reference(x, g, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                                   *, groups: int, skip_rescale: bool = True):
    """Plain PyTorch backward of the fused block: recompute the forward, then
    chain the output cotangent ``g`` back.  Returns ``(dx, dgn_scale,
    dgn_bias, dwq, dbq, dwk, dbk, dwv, dbv, dwp, dbp)``: dx in the type of
    ``x``, the parameter gradients in float32 (float64 for float64 input),
    shaped like the parameters.

    Rounding points, those of the TPU kernel: ``g`` is rounded to the working
    type T first; the proj branch takes ``gs = T(g * T(rescale))`` and the
    residual branch ``g * rescale`` in float32; do, dv, dq, dk and ds (after
    the 1/sqrt(C) scale) are rounded to T; dp, the softmax backward, dh (the
    float32 sum of three products) and the GroupNorm backward stay float32;
    the parameter gradients are float32 sums; dx is rounded to T once, at the
    end."""
    dt = x.dtype
    B, C, H, W = x.shape
    L = H * W
    cg = C // groups
    f32 = _acc_dtype(dt)
    shapes = [p.shape for p in (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)]
    gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp = (
        p.to(dt).to(f32) for p in (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp))

    # ---- recompute the forward (B, L, C) ----
    xg = x.reshape(B, groups, cg * L).to(f32)
    inv_n = 1.0 / (cg * L)
    mu = xg.sum(-1, keepdim=True) * inv_n
    var = (xg * xg).sum(-1, keepdim=True) * inv_n - mu * mu
    inv = torch.rsqrt(var + GN_EPS)                                  # (B, groups, 1)
    xhat = ((xg - mu) * inv).reshape(B, C, L).transpose(1, 2)
    h = (xhat * gamma + beta).to(dt).to(f32)

    def nin(t, w, b):
        return (torch.matmul(t, w).to(dt) + b.to(dt)).to(f32)

    def tround(t):
        return t.to(dt).to(f32)

    q, k, v = nin(h, wq, bq), nin(h, wk, bk), nin(h, wv, bv)
    scale = float(C) ** -0.5
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)                                  # float32
    pt = tround(p)
    o = tround(torch.matmul(pt, v))

    # ---- backward ----
    gt = g.to(dt).reshape(B, C, L).transpose(1, 2).to(f32)           # T values
    gs = tround(gt * round_to(_rescale(skip_rescale), dt))
    dwp = torch.einsum("blc,bld->cd", o, gs)
    dbp = gs.sum((0, 1))
    do = tround(torch.matmul(gs, wp.t()))
    dv = tround(torch.matmul(pt.transpose(1, 2), do))
    dp = torch.matmul(do, v.transpose(1, 2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = tround(ds * scale)
    dq = tround(torch.matmul(ds, k))
    dk = tround(torch.matmul(ds.transpose(1, 2), q))
    dwq, dwk, dwv = (torch.einsum("blc,bld->cd", h, d) for d in (dq, dk, dv))
    dbq, dbk, dbv = (d.sum((0, 1)) for d in (dq, dk, dv))
    dh = (torch.matmul(dq, wq.t()) + torch.matmul(dk, wk.t())) + torch.matmul(dv, wv.t())

    dgamma = (dh * xhat).sum((0, 1))
    dbeta = dh.sum((0, 1))
    dxhat = (dh * gamma).transpose(1, 2).reshape(B, groups, cg * L)
    xh = xhat.transpose(1, 2).reshape(B, groups, cg * L)
    m1 = dxhat.sum(-1, keepdim=True) * inv_n
    m2 = (dxhat * xh).sum(-1, keepdim=True) * inv_n
    dxf = (inv * (dxhat - m1 - xh * m2)).reshape(B, C, L)
    dx = dxf + gt.transpose(1, 2) * _rescale(skip_rescale)
    grads = (dgamma, dbeta, dwq, dbq, dwk, dbk, dwv, dbv, dwp, dbp)
    return (dx.to(dt).reshape(B, C, H, W),
            *(gr.reshape(shape) for gr, shape in zip(grads, shapes)))


def rows_per_chunk(C: int, L: int) -> int:
    """Query rows the kernel handles at once: all of them where shared
    memory allows, else the most that fit.  The kernel keeps k transposed
    (C x LP, LP = L rounded up to 8), v (L x C), h (L x (C + 1)) and, per
    row of a chunk, one row of q (C + 1) and of scores (LP), all float32."""
    lp = -(-L // 8) * 8
    fixed = 4 * (C * lp + L * C + L * (C + 1)) + 2 * 4 * C
    rows = (_build.SMEM_LIMIT - fixed) // (4 * (C + 1 + lp))
    if rows < 1:
        raise ValueError(f"fused_attn_block: C={C}, L={L} does not fit in shared memory")
    return min(L, rows)


def attn_body(C: int, L: int, dtype: torch.dtype) -> str:
    """Which body the forward and the backward kernel run for a shape, fixed
    by the shape: ``"tensor_cores"`` (bfloat16, C 64, L <= 96) or
    ``"scalar"`` (C 64 or 128 up to 128 tokens otherwise, float32 too) of
    ``csrc/fused_attn_block.cu`` and ``csrc/fused_attn_block_bwd.cu``, or
    ``"tiled"`` (bfloat16 at the other widths of ``TILED_CHANNELS`` and
    tokens up to 256) of ``csrc/fused_attn_block_tiled.cu``; raises on a
    shape no body takes."""
    bf16 = dtype == torch.bfloat16
    if bf16 and C == TC_CHANNELS and L <= TC_MAX_TOKENS:
        return "tensor_cores"
    if C in SUPPORTED_CHANNELS and L <= MAX_TOKENS and dtype in _DTYPE_CODES:
        return "scalar"
    if bf16 and C in TILED_CHANNELS and L <= TILED_MAX_TOKENS:
        return "tiled"
    raise ValueError(f"fused_attn_block: no kernel takes C={C}, L={L} in {dtype} (C in "
                     f"{SUPPORTED_CHANNELS} up to {MAX_TOKENS} tokens, or bfloat16 with C in "
                     f"{TILED_CHANNELS} up to {TILED_MAX_TOKENS} tokens)")


class TiledPlan(NamedTuple):
    """Launch plan of the tiled body (``fused_attn_block_tiled.cu``:
    ``rdm_attn_tiled_plan``), computed here the way the source does."""
    fwd_launches: int       # GroupNorm, q/k/v product, attention, output product (+ split sums)
    bwd_launches: int       # the forward's first three, then eleven more kernels
    fwd_smem_bytes: int     # the forward attention kernel: two q/k stages and two v stages
    ds_smem_bytes: int      # the ds kernel: max(2, C / 64) stages of q/k, then of do/v
    query_tiles: int        # both attention kernels' grid: (query_tiles, B), 128 rows
    key_tiles: int          # keys in 64-rows both kernels are built for (1, 2 or 4)
    threads: int            # both: two consumer warpgroups and a producer warp
    padded_tokens: int      # L rounded up to 16: rows of a sample in the workspace
    qkv: GemmPlan           # the forward's products on wg_gemm: B Lp rows x 3C
    proj: GemmPlan          # and B Lp rows x C
    do: GemmPlan            # the backward's: do = gs Wp^T over B Lp rows, K = C
    dq: GemmPlan            # per sample (ceil(L / 128) M tiles each): dq = ds k, K = keys
    dk: GemmPlan            # dk = ds^T q (A MN-major), K = queries
    dv: GemmPlan            # dv = pt^T do (A MN-major)
    dh: GemmPlan            # dh = [dq | dk | dv] Wqkv^T over B Lp rows, K = 3C, float32
    dwqkv: GemmPlan         # h^T [dq | dk | dv]: C x 3C, K = B ceil(L / 64) stages, split
    dwp: GemmPlan           # o^T gs: C x C, the same K

    def flat(self) -> tuple:
        """As the built library's plan: the first eight fields, then the products'."""
        return (*self[:8], *(v for p in self[8:] for v in p.flat()))


TILED_FWD_ROWS = 128
TILED_THREADS = 288         # the attention kernels: two consumer warpgroups, a producer warp
TILED_GRAD_SPLITS = 64      # the weight gradients' K splits at most


def tiled_fwd_smem_bytes(key_tiles: int) -> int:
    """The forward attention kernel's dynamic shared memory: two q/k stages
    (64 channels of 128 queries and of 64 key_tiles keys), two v stages (64
    channels of those keys), eight barriers, 1024 bytes of alignment."""
    return 1024 + 2 * (TILED_FWD_ROWS * 128 + key_tiles * 8192) + 2 * key_tiles * 8192 + 64


def tiled_ds_smem_bytes(key_tiles: int, C: int) -> int:
    """The ds kernel's: max(2, C / 64) stages of the forward's q/k stage (the
    first two hold q and k, then stage c holds do's and v's chunk c), five
    barriers, 1024 bytes of alignment."""
    return 1024 + max(2, -(-C // 64)) * (TILED_FWD_ROWS * 128 + key_tiles * 8192) + 64


def tiled_plan(B: int, C: int, L: int) -> TiledPlan:
    """The tiled body's plan at (B, C, L); ``tests`` hold it against the
    built library's on the card."""
    if not (C in TILED_CHANNELS and 1 <= L <= TILED_MAX_TOKENS and B >= 1):
        raise ValueError(f"fused_attn_block_tiled: no plan for B={B}, C={C}, L={L}")
    cdiv = lambda a, b: -(-a // b)
    lp = cdiv(L, 16) * 16
    rows = B * lp
    kt = cdiv(L, 64)
    ktm = 1 if kt <= 1 else 2 if kt <= 2 else 4
    qkv, proj = gemm_plan(False, B, 0, rows, 3 * C, C), gemm_plan(False, B, 0, rows, C, C)
    mtps = cdiv(L, TILED_FWD_ROWS)
    bwd = (gemm_plan_rows(rows, C, cdiv(C, 64), 0, 1, False, 1),
           gemm_plan_rows(rows, C, kt, mtps, B, False, 1),
           gemm_plan_rows(rows, C, kt, mtps, B, True, 1),
           gemm_plan_rows(rows, C, kt, mtps, B, True, 1),
           gemm_plan_rows(rows, C, cdiv(3 * C, 64), 0, 1, False, 1),
           gemm_plan_rows(C, 3 * C, B * kt, 0, 1, True, TILED_GRAD_SPLITS),
           gemm_plan_rows(C, C, B * kt, 0, 1, True, TILED_GRAD_SPLITS))
    core = 3 + (qkv.splits > 1)    # GroupNorm, q/k/v (and its split sum), attention
    return TiledPlan(core + 1 + (proj.splits > 1), core + 11, tiled_fwd_smem_bytes(ktm),
                     tiled_ds_smem_bytes(ktm, C), mtps, ktm, TILED_THREADS, lp, qkv, proj, *bwd)


@functools.lru_cache(maxsize=None)
def tiled_workspace_bytes(B: int, C: int, L: int, groups: int, bwd: bool) -> int:
    """Bytes of the tiled body's workspace, as the built library carves it
    (``rdm_attn_tiled_workspace``, needs ``nvcc``): one ctypes call a shape,
    kept for the process, so the source stays the one rule that sizes the
    buffer the kernels write."""
    return _tiled_library().rdm_attn_tiled_workspace(B, C, L, groups, int(bwd))


class BwdPlan(NamedTuple):
    """Launch plan of the backward kernel, as ``fused_attn_block_bwd.cu``
    computes it (``rdm_fused_attn_block_bwd_plan``)."""
    body: str          # "tensor_cores" or "scalar"
    threads: int       # a block: 32 per 16 token rows (tensor cores), else 256
    stages: int        # x and g stages of the tensor-core body's ring (0: scalar)
    smem_bytes: int    # dynamic shared memory of a block


def bwd_plan(C: int, L: int, dtype: torch.dtype) -> BwdPlan:
    """The built backward library's plan for a shape (needs ``nvcc``)."""
    out = (ctypes.c_int * 4)()
    lib = _bwd_library()
    _build.raise_on(lib, lib.rdm_fused_attn_block_bwd_plan(C, L, _DTYPE_CODES[dtype], out),
                    "fused_attn_block_bwd plan")
    return BwdPlan("tensor_cores" if out[0] else "scalar", out[1], out[2], out[3])


def check_activations(name, x):
    """Raise unless ``x`` is a contiguous NCHW float32 or bfloat16 CUDA
    tensor, which every kernel of the package reads."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def _check_width(name, C, L, dtype):
    """Raise unless the scalar or the tensor-core body takes the shape."""
    if attn_body(C, L, dtype) == "tiled":
        raise ValueError(f"{name}: C={C}, L={L} takes the tiled body")


def _cast_params(name, params, C, dtype, device):
    """The ten parameters in ``dtype``, contiguous, and 16-byte aligned (the
    kernels read weight rows with 16-byte loads); raises unless they lie on
    ``device`` with the sizes of a block of width C."""
    out = []
    for p, shape in zip(params, _param_shapes(C)):
        if p.device != device or p.numel() != math.prod(shape):
            raise ValueError(f"{name}: parameter on another device or "
                             f"of the wrong size ({tuple(p.shape)} vs {shape})")
        # one copy at most: a transposed view is cast and laid out together
        p = p.reshape(shape).to(dtype, memory_format=torch.contiguous_format).contiguous()
        out.append(p if p.data_ptr() % 16 == 0 else p.clone())
    return out


def _param_shapes(C):
    return ((C,), (C,), (C, C), (C,), (C, C), (C,), (C, C), (C,), (C, C), (C,))


def _launcher(gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp, *, C: int, L: int,
              dtype: torch.dtype, groups: int, skip_rescale: bool = True):
    """The forward kernel with its parameters prepared for CUDA tensors:
    returns ``launch(x)``, which checks NCHW ``x`` (C channels, L tokens,
    ``dtype``) and launches the kernel on it.  ``fused_attn_block`` builds
    one each call and counts the launch; the timing tools keep one to time
    the kernel without the per-call casts."""
    name = "fused_attn_block"
    device = wq.device
    if device.type != "cuda" or dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported device {device} or dtype {dtype}")
    _check_width(name, C, L, dtype)
    if C % groups != 0:
        raise ValueError(f"{name}: C={C} is not divisible by groups={groups}")
    params = _cast_params(name, (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp), C, dtype,
                          device)
    ptrs = [p.data_ptr() for p in params]
    R = rows_per_chunk(C, L)
    lib = _build.library("fused_attn_block", "rdm_fused_attn_block",
                         [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                         + [ctypes.c_float] * 3 + [ctypes.c_void_p])

    def launch(x):
        check_activations(name, x)
        B, c, H, W = x.shape
        if c != C or H * W != L or x.dtype != dtype or x.device != device:
            raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype} on {x.device} does not "
                             f"fit the block (C {C}, L {L}, {dtype} on {device})")
        if x.data_ptr() % 16:        # the tensor-core body copies whole samples in bulk
            x = x.clone()
        out = torch.empty_like(x)
        if B == 0:
            return out
        keep = params                # noqa: F841 (the pointers stay valid)
        with torch.cuda.device(device):
            err = lib.rdm_fused_attn_block(
                x.data_ptr(), out.data_ptr(), *ptrs, B, C, L, groups, R, _DTYPE_CODES[dtype],
                GN_EPS, float(C) ** -0.5, _rescale(skip_rescale),
                torch.cuda.current_stream(device).cuda_stream)
        _build.raise_on(lib, err, name)
        return out

    return launch


def fused_attn_block(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                     *, groups: int, skip_rescale: bool = True):
    """The fused attention block on NCHW ``x``.

    CPU tensors take the plain version.  CUDA tensors launch the kernel; it
    takes the shapes of ``attn_body`` (float32 or bfloat16 at C in {64, 128} up
    to 128 tokens, bfloat16 at C in {32, 64, 128, 256} up to 256 tokens)
    with C divisible by ``groups``, contiguous, and raises on anything else.
    Which body runs is fixed by the shape (``attn_body``); the tiled body
    goes through ``fused_attn_block_tiled``.
    """
    raw = (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)
    if x.device.type == "cpu":
        return fused_attn_block_reference(x, *raw, groups=groups, skip_rescale=skip_rescale)
    check_activations("fused_attn_block", x)
    B, C, H, W = x.shape
    if attn_body(C, H * W, x.dtype) == "tiled":
        out = fused_attn_block_tiled(x, *raw, groups=groups, skip_rescale=skip_rescale)
    else:
        out = _launcher(*raw, C=C, L=H * W, dtype=x.dtype, groups=groups,
                        skip_rescale=skip_rescale)(x)
    if B > 0:
        fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0


def _bwd_library():
    return _build.library("fused_attn_block_bwd", "rdm_fused_attn_block_bwd",
                          [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                          + [ctypes.c_float] * 3 + [ctypes.c_void_p],
                          extra=[("rdm_fused_attn_block_bwd_workspace",
                                  [ctypes.c_int] * 4, ctypes.c_longlong),
                                 ("rdm_fused_attn_block_bwd_plan",
                                  [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int)])


def _bwd_args(raw, C: int, L: int, dtype: torch.dtype, device) -> list:
    """The parameters the backward kernel reads, in its C order: gamma,
    beta, Wq, bq, Wk, bk, Wv, bv, Wp^T, bp cast to ``dtype`` (Wp^T by the
    copy that casts it), and for the scalar body also Wq^T, Wk^T, Wv^T."""
    wp = raw[8]
    wp_t = wp.reshape(C, C).t() if wp.numel() == C * C else wp
    params = _cast_params("fused_attn_block_bwd", (*raw[:8], wp_t, raw[9]), C, dtype, device)
    if attn_body(C, L, dtype) == "scalar":
        params += [params[i].t().contiguous() for i in (2, 4, 6)]
    return params


def _bwd_launcher(gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp, *, C: int, L: int,
                  dtype: torch.dtype, groups: int, skip_rescale: bool = True):
    """The backward kernel with its parameters prepared for CUDA tensors:
    returns ``launch(x, g)``, which checks NCHW ``x`` and ``g`` (C channels,
    L tokens, ``dtype``) and returns ``(dx, grads)``, the ten float32
    parameter gradients packed in parameter order.  ``fused_attn_block_bwd``
    builds one each call and counts the launch; the timing tools keep one to
    time the kernel without the per-call casts.  Wp arrives as Wp^T, cast
    and transposed by one copy; the scalar body also reads Wq^T, Wk^T, Wv^T,
    the tensor-core body stages the weights once and transposes them itself
    (``attn_body``)."""
    name = "fused_attn_block_bwd"
    device = wq.device
    if device.type != "cuda" or dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported device {device} or dtype {dtype}")
    _check_width(name, C, L, dtype)
    if C % groups != 0:
        raise ValueError(f"{name}: C={C} is not divisible by groups={groups}")
    params = _bwd_args((gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp), C, L, dtype, device)
    ptrs = [p.data_ptr() for p in params] + [None] * (13 - len(params))
    lib = _bwd_library()

    def launch(x, g):
        check_activations(name, x)
        B, c, H, W = x.shape
        if c != C or H * W != L or x.dtype != dtype or x.device != device:
            raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype} on {x.device} does not "
                             f"fit the block (C {C}, L {L}, {dtype} on {device})")
        if g.shape != x.shape or g.device != x.device:
            raise ValueError(f"{name}: g of shape {tuple(g.shape)} on {g.device} "
                             f"does not match x {tuple(x.shape)} on {x.device}")
        g = g.to(dtype).contiguous()
        x, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, g))   # bulk copies
        dx = torch.empty_like(x)
        grads = torch.empty(4 * C * C + 6 * C, dtype=torch.float32, device=device)
        if B == 0:
            return dx, grads.zero_()
        workspace = torch.empty(lib.rdm_fused_attn_block_bwd_workspace(B, C, L, groups),
                                dtype=torch.float32, device=device)
        keep = params                # noqa: F841 (the pointers stay valid)
        with torch.cuda.device(device):
            err = lib.rdm_fused_attn_block_bwd(
                x.data_ptr(), g.data_ptr(), dx.data_ptr(), *ptrs, grads.data_ptr(),
                workspace.data_ptr(), B, C, L, groups, _DTYPE_CODES[dtype], GN_EPS,
                float(C) ** -0.5, _rescale(skip_rescale),
                torch.cuda.current_stream(device).cuda_stream)
        _build.raise_on(lib, err, name)
        return dx, grads

    return launch


def fused_attn_block_bwd(x, g, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                         *, groups: int, skip_rescale: bool = True):
    """Backward of the fused block: ``(dx, dgn_scale, dgn_bias, dwq, dbq,
    dwk, dbk, dwv, dbv, dwp, dbp)`` for the output cotangent ``g``; dx in the
    type of ``x``, the parameter gradients float32 and shaped like the
    parameters.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (with the same limits as the forward's, and the same body for a shape:
    ``attn_body``) and raise on anything else.  The parameter gradients are
    sums in a fixed order, so two runs on the same inputs agree bit for bit.
    """
    raw = (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)
    if x.device.type == "cpu":
        return fused_attn_block_bwd_reference(x, g, *raw, groups=groups,
                                              skip_rescale=skip_rescale)
    check_activations("fused_attn_block_bwd", x)
    B, C, H, W = x.shape
    if attn_body(C, H * W, x.dtype) == "tiled":
        out = fused_attn_block_bwd_tiled(x, g, *raw, groups=groups, skip_rescale=skip_rescale)
        if B > 0:
            fused_attn_block_bwd.launches += 1
        return out
    dx, grads = _bwd_launcher(*raw, C=C, L=H * W, dtype=x.dtype, groups=groups,
                              skip_rescale=skip_rescale)(x, g)
    if B > 0:
        fused_attn_block_bwd.launches += 1
    out, offset = [], 0
    for p, shape in zip(raw, _param_shapes(C)):
        n = math.prod(shape)
        out.append(grads[offset:offset + n].reshape(p.shape))
        offset += n
    return (dx, *out)


fused_attn_block_bwd.launches = 0


def _tiled_library():
    return _build.library("fused_attn_block_tiled", "rdm_attn_tiled_fwd",
                          [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                          + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)],
                          extra=[("rdm_attn_tiled_bwd",
                                  [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                                  + [ctypes.c_float] * 4
                                  + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)],
                                  ctypes.c_int),
                                 ("rdm_attn_tiled_workspace", [ctypes.c_int] * 5,
                                  ctypes.c_longlong),
                                 ("rdm_attn_tiled_plan", [ctypes.c_int] * 4 + [ctypes.c_void_p],
                                  ctypes.c_int)])


def built_tiled_plan(B: int, C: int, L: int, groups: int) -> tuple:
    """The built library's plan (``rdm_attn_tiled_plan``, needs ``nvcc``),
    as ``TiledPlan.flat``."""
    out = (ctypes.c_int * len(tiled_plan(B, C, L).flat()))()
    lib = _tiled_library()
    _build.raise_on(lib, lib.rdm_attn_tiled_plan(B, C, L, groups, out), "fused_attn_block_tiled plan")
    return tuple(out)


def _tiled_check(name, x, groups):
    """Raise unless the tiled body takes ``x`` with ``groups``."""
    check_activations(name, x)
    B, C, H, W = x.shape
    if attn_body(C, H * W, x.dtype) != "tiled":
        raise ValueError(f"{name}: C={C}, L={H * W} in {x.dtype} is not a tiled shape")
    if C % groups != 0 or not 1 <= groups <= 32:
        raise ValueError(f"{name}: C={C} is not divisible by groups={groups} (at most 32)")


def fused_attn_block_tiled(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                           *, groups: int, skip_rescale: bool = True):
    """The fused block's tiled body (``csrc/fused_attn_block_tiled.cu``):
    bfloat16 NCHW ``x`` at a shape ``attn_body`` gives ``"tiled"``.  CPU
    tensors take the plain version; CUDA tensors launch the kernels or
    raise."""
    raw = (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)
    if x.device.type == "cpu":
        return fused_attn_block_reference(x, *raw, groups=groups, skip_rescale=skip_rescale)
    _tiled_check("fused_attn_block_tiled", x, groups)
    out = _tiled_fwd_launcher(*raw, groups=groups, skip_rescale=skip_rescale)(x)
    if x.shape[0] > 0:
        fused_attn_block_tiled.launches += 1
    return out


# the parts of the tiled forward that a launcher's launch_ms times, in order
TILED_FWD_PARTS = ("groupnorm", "qkv", "attention", "output")


def _tiled_fwd_launcher(gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp, *, groups: int,
                        skip_rescale: bool = True):
    """The tiled forward with its parameters prepared for CUDA tensors (cast
    to bfloat16, [Wq | Wk | Wv]^T, [bq | bk | bv], Wp^T): returns
    ``launch(x, launch_ms=None)`` for bfloat16 NCHW ``x`` of this width;
    ``launch_ms``, a ctypes array of ``len(TILED_FWD_PARTS)`` floats, receives
    each part's ms (CUDA events between the launches; the call then waits for
    them).  ``fused_attn_block_tiled`` builds one each call and counts the
    launch; the timing tools keep one to time the kernels without the
    per-call preparation."""
    name = "fused_attn_block_tiled"
    raw = (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)
    C, device, bf = wq.shape[0], wq.device, torch.bfloat16
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if C % groups != 0 or not 1 <= groups <= 32:
        raise ValueError(f"{name}: C={C} is not divisible by groups={groups} (at most 32)")
    for p, shape in zip(raw, _param_shapes(C)):
        if p.device != device or p.numel() != math.prod(shape):
            raise ValueError(f"{name}: parameter on another device or "
                             f"of the wrong size ({tuple(p.shape)} vs {shape})")
    args = tiled_fwd_params(raw)
    rescale = round_to(_rescale(skip_rescale), bf)
    lib = _tiled_library()

    def launch(x, launch_ms=None):
        check_activations(name, x)
        B, Cx, H, W = x.shape
        L = H * W
        if Cx != C or x.device != device or attn_body(C, L, x.dtype) != "tiled":
            raise ValueError(f"{name}: x {tuple(x.shape)} in {x.dtype} on {x.device} is not "
                             f"a tiled shape of width {C} on {device}")
        out = torch.empty_like(x)
        if B == 0:
            return out
        ws = torch.empty(tiled_workspace_bytes(B, C, L, groups, False), dtype=torch.uint8,
                         device=device)
        with torch.cuda.device(device):
            err = lib.rdm_attn_tiled_fwd(
                x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in args), ws.data_ptr(), B, C,
                L, groups, GN_EPS, float(C) ** -0.5, rescale,
                torch.cuda.current_stream(device).cuda_stream, launch_ms)
        _build.raise_on(lib, err, name)
        return out

    return launch


def tiled_fwd_params(raw) -> list:
    """The tiled forward's parameters as its source reads them, in bfloat16:
    gamma, beta, [Wq | Wk | Wv]^T (3C, C), [bq | bk | bv], Wp^T, bp.  Few
    launches: the vectors take one cast, each matrix one copy that casts and
    re-lays it."""
    bf, C, device = torch.bfloat16, raw[0].numel(), raw[0].device
    gamma, beta, bqkv, bp = torch.cat([raw[i].reshape(-1) for i in (0, 1, 3, 5, 7, 9)]).to(
        bf).split([C, C, 3 * C, C])
    wqkv_t = torch.empty((3, C, C), dtype=bf, device=device)
    wqkv_t.copy_(torch.stack([raw[i].reshape(C, C) for i in (2, 4, 6)]).transpose(1, 2))
    wp_t = torch.empty((C, C), dtype=bf, device=device).copy_(raw[8].reshape(C, C).t())
    return [gamma, beta, wqkv_t.view(3 * C, C), bqkv, wp_t, bp]


def tiled_attn_launch_ms(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                         *, groups: int, skip_rescale: bool = True, launcher=None) -> dict:
    """One call of the tiled forward on the card with each of its parts
    (``TILED_FWD_PARTS``; a split-K sum counts with its product) timed by
    CUDA events between the launches: ms by part.  Not counted in
    ``fused_attn_block_tiled.launches``: a measurement, not the model's
    path.  ``launcher``: a ``_tiled_fwd_launcher`` of these parameters to
    reuse."""
    raw = (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)
    launcher = launcher or _tiled_fwd_launcher(*raw, groups=groups, skip_rescale=skip_rescale)
    ms = (ctypes.c_float * len(TILED_FWD_PARTS))()
    launcher(x, ms)
    return dict(zip(TILED_FWD_PARTS, ms))


fused_attn_block_tiled.launches = 0


def fused_attn_block_bwd_tiled(x, g, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                               *, groups: int, skip_rescale: bool = True):
    """The backward's tiled body (``csrc/fused_attn_block_tiled.cu``), with
    ``fused_attn_block_bwd``'s outputs.  CPU tensors take the plain
    backward; CUDA tensors launch the kernels or raise.  The parameter
    gradients are float32 partials summed in a fixed order: two runs on the
    same inputs agree bit for bit."""
    raw = (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)
    if x.device.type == "cpu":
        return fused_attn_block_bwd_reference(x, g, *raw, groups=groups,
                                              skip_rescale=skip_rescale)
    _tiled_check("fused_attn_block_bwd_tiled", x, groups)
    dx, grads = _tiled_bwd_launcher(*raw, groups=groups, skip_rescale=skip_rescale)(x, g)
    if x.shape[0] > 0:
        fused_attn_block_bwd_tiled.launches += 1
    C = x.shape[1]
    n1, n2 = (C + 1) * 3 * C, (C + 1) * C
    wqkv = grads[:n1].view(C + 1, 3 * C)
    dwp = grads[n1:n1 + n2].view(C + 1, C)
    gb = grads[n1 + n2:]
    out = (gb[:C], gb[C:], wqkv[:C, :C], wqkv[C, :C], wqkv[:C, C:2 * C], wqkv[C, C:2 * C],
           wqkv[:C, 2 * C:], wqkv[C, 2 * C:], dwp[:C], dwp[C])
    return (dx, *(o.contiguous().reshape(p.shape) for o, p in zip(out, raw)))


# the parts of the tiled backward that a launcher's launch_ms times, in order
TILED_BWD_PARTS = ("recompute", "gs", "do", "ds", "dq", "dk", "dv", "dh", "gn_bwd", "dwqkv",
                   "dwp", "sums")


def _tiled_bwd_launcher(gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp, *, groups: int,
                        skip_rescale: bool = True):
    """The tiled backward with its parameters prepared for CUDA tensors (cast
    to bfloat16: gamma, beta, [Wq | Wk | Wv]^T, [bq | bk | bv], [Wq | Wk |
    Wv] and Wp): returns ``launch(x, g, launch_ms=None)`` -> ``(dx, grads)``,
    the float32 gradients packed as the source writes them, for bfloat16
    NCHW ``x`` of this width; ``launch_ms``, a ctypes array of
    ``len(TILED_BWD_PARTS)`` floats, receives each part's ms.
    ``fused_attn_block_bwd_tiled`` builds one each call and counts the
    launch; the timing tools keep one."""
    name = "fused_attn_block_bwd_tiled"
    raw = (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)
    C, device = wq.shape[0], wq.device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if C % groups != 0 or not 1 <= groups <= 32:
        raise ValueError(f"{name}: C={C} is not divisible by groups={groups} (at most 32)")
    gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp = _cast_params(name, raw, C, torch.bfloat16,
                                                               device)
    wqkv = torch.cat([wq, wk, wv], 1)
    args = [gamma, beta, wqkv.t().contiguous(), torch.cat([bq, bk, bv]), wqkv, wp]
    r = _rescale(skip_rescale)
    lib = _tiled_library()

    def launch(x, g, launch_ms=None):
        _tiled_check(name, x, groups)
        B, Cx, H, W = x.shape
        L = H * W
        if Cx != C or x.device != device:
            raise ValueError(f"{name}: x {tuple(x.shape)} on {x.device} does not fit width "
                             f"{C} on {device}")
        if g.shape != x.shape or g.device != x.device:
            raise ValueError(f"{name}: g of shape {tuple(g.shape)} on {g.device} "
                             f"does not match x {tuple(x.shape)} on {x.device}")
        g = g.to(x.dtype).contiguous()
        dx = torch.empty_like(x)
        # the source writes every element of grads; B 0 launches nothing
        grads = (torch.empty if B else torch.zeros)((C + 1) * 4 * C + 2 * C,
                                                    dtype=torch.float32, device=device)
        if B == 0:
            return dx, grads
        # the workspace's size from the source's plan, cached by shape;
        # PyTorch's caching allocator makes the buffer itself cheap
        ws = torch.empty(tiled_workspace_bytes(B, C, L, groups, True), dtype=torch.uint8,
                         device=device)
        with torch.cuda.device(device):
            err = lib.rdm_attn_tiled_bwd(
                x.data_ptr(), g.data_ptr(), dx.data_ptr(), *(a.data_ptr() for a in args),
                grads.data_ptr(), ws.data_ptr(), B, C, L, groups, GN_EPS, float(C) ** -0.5,
                round_to(r, x.dtype), r, torch.cuda.current_stream(device).cuda_stream,
                launch_ms)
        _build.raise_on(lib, err, name)
        return dx, grads

    return launch


def tiled_attn_bwd_launch_ms(x, g, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                             *, groups: int, skip_rescale: bool = True, launcher=None) -> dict:
    """One call of the tiled backward on the card with each of its parts
    (``TILED_BWD_PARTS``; the recompute is one part, a split-K sum counts
    with its product) timed by CUDA events between the launches: ms by
    part.  Not counted in ``fused_attn_block_bwd_tiled.launches``.
    ``launcher``: a ``_tiled_bwd_launcher`` of these parameters to reuse."""
    raw = (gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp)
    launcher = launcher or _tiled_bwd_launcher(*raw, groups=groups, skip_rescale=skip_rescale)
    ms = (ctypes.c_float * len(TILED_BWD_PARTS))()
    launcher(x, g, ms)
    return dict(zip(TILED_BWD_PARTS, ms))


fused_attn_block_bwd_tiled.launches = 0


class FusedAttnBlockFn(torch.autograd.Function):
    """The differentiable fused block: ``apply(x, gn_scale, gn_bias, wq, bq,
    wk, bk, wv, bv, wp, bp, groups, skip_rescale, use_kernel)``.

    ``x`` is in the working type; the parameters are the float32 master
    weights and are cast to the working type inside, so their gradients come
    back in float32 and are never rounded to the working type (a Function
    given the cast weights would have autograd round them).  It saves x and
    the parameters and its backward recomputes the forward.  With
    ``use_kernel`` both directions go through ``fused_attn_block`` and
    ``fused_attn_block_bwd`` (the kernels on CUDA tensors, the plain versions
    on CPU tensors); without it, through the plain versions on any device.
    """

    @staticmethod
    def forward(ctx, x, *args):
        params, (groups, skip_rescale, use_kernel) = args[:10], args[10:]
        ctx.save_for_backward(x, *params)
        ctx.opts = (groups, skip_rescale, use_kernel)
        fn = fused_attn_block if use_kernel else fused_attn_block_reference
        return fn(x, *params, groups=groups, skip_rescale=skip_rescale)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        groups, skip_rescale, use_kernel = ctx.opts
        fn = fused_attn_block_bwd if use_kernel else fused_attn_block_bwd_reference
        grads = fn(x, g, *params, groups=groups, skip_rescale=skip_rescale)
        return (*grads, None, None, None)


def attention_core_reference(q, k, v, softmax_f32: bool = True):
    """Plain PyTorch version of the attention core, same inputs and
    rounding: with ``softmax_f32`` (or float32 inputs) scores and softmax
    are float32 and p is rounded to v's type; otherwise the scores are
    rounded to q's type and scaled by the scale rounded to it, s - max and
    its exp are rounded, and the sum (taken in float32) is rounded before the
    division.  p.v accumulates in float32 and is rounded once."""
    dt = q.dtype
    f32 = _acc_dtype(dt)
    scale = float(q.shape[-1]) ** -0.5
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))
    if softmax_f32 or dt == f32:
        s = s * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    else:
        s = s.to(dt) * round_to(scale, dt)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.to(f32).sum(-1, keepdim=True).to(dt)
    return torch.matmul(p.to(f32), v.to(f32)).to(dt)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: the low
    13 mantissa bits to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def attention_core_3xtf32(q, k, v):
    """The float32 kernel's arithmetic in plain PyTorch (a model for the CPU
    tests, not a path of the port): every product a b as hi_a lo_b + lo_a
    hi_b + hi_a hi_b with hi = TF32(x) and lo = TF32(x - hi), the softmax
    exact in float32 and p not rounded (v is float32)."""
    def split(x):
        hi = tf32_round(x)
        return hi, tf32_round(x - hi)

    def product(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        return (torch.matmul(ah, bl) + torch.matmul(al, bh)) + torch.matmul(ah, bh)

    s = product(q, k.transpose(-1, -2)) * float(q.shape[-1]) ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return product(p / p.sum(-1, keepdim=True), v)


class CorePlan(NamedTuple):
    """Launch plan of the attention-core kernel (``csrc/attention_core.cu``)."""
    key_tiles: int          # keys padded to 16 key_tiles (2, 4, 6 or 8), zeros past L
    channel_tiles: int      # channels padded to 16 channel_tiles (4 or 8), zeros past C
    groups: int             # bfloat16: consumer groups, each taking every groups-th sample
    warps: int              # per block: one per 16 query rows in each group (and a producer)
    samples_in_flight: int  # per block: the bf16 ring's stages, two of each group's own; f32 1
    smem_bytes: int         # bf16: 1024 of alignment slack, the ring, two barriers a stage;
                            # f32: q, k, v of one sample, 16 key_tiles rows of C + 4 floats


def core_plan(L: int, C: int, dtype: torch.dtype = torch.bfloat16) -> CorePlan:
    """The kernel's plan for (L, C) in ``dtype``, as ``attention_core.cu``
    computes it; raises where the kernel does not take the shape."""
    if not (1 <= L <= MAX_TOKENS and 8 <= C <= CORE_MAX_CHANNELS and C % 8 == 0):
        raise ValueError(f"attention_core: unsupported L={L}, C={C} (L <= {MAX_TOKENS}, "
                         f"C <= {CORE_MAX_CHANNELS}, C % 8 == 0)")
    key_tiles = -(-L // 32) * 2
    channel_tiles = 4 if C <= 64 else 8
    if dtype == torch.float32:
        return CorePlan(key_tiles, channel_tiles, 1, -(-L // 16), 1,
                        3 * 16 * key_tiles * (C + 4) * 4)
    groups = 1 if key_tiles * channel_tiles >= 32 else 2
    sample = 3 * (16 * key_tiles) * (16 * channel_tiles) * 2       # q, k, v in bfloat16
    stages = CORE_STAGES_PER_GROUP * groups
    smem = 1024 + stages * (sample + 16)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"attention_core: L={L}, C={C} needs {smem} bytes of shared memory")
    return CorePlan(key_tiles, channel_tiles, groups, groups * -(-L // 16) + 1, stages, smem)


def attention_core(q, k, v, softmax_f32: bool = True):
    """softmax(q k^T / sqrt(C)) v over (B, L, C) ``q``, ``k``, ``v``, in
    q's type; the L x L scores never leave the chip.

    CPU tensors take the plain version.  CUDA tensors launch the kernel; it
    takes float32 or bfloat16 of one type, L <= 128 and C <= 128 with C % 8
    == 0, contiguous and starting on a 16-byte boundary, and raises on
    anything else.
    """
    if q.device.type == "cpu":
        return attention_core_reference(q, k, v, softmax_f32)
    name = "attention_core"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.shape != q.shape or t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise ValueError(f"{name}: q, k, v must share shape, type and device")
    if q.dim() != 3 or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: expected (B, L, C) float32 or bfloat16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, L, C = q.shape
    core_plan(L, C, q.dtype)
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _build.library("attention_core", "rdm_attention_core",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = lib.rdm_attention_core(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, C,
            _DTYPE_CODES[q.dtype], int(not softmax_f32), float(C) ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on(lib, err, name)
    attention_core.launches += 1
    return out


attention_core.launches = 0
