"""Fused NCSN++ attention block: GroupNorm -> q, k, v NINs -> softmax
attention over the L = H*W tokens -> output NIN -> residual (times 1/sqrt 2).

``fused_attn_block`` launches the hand-written CUDA kernel in
``csrc/fused_attn_block.cu`` on a CUDA tensor and runs the plain PyTorch
version ``fused_attn_block_reference`` on a CPU tensor; on a CUDA tensor it
launches the kernel or raises, it never falls back.

The kernel replaces the TPU kernel
``rdm_tpu/ops/pallas/attention.py::_fused_block_kernel``.  At the sampling
shape (B = 1024, L = 81, C = 64, bf16) it must move 21.2 MB (x in, out out)
and do about 4.4 GFLOP, so device memory bounds it (about 6.3 us at
3.35 TB/s, against 4.5 us at 989 TFLOP/s).  Its design keeps every
intermediate of one sample in shared memory, so device memory sees x, out
and the weights once; see the source for the layout.

Both versions take the model's NCHW activations and the NIN weights as
(C_in, C_out) matrices, cast every parameter to the activations' type
first, and round at the same points: h, each NIN product (before its bias
is added in the working type), the softmax probabilities and p.v are
rounded to the working type, statistics, scores and softmax are float32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

SUPPORTED_CHANNELS = (64, 128)
MAX_TOKENS = 128
GN_EPS = 1e-6
# Shared memory one block may use on sm_90 (227 KB), and the kernel's static
# share of it (two float arrays of C entries).
_SMEM_LIMIT = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def round_to(value: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype`` (how a weakly typed scalar enters
    arithmetic in the working type)."""
    return float(torch.tensor(value, dtype=dtype))


def fused_attn_block_reference(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                               *, groups: int, skip_rescale: bool = True):
    """Plain PyTorch version of the fused block, same inputs and rounding."""
    dt = x.dtype
    B, C, H, W = x.shape
    L = H * W
    f32 = torch.float32
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
    rescale = round_to(1.0 / math.sqrt(2.0) if skip_rescale else 1.0, dt)
    out = (x.reshape(B, C, L).transpose(1, 2) + o2) * rescale
    return out.transpose(1, 2).reshape(B, C, H, W)


def rows_per_chunk(C: int, L: int) -> int:
    """Query rows the kernel handles at once: all of them where shared
    memory allows, else the most that fit.  The kernel keeps k transposed
    (C x LP, LP = L rounded up to 8), v (L x C), h (L x (C + 1)) and, per
    row of a chunk, one row of q (C + 1) and of scores (LP), all float32."""
    lp = -(-L // 8) * 8
    fixed = 4 * (C * lp + L * C + L * (C + 1)) + 2 * 4 * C
    rows = (_SMEM_LIMIT - fixed) // (4 * (C + 1 + lp))
    if rows < 1:
        raise ValueError(f"fused_attn_block: C={C}, L={L} does not fit in shared memory")
    return min(L, rows)


def _library():
    lib = _build.load_library("fused_attn_block")
    fn = lib.rdm_fused_attn_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.rdm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rdm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_attn_block(x, gn_scale, gn_bias, wq, bq, wk, bk, wv, bv, wp, bp,
                     *, groups: int, skip_rescale: bool = True):
    """The fused attention block on NCHW ``x``.

    CPU tensors take the plain version.  CUDA tensors launch the kernel; it
    takes float32 or bfloat16, C in {64, 128} divisible by ``groups`` and
    at most 128 tokens, contiguous, and raises on anything else.
    """
    if x.device.type == "cpu":
        return fused_attn_block_reference(x, gn_scale, gn_bias, wq, bq, wk, bk,
                                          wv, bv, wp, bp, groups=groups,
                                          skip_rescale=skip_rescale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_block: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"fused_attn_block: expected NCHW, got shape {tuple(x.shape)}")
    B, C, H, W = x.shape
    L = H * W
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_attn_block: unsupported dtype {x.dtype}")
    if C not in SUPPORTED_CHANNELS or C % groups != 0:
        raise ValueError(f"fused_attn_block: unsupported C={C}, groups={groups}")
    if L > MAX_TOKENS:
        raise ValueError(f"fused_attn_block: {L} tokens exceed {MAX_TOKENS}")
    if not x.is_contiguous():
        raise ValueError("fused_attn_block: x must be contiguous")
    params = []
    for p, shape in ((gn_scale, (C,)), (gn_bias, (C,)), (wq, (C, C)), (bq, (C,)),
                     (wk, (C, C)), (bk, (C,)), (wv, (C, C)), (bv, (C,)),
                     (wp, (C, C)), (bp, (C,))):
        if p.device != x.device or p.numel() != math.prod(shape):
            raise ValueError("fused_attn_block: parameter on another device or "
                             f"of the wrong size ({tuple(p.shape)} vs {shape})")
        p = p.reshape(shape).to(x.dtype).contiguous()
        # the kernel reads weight rows with 16-byte loads
        params.append(p if p.data_ptr() % 16 == 0 else p.clone())
    out = torch.empty_like(x)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.rdm_fused_attn_block(
            x.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in params),
            B, C, L, groups, rows_per_chunk(C, L), _DTYPE_CODES[x.dtype],
            GN_EPS, float(C) ** -0.5, 1.0 / math.sqrt(2.0) if skip_rescale else 1.0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_attn_block launch failed: "
                           + lib.rdm_cuda_error_string(err).decode())
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0
