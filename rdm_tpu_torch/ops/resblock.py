"""Fused NCSN++ resblock (the ResnetBlockDDPMpp forward) and its gradient.

    h   = conv3x3(SiLU(GroupNorm_0(x))) + b0 + tembv
    h   = conv3x3(SiLU(GroupNorm_1(h))) + b1
    out = (shortcut(x) + h) * rescale

``tembv`` (B, C_out) is the time embedding after the block's dense layer,
computed outside in the working type, as the JAX package does.  The
shortcut is a NIN when the width changes and the identity otherwise.

``FusedResblockFn`` is the differentiable block the model calls.  It takes
the activations in the working type and the float32 master parameters,
casts the parameters inside, and its backward recomputes through autograd
of ``resblock_jnp_twin`` with the float32 parameters, as the JAX package's
custom VJP differentiates its jnp twin.  There is no backward kernel: the
JAX package has none either.

``fused_resblock`` launches the hand-written CUDA kernel
``csrc/fused_resblock.cu`` on CUDA tensors and runs the plain PyTorch
version ``fused_resblock_reference`` on CPU tensors; on a CUDA tensor it
launches the kernel or raises, it never falls back.  The kernel replaces
the TPU kernel ``rdm_tpu/ops/pallas/resblock.py::_kernel`` and keeps its
rounding points in the working type T:

* GroupNorm statistics in float32 in one pass (E[x^2] - mean^2); the
  scale and bias rounded to T; SiLU in float32, its output rounded once;
* each convolution accumulates all 9 taps in float32 and is rounded once,
  then its bias is added in T; ``+ tembv`` in T;
* the shortcut NIN is a float32 product rounded to T, then ``+ bn`` in T;
* the residual ``(xs + h)`` in T, then times ``T(rescale)`` (bf16(1/sqrt 2)
  = 0.70703125).

Parameters use the module's layouts: convolution weights (C_out, C_in, 3,
3), the NIN weight (C_in, C_out), one-dimensional scales and biases.

Every other shape of DDPM++ on CIFAR-10 and of the nf-32 NCSN++ (bfloat16,
H = W up to 64, C_in and C_out multiples of 32 up to 1024) takes the tiled
body ``csrc/fused_resblock_tiled.cu`` (``fused_resblock_tiled``): a sample
does not fit a block there, so GroupNorm, each convolution (an implicit GEMM
over every sample's tokens) and the shortcut run as launches that meet in
global memory, each intermediate stored in bfloat16 where the TPU kernel
rounds it (``resblock_body`` names the body a shape takes).

In bfloat16 the flagship's kernel runs each convolution as an implicit GEMM
on the tensor cores; the host hands it its weights and its 3x3 shift in its own
layouts: ``weight_panels`` (the weights as the stages its ring streams) and
``gather_table`` (each token row's neighbour row per tap, or the zero row).
The kernel's geometry and ring live in its source alone; ``resblock_plan``
asks the built library for them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .attention import GN_EPS, _DTYPE_CODES, _acc_dtype, _rescale, check_activations, round_to

# (H, C_out) the flagship's kernel takes, with H = W; C_in is any of KERNEL_C_IN.
KERNEL_SHAPES = ((9, 64), (4, 128), (2, 128))
KERNEL_C_IN = (64, 128, 192, 256)
MAX_GROUPS = 32
# the tiled body (bfloat16): H = W up to TILED_MAX_H, widths multiples of 32 up to TILED_MAX_C
TILED_MAX_H = 64
TILED_MAX_C = 1024
PANEL_K = 64            # input channels of one weight stage
_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_PLAN_FN = ("rdm_fused_resblock_plan", [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int)


def flagship_takes(H: int, W: int, c_in: int, c_out: int) -> bool:
    """Whether ``csrc/fused_resblock.cu`` (float32 or bfloat16) takes the shape."""
    return H == W and (H, c_out) in KERNEL_SHAPES and c_in in KERNEL_C_IN


def resblock_body(H: int, W: int, c_in: int, c_out: int, dtype: torch.dtype) -> str:
    """The body a shape takes, the one place that decides it:
    ``"tensor_cores"`` (the flagship's shapes in bfloat16), ``"scalar"``
    (the same in float32) or ``"tiled"`` (bfloat16, H = W up to
    ``TILED_MAX_H``, widths multiples of 32 up to ``TILED_MAX_C``); raises
    where none does."""
    if flagship_takes(H, W, c_in, c_out) and dtype in _DTYPE_CODES:
        return "tensor_cores" if dtype == torch.bfloat16 else "scalar"
    if (dtype == torch.bfloat16 and H == W and 1 <= H <= TILED_MAX_H
            and all(32 <= c <= TILED_MAX_C and c % 32 == 0 for c in (c_in, c_out))):
        return "tiled"
    raise ValueError(f"fused_resblock: no kernel takes H={H}, W={W}, C_in={c_in}, "
                     f"C_out={c_out} in {dtype}")


class TiledResblockPlan(NamedTuple):
    """Launches of the tiled body at (B, H, C_in, C_out), as
    ``fused_resblock_tiled.cu``'s ``rdm_resblock_tiled_plan`` gives them."""
    launches: int       # GroupNorm, conv0, GroupNorm, [NIN], conv1
    conv0_grid: tuple   # (M tiles, N tiles, 1): M = B H W token rows, N = C_out
    nin_grid: tuple     # (L tiles, N tiles, B), (0, 0, 0) without a NIN
    conv1_grid: tuple
    gn0_blocks: int     # one block a (sample, group)
    gn1_blocks: int
    gemm_threads: int
    gn_threads: int
    gemm_smem_bytes: int  # static: one 64 x 32 stage of A and of B, rows padded to 40

    def flat(self) -> tuple:
        return (self.launches, *self.conv0_grid, *self.nin_grid, *self.conv1_grid,
                self.gn0_blocks, self.gn1_blocks, self.gemm_threads, self.gn_threads,
                self.gemm_smem_bytes)


GEMM_TILE = 64


def tiled_resblock_plan(B: int, H: int, c_in: int, c_out: int, groups0: int,
                        groups1: int) -> TiledResblockPlan:
    """The tiled body's plan, computed here as its source does."""
    if not (_is_tiled(H, H, c_in, c_out, torch.bfloat16) and B >= 1
            and _groups_ok(c_in, groups0) and _groups_ok(c_out, groups1)):
        raise ValueError(f"fused_resblock_tiled: no plan for B={B}, H={H}, C_in={c_in}, "
                         f"C_out={c_out}, groups {groups0}, {groups1}")
    t = lambda n: -(-n // GEMM_TILE)
    nin = c_in != c_out
    return TiledResblockPlan(5 if nin else 4, (t(B * H * H), t(c_out), 1),
                             (t(H * H), t(c_out), B) if nin else (0, 0, 0),
                             (t(B * H * H), t(c_out), 1), B * groups0, B * groups1, 128, 256,
                             2 * GEMM_TILE * 40 * 2)


def _bias(b):
    return b[None, :, None, None]


def fused_resblock_reference(x, tembv, gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b,
                             conv1_w, conv1_b, nin_w=None, nin_b=None, *, groups0: int,
                             groups1: int, skip_rescale: bool = True):
    """Plain PyTorch version of the fused block: the kernel's inputs and
    rounding points (see the module docstring)."""
    dt = x.dtype
    f32 = _acc_dtype(dt)
    (gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b) = (
        p.to(dt) for p in (gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b))

    def gn_act(t, groups, scale, bias):
        B, C, H, W = t.shape
        tg = t.to(f32).reshape(B, groups, -1)
        inv_n = 1.0 / tg.shape[-1]
        mu = tg.sum(-1, keepdim=True) * inv_n
        var = (tg * tg).sum(-1, keepdim=True) * inv_n - mu * mu
        hh = ((tg - mu) * torch.rsqrt(var + GN_EPS)).reshape(B, C, H, W)
        hh = hh * _bias(scale.to(f32)) + _bias(bias.to(f32))
        return F.silu(hh).to(dt)

    def conv(t, w, b):
        return F.conv2d(t.to(f32), w.to(f32), padding=1).to(dt) + _bias(b)

    h = conv(gn_act(x, groups0, gn0_w, gn0_b), conv0_w, conv0_b)
    h = h + tembv.to(dt)[:, :, None, None]
    h = conv(gn_act(h, groups1, gn1_w, gn1_b), conv1_w, conv1_b)
    if nin_w is None:
        xs = x
    else:
        xs = (torch.einsum("bchw,cd->bdhw", x.to(f32), nin_w.to(dt).to(f32)).to(dt)
              + _bias(nin_b.to(dt)))
    return (xs + h) * round_to(_rescale(skip_rescale), dt)


def resblock_jnp_twin(x, tembv, gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b,
                      conv1_w, conv1_b, nin_w=None, nin_b=None, *, groups0: int,
                      groups1: int, skip_rescale: bool = True):
    """The JAX package's ``_jnp_reference`` in PyTorch, which the backward
    differentiates: the parameters stay float32 (not rounded to the working
    type), GroupNorm takes two passes (mean, then the mean squared
    deviation), the convolutions and the NIN run in float32 and are rounded
    to the working type after their bias."""
    dt = x.dtype
    f32 = _acc_dtype(dt)

    def gn_act(t, groups, scale, bias):
        B, C, H, W = t.shape
        tg = t.to(f32).reshape(B, groups, -1)
        mu = tg.mean(-1, keepdim=True)
        var = ((tg - mu) ** 2).mean(-1, keepdim=True)
        hh = ((tg - mu) / torch.sqrt(var + GN_EPS)).reshape(B, C, H, W)
        return F.silu(hh * _bias(scale.to(f32)) + _bias(bias.to(f32))).to(dt)

    def conv(t, w, b):
        return (F.conv2d(t.to(f32), w.to(f32), padding=1) + _bias(b.to(f32))).to(dt)

    h = conv(gn_act(x, groups0, gn0_w, gn0_b), conv0_w, conv0_b)
    h = h + tembv.to(dt)[:, :, None, None]
    h = conv(gn_act(h, groups1, gn1_w, gn1_b), conv1_w, conv1_b)
    if nin_w is None:
        xs = x
    else:
        xs = (torch.einsum("bchw,cd->bdhw", x.to(f32), nin_w.to(f32))
              + _bias(nin_b.to(f32))).to(dt)
    return (xs + h) * round_to(_rescale(skip_rescale), dt)


class ResblockPlan(NamedTuple):
    """Launch plan of the bfloat16 kernel for one block shape, as its source
    computes it (``csrc/fused_resblock.cu``: tc_plan)."""
    samples: int        # samples a block holds at once (a group)
    rows: int           # their token rows, padded to whole tiles; row `rows` is zero
    weight_stages: int  # stages of C_out x 64 bf16 weights a group consumes
    stages: int         # ring stages in shared memory
    stage_bytes: int
    smem_bytes: int

    @property
    def resident(self) -> bool:
        """Every stage fits: each block loads the weights once."""
        return self.stages == self.weight_stages


def _library():
    return _build.library("fused_resblock", "rdm_fused_resblock", _ARGTYPES, extra=[_PLAN_FN])


def _plan(lib, H: int, c_in: int, c_out: int) -> ResblockPlan:
    out = (ctypes.c_int * len(ResblockPlan._fields))()
    _build.raise_on(lib, lib.rdm_fused_resblock_plan(H, c_in, c_out, out), "fused_resblock plan")
    return ResblockPlan(*out)


def resblock_plan(H: int, c_in: int, c_out: int) -> ResblockPlan:
    """The bfloat16 kernel's plan for a block shape the flagship's kernel
    takes, from the built library (it needs ``nvcc``)."""
    if not flagship_takes(H, H, c_in, c_out):
        raise ValueError(f"fused_resblock: no kernel plan for H={H}, C_in={c_in}, C_out={c_out}")
    return _plan(_library(), H, c_in, c_out)


def gather_table_np(H: int, samples: int, rows: int) -> np.ndarray:
    """(9, rows) int16: for row r of a group (sample r // L, token r % L at
    y, x) and tap t = (dy + 1) * 3 + (dx + 1), the row of the token at
    (y + dy, x + dx) of the same sample, or ``rows`` (the zero row) where
    that lies outside the image or r lies past the group's samples."""
    L = H * H
    r = np.arange(rows)
    y, x = (r % L) // H, r % H
    table = np.full((9, rows), rows, np.int16)
    for t in range(9):
        yy, xx = y + t // 3 - 1, x + t % 3 - 1
        inside = (r < samples * L) & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < H)
        table[t, inside] = (r - r % L + yy * H + xx)[inside]
    return table


@functools.lru_cache(maxsize=None)
def gather_table(H: int, samples: int, rows: int, device: torch.device) -> torch.Tensor:
    """``gather_table_np`` on ``device``, made once."""
    return torch.from_numpy(gather_table_np(H, samples, rows)).to(device)


def _panel_layout(conv0_w, conv1_w, nin_w=None):
    """weight_panels' permutation, on tensors of any type (see there)."""
    c_out = conv0_w.shape[0]

    def stages(w_taps):               # (taps, C_out, C_in) -> (taps * C_in / 64, C_out, 64)
        taps, _, c_in = w_taps.shape
        return (w_taps.reshape(taps, c_out, c_in // PANEL_K, PANEL_K).transpose(1, 2)
                .reshape(-1, c_out, PANEL_K))

    parts = [] if nin_w is None else [stages(nin_w.t()[None])]
    parts += [stages(w.permute(2, 3, 0, 1).reshape(9, c_out, w.shape[1])) for w in (conv0_w, conv1_w)]
    panels = torch.cat(parts).reshape(-1, c_out, 8, 8)
    n = torch.arange(c_out, device=panels.device)
    slot = torch.arange(8, device=panels.device)
    return panels[:, n[:, None], slot[None, :] ^ (n[:, None] % 8)].reshape(-1, c_out, PANEL_K)


@functools.lru_cache(maxsize=None)
def _panel_index(c_in: int, c_out: int, device: torch.device) -> torch.Tensor:
    """For each element of the panels, its index in conv0_w, conv1_w and
    nin_w flattened one after the other."""
    n0, n1 = 9 * c_out * c_in, 9 * c_out * c_out
    pos = torch.arange(n0 + n1 + (c_in * c_out if c_in != c_out else 0))
    nin = pos[n0 + n1:].reshape(c_in, c_out) if c_in != c_out else None
    return _panel_layout(pos[:n0].reshape(c_out, c_in, 3, 3),
                         pos[n0:n0 + n1].reshape(c_out, c_out, 3, 3), nin).to(device)


def weight_panels(conv0_w, conv1_w, nin_w=None):
    """The weights as the bfloat16 kernel's ring streams them, in the
    weights' type: (stages, C_out, 64), the NIN's C_in / 64 stages, then
    conv0's 9 C_in / 64 and conv1's 9 C_out / 64, each convolution tap-major
    (tap (dy + 1) * 3 + (dx + 1)) and then by 64 input channels.  A stage
    holds for each output channel n its 64 input channels in eight 16-byte
    chunks, chunk j at slot j ^ (n % 8) (the B operand of mma.sync, which
    ldmatrix then reads free of bank conflicts).  One gather through an
    index made once per shape."""
    c_out, c_in = conv0_w.shape[:2]
    flat = [w.reshape(-1) for w in (conv0_w, conv1_w, nin_w) if w is not None]
    return torch.cat(flat)[_panel_index(c_in, c_out, conv0_w.device)]


def _check_params(params, H, c_in, device, name):
    """Raise unless the ten parameters (None for an absent NIN) fit a block
    shape the flagship's kernel takes, on ``device``; return C_out."""
    c_out = params[2].shape[0]
    if not flagship_takes(H, H, c_in, c_out):
        raise ValueError(f"{name}: unsupported shape H={H}, W={H}, C_in={c_in}, "
                         f"C_out={c_out}; the kernel takes H = W with (H, C_out) in "
                         f"{KERNEL_SHAPES} and C_in in {KERNEL_C_IN}")
    _check_param_shapes(params, c_in, c_out, device, name)
    return c_out


def _check_param_shapes(params, c_in, c_out, device, name):
    nin_w, nin_b = params[8], params[9]
    if (nin_w is None) != (c_in == c_out) or (nin_w is None) != (nin_b is None):
        raise ValueError(f"{name}: a NIN shortcut is needed exactly when C_in != C_out")
    shapes = [(c_in,), (c_in,), (c_out, c_in, 3, 3), (c_out,), (c_out,), (c_out,),
              (c_out, c_out, 3, 3), (c_out,), (c_in, c_out), (c_out,)]
    for p, shape in zip(params, shapes):
        if p is not None and (p.device != device or tuple(p.shape) != shape):
            raise ValueError(f"{name}: parameter of shape {tuple(p.shape)} on {p.device}, "
                             f"expected {shape} on {device}")


def _groups_ok(C, groups):
    return 1 <= groups <= MAX_GROUPS and C % groups == 0


def _is_tiled(H, W, c_in, c_out, dtype):
    try:
        return resblock_body(H, W, c_in, c_out, dtype) == "tiled"
    except ValueError:
        return False


def _launcher(gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b, nin_w=None,
              nin_b=None, *, H: int, dtype: torch.dtype, groups0: int, groups1: int,
              skip_rescale: bool = True):
    """The kernel with its parameters prepared for CUDA tensors: returns
    ``launch(x, tembv)``, which checks NCHW ``x`` and ``tembv`` (B, C_out)
    and launches the kernel on them.  The parameters are cast to ``dtype``:
    float32 takes the convolution weights as (9, C_in, C_out) with tap k =
    (dy + 1) * 3 + (dx + 1); bfloat16 takes ``weight_panels`` and the gather
    table of ``resblock_plan``.  ``fused_resblock`` builds one each call
    and counts the launch; the timing tools keep one to time the kernel
    without the per-call preparation."""
    name = "fused_resblock"
    raw = [gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b, nin_w, nin_b]
    device, c_in = conv0_w.device, conv0_w.shape[1]
    if device.type != "cuda" or dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported device {device} or dtype {dtype}")
    c_out = _check_params(raw, H, c_in, device, name)
    if not (_groups_ok(c_in, groups0) and _groups_ok(c_out, groups1)):
        raise ValueError(f"{name}: groups {groups0}, {groups1} do not divide "
                         f"C_in={c_in}, C_out={c_out} or exceed {MAX_GROUPS}")
    lib = _library()
    cast = [None if p is None else p.to(dtype) for p in raw]
    panels, table = None, None
    if dtype == torch.bfloat16:
        panels = weight_panels(cast[2], cast[6], cast[8])
        cast[2] = cast[6] = cast[8] = None
        plan = _plan(lib, H, c_in, c_out)
        table = gather_table(H, plan.samples, plan.rows, device)
    else:
        cast[2], cast[6] = (w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])
                            for w in (cast[2], cast[6]))
    args = []
    for p in cast + [panels, table]:
        p = None if p is None else p.contiguous()
        args.append(None if p is None else p if p.data_ptr() % 16 == 0 else p.clone())
    ptrs = [None if p is None else p.data_ptr() for p in args]

    def launch(x, tembv):
        check_activations(name, x)
        B = x.shape[0]
        if (x.shape[1:] != (c_in, H, H) or x.dtype != dtype or x.device != device
                or tembv.shape != (B, c_out) or tembv.device != device):
            raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype} on {x.device} and tembv "
                             f"{tuple(tembv.shape)} do not fit the block ({c_in}, {H}, {H}) "
                             f"-> {c_out}, {dtype} on {device}")
        tembv = tembv.to(dtype).contiguous()
        if tembv.data_ptr() % 16:   # read in 16-byte loads
            tembv = tembv.clone()
        out = torch.empty((B, c_out, H, H), dtype=dtype, device=device)
        if B == 0:
            return out
        keep = args                     # noqa: F841 (the pointers stay valid)
        with torch.cuda.device(device):
            err = lib.rdm_fused_resblock(
                x.data_ptr(), tembv.data_ptr(), out.data_ptr(), *ptrs, B, H, c_in, c_out,
                groups0, groups1, _DTYPE_CODES[dtype], GN_EPS,
                _rescale(skip_rescale), torch.cuda.current_stream(device).cuda_stream)
        _build.raise_on(lib, err, name)
        return out

    return launch


def fused_resblock(x, tembv, gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b,
                   conv1_w, conv1_b, nin_w=None, nin_b=None, *, groups0: int,
                   groups1: int, skip_rescale: bool = True):
    """The fused resblock on NCHW ``x`` with the block's ``tembv`` (B, C_out).

    CPU tensors take the plain version.  CUDA tensors launch the kernel; it
    takes the shapes of ``resblock_body`` (every block of the flagship
    NCSN++ in float32 or bfloat16; every block of DDPM++ and of the nf-32
    NCSN++ in bfloat16, through ``fused_resblock_tiled``), any batch, at
    most 32 groups, contiguous x, and raises on anything else.
    """
    raw = (gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b, nin_w, nin_b)
    kw = dict(groups0=groups0, groups1=groups1, skip_rescale=skip_rescale)
    if x.device.type == "cpu":
        return fused_resblock_reference(x, tembv, *raw, **kw)
    check_activations("fused_resblock", x)
    B, c_in, H, W = x.shape
    if resblock_body(H, W, c_in, conv0_w.shape[0], x.dtype) == "tiled":
        out = fused_resblock_tiled(x, tembv, *raw, **kw)
    else:
        out = _launcher(*raw, H=H, dtype=x.dtype, **kw)(x, tembv)
    if x.shape[0] > 0:
        fused_resblock.launches += 1
    return out


fused_resblock.launches = 0


_TILED_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])


def _tiled_library():
    return _build.library("fused_resblock_tiled", "rdm_resblock_tiled", _TILED_ARGTYPES,
                          extra=[("rdm_resblock_tiled_workspace", [ctypes.c_int] * 4,
                                  ctypes.c_longlong),
                                 ("rdm_resblock_tiled_plan",
                                  [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int)])


def built_tiled_resblock_plan(B: int, H: int, c_in: int, c_out: int, groups0: int,
                              groups1: int) -> tuple:
    """The built library's plan (needs ``nvcc``), as ``TiledResblockPlan.flat``."""
    out = (ctypes.c_int * 15)()
    lib = _tiled_library()
    _build.raise_on(lib, lib.rdm_resblock_tiled_plan(B, H, c_in, c_out, groups0, groups1, out),
                    "fused_resblock_tiled plan")
    return tuple(out)


def fused_resblock_tiled(x, tembv, gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b,
                         conv1_w, conv1_b, nin_w=None, nin_b=None, *, groups0: int,
                         groups1: int, skip_rescale: bool = True):
    """The fused block's tiled body (``csrc/fused_resblock_tiled.cu``):
    bfloat16 NCHW ``x`` at a shape ``resblock_body`` gives ``"tiled"``.  CPU tensors take the
    plain version; CUDA tensors launch the kernels or raise.  The weights go
    in as (C_out, 9 C) matrices with column tap * C + c (tap (dy + 1) * 3 +
    (dx + 1)) and the NIN as Wn^T."""
    raw = (gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b, nin_w, nin_b)
    kw = dict(groups0=groups0, groups1=groups1, skip_rescale=skip_rescale)
    if x.device.type == "cpu":
        return fused_resblock_reference(x, tembv, *raw, **kw)
    name = "fused_resblock_tiled"
    check_activations(name, x)
    B, c_in, H, W = x.shape
    c_out = conv0_w.shape[0]
    if not _is_tiled(H, W, c_in, c_out, x.dtype):
        raise ValueError(f"{name}: unsupported {x.dtype} x of shape {tuple(x.shape)} -> "
                         f"C_out={c_out}; the tiled body takes bfloat16, H = W <= "
                         f"{TILED_MAX_H}, widths multiples of 32 up to {TILED_MAX_C}")
    _check_param_shapes(raw, c_in, c_out, x.device, name)
    if not (_groups_ok(c_in, groups0) and _groups_ok(c_out, groups1)):
        raise ValueError(f"{name}: groups {groups0}, {groups1} do not divide "
                         f"C_in={c_in}, C_out={c_out} or exceed {MAX_GROUPS}")
    if tembv.shape != (B, c_out) or tembv.device != x.device:
        raise ValueError(f"{name}: tembv {tuple(tembv.shape)} on {tembv.device} does not fit "
                         f"({B}, {c_out}) on {x.device}")
    bf = torch.bfloat16
    cast = [None if p is None else p.to(bf) for p in raw]
    cast[2], cast[6] = (w.permute(0, 2, 3, 1).reshape(c_out, -1) for w in (cast[2], cast[6]))
    if cast[8] is not None:
        cast[8] = cast[8].t()
    args = [None if p is None else p.contiguous() for p in cast]
    tembv = tembv.to(bf).contiguous()
    out = torch.empty((B, c_out, H, W), dtype=bf, device=x.device)
    if B == 0:
        return out
    lib = _tiled_library()
    ws = torch.empty(lib.rdm_resblock_tiled_workspace(B, H, c_in, c_out), dtype=torch.uint8,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = lib.rdm_resblock_tiled(
            x.data_ptr(), tembv.data_ptr(), out.data_ptr(),
            *(None if p is None else p.data_ptr() for p in args), ws.data_ptr(), B, H, c_in,
            c_out, groups0, groups1, GN_EPS, round_to(_rescale(skip_rescale), bf),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(lib, err, name)
    fused_resblock_tiled.launches += 1
    return out


fused_resblock_tiled.launches = 0


def route(H: int, W: int, c_in: int, c_out: int, dtype: torch.dtype):
    """The fused block's forward for a block shape in the model's type,
    chosen once when the model is built: ``fused_resblock`` where
    ``resblock_body`` names a body (every block of the flagship, and in
    bfloat16 of DDPM++ and of the nf-32 NCSN++), else
    ``fused_resblock_reference`` on any device (the TPU kernel computes
    every shape; nothing falls back at launch time)."""
    try:
        resblock_body(H, W, c_in, c_out, dtype)
    except ValueError:
        return fused_resblock_reference
    return fused_resblock


class FusedResblockFn(torch.autograd.Function):
    """The differentiable fused block: ``apply(x, tembv, gn0_w, gn0_b,
    conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b, nin_w, nin_b, groups0,
    groups1, skip_rescale[, forward_fn])`` with ``nin_w``/``nin_b`` None
    where the width does not change.

    ``x`` and ``tembv`` are in the working type; the parameters are the
    float32 master weights.  The forward is ``forward_fn``, which casts them
    inside: ``fused_resblock`` (the default: the kernel on CUDA tensors, the
    plain version on CPU tensors) or ``fused_resblock_reference`` (the plain
    version on any device, for a block shape the kernel does not take; see
    ``route``).  The backward differentiates ``resblock_jnp_twin`` with the
    float32 parameters and the cotangent in the output's type, so the
    parameter gradients come back in float32.
    """

    @staticmethod
    def forward(ctx, x, tembv, *args):
        params, (groups0, groups1, skip_rescale, *forward_fn) = args[:10], args[10:]
        ctx.save_for_backward(x, tembv, *params)
        ctx.opts = dict(groups0=groups0, groups1=groups1, skip_rescale=skip_rescale)
        ctx.n_opts = len(args) - 10
        fn = forward_fn[0] if forward_fn else fused_resblock
        return fn(x, tembv, *params, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:len(saved)]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, needs)]
            out = resblock_jnp_twin(*ins, **ctx.opts)
            wrt = [t for t in ins if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g.to(out.dtype)))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in ins),
                *(None,) * ctx.n_opts)
