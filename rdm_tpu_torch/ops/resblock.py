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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .attention import GN_EPS, _DTYPE_CODES, _acc_dtype, _rescale, check_activations, round_to

# (H, C_out) the kernel takes, with H = W; C_in is any of KERNEL_C_IN.
KERNEL_SHAPES = ((9, 64), (4, 128), (2, 128))
KERNEL_C_IN = (64, 128, 192, 256)
MAX_GROUPS = 32


def kernel_takes(H: int, W: int, c_in: int, c_out: int) -> bool:
    """Whether the CUDA kernel takes this block shape."""
    return H == W and (H, c_out) in KERNEL_SHAPES and c_in in KERNEL_C_IN


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


def _kernel_args(x, tembv, params, name):
    """Check the inputs for the kernel and return ``(B, H, C_in, C_out,
    tembv, params)``: tembv and the parameters in the working type,
    contiguous and 16-byte aligned, the convolution weights as (9, C_in,
    C_out) with tap k = (dy + 1) * 3 + (dx + 1), and None for an absent
    NIN."""
    check_activations(name, x)
    B, c_in, H, W = x.shape
    gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b, nin_w, nin_b = params
    c_out = conv0_w.shape[0]
    if not kernel_takes(H, W, c_in, c_out):
        raise ValueError(f"{name}: unsupported shape H={H}, W={W}, C_in={c_in}, "
                         f"C_out={c_out}; the kernel takes H = W with (H, C_out) in "
                         f"{KERNEL_SHAPES} and C_in in {KERNEL_C_IN}")
    if (nin_w is None) != (c_in == c_out) or (nin_w is None) != (nin_b is None):
        raise ValueError(f"{name}: a NIN shortcut is needed exactly when C_in != C_out")
    shapes = [(c_in,), (c_in,), (c_out, c_in, 3, 3), (c_out,), (c_out,), (c_out,),
              (c_out, c_out, 3, 3), (c_out,), (c_in, c_out), (c_out,)]
    if tembv.shape != (B, c_out) or tembv.device != x.device:
        raise ValueError(f"{name}: tembv of shape {tuple(tembv.shape)} on {tembv.device} "
                         f"does not match ({B}, {c_out}) on {x.device}")
    out = []
    for p, shape in zip(params, shapes):
        if p is None:
            out.append(None)
            continue
        if p.device != x.device or tuple(p.shape) != shape:
            raise ValueError(f"{name}: parameter of shape {tuple(p.shape)} on {p.device}, "
                             f"expected {shape} on {x.device}")
        p = p.to(x.dtype)
        if p.dim() == 4:
            p = p.permute(2, 3, 1, 0).reshape(9, shape[1], shape[0])
        p = p.contiguous()
        out.append(p if p.data_ptr() % 16 == 0 else p.clone())
    return B, H, c_in, c_out, tembv.to(x.dtype).contiguous(), out


def _groups_ok(C, groups):
    return 1 <= groups <= MAX_GROUPS and C % groups == 0


def fused_resblock(x, tembv, gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b,
                   conv1_w, conv1_b, nin_w=None, nin_b=None, *, groups0: int,
                   groups1: int, skip_rescale: bool = True):
    """The fused resblock on NCHW ``x`` with the block's ``tembv`` (B, C_out).

    CPU tensors take the plain version.  CUDA tensors launch the kernel; it
    takes float32 or bfloat16, the shapes of ``kernel_takes`` (every block
    of the flagship NCSN++), any batch, at most 32 groups, contiguous x, and
    raises on anything else.
    """
    raw = (gn0_w, gn0_b, conv0_w, conv0_b, gn1_w, gn1_b, conv1_w, conv1_b, nin_w, nin_b)
    kw = dict(groups0=groups0, groups1=groups1, skip_rescale=skip_rescale)
    if x.device.type == "cpu":
        return fused_resblock_reference(x, tembv, *raw, **kw)
    B, H, c_in, c_out, tembv, params = _kernel_args(x, tembv, raw, "fused_resblock")
    if not (_groups_ok(c_in, groups0) and _groups_ok(c_out, groups1)):
        raise ValueError(f"fused_resblock: groups {groups0}, {groups1} do not divide "
                         f"C_in={c_in}, C_out={c_out} or exceed {MAX_GROUPS}")
    out = torch.empty((B, c_out, H, H), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    lib = _build.library("fused_resblock", "rdm_fused_resblock",
                   [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = lib.rdm_fused_resblock(
            x.data_ptr(), tembv.data_ptr(), out.data_ptr(), *(ptr(p) for p in params),
            B, H, c_in, c_out, groups0, groups1, _DTYPE_CODES[x.dtype],
            GN_EPS, _rescale(skip_rescale), torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(lib, err, "fused_resblock")
    fused_resblock.launches += 1
    return out


fused_resblock.launches = 0


def route(H: int, W: int, c_in: int, c_out: int):
    """The fused block's forward for a block shape, chosen once when the
    model is built: ``fused_resblock`` where the kernel takes the shape,
    else ``fused_resblock_reference`` on any device (the TPU kernel computes
    every shape; nothing falls back at launch time)."""
    return fused_resblock if kernel_takes(H, W, c_in, c_out) else fused_resblock_reference


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
