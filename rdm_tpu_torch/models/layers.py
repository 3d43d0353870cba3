"""NCSN++ building blocks in NCHW with the reference state-dict names.

Each module carries a compute ``dtype`` with the JAX package's semantics:
parameters are stored in float32 and cast to ``dtype`` for the
computation, so a bfloat16 model computes in bfloat16 with float32 master
weights.  GroupNorm takes its statistics and normalises in float32 and
rounds its output to ``dtype``.  GroupNorm uses ``min(C // 4, 32)`` groups
and eps 1e-6 throughout.
"""
from __future__ import annotations

import logging
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import SUPPORTED_CHANNELS, FusedAttnBlockFn, round_to
from ..ops.resblock import FusedResblockFn, fused_resblock
from ..ops.resize import upsample2x_nearest

logger = logging.getLogger(__name__)


def get_act(name: str):
    """Activation by config name."""
    name = name.lower()
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError(f"activation {name} does not exist")


def group_count(channels: int) -> int:
    return min(channels // 4, 32)


def default_init_(weight: torch.Tensor, scale: float, fan_in: int, fan_out: int,
                  generator: torch.Generator | None = None) -> None:
    """DDPM initializer: variance_scaling(scale, fan_avg, uniform), with
    scale 0 mapped to 1e-10."""
    scale = 1e-10 if scale == 0 else scale
    bound = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def uniform_draw(shape, generator: torch.Generator, device=None):
    """U(0, 1) of ``shape`` from ``generator``: the one draw behind every mask
    of the training forward (the label drop, then each dropout mask), whose
    leading axis is the batch."""
    return torch.rand(shape, generator=generator, device=device)


def dropout_mask(shape, rate: float, generator: torch.Generator, device=None):
    """Keep mask of ``shape``: True with probability ``1 - rate``, drawn
    from ``generator``."""
    return uniform_draw(shape, generator, device) < 1.0 - rate


def apply_dropout(h, mask, rate: float):
    """Flax's dropout on a given mask: ``where(mask, h / keep, 0)``, where the
    keep probability enters the division in ``h``'s type, as a weakly typed
    scalar does in the JAX package (in bfloat16, 0.8 becomes 0.80078125).
    ``F.dropout`` multiplies by the float reciprocal instead, which rounds
    differently."""
    return torch.where(mask, h / round_to(1.0 - rate, h.dtype), torch.zeros_like(h))


class Dense(nn.Linear):
    """``nn.Linear`` computed in ``dtype``.  The product is rounded to
    ``dtype`` before the bias is added, as in the JAX package; a fused bias
    would be added before that rounding."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computed in ``dtype``, the bias added after the
    product is rounded (see ``Dense``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, init_scale: float = 1.0, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding)
        self.dtype = dtype
        self.init_scale = init_scale

    def forward(self, x):
        dt = self.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), stride=self.stride, padding=self.padding)
        return y + self.bias.to(dt)[None, :, None, None]


def Conv3x3(in_ch: int, out_ch: int, init_scale: float = 1.0, stride: int = 1,
            padding: int = 1, dtype=torch.float32) -> Conv2d:
    """3x3 convolution; padding 1 is SAME at stride 1."""
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=padding,
                  init_scale=init_scale, dtype=dtype)


class NIN(nn.Module):
    """Channel-wise dense layer (1x1 'network in network') with weights
    ``W`` of shape (C_in, C_out) and bias ``b``."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))
        self.init_scale = init_scale
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        y = torch.einsum("bchw,cd->bdhw", x.to(dt), self.W.to(dt))
        return y + self.b.to(dt)[None, :, None, None]


class GroupNorm(nn.GroupNorm):
    """GroupNorm normalised in float32, output rounded to ``dtype``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight,
                            self.bias, self.eps).to(self.dtype)


class GaussianFourierProjection(nn.Module):
    """sin/cos(2 pi W x) time embedding with a fixed W ~ N(0, scale^2)."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.W = nn.Parameter(torch.randn(embedding_size) * scale, requires_grad=False)
        self.scale = scale

    def forward(self, x):
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class AttnBlockpp(nn.Module):
    """Self-attention over all H*W positions (81 tokens on the 9x9 GTO
    images), through ``ops.attention.FusedAttnBlockFn`` with the float32
    master weights.  With ``use_kernel`` both directions launch the CUDA
    kernels for a CUDA tensor (float32 or bfloat16) and run the plain
    versions for a CPU tensor; otherwise they run the plain versions.  (The JAX package
    takes its TPU kernel only under bfloat16, because float32 tiles trip a
    Mosaic layout check there; that is a limit of the TPU compiler, not part
    of what the block computes, so the CUDA kernel serves both types.)
    The kernels take the widths of ``ops.attention.SUPPORTED_CHANNELS``; a
    block of another width is routed to the plain versions here, once, with
    a log line, as the JAX package routes by type."""

    def __init__(self, channels: int, skip_rescale: bool = False, init_scale: float = 0.0,
                 use_kernel: bool = False, dtype=torch.float32):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(group_count(channels), channels, dtype=dtype)
        self.NIN_0 = NIN(channels, channels, dtype=dtype)
        self.NIN_1 = NIN(channels, channels, dtype=dtype)
        self.NIN_2 = NIN(channels, channels, dtype=dtype)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale, dtype=dtype)
        self.skip_rescale = skip_rescale
        if use_kernel and channels not in SUPPORTED_CHANNELS:
            logger.warning("attention block of width %d: the CUDA kernels take widths %s; "
                           "this block runs the plain versions", channels, SUPPORTED_CHANNELS)
            use_kernel = False
        self.use_kernel = use_kernel
        self.dtype = dtype

    def forward(self, x):
        return FusedAttnBlockFn.apply(
            x.to(self.dtype).contiguous(),
            self.GroupNorm_0.weight, self.GroupNorm_0.bias,
            self.NIN_0.W, self.NIN_0.b, self.NIN_1.W, self.NIN_1.b,
            self.NIN_2.W, self.NIN_2.b, self.NIN_3.W, self.NIN_3.b,
            self.GroupNorm_0.num_groups, self.skip_rescale, self.use_kernel)


class ResnetBlockDDPMpp(nn.Module):
    """GN -> act -> conv3x3 -> + time -> GN -> act -> dropout -> conv3x3
    (zero-init), with a NIN shortcut when the width changes and the
    1/sqrt(2) skip rescale.

    With ``use_kernel`` the block goes through ``ops.resblock.FusedResblockFn``
    where the JAX package takes its TPU kernel: bfloat16, no active dropout,
    and a time embedding.  Like the TPU kernel, the fused block applies SiLU
    whatever ``act`` is, and rounds at the kernel's points, which differ
    from this module's.  ``fused_forward`` is the fused block's forward
    (``NCSNpp`` takes it from ``ops.resblock.route`` when it builds the
    block): ``fused_resblock``, which launches the kernel for a CUDA tensor
    and runs its plain version for a CPU tensor, or, for a shape the kernel
    does not take, ``fused_resblock_reference`` on any device, as the JAX
    package's kernel computes every shape.  The parameters and their names
    are the same either way."""

    def __init__(self, act, in_ch: int, out_ch: int, temb_dim: int | None = None,
                 dropout: float = 0.1, skip_rescale: bool = False,
                 init_scale: float = 0.0, use_kernel: bool = False,
                 fused_forward=fused_resblock, dtype=torch.float32):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(group_count(in_ch), in_ch, dtype=dtype)
        self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(group_count(out_ch), out_ch, dtype=dtype)
        self.Conv_1 = Conv3x3(out_ch, out_ch, init_scale=init_scale, dtype=dtype)
        if in_ch != out_ch:
            self.NIN_0 = NIN(in_ch, out_ch, dtype=dtype)
        self.act = act
        self.dropout = dropout
        self.skip_rescale = skip_rescale
        self.use_kernel = use_kernel
        self.fused_forward = fused_forward
        self.dtype = dtype

    def forward(self, x, temb=None, train: bool = False, generator=None):
        """With ``train`` and a dropout rate above 0, the dropout mask is
        drawn from ``generator``."""
        if (self.use_kernel and self.dtype == torch.bfloat16
                and not (train and self.dropout > 0) and temb is not None):
            nin = (self.NIN_0.W, self.NIN_0.b) if hasattr(self, "NIN_0") else (None, None)
            return FusedResblockFn.apply(
                x.to(self.dtype).contiguous(), self.Dense_0(self.act(temb)),
                self.GroupNorm_0.weight, self.GroupNorm_0.bias,
                self.Conv_0.weight, self.Conv_0.bias,
                self.GroupNorm_1.weight, self.GroupNorm_1.bias,
                self.Conv_1.weight, self.Conv_1.bias, *nin,
                self.GroupNorm_0.num_groups, self.GroupNorm_1.num_groups, self.skip_rescale,
                self.fused_forward)
        h = self.act(self.GroupNorm_0(x))
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.act(self.GroupNorm_1(h))
        if train and self.dropout > 0:
            h = apply_dropout(h, dropout_mask(h.shape, self.dropout, generator, h.device),
                              self.dropout)
        h = self.Conv_1(h)
        if hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        out = x.to(self.dtype) + h
        return out / round_to(math.sqrt(2.0), self.dtype) if self.skip_rescale else out


class Upsample(nn.Module):
    """Nearest 2x upsample, then an optional 3x3 conv."""

    def __init__(self, channels: int, with_conv: bool = False, dtype=torch.float32):
        super().__init__()
        if with_conv:
            self.Conv_0 = Conv3x3(channels, channels, dtype=dtype)
        self.with_conv = with_conv

    def forward(self, x):
        h = upsample2x_nearest(x)
        return self.Conv_0(h) if self.with_conv else h


class Downsample(nn.Module):
    """Pad right/bottom by one, then a stride-2 VALID 3x3 conv; or a 2x2
    average pool."""

    def __init__(self, channels: int, with_conv: bool = False, dtype=torch.float32):
        super().__init__()
        if with_conv:
            self.Conv_0 = Conv3x3(channels, channels, stride=2, padding=0, dtype=dtype)
        self.with_conv = with_conv

    def forward(self, x):
        if self.with_conv:
            return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, stride=2)
