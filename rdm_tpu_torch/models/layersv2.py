"""EDM-style layers for ADM and VDM, NCHW, with the reference state-dict
names: ``PositionalEmbedding``, ``EDMLinear`` (``weight`` [out, in],
``bias``), ``EDMConv2d`` (``weight`` OIHW, ``bias``, a non-persistent
``resample_filter`` buffer), ``EDMGroupNorm`` and ``attention_op``.

Weights are stored in float32 and computed in the module's ``dtype``: the
product is rounded to it before the bias is added, and GroupNorm takes its
statistics in float32 (``layers.Dense``'s rules).  Initialisation follows
EDM, ``weight_init(mode, fan_in, fan_out) * gain``; a bias takes its own
length as both fans, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import GroupNorm


def edm_init_(tensor: torch.Tensor, mode: str, fan_in: int, fan_out: int, gain: float,
              generator: torch.Generator | None = None) -> None:
    """Fill ``tensor`` with EDM's ``weight_init(mode)`` times ``gain``."""
    with torch.no_grad():
        if mode == "xavier_uniform":
            tensor.uniform_(-1, 1, generator=generator).mul_(math.sqrt(6 / (fan_in + fan_out)))
        elif mode == "xavier_normal":
            tensor.normal_(0, 1, generator=generator).mul_(math.sqrt(2 / (fan_in + fan_out)))
        elif mode == "kaiming_uniform":
            tensor.uniform_(-1, 1, generator=generator).mul_(math.sqrt(3 / fan_in))
        elif mode == "kaiming_normal":
            tensor.normal_(0, 1, generator=generator).mul_(math.sqrt(1 / fan_in))
        else:
            raise ValueError(f'Invalid init mode "{mode}"')
        tensor.mul_(gain)


class PositionalEmbedding(nn.Module):
    """EDM's positional embedding: cos before sin, in float32."""

    def __init__(self, num_channels: int, max_positions: int = 10000, endpoint: bool = False):
        super().__init__()
        self.num_channels, self.max_positions, self.endpoint = num_channels, max_positions, endpoint

    def forward(self, x):
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=x.device)
        freqs = freqs / (half - (1 if self.endpoint else 0))
        freqs = (1 / self.max_positions) ** freqs
        ang = x.float()[:, None] * freqs[None, :]
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


class EDMLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init_mode: str = "kaiming_normal", init_weight: float = 1.0,
                 init_bias: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.init_mode, self.init_weight, self.init_bias = init_mode, init_weight, init_bias
        self.dtype = dtype

    def init_weights_(self, generator=None):
        out_f, in_f = self.weight.shape
        edm_init_(self.weight, self.init_mode, in_f, out_f, self.init_weight, generator)
        if self.bias is not None:
            edm_init_(self.bias, self.init_mode, out_f, out_f, self.init_bias, generator)

    def forward(self, x):
        dt = self.dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y + self.bias.to(dt) if self.bias is not None else y


def _resample_filter(resample_filter) -> torch.Tensor:
    f = np.asarray(resample_filter, np.float32)
    return torch.from_numpy(np.outer(f, f) / f.sum() ** 2)[None, None]


class EDMConv2d(nn.Module):
    """Convolution with EDM's filter resampling before it: the up path is a
    stride-2 transposed depthwise convolution with 4 f (padding
    ``(len(f) - 1) // 2``), the down path a stride-2 depthwise convolution
    with f; a ``kernel`` of 0 resamples only."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, bias: bool = True,
                 up: bool = False, down: bool = False, resample_filter=(1, 1),
                 init_mode: str = "kaiming_normal", init_weight: float = 1.0,
                 init_bias: float = 0.0, dtype=torch.float32):
        super().__init__()
        assert not (up and down)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.up, self.down = up, down
        self.weight = (nn.Parameter(torch.zeros(out_channels, in_channels, kernel, kernel))
                       if kernel else None)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if kernel and bias else None
        self.register_buffer("resample_filter",
                             _resample_filter(resample_filter) if up or down else None,
                             persistent=False)
        self.init_mode, self.init_weight, self.init_bias = init_mode, init_weight, init_bias
        self.dtype = dtype

    def init_weights_(self, generator=None):
        if self.weight is None:
            return
        out_c, in_c, kh, kw = self.weight.shape
        edm_init_(self.weight, self.init_mode, in_c * kh * kw, out_c * kh * kw,
                  self.init_weight, generator)
        if self.bias is not None:
            edm_init_(self.bias, self.init_mode, out_c, out_c, self.init_bias, generator)

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        C = x.shape[1]
        if self.up or self.down:
            f = self.resample_filter.to(dt)
            f_pad = (f.shape[-1] - 1) // 2
            if self.up:
                x = F.conv_transpose2d(x, (f * 4).expand(C, 1, *f.shape[2:]), groups=C,
                                       stride=2, padding=f_pad)
            else:
                x = F.conv2d(x, f.expand(C, 1, *f.shape[2:]), groups=C, stride=2,
                             padding=f_pad)
        if self.weight is not None:
            x = F.conv2d(x, self.weight.to(dt), padding=self.weight.shape[-1] // 2)
            if self.bias is not None:
                x = x + self.bias.to(dt)[None, :, None, None]
        return x


class EDMGroupNorm(GroupNorm):
    """GroupNorm with ``min(num_groups, C // min_channels_per_group)``
    groups, eps 1e-5."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 min_channels_per_group: int = 4, eps: float = 1e-5, dtype=torch.float32):
        super().__init__(min(num_groups, num_channels // min_channels_per_group), num_channels,
                         eps=eps, dtype=dtype)


def attention_op(q, k):
    """softmax over keys of q^T k / sqrt(C) in float32, returned in q's type;
    q, k: [N, C, L] (k is scaled in its own type first, as in EDM)."""
    w = torch.einsum("ncq,nck->nqk", q.float(), (k / math.sqrt(k.shape[1])).float())
    return torch.softmax(w, dim=2).to(q.dtype)
