"""NCSNv1/v2-era refinement blocks and the DDPM-era residual block, in
NCHW: the rest of the layer zoo.  No model of either package calls them.

* ``get_timestep_embedding``: the sinusoidal timestep embedding;
* ``CRPBlock`` (chained residual pooling: 5x5 stride-1 max or average
  pools, the average counting the zero padding), ``RCUBlock`` (residual
  conv units), ``MSFBlock`` (multi-scale fusion: a 3x3 conv of each input,
  bilinearly resized with antialiasing to a common shape, summed) and
  ``RefineBlock`` (RefineNet);
* ``DDPMResnetBlock``: GroupNorm (min(32, C) groups, eps 1e-6), act, 3x3
  conv, the time embedding's projection, GroupNorm, act, dropout, 3x3 conv,
  and a 3x3 conv or a per-pixel linear shortcut when the width changes.

The DDPM-era up- and downsampling are ``layers.Upsample`` and
``layers.Downsample``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import apply_dropout, dropout_mask


def get_timestep_embedding(timesteps, embedding_dim: int, max_positions: int = 10000):
    """(B,) timesteps -> (B, embedding_dim) sin/cos features (zero-padded
    when the dimension is odd)."""
    half = embedding_dim // 2
    emb = math.log(max_positions) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    emb = torch.cat([emb.sin(), emb.cos()], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _conv3x3(in_ch: int, out_ch: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=bias)


def _pool5(x, maxpool: bool):
    if maxpool:
        return F.max_pool2d(x, 5, stride=1, padding=2)
    return F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)


class CRPBlock(nn.Module):
    def __init__(self, features: int, n_stages: int, act: Callable = F.relu,
                 maxpool: bool = True):
        super().__init__()
        self.convs = nn.ModuleList([_conv3x3(features, features, bias=False)
                                    for _ in range(n_stages)])
        self.act, self.maxpool = act, maxpool

    def forward(self, x):
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(_pool5(path, self.maxpool))
            x = path + x
        return x


class RCUBlock(nn.Module):
    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable = F.relu):
        super().__init__()
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act
        for i in range(n_blocks):
            for j in range(n_stages):
                setattr(self, f"{i + 1}_{j + 1}_conv", _conv3x3(features, features, bias=False))

    def forward(self, x):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.convs = nn.ModuleList([_conv3x3(c, features) for c in in_planes])

    def forward(self, xs, shape):
        total = 0.0
        for conv, x in zip(self.convs, xs):
            h = F.interpolate(conv(x), size=tuple(shape), mode="bilinear",
                              align_corners=False, antialias=True)
            total = total + h
        return total


class RefineBlock(nn.Module):
    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu,
                 start: bool = False, end: bool = False, maxpool: bool = True):
        super().__init__()
        self.adapt_convs = nn.ModuleList([RCUBlock(c, 2, 2, act) for c in in_planes])
        self.msf = MSFBlock(in_planes, features) if len(in_planes) > 1 else None
        self.crp = CRPBlock(features, 2, act, maxpool)
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act)

    def forward(self, xs, output_shape):
        hs = [adapt(x) for adapt, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, output_shape) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h))


class DDPMResnetBlock(nn.Module):
    def __init__(self, act: Callable, in_ch: int, out_ch: int, temb_dim: Optional[int] = None,
                 conv_shortcut: bool = False, dropout: float = 0.1):
        super().__init__()
        self.act, self.dropout = act, dropout
        self.norm1 = nn.GroupNorm(min(32, in_ch), in_ch, eps=1e-6)
        self.conv1 = _conv3x3(in_ch, out_ch)
        self.temb_proj = nn.Linear(temb_dim, out_ch) if temb_dim is not None else None
        self.norm2 = nn.GroupNorm(min(32, out_ch), out_ch, eps=1e-6)
        self.conv2 = _conv3x3(out_ch, out_ch)
        if in_ch != out_ch:
            if conv_shortcut:
                self.shortcut = _conv3x3(in_ch, out_ch)
            else:
                self.nin_shortcut = nn.Linear(in_ch, out_ch)
        self.in_ch, self.out_ch, self.conv_shortcut = in_ch, out_ch, conv_shortcut

    def forward(self, x, temb=None, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train`` drops with ``dropout`` (masks from ``generator``)."""
        h = self.conv1(self.act(self.norm1(x)))
        if temb is not None:
            h = h + self.temb_proj(self.act(temb))[:, :, None, None]
        h = self.act(self.norm2(h))
        if train and self.dropout > 0:
            h = apply_dropout(h, dropout_mask(h.shape, self.dropout, generator, h.device),
                              self.dropout)
        h = self.conv2(h)
        if self.in_ch != self.out_ch:
            if self.conv_shortcut:
                x = self.shortcut(x)
            else:
                x = self.nin_shortcut(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + h
