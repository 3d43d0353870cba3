"""VDM score network, NCHW, with the reference state-dict names: a U-Net of
constant width and resolution over image Fourier features, EDM-style convs,
a timestep embedding of ``1000 (sigma - sigma_min) / (sigma_max -
sigma_min)`` and optional single-head attention.  Registered as ``vdm``.

The reference keeps its blocks in two lists, ``enc`` and ``dec``; with
attention on they interleave a resblock and an attention block
(``enc.0`` resblock, ``enc.1`` attention, ...).  ``cond_map`` (linear,
silu, linear) and ``out`` (GroupNorm, silu, conv) are sequences.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .adm import init_edm_weights
from .layers import GroupNorm, apply_dropout, dropout_mask, group_count
from .layersv2 import EDMConv2d, EDMLinear, attention_op
from .registry import register_model


def fourier_freqs(start: int = 6, end: int = 8) -> torch.Tensor:
    return torch.tensor([2.0 ** k for k in range(start, end)], dtype=torch.float32) * 2 * math.pi


def image_fourier_features(x, freqs):
    """[x, sin(f x), cos(f x)] over the channels, each channel's frequencies
    next to each other."""
    C = x.shape[1]
    ang = x.repeat_interleave(len(freqs), dim=1) * freqs.repeat(C)[None, :, None, None]
    return torch.cat([x, torch.sin(ang), torch.cos(ang)], dim=1)


def get_timestep_embedding(t, embedding_dim: int):
    """Sinusoidal embedding of ``1000 t``, sin before cos."""
    t = t * 1000.0
    half = embedding_dim // 2
    scale = math.log(10000) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -scale)
    emb = t[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class VDMResNetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cond_dim: int, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = EDMConv2d(in_ch, out_ch, 3, dtype=dtype)
        self.conv2 = EDMConv2d(out_ch, out_ch, 3, init_weight=0.0, dtype=dtype)
        self.norm1 = GroupNorm(group_count(in_ch), in_ch, dtype=dtype)
        self.norm2 = GroupNorm(group_count(out_ch), out_ch, dtype=dtype)
        if in_ch != out_ch:
            self.skip = EDMConv2d(in_ch, out_ch, 1, dtype=dtype)
        self.cond_map = EDMLinear(cond_dim, out_ch, bias=False, init_weight=0.0, dtype=dtype)
        self.dropout = dropout

    def forward(self, x, cond, train: bool = False, generator=None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.cond_map(cond)[:, :, None, None]
        h = F.silu(self.norm2(h))
        if train and self.dropout > 0:
            h = apply_dropout(h, dropout_mask(h.shape, self.dropout, generator, h.device),
                              self.dropout)
        h = self.conv2(h)
        if hasattr(self, "skip"):
            x = self.skip(x)
        return h + x


class VDMAttnBlock(nn.Module):
    """Single-head self-attention; the 3C qkv channels are (channel,
    q/k/v), interleaved per channel."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm(group_count(channels), channels, dtype=dtype)
        self.qkv = EDMConv2d(channels, 3 * channels, 1, dtype=dtype)
        self.proj_out = EDMConv2d(channels, channels, 1, init_weight=0.0, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        q, k, v = self.qkv(self.norm(x)).reshape(B, C, 3, H * W).unbind(2)
        w = attention_op(q, k)
        a = torch.einsum("nqk,nck->ncq", w, v).reshape(B, C, H, W)
        return self.proj_out(a) + x


@register_model(name="vdm")
class VDM(nn.Module):
    def __init__(self, channels: int = 128, num_blocks: int = 32, attention: bool = False,
                 dropout: float = 0.1, num_channels: int = 3, sigma_min: float = 0.01,
                 sigma_max: float = 50.0, scale_by_sigma: bool = True,
                 image_fourier: bool = True, image_fourier_start: int = 6,
                 image_fourier_end: int = 8, dtype=torch.float32):
        super().__init__()
        ch = channels
        self.channels, self.num_blocks, self.attention = channels, num_blocks, attention
        self.sigma_min, self.sigma_max = float(sigma_min), float(sigma_max)
        self.scale_by_sigma, self.image_fourier = scale_by_sigma, image_fourier
        self.dtype = dtype
        self.register_buffer("freqs", fourier_freqs(image_fourier_start, image_fourier_end),
                             persistent=False)
        in_ch = num_channels * (1 + 2 * len(self.freqs)) if image_fourier else num_channels

        self.cond_map = nn.Sequential(EDMLinear(ch, 4 * ch, dtype=dtype), nn.SiLU(),
                                      EDMLinear(4 * ch, 4 * ch, dtype=dtype))
        self.conv_in = EDMConv2d(in_ch, ch, 3, dtype=dtype)

        def blocks(in_width):
            out = [VDMResNetBlock(in_width, ch, 4 * ch, dropout, dtype=dtype)]
            if attention:
                out.append(VDMAttnBlock(ch, dtype=dtype))
            return out

        self.enc = nn.ModuleList([b for _ in range(num_blocks) for b in blocks(ch)])
        self.mid1 = VDMResNetBlock(ch, ch, 4 * ch, dropout, dtype=dtype)
        self.midattn = VDMAttnBlock(ch, dtype=dtype)
        self.mid2 = VDMResNetBlock(ch, ch, 4 * ch, dropout, dtype=dtype)
        self.dec = nn.ModuleList([b for _ in range(num_blocks + 1) for b in blocks(2 * ch)])
        self.out = nn.Sequential(GroupNorm(group_count(ch), ch, dtype=dtype), nn.SiLU(),
                                 EDMConv2d(ch, num_channels, 3, init_weight=0.0, dtype=dtype))

    @classmethod
    def from_config(cls, config):
        m = config.model
        return cls(channels=m.channels, num_blocks=m.num_blocks,
                   attention=m.get("attention", False), dropout=m.dropout,
                   num_channels=config.data.num_channels,
                   sigma_min=config.sde.sigma_min, sigma_max=config.sde.sigma_max,
                   scale_by_sigma=m.get("scale_by_sigma", True),
                   image_fourier=m.get("image_fourier", True),
                   image_fourier_start=m.get("image_fourier_start", 6),
                   image_fourier_end=m.get("image_fourier_end", 8))

    def init_weights(self, generator: torch.Generator | None = None) -> "VDM":
        return init_edm_weights(self, generator)

    def forward(self, x, time_cond, class_labels=None, train: bool = False,
                generator: torch.Generator | None = None):
        """``class_labels`` is ignored (the model is unconditional)."""
        if train and generator is None:
            raise ValueError("training draws dropout masks: pass a generator")
        sigma = time_cond
        t = (sigma - self.sigma_min) / (self.sigma_max - self.sigma_min)
        cond = self.cond_map(get_timestep_embedding(t, self.channels))
        if self.image_fourier:
            x = image_fourier_features(x, self.freqs)
        x = self.conv_in(x)

        step = 2 if self.attention else 1
        outputs = [x]
        for i in range(0, len(self.enc), step):
            x = self.enc[i](x, cond, train, generator)
            if self.attention:
                x = self.enc[i + 1](x)
            outputs.append(x)
        x = self.mid1(x, cond, train, generator)
        x = self.midattn(x)
        x = self.mid2(x, cond, train, generator)
        for i in range(0, len(self.dec), step):
            x = torch.cat([x, outputs.pop()], dim=1)
            x = self.dec[i](x, cond, train, generator)
            if self.attention:
                x = self.dec[i + 1](x)
        assert not outputs
        out = self.out(x)
        if self.scale_by_sigma:
            out = out / sigma[:, None, None, None]
        return out
