"""Conditional 1-D U-Net in NCL layout, (B, C, L), with the legacy reference's
state-dict names.

Both variants of the reference share the architecture: a k7 conv stem, per
level [ResnetBlock, ResnetBlock, linear attention, downsample], a bottleneck
ResnetBlock / full attention / ResnetBlock, the mirrored up path with
nearest resizes to odd lengths, the stem's output concatenated before the
last ResnetBlock, RMSNorm pre-norms, (scale + 1, shift) FiLM from the time
and class embeddings, and a mask-value null label for classifier-free
guidance.

* ``legacy=True`` (the GTO_Halo_DM original): SiLU blocks; one SiLU + Linear
  over cat(time, class) gives (scale, shift) for block1 (``mlp.1``); the
  linear attention takes q's softmax over channels (scaled) and k's over
  length, and its output is Conv + RMSNorm (``to_out.0``, ``to_out.1``).
  The reference's state dict loads with ``strict=True``.
* ``legacy=False`` (the RDM registry model): GELU blocks; separate GELU +
  Linear projections of the time and class embeddings (``time_proj``,
  ``class_proj``), summed into (e, e) for block2; q's softmax over length,
  k's over channels, a plain Conv out.

GELU is the tanh approximation throughout.  The nearest resize gathers
rows ``floor(i * L / target)``; the strided downsample is
``Conv1d(k=4, s=2, p=1)`` and the last level's a k3 conv.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .registry import register_model


def gelu(x):
    return F.gelu(x, approximate="tanh")


def nearest_resize_1d(x, target_len: int):
    """Nearest resize of (B, C, L) to ``target_len`` rows ``floor(i * L /
    target_len)``."""
    L = x.shape[-1]
    if L == target_len:
        return x
    idx = torch.arange(target_len, device=x.device) * L // target_len
    return x.index_select(-1, idx)


class RMSNorm1d(nn.Module):
    """``x / max(||x||_C, 1e-12) * g * sqrt(C)``."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1))

    def forward(self, x):
        return F.normalize(x, dim=1) * self.g * math.sqrt(x.shape[1])


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim, self.theta = dim, theta

    def forward(self, t):
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=t.device)
                          * -(math.log(self.theta) / (half - 1)))
        emb = t[:, None] * freqs[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Random (frozen: no gradient reaches ``weights``) or learned Fourier
    features, with ``t`` itself in front."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        self.is_random = is_random
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t):
        w = self.weights.detach() if self.is_random else self.weights
        freqs = t[:, None] * w[None, :] * 2 * math.pi
        return torch.cat([t[:, None], freqs.sin(), freqs.cos()], dim=-1)


class Block1d(nn.Module):
    def __init__(self, dim: int, dim_out: int, groups: int = 8, legacy: bool = False):
        super().__init__()
        self.proj = nn.Conv1d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)
        self.legacy = legacy

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x) if self.legacy else gelu(x)


class ResnetBlock1d(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_dim: int, class_dim: int,
                 groups: int = 8, legacy: bool = False):
        super().__init__()
        self.legacy = legacy
        if legacy:
            self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_dim + class_dim, dim_out * 2))
        else:
            self.time_proj = nn.Linear(time_dim, dim_out)
            self.class_proj = nn.Linear(class_dim, dim_out)
        self.block1 = Block1d(dim, dim_out, groups, legacy)
        self.block2 = Block1d(dim_out, dim_out, groups, legacy)
        self.res_conv = nn.Conv1d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, temb, cemb):
        if self.legacy:
            cond = self.mlp(torch.cat([temb, cemb], dim=-1))[:, :, None]
            h = self.block1(x, cond.chunk(2, dim=1))
            h = self.block2(h)
        else:
            h = self.block1(x)
            e = self.time_proj(gelu(temb))[:, :, None] + self.class_proj(gelu(cemb))[:, :, None]
            h = self.block2(h, (e, e))
        return h + self.res_conv(x)


class LinearAttention1d(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, legacy: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.legacy = heads, dim_head, legacy
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        out = nn.Conv1d(hidden, dim, 1)
        self.to_out = nn.Sequential(out, RMSNorm1d(dim)) if legacy else out

    def forward(self, x):
        B, _, L = x.shape
        q, k, v = (t.reshape(B, self.heads, self.dim_head, L)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        if self.legacy:
            q = q.softmax(dim=-2) * self.dim_head ** -0.5     # over channels
            k = k.softmax(dim=-1)                             # over length
            context = torch.einsum("bhdn,bhen->bhde", k, v)
            out = torch.einsum("bhde,bhdn->bhen", context, q)
        else:
            q = q.softmax(dim=-1)                             # over length
            k = k.softmax(dim=-2)                             # over channels
            context = torch.einsum("bhdk,bhdl->bhkl", k, v)
            out = torch.einsum("bhdk,bhkl->bhdl", q, context)
        return self.to_out(out.reshape(B, -1, L))


class Attention1d(nn.Module):
    """Scaled dot-product attention over the length, float32 softmax."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv1d(hidden, dim, 1)

    def forward(self, x):
        B, _, L = x.shape
        q, k, v = (t.reshape(B, self.heads, self.dim_head, L).transpose(-1, -2)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        sim = torch.einsum("bhid,bhjd->bhij", q * self.dim_head ** -0.5, k)
        attn = sim.float().softmax(dim=-1).to(x.dtype)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        return self.to_out(out.transpose(-1, -2).reshape(B, -1, L))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn, self.norm = fn, RMSNorm1d(dim)

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class _Resize(nn.Module):
    """Nearest resize to a fixed length (holds no weights)."""

    def __init__(self, target_len: Optional[int]):
        super().__init__()
        self.target_len = target_len

    def forward(self, x):
        return nearest_resize_1d(x, self.target_len or x.shape[-1] * 2)


@register_model(name="unet1d")
class UNet1D(nn.Module):
    def __init__(self, dim: int = 64, class_dim: int = 1, seq_length: int = 67, channels: int = 1,
                 dim_mults: Sequence[int] = (1, 2, 4),
                 embed_class_layers_dims: Sequence[int] = (64, 64),
                 cond_drop_prob: float = 0.5, mask_val: float = 0.0,
                 init_dim: Optional[int] = None, out_dim: Optional[int] = None,
                 resnet_block_groups: int = 4, learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False, random_fourier_features: bool = False,
                 learned_sinusoidal_dim: int = 16, sinusoidal_pos_emb_theta: float = 10000.0,
                 attn_dim_head: int = 32, attn_heads: int = 4, self_condition: bool = False,
                 legacy: bool = False):
        super().__init__()
        self.dim, self.class_dim, self.channels = dim, class_dim, channels
        self.seq_length = seq_length
        self.cond_drop_prob, self.mask_val, self.legacy = cond_drop_prob, mask_val, legacy
        self.self_condition = self_condition

        layers, d_in = [], class_dim
        for i, d in enumerate(embed_class_layers_dims):
            layers.append(nn.Linear(d_in, d))
            if i < len(embed_class_layers_dims) - 1:
                layers.append(nn.GELU(approximate="tanh"))
            d_in = d
        self.classes_mlp = nn.Sequential(*layers)
        cemb_dim = embed_class_layers_dims[-1]

        time_dim = dim * 4
        if learned_sinusoidal_cond or random_fourier_features:
            pos = RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim, random_fourier_features)
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            pos = SinusoidalPosEmb(dim, sinusoidal_pos_emb_theta)
            fourier_dim = dim
        self.time_mlp = nn.Sequential(pos, nn.Linear(fourier_dim, time_dim),
                                      nn.GELU(approximate="tanh"), nn.Linear(time_dim, time_dim))

        init_dim = init_dim or dim
        self.init_conv = nn.Conv1d(channels, init_dim, 7, padding=3)
        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        g = resnet_block_groups

        def res(a, b):
            return ResnetBlock1d(a, b, time_dim, cemb_dim, g, legacy)

        def lin_attn(d):
            return Residual(PreNorm(d, LinearAttention1d(d, attn_heads, attn_dim_head, legacy)))

        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            down = (nn.Conv1d(dim_in, dim_out, 3, padding=1) if is_last
                    else nn.Conv1d(dim_in, dim_out, 4, stride=2, padding=1))
            self.downs.append(nn.ModuleList([res(dim_in, dim_in), res(dim_in, dim_in),
                                             lin_attn(dim_in), down]))

        mid = dims[-1]
        self.mid_block1 = res(mid, mid)
        self.mid_attn = Residual(PreNorm(mid, Attention1d(mid, attn_heads, attn_dim_head)))
        self.mid_block2 = res(mid, mid)

        n = len(in_out)
        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            conv = nn.Conv1d(dim_out, dim_in, 3, padding=1)
            if ind == n - 1:
                up = conv
            else:
                target = (int(seq_length / 2) if ind == n - 3 else
                          seq_length if ind == n - 2 else None)
                up = nn.Sequential(_Resize(target), conv)
            self.ups.append(nn.ModuleList([res(dim_out + dim_in, dim_out),
                                           res(dim_out + dim_in, dim_out),
                                           lin_attn(dim_out), up]))

        self.final_res_block = res(dim * 2, dim)
        self.out_dim = out_dim or channels * (2 if learned_variance else 1)
        self.final_conv = nn.Conv1d(dim, self.out_dim, 1)

    @classmethod
    def from_config(cls, config):
        m = config.model
        return cls(
            dim=m.dim, class_dim=m.class_dim, seq_length=m.seq_length,
            channels=m.get("channels", 1), dim_mults=tuple(m.dim_mults),
            embed_class_layers_dims=tuple(m.embed_class_layers_dims),
            cond_drop_prob=m.get("cond_drop_prob", 0.5), mask_val=m.get("mask_val", 0.0),
            resnet_block_groups=m.get("resnet_block_groups", 4),
            learned_variance=m.get("learned_variance", False),
            learned_sinusoidal_cond=m.get("learned_sinusoidal_cond", False),
            random_fourier_features=m.get("random_fourier_features", False),
            learned_sinusoidal_dim=m.get("learned_sinusoidal_dim", 16),
            sinusoidal_pos_emb_theta=m.get("sinusoidal_pos_emb_theta", 10000),
            attn_dim_head=m.get("attn_dim_head", 32), attn_heads=m.get("attn_heads", 4),
            self_condition=m.get("self_condition", False))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "UNet1D":
        """Flax's default initialisation from ``generator``: convolution and
        linear weights lecun-normal (a normal of variance 1 / fan_in,
        truncated at two standard deviations), biases zero, norms one,
        Fourier weights N(0, 1)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv1d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, RMSNorm1d):
                mod.g.fill_(1.0)
            elif isinstance(mod, RandomOrLearnedSinusoidalPosEmb):
                nn.init.normal_(mod.weights, generator=generator)
        return self

    def forward(self, x, time, class_labels=None, *, cond_drop_prob=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x`` (B, C, L) with L = seq_length; ``time`` (B,); ``class_labels``
        (B, class_dim).  Labels are dropped to ``mask_val`` with probability
        ``cond_drop_prob`` (the module's when None): a row keeps its label
        where a uniform draw from ``generator`` is >= the probability."""
        B = x.shape[0]
        if class_labels is None:
            class_labels = torch.zeros((B, self.class_dim), dtype=x.dtype, device=x.device)
        p = self.cond_drop_prob if cond_drop_prob is None else cond_drop_prob
        if p == 0:
            cl = class_labels
        elif p == 1:
            cl = torch.full_like(class_labels, self.mask_val)
        else:
            u = torch.rand((B, 1), generator=generator, device=x.device)
            cl = torch.where(u >= p, class_labels, torch.full_like(class_labels, self.mask_val))

        c = self.classes_mlp(cl)
        temb = self.time_mlp(time)

        x = self.init_conv(x)
        r = x
        hs = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, temb, c)
            hs.append(x)
            x = attn(block2(x, temb, c))
            hs.append(x)
            x = down(x)

        x = self.mid_block2(self.mid_attn(self.mid_block1(x, temb, c)), temb, c)

        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), temb, c)
            x = block2(torch.cat([x, hs.pop()], dim=1), temb, c)
            x = up(attn(x))

        x = self.final_res_block(torch.cat([x, r], dim=1), temb, c)
        return self.final_conv(x)

    def forward_with_cond_scale(self, x, time, class_labels, cond_scale: float = 1.0,
                                rescaled_phi: float = 0.0):
        """Classifier-free guidance: at ``cond_scale`` 1 one conditional
        forward; otherwise one forward over the 2B batch [labels; mask_val],
        ``null + (cond - null) * cond_scale``, blended with its rescale to the
        conditional output's standard deviation by ``rescaled_phi``."""
        if cond_scale == 1.0:
            return self(x, time, class_labels, cond_drop_prob=0.0)
        B = x.shape[0]
        null = torch.full_like(class_labels, self.mask_val)
        out = self(torch.cat([x, x]), torch.cat([time, time]),
                   torch.cat([class_labels, null]), cond_drop_prob=0.0)
        logits, null_logits = out[:B], out[B:]
        scaled = null_logits + (logits - null_logits) * cond_scale
        if rescaled_phi == 0.0:
            return scaled
        dims = tuple(range(1, scaled.dim()))
        std_l = logits.std(dim=dims, correction=0, keepdim=True)
        std_s = scaled.std(dim=dims, correction=0, keepdim=True)
        rescaled = scaled * (std_l / (std_s + 1e-6))
        rescaled = torch.where(torch.isnan(rescaled), scaled, rescaled)
        return rescaled * rescaled_phi + scaled * (1.0 - rescaled_phi)
