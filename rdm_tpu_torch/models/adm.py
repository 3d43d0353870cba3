"""ADM (EDM's variant of the Dhariwal-Nichol U-Net), NCHW, with the
reference state-dict names (``map_layer0``, ``enc.16x16_block0.conv0``,
...).  Used by the ImageNet64C config (``configs/model/adm.yaml``) and
registered as ``adm`` through ``WrappedADM``, which one-hot encodes integer
labels, feeds ``log(sigma / 2)`` as the noise label, runs the backbone in
bfloat16 by default (the reference runs float16) and divides by sigma when
``scale_by_sigma``.

Randomness in training (the label dropout, then each block's dropout mask
in order) comes from the ``torch.Generator`` passed to ``forward``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import apply_dropout, dropout_mask, uniform_draw
from .layersv2 import (EDMConv2d, EDMGroupNorm, EDMLinear, PositionalEmbedding,
                       attention_op)
from .registry import register_model

_INIT = dict(init_mode="kaiming_uniform", init_weight=(1 / 3) ** 0.5, init_bias=(1 / 3) ** 0.5)
_INIT_ZERO = dict(init_mode="kaiming_uniform", init_weight=0.0, init_bias=0.0)


def init_edm_weights(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """EDM initialisation of every ``EDMLinear``/``EDMConv2d`` in ``module``
    from ``generator``, unit GroupNorm scales and zero shifts."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (EDMLinear, EDMConv2d)):
                mod.init_weights_(generator)
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return module


class UNetBlock(nn.Module):
    """GN -> silu -> conv (with resampling) -> adaptive scale/shift from the
    embedding -> GN -> silu -> dropout -> zero-init conv, plus the skip
    (resampled and 1x1-convolved where needed); then optional multi-head
    self-attention of 64 channels a head."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 channels_per_head: int = 64, dropout: float = 0.0, skip_scale: float = 1.0,
                 eps: float = 1e-5, adaptive_scale: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_heads = out_channels // channels_per_head if attention else 0
        self.norm0 = EDMGroupNorm(in_channels, eps=eps, dtype=dtype)
        self.conv0 = EDMConv2d(in_channels, out_channels, 3, up=up, down=down, dtype=dtype,
                               **_INIT)
        self.affine = EDMLinear(emb_channels, out_channels * (2 if adaptive_scale else 1),
                                dtype=dtype, **_INIT)
        self.norm1 = EDMGroupNorm(out_channels, eps=eps, dtype=dtype)
        self.conv1 = EDMConv2d(out_channels, out_channels, 3, dtype=dtype, **_INIT_ZERO)
        if out_channels != in_channels or up or down:
            kernel = 1 if out_channels != in_channels else 0
            self.skip = EDMConv2d(in_channels, out_channels, kernel, up=up, down=down,
                                  dtype=dtype, **_INIT)
        if self.num_heads:
            self.norm2 = EDMGroupNorm(out_channels, eps=eps, dtype=dtype)
            self.qkv = EDMConv2d(out_channels, out_channels * 3, 1, dtype=dtype, **_INIT)
            self.proj = EDMConv2d(out_channels, out_channels, 1, dtype=dtype, **_INIT_ZERO)
        self.dropout = dropout
        self.skip_scale = skip_scale
        self.adaptive_scale = adaptive_scale
        self.dtype = dtype

    def forward(self, x, emb, train: bool = False, generator=None):
        orig = x
        h = self.conv0(F.silu(self.norm0(x)))
        params = self.affine(emb)[:, :, None, None].to(h.dtype)
        if self.adaptive_scale:
            scale, shift = params.chunk(2, dim=1)
            h = F.silu(shift + self.norm1(h) * (scale + 1))
        else:
            h = F.silu(self.norm1(h + params))
        if train and self.dropout > 0:
            h = apply_dropout(h, dropout_mask(h.shape, self.dropout, generator, h.device),
                              self.dropout)
        h = self.conv1(h)
        if hasattr(self, "skip"):
            orig = self.skip(orig)
        x = (h + orig.to(h.dtype)) * self.skip_scale

        if self.num_heads:
            B, C, H, W = x.shape
            # The 3C channels are (head, channel of the head, q/k/v): q, k
            # and v interleave per channel.
            qkv = self.qkv(self.norm2(x)).reshape(B * self.num_heads, C // self.num_heads, 3,
                                                  H * W)
            q, k, v = qkv.unbind(2)
            w = attention_op(q, k)
            a = torch.einsum("nqk,nck->ncq", w, v).reshape(B, C, H, W)
            x = (self.proj(a) + x) * self.skip_scale
        return x


class ADM(nn.Module):
    """The U-Net: positional noise embedding, a two-layer map, an optional
    label map; an encoder of ``num_blocks`` blocks a resolution (a
    downsampling block between), a decoder of ``num_blocks + 1`` blocks a
    resolution taking the encoder's skips; GN -> silu -> zero-init conv
    out."""

    def __init__(self, img_resolution: int = 64, in_channels: int = 3, out_channels: int = 3,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 192,
                 channel_mult: Sequence[int] = (1, 2, 3, 4), channel_mult_emb: int = 4,
                 num_blocks: int = 3, attn_resolutions: Sequence[int] = (32, 16, 8),
                 dropout: float = 0.10, label_dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        emb_ch = model_channels * channel_mult_emb
        block_kw = dict(emb_channels=emb_ch, channels_per_head=64, dropout=dropout, dtype=dtype)
        self.label_dim, self.label_dropout = label_dim, label_dropout
        self.dtype = dtype

        self.map_noise = PositionalEmbedding(model_channels)
        if augment_dim:
            self.map_augment = EDMLinear(augment_dim, model_channels, bias=False, **_INIT_ZERO)
        self.map_layer0 = EDMLinear(model_channels, emb_ch, **_INIT)
        self.map_layer1 = EDMLinear(emb_ch, emb_ch, **_INIT)
        if label_dim:
            self.map_label = EDMLinear(label_dim, emb_ch, bias=False, init_mode="kaiming_normal",
                                       init_weight=label_dim ** 0.5)

        self.enc = nn.ModuleDict()
        cout = in_channels
        caux = [model_channels * channel_mult[0]]   # skip widths, for the decoder
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_conv"] = EDMConv2d(cin, cout, 3, dtype=dtype, **_INIT)
            else:
                self.enc[f"{res}x{res}_down"] = UNetBlock(cout, cout, down=True, **block_kw)
                caux.append(cout)
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block_kw)
                caux.append(cout)

        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = UNetBlock(cout, cout, attention=True, **block_kw)
                self.dec[f"{res}x{res}_in1"] = UNetBlock(cout, cout, **block_kw)
            else:
                self.dec[f"{res}x{res}_up"] = UNetBlock(cout, cout, up=True, **block_kw)
            for idx in range(num_blocks + 1):
                cin, cout = cout + caux.pop(), model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=(res in attn_resolutions), **block_kw)
        assert not caux
        self.out_norm = EDMGroupNorm(cout, dtype=dtype)
        self.out_conv = EDMConv2d(cout, out_channels, 3, dtype=dtype, **_INIT_ZERO)

    def forward(self, x, noise_labels, class_labels, augment_labels=None, train: bool = False,
                generator=None):
        emb = self.map_noise(noise_labels)
        if hasattr(self, "map_augment") and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels)
        emb = F.silu(self.map_layer0(emb))
        emb = self.map_layer1(emb)
        if self.label_dim:
            tmp = class_labels
            if train and self.label_dropout:
                keep = uniform_draw((x.shape[0], 1), generator, x.device) >= self.label_dropout
                tmp = tmp * keep.to(tmp.dtype)
            emb = emb + self.map_label(tmp)
        emb = F.silu(emb)

        skips = []
        for name, block in self.enc.items():
            x = block(x) if name.endswith("_conv") else block(x, emb, train, generator)
            skips.append(x)
        for name, block in self.dec.items():
            if "_block" in name:
                x = torch.cat([x, skips.pop()], dim=1)
            x = block(x, emb, train, generator)
        assert not skips
        return self.out_conv(F.silu(self.out_norm(x)))


@register_model(name="adm")
class WrappedADM(nn.Module):
    """``ADM`` as a score network ``(x, sigma, class_labels)``: labels as
    integers [B] or [B, 1] are one-hot encoded, [B, num_classes] taken as
    they are, None is the all-zero (unconditional) label; the noise label
    is ``log(sigma / 2)``; the output is float32, divided by sigma when
    ``scale_by_sigma``."""

    def __init__(self, img_resolution: int = 64, num_channels: int = 3, num_classes: int = 1000,
                 model_channels: int = 192, channel_mult: Sequence[int] = (1, 2, 3, 4),
                 channel_mult_emb: int = 4, num_blocks: int = 3,
                 attn_resolutions: Sequence[int] = (32, 16, 8), dropout: float = 0.1,
                 label_dropout: float = 0.0, scale_by_sigma: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.scale_by_sigma = scale_by_sigma
        self.dtype = dtype
        self.model = ADM(img_resolution=img_resolution, in_channels=num_channels,
                         out_channels=num_channels, label_dim=num_classes,
                         model_channels=model_channels, channel_mult=channel_mult,
                         channel_mult_emb=channel_mult_emb, num_blocks=num_blocks,
                         attn_resolutions=attn_resolutions, dropout=dropout,
                         label_dropout=label_dropout, dtype=dtype)

    @classmethod
    def from_config(cls, config):
        m = config.model
        return cls(img_resolution=config.data.image_size,
                   num_channels=config.data.num_channels,
                   num_classes=config.data.get("num_classes", 0),
                   model_channels=m.model_channels, channel_mult=tuple(m.channel_mult),
                   channel_mult_emb=m.channel_mult_emb, num_blocks=m.num_blocks,
                   attn_resolutions=tuple(m.attn_resolutions), dropout=m.dropout,
                   label_dropout=config.get("training", {}).get("drop_label", 0.0),
                   scale_by_sigma=m.get("scale_by_sigma", True))

    def init_weights(self, generator: torch.Generator | None = None) -> "WrappedADM":
        return init_edm_weights(self, generator)

    def forward(self, x, time_cond, class_labels=None, train: bool = False,
                generator: torch.Generator | None = None):
        if train and generator is None:
            raise ValueError("training draws dropout and label-drop masks: pass a generator")
        sigma = time_cond
        B = x.shape[0]
        if class_labels is None:
            onehot = torch.zeros(B, self.num_classes, dtype=x.dtype, device=x.device)
        elif class_labels.dim() == 1 or class_labels.shape[-1] == 1:
            onehot = F.one_hot(class_labels.reshape(B).long(), self.num_classes).to(x.dtype)
        else:
            onehot = class_labels
        fx = self.model(x.to(self.dtype), torch.log(sigma / 2.0), onehot, train=train,
                        generator=generator).float()
        if self.scale_by_sigma:
            fx = fx / sigma[:, None, None, None]
        return fx
