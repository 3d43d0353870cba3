"""NCSN++ score network in NCHW with the reference state-dict names.

Port of the JAX package's ``models/ncsnpp.py``, keeping its topology:

* the down path pushes one skip per resblock plus one extra per
  resolution, so each resolution has ``num_res_blocks + 1`` up blocks;
* the 9 -> 4 -> 2 path uses pad + stride-2 convs, and the up path resizes
  the upsampled 8x8 feature to meet a 9x9 skip by the nearest rule;
* the input-conv features are pushed as ``hs[0]`` and never consumed;
* the Fourier embedding of log(sigma), the 2nf -> 4nf -> 4nf time MLP and
  the additive label embedding.

GTO config: nf 64, ch_mult (1, 2, 2), 2 res blocks, attention at
resolution 9 (blocks ``down_attn.0-1`` and ``up_attn.6-8``), 9x9x1 input,
swish, skip rescale.  With ``precision: bfloat16`` the parameters stay
float32 and the computation runs in bfloat16, as in the JAX package.
``attn_pallas`` and ``resblock_pallas`` of the model config turn on the
fused attention blocks and the fused resblocks (``attn_kernel``,
``resblock_kernel``).
"""
from __future__ import annotations

import logging
from typing import Sequence

import torch
from torch import nn

from ..ops import resblock as rb_ops
from ..ops.resize import nearest_resize
from . import layers
from .layers import (AttnBlockpp, Conv3x3, Dense, Downsample, GaussianFourierProjection,
                     GroupNorm, NIN, ResnetBlockDDPMpp, Upsample, default_init_, get_act,
                     group_count)
from .registry import register_model

logger = logging.getLogger(__name__)


@register_model(name="ncsnpp")
class NCSNpp(nn.Module):
    def __init__(self, nf: int = 64, ch_mult: Sequence[int] = (1, 2, 2),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (9,),
                 dropout: float = 0.2, resamp_with_conv: bool = True,
                 conditional: bool = True, cond_drop_prob: float = 0.5,
                 num_classes: int = 1,
                 init_scale: float = 0.0, skip_rescale: bool = True,
                 image_size: int = 9, channels: int = 1,
                 scale_by_sigma: bool = False, fourier_scale: float = 16.0,
                 nonlinearity: str = "swish", dtype=torch.float32,
                 attn_kernel: bool = False, resblock_kernel: bool = False):
        super().__init__()
        self.nf = nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.conditional = conditional
        self.cond_drop_prob = cond_drop_prob
        self.num_classes = num_classes
        self.image_size = image_size
        self.channels = channels
        self.scale_by_sigma = scale_by_sigma
        self.dtype = dtype
        self.act = act = get_act(nonlinearity)
        levels = len(self.ch_mult)

        def resblock(in_ch, out_ch, level):
            # The block's nominal resolution and the model's type decide,
            # once, whether a CUDA kernel takes its shape (every block of the
            # flagship, of DDPM++ and of the nf-32 NCSN++ in bfloat16); a
            # block none takes runs the fused block's plain version on any
            # device.
            res = self._resolution(level)
            fused = rb_ops.route(res, res, in_ch, out_ch, dtype)
            if resblock_kernel and fused is not rb_ops.fused_resblock:
                logger.warning("resblock %dx%d, %d -> %d channels, %s: no CUDA kernel takes "
                               "this shape; the block runs the fused block's plain version",
                               res, res, in_ch, out_ch, dtype)
            return ResnetBlockDDPMpp(act, in_ch, out_ch, temb_dim=4 * nf, dropout=dropout,
                                     skip_rescale=skip_rescale, init_scale=init_scale,
                                     use_kernel=resblock_kernel, fused_forward=fused,
                                     dtype=dtype)

        def attnblock(ch, level):
            res = self._resolution(level)
            return AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=init_scale,
                               use_kernel=attn_kernel, dtype=dtype, tokens=res * res)

        # Registration order is the reference's parameters() order, which the
        # EMA shadow list follows.
        self.time_embed = GaussianFourierProjection(embedding_size=nf, scale=fourier_scale)
        self.time_mlp = nn.ModuleList([Dense(2 * nf, 4 * nf, dtype=dtype), nn.Identity(),
                                       Dense(4 * nf, 4 * nf, dtype=dtype)])
        if conditional:
            self.label_emb = Dense(num_classes, 4 * nf, dtype=dtype)
        self.input_conv = Conv3x3(channels, nf, dtype=dtype)

        down_blocks, down_attn, downsample = [], [], []
        hs_ch = [nf]
        in_ch = nf
        for i, mult in enumerate(self.ch_mult):
            for _ in range(num_res_blocks):
                down_blocks.append(resblock(in_ch, nf * mult, i))
                in_ch = nf * mult
                down_attn.append(attnblock(in_ch, i) if self._has_attn(i) else None)
                hs_ch.append(in_ch)
            hs_ch.append(in_ch)
            if i != levels - 1:
                downsample.append(Downsample(in_ch, with_conv=resamp_with_conv, dtype=dtype))
        self.down_blocks = nn.ModuleList(down_blocks)
        self.down_attn = nn.ModuleList(down_attn)
        self.downsample = nn.ModuleList(downsample)

        self.mid_block1 = resblock(in_ch, in_ch, levels - 1)
        if self._has_attn(levels - 1):
            self.mid_attn = attnblock(in_ch, levels - 1)
        self.mid_block2 = resblock(in_ch, in_ch, levels - 1)

        up_blocks, up_attn, upsample = [], [], []
        for i in reversed(range(levels)):
            out_ch = nf * self.ch_mult[i]
            for _ in range(num_res_blocks + 1):
                up_blocks.append(resblock(in_ch + hs_ch.pop(), out_ch, i))
                in_ch = out_ch
                up_attn.append(attnblock(in_ch, i) if self._has_attn(i) else None)
            if i != 0:
                upsample.append(Upsample(in_ch, with_conv=resamp_with_conv, dtype=dtype))
        self.up_blocks = nn.ModuleList(up_blocks)
        self.up_attn = nn.ModuleList(up_attn)
        self.upsample = nn.ModuleList(upsample)
        assert len(hs_ch) == 1

        self.out_norm = GroupNorm(group_count(in_ch), in_ch, dtype=dtype)
        self.out_conv = Conv3x3(in_ch, channels, init_scale=init_scale, dtype=dtype)

    @classmethod
    def from_config(cls, config):
        m = config.model
        d = config.get("data", {})
        image_size = m.get("image_size", d.get("image_size", 9))
        return cls(
            nf=m.nf, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
            attn_resolutions=tuple(m.attn_resolutions), dropout=m.dropout,
            resamp_with_conv=m.resamp_with_conv, conditional=m.conditional,
            cond_drop_prob=m.get("cond_drop_prob", 0.0),
            num_classes=m.get("num_classes", d.get("num_classes", 1)),
            init_scale=m.init_scale, skip_rescale=m.skip_rescale,
            image_size=image_size, channels=m.get("channels", d.get("num_channels", 1)),
            scale_by_sigma=m.get("scale_by_sigma", False),
            fourier_scale=m.fourier_scale, nonlinearity=m.nonlinearity,
            dtype=torch.bfloat16 if m.get("precision") == "bfloat16" else torch.float32,
            attn_kernel=bool(m.get("attn_pallas", False)),
            resblock_kernel=bool(m.get("resblock_pallas", False)),
        )

    def _resolution(self, level: int) -> int:
        """Nominal resolution of a level, as the reference computes it."""
        return self.image_size // (2 ** level)

    def _has_attn(self, level: int) -> bool:
        return self._resolution(level) in self.attn_resolutions

    def init_weights(self, generator: torch.Generator | None = None) -> "NCSNpp":
        """Random weights from ``generator``: DDPM init for convs, dense and
        NIN layers, zero biases, unit GroupNorm scales, N(0, fourier_scale^2)
        Fourier features."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Dense, nn.Conv2d)):
                    fan_in = mod.weight[0].numel()
                    fan_out = mod.weight.shape[0] * mod.weight[0, 0].numel()
                    default_init_(mod.weight, getattr(mod, "init_scale", 1.0),
                                  fan_in, fan_out, generator)
                    mod.bias.zero_()
                elif isinstance(mod, NIN):
                    default_init_(mod.W, mod.init_scale, *mod.W.shape, generator)
                    mod.b.zero_()
                elif isinstance(mod, GroupNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                elif isinstance(mod, GaussianFourierProjection):
                    mod.W.normal_(0.0, mod.scale, generator=generator)
        return self

    def forward(self, x, time_cond, class_labels=None, train: bool = False,
                generator: torch.Generator | None = None):
        """x: [B, C, H, W]; time_cond: [B] noise level (the marginal sigma);
        class_labels: optional [B, num_classes].  ``train`` turns on dropout
        and the classifier-free-guidance label drop, both drawn from
        ``generator`` (the label drop first, then each resblock's mask in
        order)."""
        act = self.act
        if self.conditional and class_labels is None:
            class_labels = torch.zeros(x.shape[0], self.num_classes, dtype=x.dtype,
                                       device=x.device)
        if train and generator is None:
            raise ValueError("training draws dropout and label-drop masks: pass a generator")
        if self.conditional and train and self.cond_drop_prob > 0:
            drop = layers.uniform_draw((x.shape[0], 1), generator, x.device)
            mask = drop < self.cond_drop_prob
            class_labels = class_labels * (1.0 - mask.to(class_labels.dtype))

        temb = self.time_embed(torch.log(time_cond))
        temb = self.time_mlp[0](temb)
        temb = act(temb)
        temb = self.time_mlp[2](temb)
        if self.conditional:
            temb = temb + self.label_emb(class_labels)

        h = self.input_conv(x)
        hs = [h]
        k = 0
        levels = len(self.ch_mult)
        for i in range(levels):
            for _ in range(self.num_res_blocks):
                h = self.down_blocks[k](h, temb, train, generator)
                if self.down_attn[k] is not None:
                    h = self.down_attn[k](h)
                hs.append(h)
                k += 1
            hs.append(h)
            if i != levels - 1:
                h = self.downsample[i](h)

        h = self.mid_block1(h, temb, train, generator)
        if hasattr(self, "mid_attn"):
            h = self.mid_attn(h)
        h = self.mid_block2(h, temb, train, generator)

        k = 0
        for j, i in enumerate(reversed(range(levels))):
            for _ in range(self.num_res_blocks + 1):
                h_skip = hs.pop()
                h = nearest_resize(h, h_skip.shape[2:])
                h = torch.cat([h, h_skip], dim=1)
                h = self.up_blocks[k](h, temb, train, generator)
                if self.up_attn[k] is not None:
                    h = self.up_attn[k](h)
                k += 1
            if i != 0:
                h = self.upsample[j](h)
        # hs[0] (the input-conv features) is never consumed, as in the reference.
        assert len(hs) == 1

        h = act(self.out_norm(h))
        h = self.out_conv(h)
        if self.scale_by_sigma:
            h = h / time_cond.reshape(-1, 1, 1, 1)
        return h
