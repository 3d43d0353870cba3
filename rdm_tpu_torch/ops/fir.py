"""StyleGAN2-style FIR resampling, NCHW.

``upfirdn2d`` is the whole primitive: upsample by zero-stuffing, pad (a
negative pad crops), convolve with the filter, downsample.  Every derived op
uses it, so ``upsample_2d`` and ``downsample_2d`` work; the reference's own
``upfirdn2d`` pads and correlates only, so its up and down helpers raise,
and its fused up path is wrong.  This module keeps the JAX package's
corrected semantics (``rdm_tpu/ops/fir.py``).  Convolution weights are
OIHW.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _setup_kernel(k):
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    assert k.ndim == 2 and k.shape[0] == k.shape[1]
    return k


def upfirdn2d(x, f, up: int = 1, down: int = 1, pad=(0, 0)):
    """x: (N, C, H, W); f: a 2-D filter.  ``pad`` is one int, (p0, p1) for
    both axes, or (px0, px1, py0, py1)."""
    if isinstance(pad, int):
        pad = (pad, pad, pad, pad)
    elif len(pad) == 2:
        pad = (pad[0], pad[1], pad[0], pad[1])
    px0, px1, py0, py1 = pad
    N, C, H, W = x.shape
    f = torch.as_tensor(np.asarray(f), dtype=x.dtype, device=x.device)
    if up > 1:
        x = F.pad(x.reshape(N, C, H, 1, W, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(N, C, H * up, W * up)
    x = F.pad(x, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    if min(px0, px1, py0, py1) < 0:
        x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0),
              max(-px0, 0): x.shape[3] - max(-px1, 0)]
    # correlation with the flipped filter is convolution with the filter
    w = torch.flip(f, (0, 1))[None, None].expand(C, 1, *f.shape)
    return F.conv2d(x, w, stride=down, groups=C)


def upsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
    k = _setup_kernel([1] * factor if k is None else k) * (gain * factor ** 2)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
    k = _setup_kernel([1] * factor if k is None else k) * gain
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def naive_upsample_2d(x, factor: int = 2):
    N, C, H, W = x.shape
    x = x.reshape(N, C, H, 1, W, 1).expand(N, C, H, factor, W, factor)
    return x.reshape(N, C, H * factor, W * factor)


def naive_downsample_2d(x, factor: int = 2):
    N, C, H, W = x.shape
    return x.reshape(N, C, H // factor, factor, W // factor, factor).mean(dim=(3, 5))


def upsample_conv_2d(x, w, k=None, factor: int = 2, gain: float = 1.0):
    """Upsample and convolve in one: a stride-``factor`` transposed
    convolution with ``w`` (OIHW, square), then the FIR filter."""
    assert w.shape[2] == w.shape[3]
    conv_h = w.shape[2]
    k = _setup_kernel([1] * factor if k is None else k) * (gain * factor ** 2)
    p = (k.shape[0] - factor) - (conv_h - 1)
    # the JAX package's input-dilated correlation with w == a transposed
    # convolution with w flipped, in/out swapped
    x = F.conv_transpose2d(x, torch.flip(w, (2, 3)).transpose(0, 1), stride=factor)
    return upfirdn2d(x, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x, w, k=None, factor: int = 2, gain: float = 1.0):
    """The FIR filter, then a stride-``factor`` convolution with ``w`` (OIHW)."""
    conv_h = w.shape[2]
    k = _setup_kernel([1] * factor if k is None else k) * gain
    p = (k.shape[0] - factor) + (conv_h - 1)
    x = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w, stride=factor)
