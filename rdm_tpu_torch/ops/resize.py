"""Nearest-neighbour resampling in NCHW.

NCSN++ upsamples by exactly 2x and, in its up path, resizes an 8x8 feature
map to meet a 9x9 skip.  Both follow PyTorch's nearest rule
``src = floor(dst * in / out)``, which is what ``F.interpolate`` with
``mode="nearest"`` computes (the JAX package implements the same rule with
gathers, because the JAX image resize centres half-pixels differently).
"""
from __future__ import annotations

import torch.nn.functional as F


def upsample2x_nearest(x):
    """Exact 2x nearest upsample of an NCHW tensor (each pixel -> 2x2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def nearest_resize(x, size):
    """Resize NCHW ``x`` to spatial ``size=(H, W)`` by the nearest rule."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")
