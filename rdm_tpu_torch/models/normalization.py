"""The normalization zoo of the older model families, NCHW, and
``get_normalization(config, conditional)``.

The live models use plain GroupNorm; the registry is part of the API of
the NCSN-era families.  Statistics are per sample and channel over H, W
(the batch too for batch norm), variances biased, eps 1e-5, as in the JAX
package.  State-dict names are the reference's: ``weight``/``bias`` of an
affine instance norm, ``alpha``/``gamma``/``beta`` scales stored as the
scales themselves (initialised N(1, 0.02); the JAX package stores ``alpha
- 1`` and ``gamma - 1``), ``embed.weight`` for the per-class tables.

A conditional norm takes integer class labels ``y`` [B].  Its table is
initialised as the reference's code does: the scale columns U[0, 1) (the
variance norm N(1, 0.02)), the bias columns zero.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import GroupNorm

_EPS = 1e-5


def _moments(x, dims=(2, 3)):
    return x.mean(dim=dims, keepdim=True), x.var(dim=dims, unbiased=False, keepdim=True)


def _instance_normalise(x, eps):
    mean, var = _moments(x)
    return (x - mean) / torch.sqrt(var + eps)


def _channel_mean_norm(x, eps):
    """The per-channel means of each sample, standardised over the channels
    (the ``++`` term): [B, C]."""
    means = x.mean(dim=(2, 3))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, unbiased=False, keepdim=True)
    return (means - m) / torch.sqrt(v + eps)


def get_normalization(config, conditional: bool = False):
    """A constructor ``norm(num_features, **kw)`` for
    ``config.model.normalization``."""
    norm = config.model.normalization
    if conditional:
        if norm == "InstanceNorm++":
            return lambda num_features, **kw: ConditionalInstanceNorm2dPlus(
                num_features, config.model.num_classes, **kw)
        raise NotImplementedError(f"{norm} not implemented yet.")
    if norm == "InstanceNorm":
        return InstanceNorm2d
    if norm == "InstanceNorm++":
        return InstanceNorm2dPlus
    if norm == "VarianceNorm":
        return VarianceNorm2d
    if norm == "GroupNorm":
        return lambda num_features, num_groups=32, **kw: GroupNorm(num_groups, num_features)
    raise ValueError("Unknown normalization: %s" % norm)


class InstanceNorm2d(nn.Module):
    def __init__(self, num_features: int, affine: bool = True, eps: float = _EPS):
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        self.affine, self.eps = affine, eps

    def forward(self, x):
        h = _instance_normalise(x, self.eps)
        if self.affine:
            h = h * self.weight[:, None, None] + self.bias[:, None, None]
        return h


class VarianceNorm2d(nn.Module):
    """Divide by the per-channel standard deviation, scale by ``alpha``."""

    def __init__(self, num_features: int, bias: bool = False, eps: float = _EPS):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features).normal_(1.0, 0.02))
        if bias:
            self.beta = nn.Parameter(torch.zeros(num_features))
        self.bias, self.eps = bias, eps

    def forward(self, x):
        _, var = _moments(x)
        out = x / torch.sqrt(var + self.eps) * self.alpha[:, None, None]
        if self.bias:
            out = out + self.beta[:, None, None]
        return out


class InstanceNorm2dPlus(nn.Module):
    """Instance norm plus the standardised channel means scaled by
    ``alpha``: ``gamma h + alpha means_norm (+ beta)``."""

    def __init__(self, num_features: int, bias: bool = True, eps: float = _EPS):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features).normal_(1.0, 0.02))
        self.gamma = nn.Parameter(torch.empty(num_features).normal_(1.0, 0.02))
        if bias:
            self.beta = nn.Parameter(torch.zeros(num_features))
        self.bias, self.eps = bias, eps

    def forward(self, x):
        means_norm = _channel_mean_norm(x, self.eps)
        h = _instance_normalise(x, self.eps)
        out = (self.gamma[:, None, None] * h
               + means_norm[:, :, None, None] * self.alpha[:, None, None])
        if self.bias:
            out = out + self.beta[:, None, None]
        return out


class _CondAffine(nn.Module):
    """The per-class (gamma[, beta]) table of a conditional norm."""

    def __init__(self, num_features: int, num_classes: int, bias: bool):
        super().__init__()
        self.embed = nn.Embedding(num_classes, num_features * (2 if bias else 1))
        with torch.no_grad():
            self.embed.weight[:, :num_features].uniform_()
            self.embed.weight[:, num_features:].zero_()
        self.num_features, self.bias = num_features, bias

    def affine(self, h, y):
        emb = self.embed(y.long())
        C = self.num_features
        out = emb[:, :C, None, None] * h
        if self.bias:
            out = out + emb[:, C:, None, None]
        return out


class ConditionalBatchNorm2d(_CondAffine):
    """Batch norm without its own affine (the JAX package's semantics: batch
    statistics in training, with biased variances kept as running averages
    of momentum 0.99; the running averages otherwise), then the class's
    affine."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True,
                 eps: float = _EPS):
        super().__init__(num_features, num_classes, bias)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.eps = eps

    def forward(self, x, y):
        if self.training:
            mean, var = _moments(x, dims=(0, 2, 3))
            with torch.no_grad():
                m = 0.99
                self.running_mean.mul_(m).add_((1 - m) * mean.flatten())
                self.running_var.mul_(m).add_((1 - m) * var.flatten())
        else:
            mean = self.running_mean[None, :, None, None]
            var = self.running_var[None, :, None, None]
        return self.affine((x - mean) / torch.sqrt(var + self.eps), y)


class ConditionalInstanceNorm2d(_CondAffine):
    def __init__(self, num_features: int, num_classes: int, bias: bool = True,
                 eps: float = _EPS):
        super().__init__(num_features, num_classes, bias)
        self.eps = eps

    def forward(self, x, y):
        return self.affine(_instance_normalise(x, self.eps), y)


class ConditionalVarianceNorm2d(nn.Module):
    def __init__(self, num_features: int, num_classes: int, bias: bool = False,
                 eps: float = _EPS):
        super().__init__()
        self.embed = nn.Embedding(num_classes, num_features)
        with torch.no_grad():
            self.embed.weight.normal_(1.0, 0.02)
        self.eps = eps

    def forward(self, x, y):
        _, var = _moments(x)
        return self.embed(y.long())[:, :, None, None] * (x / torch.sqrt(var + self.eps))


class ConditionalNoneNorm2d(_CondAffine):
    """No normalisation, only the class's affine."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True):
        super().__init__(num_features, num_classes, bias)

    def forward(self, x, y):
        return self.affine(x, y)


class NoneNorm2d(nn.Module):
    def __init__(self, num_features: int = 0, bias: bool = True):
        super().__init__()

    def forward(self, x):
        return x


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Class-conditional InstanceNorm++: per-class gamma, alpha (and beta)
    in one table, the scales initialised N(1, 0.02)."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True,
                 eps: float = _EPS):
        super().__init__()
        self.embed = nn.Embedding(num_classes, num_features * (3 if bias else 2))
        with torch.no_grad():
            self.embed.weight[:, :2 * num_features].normal_(1.0, 0.02)
            self.embed.weight[:, 2 * num_features:].zero_()
        self.num_features, self.bias, self.eps = num_features, bias, eps

    def forward(self, x, y):
        C = self.num_features
        means_norm = _channel_mean_norm(x, self.eps)
        h = _instance_normalise(x, self.eps)
        emb = self.embed(y.long())
        out = emb[:, :C, None, None] * h + means_norm[:, :, None, None] * emb[:, C:2 * C, None, None]
        if self.bias:
            out = out + emb[:, 2 * C:, None, None]
        return out
