"""Training state: step, model, optimizer and EMA in one object.

The JAX package threads an immutable PyTree through a jitted step; here the
step function updates the model's parameters, the optimizer's moments and
the EMA's shadow tensors in place and advances ``step``.
"""
from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from ..models.ema import ExponentialMovingAverage
from .losses import ClipAdamWarmup, get_optimizer


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: ClipAdamWarmup
    ema: ExponentialMovingAverage

    @property
    def params(self) -> list:
        """The trainable parameters, in the EMA's (``parameters()``) order."""
        return self.optimizer.params


def trainable_parameters(model: nn.Module) -> list:
    """``(name, parameter)`` of every parameter that trains: ``parameters()``
    order without the frozen Fourier features."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def init_train_state(model: nn.Module, config) -> TrainState:
    """Optimizer and EMA for ``model`` (already on its device, with its
    initial weights)."""
    named = trainable_parameters(model)
    return TrainState(step=0, model=model, optimizer=get_optimizer(config, named),
                      ema=ExponentialMovingAverage([p for _, p in named],
                                                   decay=config.model.ema_rate))
