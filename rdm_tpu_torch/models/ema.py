"""Exponential moving average of a model's trainable parameters.

The shadow list follows ``parameters()`` order without the frozen Fourier
``time_embed.W`` (the trainable parameters, in the reference's order), as
the reference checkpoint's ``ema.shadow_params`` does.  The decay warms up
as ``min(decay, (1 + n) / (10 + n))`` and the update is
``s -= (1 - d) (s - p)``, with ``1 - d`` computed in float32 as the JAX
package computes it.  The shadow tensors are updated in place.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


class ExponentialMovingAverage:
    def __init__(self, parameters, decay: float):
        if not 0.0 <= decay <= 1.0:
            raise ValueError("Decay must be between 0 and 1")
        self.decay = float(decay)
        self.num_updates = 0
        self.shadow_params = [p.detach().clone() for p in parameters]

    def one_minus_decay(self, num_updates: int) -> float:
        """``1 - min(decay, (1 + n) / (10 + n))`` in float32 arithmetic; a
        negative count (a restored state that kept none) uses ``decay``."""
        if num_updates < 0:
            d = np.float32(self.decay)
        else:
            n = np.float32(num_updates)
            d = np.minimum(np.float32(self.decay),
                           (np.float32(1.0) + n) / (np.float32(10.0) + n))
        return float(np.float32(1.0) - d)

    @torch.no_grad()
    def update(self, parameters) -> None:
        """One EMA step towards ``parameters`` (the same order as the shadow
        list)."""
        if self.num_updates >= 0:
            self.num_updates += 1
        params = [p.detach() for p in parameters]
        diff = torch._foreach_sub(self.shadow_params, params)
        torch._foreach_mul_(diff, self.one_minus_decay(self.num_updates))
        torch._foreach_sub_(self.shadow_params, diff)

    @torch.no_grad()
    def copy_to(self, parameters) -> None:
        """Write the shadow values into ``parameters``."""
        for s, p in zip(self.shadow_params, parameters):
            p.copy_(s)

    @contextlib.contextmanager
    def average_parameters(self, parameters):
        """Within the block ``parameters`` hold the shadow values; the live
        values are put back after it."""
        parameters = list(parameters)
        with torch.no_grad():
            live = [p.detach().clone() for p in parameters]
            self.copy_to(parameters)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, v in zip(parameters, live):
                    p.copy_(v)

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Take ``num_updates`` and the shadow values from ``state``; the
        decay stays the configured one, as the JAX package restores it."""
        self.num_updates = int(state["num_updates"])
        shadows = state["shadow_params"]
        if len(shadows) != len(self.shadow_params):
            raise ValueError(f"EMA state has {len(shadows)} entries, expected "
                             f"{len(self.shadow_params)}")
        for s, v in zip(self.shadow_params, shadows):
            s.copy_(v)
