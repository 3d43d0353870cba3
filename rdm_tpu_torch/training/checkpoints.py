"""Restore training checkpoints in the reference torch-pickle layout.

A checkpoint is a ``torch.save`` pickle ``{step, model, optimizer, ema,
scaler, config, ...}``: ``model`` is a state dict in the reference names,
``ema`` holds ``shadow_params`` as a list in ``parameters()`` order.
Checkpoints written by the JAX package also keep the optax optimizer state
under ``optimizer`` and Flax trees under ``native_params`` and
``native_ema_shadow``; unpickling them names optax's state classes and
``numpy._core`` (numpy >= 2).

This module reads ``step``, ``model`` and ``ema`` and ignores the rest.  It
unpickles through a restricted unpickler: the optax state classes become
one inert stub, ``numpy._core`` maps to ``numpy.core`` under numpy < 2,
names from ``torch``, ``numpy``, ``collections`` and ``_codecs`` load as
usual, and any other global raises.  So a checkpoint loads without optax
(or JAX) installed, and a pickle cannot name arbitrary callables.
"""
from __future__ import annotations

import logging
import os
import pickle
import types
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.convert import ema_state_dict

_OPTAX_STATE_CLASSES = {
    ("optax._src.transform", "ScaleByAdamState"),
    ("optax._src.transform", "ScaleByScheduleState"),
    ("optax._src.base", "EmptyState"),
}
_ALLOWED_ROOTS = ("torch", "numpy", "collections", "_codecs")
_NUMPY_MAJOR = int(np.__version__.split(".")[0])


class OptimizerStateStub:
    """Stands in for an optax state tuple; keeps its fields, does nothing."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.fields = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _OPTAX_STATE_CLASSES:
            return OptimizerStateStub
        if _NUMPY_MAJOR < 2 and (module == "numpy._core" or module.startswith("numpy._core.")):
            module = "numpy.core" + module[len("numpy._core"):]
        if module.split(".")[0] in _ALLOWED_ROOTS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint names a disallowed global {module}.{name}")


# ``torch.load(pickle_module=...)`` takes a module-like object.
restricted_pickle = types.SimpleNamespace(
    Unpickler=RestrictedUnpickler,
    load=lambda f, **kw: RestrictedUnpickler(f, **kw).load(),
    __name__="restricted_pickle")


class Checkpoint(NamedTuple):
    step: int
    model: dict           # state dict, reference names
    ema: Optional[dict]   # EMA weights as a state dict, or None


def restore_checkpoint(path: str) -> Optional[Checkpoint]:
    """Read ``step``, ``model`` and ``ema`` from a checkpoint.  A missing
    file logs a warning and returns None."""
    if not os.path.exists(path):
        logging.warning(f"No checkpoint found at {path}.")
        return None
    loaded = torch.load(path, map_location="cpu", pickle_module=restricted_pickle,
                        weights_only=False)
    model_sd = {k.removeprefix("module."): v for k, v in loaded["model"].items()}
    ema_entry = loaded.get("ema") or {}
    shadows = ema_entry.get("shadow_params")
    ema_sd = ema_state_dict(model_sd, shadows) if shadows is not None else None
    return Checkpoint(step=int(loaded["step"]), model=model_sd, ema=ema_sd)


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The ``checkpoint_{k}.pth`` with the highest k, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    best_k, best = -1, None
    for name in os.listdir(checkpoint_dir):
        if name.startswith("checkpoint_") and name.endswith(".pth"):
            try:
                k = int(name[len("checkpoint_"):-len(".pth")])
            except ValueError:
                continue
            if k > best_k:
                best_k, best = k, os.path.join(checkpoint_dir, name)
    return best
