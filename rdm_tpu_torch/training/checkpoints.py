"""Save and restore training checkpoints in the reference torch-pickle layout.

A checkpoint is a ``torch.save`` pickle ``{step, model, optimizer, ema,
scaler, config, ...}``: ``model`` is a state dict in the reference names,
``ema`` holds ``decay``, ``num_updates`` and ``shadow_params`` as a list in
``parameters()`` order.  Checkpoints written by the JAX package keep the
optax optimizer state under ``optimizer.optax_state`` and Flax trees under
``native_params`` and ``native_ema_shadow``; unpickling them names optax's
state classes and ``numpy._core`` (numpy >= 2).  The port writes its own
optimizer state under ``optimizer`` (counts and name-keyed Adam moments);
the JAX package's restore reads such a file through its reference branch
(model, EMA and step; a fresh optimizer).

``restore_checkpoint`` reads ``step``, ``model``, ``ema`` and the optimizer
state of either package and ignores the rest.  It unpickles through a
restricted unpickler: the optax state classes become
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

from ..models.convert import adam_state_from_jax, ema_state_dict

_OPTAX_STATE_CLASSES = {
    ("optax._src.transform", "ScaleByAdamState"),
    ("optax._src.transform", "ScaleByScheduleState"),
    ("optax._src.base", "EmptyState"),
}

_ALLOWED_ROOTS = ("torch", "numpy", "collections", "_codecs")
_NUMPY_MAJOR = int(np.__version__.split(".")[0])


class OptimizerStateStub:
    """Stands in for an optax state tuple; keeps its fields, does nothing.
    The three classes differ in their number of fields: ``EmptyState`` 0,
    ``ScaleByScheduleState`` 1 (count), ``ScaleByAdamState`` 3 (count, mu,
    nu)."""

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
    model: dict                  # state dict, reference names
    ema: Optional[dict]          # EMA weights as a state dict, or None
    ema_num_updates: Optional[int] = None
    optimizer: Optional[dict] = None   # the port optimizer's state dict, or None


def _optimizer_state(entry) -> Optional[dict]:
    """The port optimizer's state from a checkpoint's ``optimizer`` entry:
    the port's own layout, or the JAX package's optax chain (clip, Adam,
    schedule); None for anything else (a reference torch Adam)."""
    if not isinstance(entry, dict):
        return None
    if {"count", "schedule_count", "mu", "nu"} <= set(entry):
        return entry
    chain = entry.get("optax_state")
    if chain is None:
        return None
    stubs = [s for s in chain if isinstance(s, OptimizerStateStub)]
    adam = [s for s in stubs if len(s.fields) == 3]
    schedule = [s for s in stubs if len(s.fields) == 1]
    if len(stubs) != len(chain) or len(adam) != 1 or len(schedule) != 1:
        raise ValueError("unrecognised optax state in checkpoint: "
                         + ", ".join(type(s).__name__ for s in chain))
    count, mu, nu = adam[0].fields
    return adam_state_from_jax(count, mu, nu, schedule[0].fields[0])


def restore_checkpoint(path: str) -> Optional[Checkpoint]:
    """Read ``step``, ``model``, ``ema`` and the optimizer state from a
    checkpoint.  A missing file logs a warning and returns None."""
    if not os.path.exists(path):
        logging.warning(f"No checkpoint found at {path}.")
        return None
    loaded = torch.load(path, map_location="cpu", pickle_module=restricted_pickle,
                        weights_only=False)
    model_sd = {k.removeprefix("module."): v for k, v in loaded["model"].items()}
    ema_entry = loaded.get("ema") or {}
    shadows = ema_entry.get("shadow_params")
    ema_sd = ema_state_dict(model_sd, shadows) if shadows is not None else None
    n = ema_entry.get("num_updates")
    return Checkpoint(step=int(loaded["step"]), model=model_sd, ema=ema_sd,
                      ema_num_updates=None if n is None else int(n),
                      optimizer=_optimizer_state(loaded.get("optimizer")))


def save_checkpoint(path: str, state, config=None) -> None:
    """Write ``state`` (a ``TrainState``) in the reference layout ``{step,
    model, optimizer, ema: {decay, num_updates, shadow_params}, scaler: None,
    config}``, every tensor float32 on the CPU."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def cpu(t):
        return t.detach().to("cpu", torch.float32).clone()

    opt = state.optimizer.state_dict()
    checkpoint = {
        "step": int(state.step),
        "model": {k: cpu(v) for k, v in state.model.state_dict().items()},
        "optimizer": {"count": opt["count"], "schedule_count": opt["schedule_count"],
                      "mu": {k: cpu(v) for k, v in opt["mu"].items()},
                      "nu": {k: cpu(v) for k, v in opt["nu"].items()}},
        "ema": {"decay": float(state.ema.decay), "num_updates": int(state.ema.num_updates),
                "shadow_params": [cpu(s) for s in state.ema.shadow_params]},
        "scaler": None,
        "config": config.to_plain() if hasattr(config, "to_plain") else config,
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(checkpoint, tmp)
    os.replace(tmp, path)


def load_into_state(state, ckpt: Checkpoint) -> None:
    """Put a restored checkpoint into ``state``: weights, EMA, optimizer (when
    the file has one) and step."""
    state.model.load_state_dict(ckpt.model, strict=True)
    if ckpt.ema is not None:
        sd = ckpt.ema
        state.ema.load_state_dict({
            "num_updates": ckpt.ema_num_updates if ckpt.ema_num_updates is not None
            else state.ema.num_updates,
            "shadow_params": [sd[n] for n in state.optimizer.names]})
    else:
        state.ema.load_state_dict({"num_updates": state.ema.num_updates,
                                   "shadow_params": list(state.params)})
    if ckpt.optimizer is not None:
        state.optimizer.load_state_dict(ckpt.optimizer)
    state.step = ckpt.step


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
