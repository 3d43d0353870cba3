"""Save and restore training checkpoints in the reference torch-pickle layout.

A checkpoint is a ``torch.save`` pickle ``{step, model, optimizer, ema,
scaler, config, ...}``: ``model`` is a state dict in the reference names,
``ema`` holds ``decay``, ``num_updates`` and ``shadow_params`` as a list in
``parameters()`` order.  Checkpoints written by the JAX package keep the
optax optimizer state under ``optimizer.optax_state`` and Flax trees under
``native_params`` and ``native_ema_shadow``; unpickling them names optax's
state classes and ``numpy._core`` (numpy >= 2).  The port writes the same
entries (the optimizer state as the JAX package's optax chain, the trees as
nested dicts of float32 numpy arrays), so the JAX package resumes a port
run with its Adam moments, counts and learning rate.  It names optax's
classes in the pickle without importing optax (``_OptaxPickler``).

The model families convert through ``models.convert.FAMILIES``: NCSN++,
ADM and VDM checkpoints of the port carry the weights under their
reference names in ``model`` and as Flax trees; the JAX package writes ADM
and VDM checkpoints with an empty ``model`` and the weights only in
``native_params`` / ``native_ema_shadow``, which ``restore_checkpoint``
then reads (the family named by the caller, else by the checkpoint's
config).

The legacy 1-D pipeline's ``model-epoch-N.pt`` is the JAX package's
``Trainer1D`` layout ``{step, model, opt, ema, scaler: None, version}``:
``model`` and ``ema`` are Flax trees of numpy arrays and ``opt`` is optax's
``(EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState()))`` for
``chain(clip_by_global_norm, adam)``.  ``restore_unet1d_checkpoint`` and
``save_unet1d_checkpoint`` read and write it (the U-Net's variant is read
from the weights' names), so either package's sampler and trainer take
the other's files.

The port writes pickle protocol 4 (``PICKLE_PROTOCOL``); either package
reads any protocol.

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

from ..models.convert import (FAMILIES, adam_state_from_jax, ema_state_dict,
                              unet1d_state_dict_from_jax, unet1d_tree_from_state_dict)

_OPTAX_EMPTY = ("optax._src.base", "EmptyState")
_OPTAX_ADAM = ("optax._src.transform", "ScaleByAdamState")
_OPTAX_SCHEDULE = ("optax._src.transform", "ScaleByScheduleState")
_OPTAX_STATE_CLASSES = {_OPTAX_EMPTY, _OPTAX_ADAM, _OPTAX_SCHEDULE}

_ALLOWED_ROOTS = ("torch", "numpy", "collections", "_codecs")
# the pickle protocol of the checkpoints the port writes: 4 stores the numpy
# arrays' bytes as they are, where protocol 2 (torch's default) encodes them
# as latin-1 text, half as large again and slower to write and read
PICKLE_PROTOCOL = 4
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


class _GlobalName:
    """A module-level name that ``_OptaxPickler`` writes as is.  Callable
    only so that the pickler takes it as a reduce function."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __call__(self, *args):
        raise TypeError(f"{self.module}.{self.name} is a name to pickle, not a class")


class _OptaxState:
    """One optax state tuple to write; it unpickles as ``cls(*fields)``."""

    def __init__(self, cls: tuple, *fields):
        self.cls, self.fields = _GlobalName(*cls), fields

    def __reduce__(self):
        return self.cls, self.fields


class _OptaxPickler(pickle._Pickler):
    """Python's own pickler, writing each ``_GlobalName`` as a global by
    name.  Both picklers check that a global they write can be imported;
    the port writes optax's class names where optax is not installed."""

    dispatch = dict(pickle._Pickler.dispatch)

    def _save_global_name(self, obj):
        if self.proto >= 4:
            self.save(obj.module)
            self.save(obj.name)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{obj.module}\n{obj.name}\n".encode("utf-8"))
        self.memoize(obj)

    dispatch[_GlobalName] = _save_global_name


optax_pickle = types.SimpleNamespace(Pickler=_OptaxPickler, __name__="optax_pickle")


def _optax_chain(optimizer, model_sd: dict, model_name: str = "ncsnpp") -> tuple:
    """The optimizer's state as the JAX package's optax chain
    (``rdm_tpu/training/losses.py:get_optimizer``): the clip's empty state
    when clipping is on, Adam's count and moments, the schedule's count.
    The moments are Flax trees; NCSN++'s frozen ``time_embed.W`` has zero
    moments there, as under optax."""
    to_tree = FAMILIES[model_name][1]

    def tree(moments):
        sd = {k: torch.zeros_like(v) if k == "time_embed.W" else moments[k]
              for k, v in model_sd.items()}
        return to_tree(sd)

    opt = optimizer.state_dict()
    chain = [_OptaxState(_OPTAX_EMPTY)] if optimizer.grad_clip >= 0 else []
    return tuple(chain + [
        _OptaxState(_OPTAX_ADAM, np.asarray(opt["count"], np.int32), tree(opt["mu"]),
                    tree(opt["nu"])),
        _OptaxState(_OPTAX_SCHEDULE, np.asarray(opt["schedule_count"], np.int32))])


class Checkpoint(NamedTuple):
    step: int
    model: dict                  # state dict, reference names
    ema: Optional[dict]          # EMA weights as a state dict, or None
    ema_num_updates: Optional[int] = None
    optimizer: Optional[dict] = None   # the port optimizer's state dict, or None


def _optimizer_state(entry, model_name: str = "ncsnpp") -> Optional[dict]:
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
    return adam_state_from_jax(count, mu, nu, schedule[0].fields[0], model_name)


# buffers a reference checkpoint may hold that the port's modules do not save
_BUFFERS = ("resample_filter", "freqs")


def _family(config) -> str:
    """The model family ``config`` names (``model.name``), else NCSN++."""
    if hasattr(config, "to_plain"):
        config = config.to_plain()
    if isinstance(config, dict) and isinstance(config.get("model"), dict):
        return config["model"].get("name") or "ncsnpp"
    return "ncsnpp"


def _model_name(loaded: dict, model_name: Optional[str]) -> str:
    """The caller's model name, else the checkpoint config's, else NCSN++."""
    return model_name or _family(loaded.get("config"))


def restore_checkpoint(path: str, model_name: Optional[str] = None) -> Optional[Checkpoint]:
    """Read ``step``, ``model``, ``ema`` and the optimizer state from a
    checkpoint.  A missing file logs a warning and returns None."""
    if not os.path.exists(path):
        logging.warning(f"No checkpoint found at {path}.")
        return None
    loaded = torch.load(path, map_location="cpu", pickle_module=restricted_pickle,
                        weights_only=False)
    name = _model_name(loaded, model_name)
    model_sd = {k.removeprefix("module."): v for k, v in loaded["model"].items()
                if k.rsplit(".", 1)[-1] not in _BUFFERS}
    ema_entry = loaded.get("ema") or {}
    if not model_sd and "native_params" in loaded:
        # the JAX package's ADM and VDM checkpoints
        from_jax = FAMILIES[name][0]
        model_sd = from_jax(loaded["native_params"])
        shadow = loaded.get("native_ema_shadow")
        ema_sd = from_jax(shadow) if shadow is not None else None
    else:
        shadows = ema_entry.get("shadow_params")
        ema_sd = ema_state_dict(model_sd, shadows) if shadows is not None else None
    n = ema_entry.get("num_updates")
    return Checkpoint(step=int(loaded["step"]), model=model_sd, ema=ema_sd,
                      ema_num_updates=None if n is None else int(n),
                      optimizer=_optimizer_state(loaded.get("optimizer"), name))


def save_checkpoint(path: str, state, config=None) -> None:
    """Write ``state`` (a ``TrainState``) in the JAX package's layout
    ``{step, model, optimizer: {optax_state}, ema: {decay, num_updates,
    shadow_params}, scaler: None, config, native_params,
    native_ema_shadow}``, every tensor and array float32 on the CPU; the
    Flax trees and the optimizer's moments in the layout of the JAX
    package's family that ``config.model.name`` names (NCSN++ without a
    config)."""
    model_name = _family(config)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def cpu(t):
        return t.detach().to("cpu", torch.float32).clone()

    model_sd = {k: cpu(v) for k, v in state.model.state_dict().items()}
    shadows = [cpu(s) for s in state.ema.shadow_params]
    to_tree = FAMILIES[model_name][1]
    checkpoint = {
        "step": int(state.step),
        "model": model_sd,
        "optimizer": {"optax_state": _optax_chain(state.optimizer, model_sd, model_name)},
        "ema": {"decay": float(state.ema.decay), "num_updates": int(state.ema.num_updates),
                "shadow_params": shadows},
        "scaler": None,
        "config": config.to_plain() if hasattr(config, "to_plain") else config,
        "native_params": to_tree(model_sd),
        "native_ema_shadow": to_tree(ema_state_dict(model_sd, shadows)),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(checkpoint, tmp, pickle_module=optax_pickle, pickle_protocol=PICKLE_PROTOCOL)
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


# ---------------------------------------------------------------------------
# the legacy 1-D pipeline's model-epoch-N.pt

UNET1D_CHECKPOINT_VERSION = "rdm_tpu-1"


class Checkpoint1D(NamedTuple):
    step: int
    model: dict                  # the U-Net's state dict
    ema: Optional[dict]          # the EMA weights as a state dict, or None
    optimizer: Optional[dict]    # {count, schedule_count, mu, nu}, or None


def _stubs(entry):
    """Every optax state stub of a nested tuple, in order."""
    if isinstance(entry, OptimizerStateStub):
        return [entry]
    if isinstance(entry, (tuple, list)):
        return [s for e in entry for s in _stubs(e)]
    raise ValueError(f"unrecognised optax state in checkpoint: {type(entry).__name__}")


def restore_unet1d_checkpoint(path: str) -> Checkpoint1D:
    """Read a 1-D ``model-epoch-N.pt`` of either package: the weights, the
    EMA weights and Adam's count and moments, as state dicts of the port's
    ``UNet1D``."""
    loaded = torch.load(path, map_location="cpu", pickle_module=restricted_pickle,
                        weights_only=False)
    legacy = "cond_mlp" in loaded["model"]["mid_block1"]
    model_sd = unet1d_state_dict_from_jax(loaded["model"], legacy)
    ema = loaded.get("ema")
    ema_sd = unet1d_state_dict_from_jax(ema, legacy) if ema is not None else None
    optimizer = None
    if loaded.get("opt") is not None:
        adam = [s for s in _stubs(loaded["opt"]) if len(s.fields) == 3]
        if len(adam) != 1:
            raise ValueError("the checkpoint's optax state holds no single Adam state")
        count, mu, nu = adam[0].fields
        count = int(np.asarray(count))
        optimizer = {"count": count, "schedule_count": count,
                     "mu": unet1d_state_dict_from_jax(mu, legacy),
                     "nu": unet1d_state_dict_from_jax(nu, legacy)}
    return Checkpoint1D(step=int(loaded["step"]), model=model_sd, ema=ema_sd,
                        optimizer=optimizer)


def save_unet1d_checkpoint(path: str, step: int, model_sd: dict, ema_sd: dict,
                           optimizer_state: dict) -> None:
    """Write a 1-D ``model-epoch-N.pt`` in the JAX package's layout:
    ``optimizer_state`` is ``ClipAdamWarmup.state_dict()`` of the U-Net's
    parameters (clipping on, a constant learning rate)."""
    legacy = any(".mlp.1." in k for k in model_sd)

    def tree(sd):
        return unet1d_tree_from_state_dict(sd, legacy)

    adam = _OptaxState(_OPTAX_ADAM, np.asarray(optimizer_state["count"], np.int32),
                       tree(optimizer_state["mu"]), tree(optimizer_state["nu"]))
    checkpoint = {
        "step": int(step),
        "model": tree(model_sd),
        "opt": (_OptaxState(_OPTAX_EMPTY), (adam, _OptaxState(_OPTAX_EMPTY))),
        "ema": tree(ema_sd),
        "scaler": None,
        "version": UNET1D_CHECKPOINT_VERSION,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(checkpoint, tmp, pickle_module=optax_pickle, pickle_protocol=PICKLE_PROTOCOL)
    os.replace(tmp, path)
