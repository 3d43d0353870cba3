"""Weights in and out of the reference state-dict layout.

* ``state_dict_from_jax`` takes the JAX package's Flax ``params`` tree for
  NCSN++ (nested dicts of arrays, NHWC/HWIO layout) and returns the port's
  state dict: convs HWIO -> OIHW, dense (in, out) -> (out, in), GroupNorm
  scale/bias -> weight/bias, NIN W/b unchanged.
* ``ema_state_dict`` places an EMA ``shadow_params`` list, which follows
  ``parameters()`` order without the frozen Fourier ``time_embed.W``, onto
  the names of a model state dict.
* ``adam_state_from_jax`` turns the JAX package's Adam state (``count`` and
  the ``mu``/``nu`` trees, which have the layout of ``params``) and its
  schedule count into the port's optimizer state, without
  ``time_embed.W``, which does not train.
* ``jax_tree_from_state_dict`` is the inverse of ``state_dict_from_jax``:
  the Flax ``params`` tree as nested dicts of float32 numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v, dtype=np.float32)))


def _conv(node, prefix, out):
    out[prefix + ".weight"] = _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    out[prefix + ".bias"] = _t(node["bias"])


def _linear(node, prefix, out):
    out[prefix + ".weight"] = _t(np.transpose(np.asarray(node["kernel"])))
    out[prefix + ".bias"] = _t(node["bias"])


def _norm(node, prefix, out):
    out[prefix + ".weight"] = _t(node["scale"])
    out[prefix + ".bias"] = _t(node["bias"])


def _nin(node, prefix, out):
    out[prefix + ".W"] = _t(node["W"])
    out[prefix + ".b"] = _t(node["b"])


def _resblock(node, prefix, out):
    _norm(node["norm0"], prefix + ".GroupNorm_0", out)
    _conv(node["conv0"]["conv"], prefix + ".Conv_0", out)
    _linear(node["temb_proj"], prefix + ".Dense_0", out)
    _norm(node["norm1"], prefix + ".GroupNorm_1", out)
    _conv(node["conv1"]["conv"], prefix + ".Conv_1", out)
    if "shortcut" in node:
        _nin(node["shortcut"], prefix + ".NIN_0", out)


def _attn(node, prefix, out):
    _norm(node["norm"], prefix + ".GroupNorm_0", out)
    _nin(node["q"], prefix + ".NIN_0", out)
    _nin(node["k"], prefix + ".NIN_1", out)
    _nin(node["v"], prefix + ".NIN_2", out)
    _nin(node["proj"], prefix + ".NIN_3", out)


def state_dict_from_jax(params: dict) -> dict:
    """NCSN++ Flax params -> port state dict, in the reference order."""
    out: dict = {}
    out["time_embed.W"] = _t(params["time_embed"]["W"])
    _linear(params["time_mlp0"], "time_mlp.0", out)
    _linear(params["time_mlp1"], "time_mlp.2", out)
    if "label_emb" in params:
        _linear(params["label_emb"], "label_emb", out)
    _conv(params["input_conv"]["conv"], "input_conv", out)
    n_down = 0
    while f"db{n_down}" in params:
        _resblock(params[f"db{n_down}"], f"down_blocks.{n_down}", out)
        n_down += 1
    for k in range(n_down):
        if f"da{k}" in params:
            _attn(params[f"da{k}"], f"down_attn.{k}", out)
    i = 0
    while f"ds{i}" in params:
        _conv(params[f"ds{i}"]["conv"]["conv"], f"downsample.{i}.Conv_0", out)
        i += 1
    _resblock(params["mid_block1"], "mid_block1", out)
    if "mid_attn" in params:
        _attn(params["mid_attn"], "mid_attn", out)
    _resblock(params["mid_block2"], "mid_block2", out)
    n_up = 0
    while f"ub{n_up}" in params:
        _resblock(params[f"ub{n_up}"], f"up_blocks.{n_up}", out)
        n_up += 1
    for k in range(n_up):
        if f"ua{k}" in params:
            _attn(params[f"ua{k}"], f"up_attn.{k}", out)
    j = 0
    while f"us{j}" in params:
        _conv(params[f"us{j}"]["conv"]["conv"], f"upsample.{j}.Conv_0", out)
        j += 1
    _norm(params["out_norm"], "out_norm", out)
    _conv(params["out_conv"]["conv"], "out_conv", out)
    return out


def ema_param_order(sd_keys) -> list:
    """Names in EMA ``shadow_params`` order: state-dict order minus the
    frozen Fourier ``time_embed.W``."""
    return [k for k in sd_keys if k != "time_embed.W"]


def ema_state_dict(model_sd: dict, shadow_list) -> dict:
    """The EMA weights as a state dict: ``shadow_list`` placed on the names
    of ``model_sd``; the frozen ``time_embed.W`` keeps the model's value."""
    order = ema_param_order(model_sd.keys())
    if len(order) != len(shadow_list):
        raise ValueError(f"EMA list has {len(shadow_list)} entries, the model "
                         f"{len(order)} trainable parameters")
    out = dict(model_sd)
    for key, tensor in zip(order, shadow_list):
        if tuple(tensor.shape) != tuple(model_sd[key].shape):
            raise ValueError(f"EMA entry for {key} has shape {tuple(tensor.shape)}")
        out[key] = tensor
    return out


def adam_state_from_jax(count, mu: dict, nu: dict, schedule_count) -> dict:
    """The JAX package's optax Adam state (numpy trees) as the state dict of
    the port's optimizer (``training.losses.ClipAdamWarmup``)."""
    def moments(tree):
        sd = state_dict_from_jax(tree)
        return {k: v for k, v in sd.items() if k != "time_embed.W"}

    return {"count": int(count), "schedule_count": int(schedule_count),
            "mu": moments(mu), "nu": moments(nu)}


# Flax names of a resblock's and an attention block's submodules.
_RESBLOCK_FLAX = {"GroupNorm_0": ("norm0",), "Conv_0": ("conv0", "conv"),
                  "Dense_0": ("temb_proj",), "GroupNorm_1": ("norm1",),
                  "Conv_1": ("conv1", "conv"), "NIN_0": ("shortcut",)}
_ATTN_FLAX = {"GroupNorm_0": ("norm",), "NIN_0": ("q",), "NIN_1": ("k",), "NIN_2": ("v",),
              "NIN_3": ("proj",)}
_LIST_FLAX = {"down_blocks": "db", "up_blocks": "ub", "down_attn": "da", "up_attn": "ua",
              "downsample": "ds", "upsample": "us"}


def _flax_module_path(mods) -> tuple:
    """The Flax path of the module a state-dict key names (its dotted
    module names without the leaf)."""
    head = mods[0]
    if head == "time_mlp":
        return ({"0": "time_mlp0", "2": "time_mlp1"}[mods[1]],)
    if head in ("input_conv", "out_conv"):
        return (head, "conv")
    if head in _LIST_FLAX:
        name, rest = _LIST_FLAX[head] + mods[1], mods[2:]
    else:
        name, rest = head, mods[1:]
    if not rest:
        return (name,)
    if head in ("downsample", "upsample"):
        return (name, "conv", "conv")
    table = _ATTN_FLAX if head in ("down_attn", "up_attn", "mid_attn") else _RESBLOCK_FLAX
    return (name,) + table[rest[0]]


def _flax_leaf(leaf: str, value: np.ndarray) -> tuple:
    """A state-dict leaf as its Flax leaf name and array: convolution
    kernels OIHW -> HWIO, dense (out, in) -> (in, out), GroupNorm weight ->
    scale, NIN W/b and the Fourier W unchanged."""
    if leaf == "weight":
        if value.ndim == 4:
            return "kernel", value.transpose(2, 3, 1, 0)
        if value.ndim == 2:
            return "kernel", value.T
        return "scale", value
    return leaf, value


def jax_tree_from_state_dict(sd: dict) -> dict:
    """Port state dict (reference names) -> NCSN++ Flax params tree of
    float32 numpy arrays; the inverse of ``state_dict_from_jax``."""
    tree: dict = {}
    for key, tensor in sd.items():
        *mods, leaf = key.split(".")
        node = tree
        for name in _flax_module_path(mods):
            node = node.setdefault(name, {})
        name, value = _flax_leaf(leaf, tensor.detach().cpu().numpy().astype(np.float32))
        node[name] = np.ascontiguousarray(value)
    return tree
