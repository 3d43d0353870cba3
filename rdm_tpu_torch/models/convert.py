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
* ``adm_state_dict_from_jax`` / ``vdm_state_dict_from_jax`` do the same for
  the JAX package's ADM (``WrappedADM``, or the bare ``ADM``) and VDM trees,
  and ``adm_tree_from_state_dict`` / ``vdm_tree_from_state_dict`` invert
  them.  EDM convs are HWIO there and OIHW here, EDM linears (in, out) and
  (out, in); ADM's GroupNorms nest a Flax ``gn``; VDM's ``enc.N``/``dec.N``
  interleave resblocks and attention blocks when attention is on, where the
  JAX package names them ``encK``/``enc_attnK``.  The buffers
  ``resample_filter`` and ``freqs`` are in neither.
* ``unet1d_state_dict_from_jax`` / ``unet1d_tree_from_state_dict`` carry
  the JAX package's 1-D U-Net (either variant) to the port's state dict,
  in the legacy reference's names, and back: Flax conv kernels (k, I, O)
  against torch's (O, I, k), dense kernels (I, O) against (O, I), RMSNorm
  ``g`` (C,) against (1, C, 1), GroupNorm ``scale`` against ``weight``.
* ``FAMILIES`` names each model's pair, for checkpoints.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


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


def adam_state_from_jax(count, mu: dict, nu: dict, schedule_count,
                        model_name: str = "ncsnpp") -> dict:
    """The JAX package's optax Adam state (numpy trees) as the state dict of
    the port's optimizer (``training.losses.ClipAdamWarmup``)."""
    from_jax = FAMILIES[model_name][0]

    def moments(tree):
        sd = from_jax(tree)
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


# ---------------------------------------------------------------------------
# ADM and VDM

def _walk(tree: dict, path=()):
    """(path, array) of every leaf of a nested dict."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def _edm_to_torch(leaf: str, value: np.ndarray) -> tuple:
    """A Flax EDM leaf as its state-dict leaf: HWIO -> OIHW, (in, out) ->
    (out, in), GroupNorm scale -> weight."""
    if leaf == "scale":
        return "weight", value
    if leaf == "weight" and value.ndim == 4:
        return leaf, value.transpose(3, 2, 0, 1)
    if leaf == "weight" and value.ndim == 2:
        return leaf, value.T
    return leaf, value


def _edm_to_flax(leaf: str, value: np.ndarray, norm: bool) -> tuple:
    if norm:
        return ("scale" if leaf == "weight" else leaf), value
    if leaf == "weight" and value.ndim == 4:
        return leaf, value.transpose(2, 3, 1, 0)
    if leaf == "weight" and value.ndim == 2:
        return leaf, value.T
    return leaf, value


def _put(tree: dict, path, value) -> None:
    node = tree
    for name in path[:-1]:
        node = node.setdefault(name, {})
    node[path[-1]] = np.ascontiguousarray(value, dtype=np.float32)


def _numpy(tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy().astype(np.float32)


def _unwrap(sd: dict, prefix: str) -> tuple:
    """(keys without ``prefix``, whether every key had it)."""
    wrapped = bool(sd) and all(k.startswith(prefix) for k in sd)
    return ({k[len(prefix):]: v for k, v in sd.items()} if wrapped else sd), wrapped


def adm_state_dict_from_jax(params: dict) -> dict:
    """ADM Flax params (``WrappedADM``'s ``{"model": ...}`` or a bare
    ``ADM``'s) -> the port's state dict (``model.``-prefixed for the
    wrapper)."""
    wrapped = set(params) == {"model"}
    out: dict = {}
    for path, value in _walk(params["model"] if wrapped else params):
        path = [p for p in path if p != "gn"]
        head = path[0]
        if head.startswith(("enc_", "dec_")):
            path = [head[:3], head[4:]] + path[1:]
        leaf, value = _edm_to_torch(path[-1], value)
        out[("model." if wrapped else "") + ".".join(path[:-1] + [leaf])] = _t(value)
    return out


def adm_tree_from_state_dict(sd: dict) -> dict:
    """The port's ADM state dict -> the JAX package's Flax params tree;
    the inverse of ``adm_state_dict_from_jax``."""
    sd, wrapped = _unwrap(sd, "model.")
    tree: dict = {}
    for key, tensor in sd.items():
        *mods, leaf = key.split(".")
        if mods[0] in ("enc", "dec"):
            mods = [f"{mods[0]}_{mods[1]}"] + mods[2:]
        norm = mods[-1].startswith("norm") or mods[-1] == "out_norm"
        name, value = _edm_to_flax(leaf, _numpy(tensor), norm)
        _put(tree, mods + (["gn"] if norm else []) + [name], value)
    return {"model": tree} if wrapped else tree


_VDM_SEQ = {("cond_map", "0"): "cond_map0", ("cond_map", "2"): "cond_map1",
            ("out", "0"): "out_norm", ("out", "2"): "out_conv"}
_VDM_NORMS = ("norm1", "norm2", "norm", "out_norm")


def vdm_state_dict_from_jax(params: dict) -> dict:
    """VDM Flax params -> the port's state dict."""
    attention = "enc_attn0" in params or "dec_attn0" in params
    seq = {v: k for k, v in _VDM_SEQ.items()}
    out: dict = {}
    for path, value in _walk(params):
        head, rest = path[0], list(path[1:])
        block = re.fullmatch(r"(enc|dec)(_attn)?(\d+)", head)
        if head in seq:
            mods = list(seq[head])
        elif block:
            stage, attn, k = block.group(1), block.group(2) is not None, int(block.group(3))
            mods = [stage, str(2 * k + attn if attention else k)]
        else:
            mods = [head]
        leaf, value = _edm_to_torch(rest[-1], value)
        out[".".join(mods + rest[:-1] + [leaf])] = _t(value)
    return out


def vdm_tree_from_state_dict(sd: dict) -> dict:
    """The port's VDM state dict -> the JAX package's Flax params tree; the
    inverse of ``vdm_state_dict_from_jax``."""
    attention = any(k.startswith(("enc.1.qkv", "enc.1.norm.")) for k in sd)
    tree: dict = {}
    for key, tensor in sd.items():
        *mods, leaf = key.split(".")
        if tuple(mods[:2]) in _VDM_SEQ:
            mods = [_VDM_SEQ[tuple(mods[:2])]] + mods[2:]
        elif mods[0] in ("enc", "dec"):
            idx = int(mods[1])
            if attention:
                base = f"{mods[0]}{idx // 2}" if idx % 2 == 0 else f"{mods[0]}_attn{idx // 2}"
            else:
                base = f"{mods[0]}{idx}"
            mods = [base] + mods[2:]
        norm = mods[-1] in _VDM_NORMS
        name, value = _edm_to_flax(leaf, _numpy(tensor), norm)
        _put(tree, mods + [name], value)
    return tree


# ---------------------------------------------------------------------------
# the 1-D U-Net: module names of the JAX tree <-> the legacy reference's

_UNET1D_SLOTS = ("block1", "block2", "attn")
_UNET1D_TIME = {"0": "sinu_pos_emb", "1": "time_mlp0", "3": "time_mlp1"}


def _unet1d_flax_path(key: str, value: np.ndarray) -> tuple:
    """A state-dict key of the port's ``UNet1D`` -> (Flax path, value)."""
    parts = key.split(".")
    head, leaf = parts[0], parts[-1]
    if head in ("downs", "ups"):
        slot = int(parts[2])
        name = (_UNET1D_SLOTS[slot] if slot < 3 else
                "downsample" if head == "downs" else "upsample")
        mods, rest = [f"{head[:-1]}{parts[1]}_{name}"], parts[3:-1]
        if name == "upsample" and rest == ["1"]:     # Sequential(resize, conv)
            rest = []
    elif head == "time_mlp":
        mods, rest = [_UNET1D_TIME[parts[1]]], parts[2:-1]
    elif head == "classes_mlp":
        mods, rest = [f"classes_mlp{int(parts[1]) // 2}"], parts[2:-1]
    else:
        mods, rest = [head], parts[1:-1]
    rest = ".".join(rest)
    for old, new in (("mlp.1", "cond_mlp"), ("fn.norm", "norm"), ("fn.fn", "fn"),
                     ("to_out.0", "to_out"), ("to_out.1", "to_out_norm")):
        rest = re.sub(rf"(^|\.){re.escape(old)}($|\.)", rf"\g<1>{new}\g<2>", rest)
    mods += [r for r in rest.split(".") if r]
    if leaf == "weight" and value.ndim == 3:
        return mods + ["kernel"], np.transpose(value, (2, 1, 0))
    if leaf == "weight" and value.ndim == 2:
        return mods + ["kernel"], np.transpose(value)
    if leaf == "weight":
        return mods + ["scale"], value
    if leaf == "g":
        return mods + ["g"], value.reshape(-1)
    return mods + [leaf], value


def _unet1d_torch_key(path, value: np.ndarray, legacy: bool, n_levels: int) -> tuple:
    """A Flax path of the JAX package's ``UNet1D`` -> (state-dict key,
    value); the inverse of ``_unet1d_flax_path``."""
    head, rest, leaf = path[0], list(path[1:-1]), path[-1]
    block = re.fullmatch(r"(down|up)(\d+)_(block1|block2|attn|downsample|upsample)", head)
    if block:
        stage, lvl, name = block.groups()
        slot = {"block1": "0", "block2": "1", "attn": "2"}.get(name, "3")
        mods = [stage + "s", lvl, slot]
        if name == "upsample" and int(lvl) != n_levels - 1:
            mods.append("1")
    elif head in _UNET1D_TIME.values():
        mods = ["time_mlp", next(k for k, v in _UNET1D_TIME.items() if v == head)]
    elif head.startswith("classes_mlp"):
        mods = ["classes_mlp", str(2 * int(head[len("classes_mlp"):]))]
    else:
        mods = [head]
    attention = head.endswith("_attn")
    for r in rest:
        if r == "cond_mlp":
            mods += ["mlp", "1"]
        elif attention and r in ("norm", "fn"):
            mods += ["fn", r]
        elif r == "to_out" and legacy and head != "mid_attn":
            mods += ["to_out", "0"]
        elif r == "to_out_norm":
            mods += ["to_out", "1"]
        else:
            mods.append(r)
    if leaf == "kernel":
        value = np.transpose(value, (2, 1, 0)) if value.ndim == 3 else np.transpose(value)
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf == "g":
        value = value.reshape(1, -1, 1)
    return ".".join(mods + [leaf]), value


def unet1d_state_dict_from_jax(params: dict, legacy: bool) -> dict:
    """The JAX package's ``UNet1D`` Flax params (``legacy`` names the
    variant) -> the port's state dict."""
    n_levels = sum(1 for k in params if re.fullmatch(r"up\d+_block1", k))
    out: dict = {}
    for path, value in _walk(params):
        key, value = _unet1d_torch_key(path, np.asarray(value, np.float32), legacy, n_levels)
        out[key] = _t(value)
    return out


def unet1d_tree_from_state_dict(sd: dict, legacy: bool) -> dict:
    """The port's ``UNet1D`` state dict -> the JAX package's Flax params
    tree; the inverse of ``unet1d_state_dict_from_jax``."""
    if legacy != any(".mlp.1." in k for k in sd):
        raise ValueError(f"the state dict is not of the {'legacy' if legacy else 'RDM'} variant")
    tree: dict = {}
    for key, tensor in sd.items():
        path, value = _unet1d_flax_path(key, _numpy(tensor))
        _put(tree, path, value)
    return tree


# model name -> (Flax params -> state dict, state dict -> Flax params)
FAMILIES = {
    "ncsnpp": (state_dict_from_jax, jax_tree_from_state_dict),
    "adm": (adm_state_dict_from_jax, adm_tree_from_state_dict),
    "vdm": (vdm_state_dict_from_jax, vdm_tree_from_state_dict),
}
