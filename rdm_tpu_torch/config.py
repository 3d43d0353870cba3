"""Hydra-style run configuration, read without PyYAML.

A training run persists its composed config as ``<run>/.hydra/config.yaml``;
sampling and benchmarking read it back as the model manifest.  This module
composes ``configs/<name>.yaml`` with its ``defaults:`` list and Hydra-style
CLI overrides (``group=option``, ``a.b=value``, ``+a.b=value``), and reads a
run manifest, exactly as the JAX package's ``config.py`` does.

The YAML files involved use a small subset of YAML, so this module carries
its own reader for it rather than depending on PyYAML:

* block mappings nested by indentation, and block lists (``- item``, also
  at the parent key's indentation, also holding ``key: value`` items);
* flow lists of scalars (``[1, 2, 2]``);
* full-line and trailing ``#`` comments;
* plain and quoted scalars, typed by YAML 1.1's implicit rules as PyYAML's
  ``safe_load`` types them: ``null``/``~``, booleans (``true``, ``yes``,
  ``on`` ...), ints (with ``0x``/``0b``/octal/underscore forms) and floats
  that carry a ``.`` — so ``1e-8`` stays the string ``'1e-8'``.  ``???``
  is a string.

Anything outside that subset raises ``ValueError``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Iterable

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


class ConfigDict(dict):
    """Dot-access dict (the subset of OmegaConf the pipeline uses)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigDict.wrap(v) for v in obj]
        return obj

    def to_plain(self):
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o
        return unwrap(self)


# --------------------------------------------------------------------------
# YAML subset reader

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_FLOAT_RE = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")
_INT_RE = re.compile(
    r"^(?:[-+]?0b[0-1_]+"
    r"|[-+]?0[0-7_]+"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_TIMESTAMP_RE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _sexagesimal(digits: str, conv):
    value = 0
    for part in digits.split(":"):
        value = value * 60 + conv(part)
    return value


def _to_int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    if s[0] in "+-":
        s = s[1:]
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s[0] == "0":
        return sign * int(s, 8)
    if ":" in s:
        return sign * _sexagesimal(s, int)
    return sign * int(s)


def _to_float(s: str) -> float:
    s = s.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    if s[0] in "+-":
        s = s[1:]
    if s == ".inf":
        return sign * float("inf")
    if s == ".nan":
        return float("nan")
    if ":" in s:
        return sign * _sexagesimal(s, float)
    return sign * float(s)


def parse_scalar(s: str) -> Any:
    """Type one plain or quoted scalar as YAML 1.1 (PyYAML ``safe_load``)."""
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _FLOAT_RE.match(s):
        return _to_float(s)
    if _INT_RE.match(s):
        return _to_int(s)
    if _TIMESTAMP_RE.match(s):
        raise ValueError(f"YAML timestamps are not supported: {s!r}")
    if s[:1] in "[{&*!|>%@`\"'":
        raise ValueError(f"unsupported YAML scalar: {s!r}")
    return s


def parse_value(s: str) -> Any:
    """A scalar or a flow list of scalars (``[1, 2, 2]``)."""
    s = s.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unterminated flow list: {s!r}")
        body = s[1:-1].strip()
        if not body:
            return []
        if "[" in body or "{" in body:
            raise ValueError(f"nested flow collections are not supported: {s!r}")
        return [parse_scalar(item) for item in body.split(",")]
    return parse_scalar(s)


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :-[,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(text: str):
    """``key: value`` -> (key, value) or None when ``text`` is no mapping
    entry."""
    m = re.match(r"^([^\s:#\[\]{}'\"][^:#]*?)\s*:(?:\s+(.*)|)$", text)
    if not m:
        return None
    return m.group(1), (m.group(2) or "").strip()


def loads(text: str) -> Any:
    """Parse a YAML document of the supported subset."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tab indentation is not supported")
        body = _strip_comment(raw).rstrip()
        if body.strip() in ("", "---"):
            continue
        lines.append((len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return None
    value, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected content: {lines[pos][1]!r}")
    return value


def _parse_block(lines, pos, indent):
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        return _parse_list(lines, pos, indent)
    if _split_key(lines[pos][1]) is not None:
        return _parse_map(lines, pos, indent)
    if len(lines) - pos == 1:
        return parse_value(lines[pos][1]), pos + 1
    raise ValueError(f"unsupported YAML line: {lines[pos][1]!r}")


def _parse_map(lines, pos, indent):
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        entry = _split_key(lines[pos][1])
        if entry is None:
            break
        key, rest = entry
        key = parse_scalar(key)
        pos += 1
        if rest:
            out[key] = parse_value(rest)
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("- "))):
            out[key], pos = _parse_block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"bad indentation at {lines[pos][1]!r}")
    return out, pos


def _parse_list(lines, pos, indent):
    out = []
    while pos < len(lines) and lines[pos][0] == indent and (
            lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
        rest = lines[pos][1][1:].strip()
        pos += 1
        if not rest:
            if pos < len(lines) and lines[pos][0] > indent:
                item, pos = _parse_block(lines, pos, lines[pos][0])
            else:
                item = None
            out.append(item)
            continue
        entry = _split_key(rest)
        if entry is None:
            out.append(parse_value(rest))
            continue
        # A mapping item: its first entry sits after the dash, the rest are
        # indented to the column of that first key.
        inner_indent = indent + 2 + (len(rest) - len(rest.lstrip()))
        sub = [(inner_indent, rest)]
        while pos < len(lines) and lines[pos][0] >= inner_indent:
            sub.append(lines[pos])
            pos += 1
        item, used = _parse_map(sub, 0, inner_indent)
        if used != len(sub):
            raise ValueError(f"bad mapping in list item: {rest!r}")
        out.append(item)
    return out, pos


def load_yaml(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# --------------------------------------------------------------------------
# Composition (mirrors the JAX package's ``config.py``)

def _merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _set_dotted(cfg: dict, dotted: str, value: Any, allow_new: bool = True):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node:
            if not allow_new:
                raise KeyError(f"Unknown config path: {dotted}")
            node[k] = ConfigDict()
        node = node[k]
    node[keys[-1]] = ConfigDict.wrap(value)


def _load_yaml(path: str) -> dict:
    return load_yaml(path) or {}


def load_config(name: str = "train", overrides: Iterable[str] = (),
                config_dir: str = DEFAULT_CONFIG_DIR) -> ConfigDict:
    """Compose ``<config_dir>/<name>.yaml`` with its defaults list and
    Hydra-style CLI overrides."""
    overrides = list(overrides)
    root = _load_yaml(os.path.join(config_dir, f"{name}.yaml"))
    defaults = root.pop("defaults", [])
    root.pop("hydra", None)

    group_choice = {}
    order = []
    for entry in defaults:
        if entry == "_self_" or entry is None:
            continue
        if isinstance(entry, dict):
            for g, opt in entry.items():
                if str(g).startswith("override "):
                    continue
                group_choice[g] = opt
                order.append(g)
    cli_sets = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        add = key.startswith("+")
        key = key.lstrip("+")
        value = parse_value(raw)
        if isinstance(value, str):
            # YAML 1.1 does not type bare scientific notation ("1e-3");
            # coerce numeric-looking strings as Hydra/OmegaConf do.
            try:
                value = int(value)
            except ValueError:
                try:
                    value = float(value)
                except ValueError:
                    pass
        if key in group_choice or (key in ("model", "data") and isinstance(value, str)
                                   and os.path.isdir(os.path.join(config_dir, key))):
            group_choice[key] = value
            if key not in order:
                order.append(key)
        else:
            cli_sets.append((key, value, add))

    cfg: dict = ConfigDict()
    for g in order:
        group_cfg = _load_yaml(os.path.join(config_dir, g, f"{group_choice[g]}.yaml"))
        _merge(cfg, ConfigDict.wrap({g: group_cfg}))
    _merge(cfg, ConfigDict.wrap(root))
    for key, value, add in cli_sets:
        _set_dotted(cfg, key, value, allow_new=True)
    return ConfigDict.wrap(cfg)


def _dump_scalar(v) -> str:
    """One scalar as YAML that both this reader and PyYAML type back to
    ``v``."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        mantissa, e, exp = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + (e + (exp if exp[0] in "+-" else "+" + exp) if e else "")
    if isinstance(v, str):
        plain = (v and v == v.strip() and parse_scalar(v) == v
                 and not any(c in v for c in ":#'\"\n[]{},&*!|>%@`"))
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise ValueError(f"cannot write {type(v).__name__} {v!r} to the config snapshot")


def dumps(obj, indent: int = 0) -> str:
    """A mapping of scalars, lists and mappings as block YAML of the subset
    ``loads`` reads (lists at their key's indentation, as PyYAML writes
    them)."""
    lines = []
    pad = " " * indent
    for key, value in obj.items():
        k = _dump_scalar(key)
        if isinstance(value, dict):
            if not value:
                raise ValueError(f"cannot write the empty mapping at {key!r}")
            lines.append(f"{pad}{k}:")
            lines.append(dumps(value, indent + 2))
        elif isinstance(value, (list, tuple)):
            if not value:
                lines.append(f"{pad}{k}: []")
                continue
            lines.append(f"{pad}{k}:")
            for item in value:
                if isinstance(item, (dict, list, tuple)):
                    raise ValueError(f"cannot write a nested collection in list {key!r}")
                lines.append(f"{pad}- {_dump_scalar(item)}")
        else:
            lines.append(f"{pad}{k}: {_dump_scalar(value)}")
    return "\n".join(lines)


def save_config_snapshot(cfg, work_dir: str) -> str:
    """Write the composed config as ``<work_dir>/.hydra/config.yaml``, the
    run manifest that sampling and benchmarking read back (with this module
    or with PyYAML)."""
    hydra_dir = os.path.join(work_dir, ".hydra")
    os.makedirs(hydra_dir, exist_ok=True)
    path = os.path.join(hydra_dir, "config.yaml")
    plain = cfg.to_plain() if isinstance(cfg, ConfigDict) else cfg
    with open(path, "w") as f:
        f.write(dumps(plain) + "\n")
    return path


def load_hydra_config_from_run(load_dir: str) -> ConfigDict:
    """Read a run's ``.hydra/config.yaml`` manifest."""
    return ConfigDict.wrap(_load_yaml(os.path.join(load_dir, ".hydra", "config.yaml")))
