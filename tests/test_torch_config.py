"""The port's YAML-subset reader and config composition against PyYAML and
the JAX package's ``config.py`` (exact equality, types included)."""
import glob
import os

import pytest
import yaml

from rdm_tpu.config import load_config as jax_load_config
from rdm_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(
    glob.glob(os.path.join(ROOT, "rdm_tpu", "configs", "**", "*.yaml"), recursive=True)
    + glob.glob(os.path.join(ROOT, "rdm_tpu_torch", "configs", "**", "*.yaml"), recursive=True)
    + glob.glob(os.path.join(ROOT, "Training Runs", "*", ".hydra", "config.yaml")))


def _typed(obj):
    """Value with every leaf's type spelled out, so 1 != 1.0 != True."""
    if isinstance(obj, dict):
        return {k: _typed(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_typed(v) for v in obj]
    return (type(obj).__name__, obj)


def test_config_files_found():
    names = [os.path.relpath(p, ROOT) for p in YAML_FILES]
    assert "Training Runs/2026.08.17_184657/.hydra/config.yaml" in names
    assert len([n for n in names if n.startswith("rdm_tpu/configs")]) >= 10


@pytest.mark.parametrize("path", YAML_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_reader_equals_safe_load(path):
    with open(path) as f:
        expected = yaml.safe_load(f)
    assert _typed(tconfig.load_yaml(path)) == _typed(expected)


@pytest.mark.parametrize("text", [
    "1e-8", "0.", "1.", "???", "5", "-3", "0.0005", "+1.5e+3", "1.0e-3", "1e3",
    "true", "True", "yes", "on", "off", "No", "null", "~", "Null", "0x1F", "010",
    "0b101", "1_000", "1:30", ".inf", "-.inf", "abc def", "'quoted'", '"dq"',
    "[1, 2, 2]", "[]", "[a, 1e-3, 0.5, null]", "Training Runs/x/checkpoint.pth",
])
def test_scalar_typing_equals_safe_load(text):
    assert _typed(tconfig.parse_value(text)) == _typed(yaml.safe_load(text))


def test_eps_stays_a_string():
    # YAML 1.1 has no bare exponent floats: ``eps: 1e-8`` loads as a string.
    cfg = tconfig.load_hydra_config_from_run(
        os.path.join(ROOT, "Training Runs", "2026.08.17_184657"))
    assert cfg.optim.eps == "1e-8"
    assert cfg.model.attn_pallas is True and cfg.model.precision == "bfloat16"
    assert cfg.model.init_scale == 0.0 and isinstance(cfg.model.init_scale, float)


def test_block_structure():
    text = ("a:\n  b: 1   # trailing comment\n  c:\n  - 1\n  - x\n"
            "# full-line comment\nd:\n- _self_\n- model: ncsnpp\n- data: gto\n"
            "e: [1, 2]\nf:\ng: '# not a comment'\n")
    assert tconfig.loads(text) == yaml.safe_load(text)


def test_unsupported_yaml_raises():
    with pytest.raises(ValueError):
        tconfig.loads("a: {b: 1}\n")


@pytest.mark.parametrize("overrides", [
    [],
    ["model.nf=16", "model.ch_mult=[1,2]", "optim.eps=1e-6", "+foo.bar=3",
     "sampling.snr=0.1", "data=gto_halo", "training.snapshot_sampling=false"],
])
def test_load_config_matches_jax(overrides):
    ours = tconfig.load_config("train", overrides,
                               config_dir=os.path.join(ROOT, "rdm_tpu", "configs"))
    assert _typed(ours.to_plain()) == _typed(jax_load_config("train", overrides).to_plain())


def test_port_configs_match_jax_configs():
    # The port keeps its own copies; they compose to the same config.
    for name, ov in (("train", []), ("vis", ["load_dir=x", "eval.batch_size=4"])):
        assert _typed(tconfig.load_config(name, ov).to_plain()) == \
            _typed(jax_load_config(name, ov).to_plain())
