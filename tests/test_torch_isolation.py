"""The port runs where JAX, flax, optax and PyYAML are absent, and imports
nothing of the JAX package."""
import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "rdm_tpu")

SCRIPT = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = {blocked!r}

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    for name in list(sys.modules):
        if blocked(name):
            del sys.modules[name]

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    for name in BLOCKED:
        try:
            __import__(name)
        except ImportError:
            pass
        else:
            raise SystemExit("finder failed to block " + name)

    import pkgutil
    import rdm_tpu_torch
    for mod in pkgutil.walk_packages(rdm_tpu_torch.__path__, "rdm_tpu_torch."):
        __import__(mod.name)
    import chip_smoke

    from rdm_tpu_torch.benchmark.common import LoadedModel, generate_raw_samples
    from rdm_tpu_torch.config import load_hydra_config_from_run
    from rdm_tpu_torch.sde import RVESDE

    run = "Training Runs/2026.08.17_184657"
    cfg = load_hydra_config_from_run(run)
    assert cfg.model.attn_pallas is True and cfg.optim.eps == "1e-8"
    lm = LoadedModel(run, device="cpu")
    assert lm.step == 100001
    flat, times = generate_raw_samples(lm, 2, 2, sde_override=RVESDE(0.01, 5, 3))
    assert flat.shape == (2, 67) and 0.0 <= flat.min() and flat.max() <= 1.0
    assert not [m for m in sys.modules if blocked(m)]
    print("ISOLATED-OK")
""")


def test_port_runs_without_jax_optax_yaml():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, "rdm_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        files += [os.path.join(dirpath, f) for f in filenames]
    return files


def test_port_sources_never_name_jax_or_the_jax_package():
    pattern = re.compile(r"\bjax\b|\bjaxlib\b|\bflax\b|rdm_tpu\.|import yaml|from yaml")
    files = _port_files()
    assert any(f.endswith("fused_attn_block.cu") for f in files)
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                if pattern.search(line):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{n}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
