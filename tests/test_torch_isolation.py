"""The port runs where JAX, flax, optax and PyYAML are absent, and imports
nothing of the JAX package or of its ``scripts/``."""
import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "rdm_tpu", "scripts")

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

    # training: the flagship's optimizer state restores, and the CLI trains,
    # logs, checkpoints and samples
    import os, tempfile
    from rdm_tpu_torch import run_train
    from rdm_tpu_torch.data import make_synthetic_gto_pkl
    from rdm_tpu_torch.training import checkpoints
    ck = checkpoints.restore_checkpoint(run + "/checkpoints/checkpoint_10.pth")
    assert ck.optimizer["count"] == 100000
    root = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        pkl = make_synthetic_gto_pkl(os.path.join(tmp, "t.pkl"), n=16)
        work = run_train.main(["+device=cpu", "model.nf=16", "model.ch_mult=[1,2]",
                               "model.num_res_blocks=1", "model.attn_pallas=true",
                               "data.pkl_path=" + pkl, "training.batch_size=4",
                               "eval.batch_size=4", "training.n_iters=1",
                               "training.snapshot_freq=1", "sde.num_scales=3"])
        assert os.path.exists(os.path.join(work, "checkpoints", "checkpoint_1.pth"))
        assert "training_loss" in open(os.path.join(work, "logs")).read()
        os.chdir(root)
    assert not [m for m in sys.modules if blocked(m)]
    print("ISOLATED-OK")
""")


def test_port_runs_without_jax_optax_yaml():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
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
