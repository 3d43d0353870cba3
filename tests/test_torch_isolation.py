"""The port runs where JAX, flax, optax, PyYAML, sklearn and matplotlib are
absent, and imports nothing of the JAX package or of its ``scripts/``; a
1-D checkpoint that the JAX package wrote (in this process, before the
blocked one starts) restores there."""
import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "rdm_tpu", "scripts", "sklearn",
           "matplotlib")

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

    # evaluation: the round-2 record through the inverse pipeline, the ML
    # metrics and the native oracle (the port's own halo table and library)
    import json, pickle, types
    import numpy as np
    from rdm_tpu_torch.benchmark import GTOHaloBenchmarker, MLStatisticsBenchmarker
    from rdm_tpu_torch.benchmark.ml_statistics import save_plots_or_say
    from rdm_tpu_torch.physics.oracle import evaluate_warmstarts_native
    rec = "benchmark_results/round2_flagship_1024/"
    raw = np.load(rec + "ml_statistics/generated_samples.npy")
    g = GTOHaloBenchmarker.__new__(GTOHaloBenchmarker)
    g.lm = types.SimpleNamespace(cfg=cfg)
    g.total_spherical_clips = g.total_spherical_elements = 0
    phys = g._inverse_pipeline(raw)
    assert g.total_spherical_clips == 2050
    assert np.abs(phys - np.load(rec + "gto_halo/generated_samples.npy")).max() < 1e-8
    with open("datasets/training_data_boundary_80073.pkl", "rb") as f:
        ref = np.asarray(pickle.load(f))
    sm = MLStatisticsBenchmarker.__new__(MLStatisticsBenchmarker).compute_standard_metrics(raw, ref)
    with open(rec + "ml_statistics/ml_statistics_results.json") as f:
        want = json.load(f)["standard_metrics"]
    assert all(abs(sm[k] - want[k]) <= 1e-9 * abs(want[k]) for k in want), sm
    graded = evaluate_warmstarts_native(phys[:4, 1:], phys[:4, 0])
    assert graded["feasible"].shape == (4,) and np.isfinite(graded["cost"]).all()
    save_plots_or_say(lambda plt: None)     # prints that the plots were skipped

    # the other families: the goldens load and run, a checkpoint round-trips
    import torch
    from rdm_tpu_torch.models import adm, vdm
    g = np.load("tests/golden/adm_golden.npz")
    m = adm.ADM(img_resolution=16, label_dim=10, model_channels=32, channel_mult=(1, 2),
                channel_mult_emb=2, num_blocks=1, attn_resolutions=(8,), dropout=0.0)
    m.load_state_dict(dict((k[3:], torch.from_numpy(g[k])) for k in g.files
                           if k.startswith("sd.")))
    with torch.no_grad():
        out = m(torch.from_numpy(g["x"]), torch.from_numpy(g["noise_labels"]),
                torch.from_numpy(g["onehot"]))
    assert np.abs(out.numpy() - g["out"]).max() < 1e-4
    from rdm_tpu_torch.config import load_config
    from rdm_tpu_torch.training.state import init_train_state
    vcfg = load_config("train", ["data=cifar10", "model=vdm", "model.channels=8",
                                 "model.num_blocks=1"])
    v = init_train_state(vdm.VDM.from_config(vcfg).init_weights(torch.Generator()), vcfg)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoints.save_checkpoint(tmp + "/c.pth", v, config=vcfg)
        ck = checkpoints.restore_checkpoint(tmp + "/c.pth")
        checkpoints.load_into_state(v, ck)
        assert "enc.0.conv1.weight" in ck.model and ck.optimizer["count"] == 0

        # data generation on the native oracle, and its training pickle
        from rdm_tpu_torch import datagen, generate_data
        summary = generate_data.main(["--backend", "native", "--seed", "4", "--seed_step", "1",
                                      "--result_folder", tmp + "/gd"])
        assert summary["n_feasible"] == 1
        assert datagen.prepare_training_data(tmp + "/gd") == 1

    # the legacy 1-D pipeline: a checkpoint the JAX package wrote restores
    # (optax's state classes through the restricted unpickler), and the two
    # CLIs train one epoch and sample from its checkpoint on the CPU
    from rdm_tpu_torch import sample_1d, train_1d
    from rdm_tpu_torch.diffusion1d import GaussianDiffusion1D
    from rdm_tpu_torch.diffusion1d.trainer1d import Trainer1D
    from rdm_tpu_torch.models.unet1d import UNet1D
    ck1 = checkpoints.restore_unet1d_checkpoint({jax_1d!r})
    assert ck1.step == 3 and ck1.optimizer["count"] == 1 and ck1.ema is not None
    m1 = UNet1D(dim=8, dim_mults=(1, 2), embed_class_layers_dims=(8, 8), seq_length=66,
                legacy=True)
    m1.load_state_dict(ck1.model, strict=True)
    assert all(float(v.abs().max()) > 0 for v in ck1.optimizer["nu"].values())
    flags = ["--unet_dim", "8", "--unet_dim_mults", "1,2", "--embed_class_layers_dims", "8,8",
             "--timesteps", "4", "--device", "cpu"]
    with tempfile.TemporaryDirectory() as tmp:
        pkl = make_synthetic_gto_pkl(os.path.join(tmp, "d.pkl"), n=32)
        tr = train_1d.main(["--data_path", pkl, "--batch_size", "8", "--max_epoch", "1",
                            "--training_data_num", "32", "--result_folder", tmp, *flags])
        ckpt = os.path.join(str(tr.results_folder), "model-epoch-1.pt")
        full = sample_1d.main(["--checkpoint", ckpt, "--sample_num", "4", "--batch_size", "4",
                               "--output", os.path.join(tmp, "s.pkl"), *flags])
    assert full.shape == (4, 67) and np.isfinite(full).all()
    assert not [m for m in sys.modules if blocked(m)]
    print("ISOLATED-OK")
""")


def write_jax_1d_checkpoint(folder) -> str:
    """A ``model-epoch-1.pt`` written by the JAX package's ``Trainer1D.save``
    at dim 8: constant weights, one Adam update, step 3."""
    import pathlib

    import jax
    import numpy as np
    import optax

    from rdm_tpu.diffusion1d.trainer1d import Trainer1D
    from rdm_tpu.models.unet1d import UNet1D

    model = UNet1D(dim=8, dim_mults=(1, 2), embed_class_layers_dims=(8, 8), seq_length=66,
                   legacy=True)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            np.zeros((2, 66, 1), np.float32), np.zeros(2, np.float32),
                            np.zeros((2, 1), np.float32))["params"]
    params = jax.tree.map(lambda s: np.full(s.shape, 0.1, np.float32), shapes)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4, b1=0.9, b2=0.99))
    jt = Trainer1D.__new__(Trainer1D)
    jt.results_folder, jt.step = pathlib.Path(folder), 3
    jt.params = jt.ema_params = params
    jt.opt_state = jax.jit(lambda p: tx.update(p, tx.init(p), p)[1])(params)
    jt.save("epoch-1")
    return str(jt.results_folder / "model-epoch-1.pt")


def test_port_runs_without_jax_optax_yaml(tmp_path):
    jax_1d = write_jax_1d_checkpoint(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(blocked=BLOCKED, jax_1d=jax_1d)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout
    assert "matplotlib is not installed: plots skipped" in proc.stdout


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, "rdm_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        files += [os.path.join(dirpath, f) for f in filenames if not f.endswith(".npz")]
    return files


def test_port_sources_never_name_jax_or_the_jax_package():
    pattern = re.compile(r"\bjax\b|\bjaxlib\b|\bflax\b|rdm_tpu\.|import yaml|from yaml")
    files = _port_files()
    assert any(f.endswith("fused_attn_block.cu") for f in files)
    # the oracle's backend names keep the JAX package's CLI choices, one of
    # which is the string "jax"; that file may name it as a string
    backend_names = os.path.join(ROOT, "rdm_tpu_torch", "physics", "oracle.py")
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                if path == backend_names:
                    line = line.replace('"jax"', '""')
                if pattern.search(line):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{n}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
