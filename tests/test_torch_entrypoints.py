"""The port's entry points: device selection, the run_vis CLI and the bench
module, on the CPU at tiny sizes."""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from rdm_tpu_torch import bench, run_vis
from rdm_tpu_torch.benchmark.common import LoadedModel, sampling_efficiency_metrics
from rdm_tpu_torch.config import load_config
from rdm_tpu_torch.device import resolve_device
from rdm_tpu_torch.models import NCSNpp
from rdm_tpu_torch.models.convert import ema_param_order

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoadedModel(os.path.join(ROOT, "Training Runs", "2026.08.17_184657"))
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def tiny_run(tmp_path):
    """A run directory in the reference layout: .hydra/config.yaml and a
    torch-pickle checkpoint with model, EMA list and step."""
    cfg = load_config("train", ["model.nf=16", "model.ch_mult=[1,2]",
                                "model.num_res_blocks=1", "sde.num_scales=4"])
    run = tmp_path / "run"
    (run / ".hydra").mkdir(parents=True)
    (run / "checkpoints").mkdir()
    with open(run / ".hydra" / "config.yaml", "w") as f:
        yaml.safe_dump(cfg.to_plain(), f, sort_keys=False)
    model = NCSNpp.from_config(cfg).init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    shadow = [sd[k] + 0.01 for k in ema_param_order(sd)]
    torch.save({"step": 7, "model": sd, "optimizer": {},
                "ema": {"decay": 0.999, "num_updates": 7, "shadow_params": shadow},
                "scaler": None, "config": cfg.to_plain()},
               run / "checkpoints" / "checkpoint_1.pth")
    return run


def test_loaded_model_takes_ema_weights(tiny_run):
    lm = LoadedModel(str(tiny_run), device="cpu")
    sd = lm.model.state_dict()
    raw = torch.load(tiny_run / "checkpoints" / "checkpoint_1.pth", weights_only=False)
    key = ema_param_order(sd)[3]
    assert torch.equal(sd[key], raw["model"][key] + 0.01)
    assert lm.step == 7 and lm.model.dtype == torch.float32   # train.yaml: no precision key


def test_run_vis_writes_samples(tiny_run, tmp_path):
    out = run_vis.main([f"load_dir={tiny_run}", "eval.batch_size=2", "eval.rounds=2",
                        "+device=cpu"], out_root=str(tmp_path / "vis"))
    for r in range(2):
        with np.load(os.path.join(out, "images", f"samples_{r}.npz")) as z:
            s = z["samples"]
        assert s.shape == (2, 9, 9, 1) and s.dtype == np.uint8


def test_run_vis_turns_on_the_resblock_kernel(tiny_run, tmp_path, monkeypatch):
    """``model.resblock_pallas=true`` (with bfloat16) routes every resblock
    of the loaded model through the fused block."""
    from rdm_tpu_torch.models.layers import ResnetBlockDDPMpp
    from rdm_tpu_torch.ops import resblock as rb_ops

    calls = []
    apply = rb_ops.FusedResblockFn.apply
    monkeypatch.setattr(rb_ops.FusedResblockFn, "apply", lambda *a: calls.append(1) or apply(*a))
    out = run_vis.main([f"load_dir={tiny_run}", "eval.batch_size=2", "+device=cpu",
                        "model.resblock_pallas=true", "model.precision=bfloat16"],
                       out_root=str(tmp_path / "vis"))
    with np.load(os.path.join(out, "images", "samples_0.npz")) as z:
        assert z["samples"].shape == (2, 9, 9, 1)
    n_blocks = sum(isinstance(m, ResnetBlockDDPMpp) for m in NCSNpp(
        nf=16, ch_mult=(1, 2), num_res_blocks=1).modules())
    assert n_blocks == 8 and len(calls) == n_blocks * 3     # sde.num_scales 4: 3 steps
    lm = LoadedModel(str(tiny_run), device="cpu", model_overrides={"resblock_pallas": True})
    assert all(m.use_kernel for m in lm.model.modules() if isinstance(m, ResnetBlockDDPMpp))


def test_bench_prints_one_json_line(capsys):
    bench.main(["--batch", "2", "--steps", "3", "--repeats", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["value"] > 0 and out["value_cfg_w0.1"] > 0 and out["device"] == "cpu"


def test_micro_cf_prints_the_tpu_scripts_lines_on_the_cpu(monkeypatch):
    """``python -m rdm_tpu_torch.scripts.micro_cf --device cpu --tb 2`` prints
    the TPU script's lines in its order (device, conv, dots K 64, dots
    K 192, roll, transpose pair), host-clock times only; without a card and
    without ``--device`` it raises."""
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "rdm_tpu_torch.scripts.micro_cf",
                           "--device", "cpu", "--tb", "2"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 6, lines
    heads = ["device: cpu", "cuDNN conv3x3 NHWC (TB=2):", "9 dots (C=64,K=64)@(K,N=162):",
             "3 dots (C=64,K=192)@(K,N=162):", "8 masked lane-rolls (C,N):",
             "transpose pair (N,C)<->(C,N):"]
    for line, head in zip(lines, heads):
        assert line.startswith(head), (line, head)
    for line in lines[1:]:
        assert float(line.split("chained")[1].split("us")[0]) > 0
        assert "bound" not in line and "cold" not in line     # no card numbers from the CPU
    assert all("TF/s" in line for line in lines[1:4])

    from rdm_tpu_torch.scripts import micro_cf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        micro_cf.main([])


def test_sampling_efficiency_metrics():
    m = sampling_efficiency_metrics([1.0, 3.0])
    assert m["total_sampling_time"] == 4.0 and m["samples_per_second"] == 0.5


class _Foreign:
    """A class the checkpoint unpickler must refuse to construct."""


def test_checkpoint_unpickler_refuses_foreign_globals(tmp_path):
    import pickle

    from rdm_tpu_torch.training.checkpoints import restore_checkpoint

    path = tmp_path / "bad.pth"
    torch.save({"step": 1, "model": {}, "payload": _Foreign()}, path)
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        restore_checkpoint(str(path))


def test_checkpoint_unpickler_maps_numpy_core_for_old_numpy(monkeypatch):
    import importlib
    import io
    import pickle
    import warnings

    from rdm_tpu_torch.training import checkpoints

    up = checkpoints.RestrictedUnpickler(io.BytesIO(b""))
    assert up.find_class("optax._src.base", "EmptyState") is checkpoints.OptimizerStateStub
    monkeypatch.setattr(checkpoints, "_NUMPY_MAJOR", 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # numpy >= 2 warns on numpy.core
        fn = up.find_class("numpy._core.multiarray", "_reconstruct")
        expected = importlib.import_module("numpy.core.multiarray")._reconstruct
    assert fn is expected
    with pytest.raises(pickle.UnpicklingError):
        up.find_class("optax._src.transform", "SomethingElse")
