"""The port's training CLI on the CPU with a tiny config: run directory,
log lines the telemetry parser reads, checkpoints, snapshot samples, and a
resume from the meta checkpoint."""
import os

import numpy as np
import pytest
import torch

from rdm_tpu_torch import run_train
from rdm_tpu_torch.config import load_hydra_config_from_run
from rdm_tpu_torch.data import make_synthetic_gto_pkl
from rdm_tpu_torch.training import checkpoints
from telemetry.plot_losses import parse_log_file

torch.set_num_threads(1)  # the suite runs in parallel worker processes

TINY = ["+device=cpu", "model.nf=16", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
        "model.precision=bfloat16", "model.attn_pallas=true", "data.gto_mean=0",
        "data.gto_std=1", "training.batch_size=8", "eval.batch_size=16",
        "training.log_freq=1", "training.eval_freq=2", "training.snapshot_freq=3",
        "training.snapshot_freq_for_preemption=2", "sde.num_scales=4"]


@pytest.fixture
def first_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pkl = make_synthetic_gto_pkl(str(tmp_path / "train.pkl"), n=40)
    work_dir = run_train.main(TINY + [f"data.pkl_path={pkl}", "training.n_iters=3"])
    return tmp_path / work_dir, pkl


def test_run_train_on_cpu(first_run):
    run, _ = first_run
    cfg = load_hydra_config_from_run(str(run))
    assert cfg.model.nf == 16 and cfg.device == "cpu" and cfg.optim.eps == "1e-8"
    train_steps, train_losses, eval_steps, eval_losses = parse_log_file(str(run / "logs"))
    assert train_steps == [0, 1, 2, 3] and eval_steps == [0, 2]
    assert np.all(np.isfinite(train_losses)) and np.all(np.isfinite(eval_losses))
    ckpt = checkpoints.restore_checkpoint(str(run / "checkpoints" / "checkpoint_1.pth"))
    assert ckpt.step == 4 and ckpt.optimizer["count"] == 4 and ckpt.ema_num_updates == 4
    meta = checkpoints.restore_checkpoint(str(run / "checkpoints-meta" / "checkpoint.pth"))
    assert meta.step == 3
    sample = np.load(run / "samples" / "iter_3" / "sample_0.npy")
    assert sample.shape == (8, 1, 9, 9) and sample.dtype == np.uint8


def test_run_train_resumes_from_meta_checkpoint(first_run, monkeypatch):
    run, pkl = first_run
    meta = run / "checkpoints-meta" / "checkpoint.pth"
    saved = checkpoints.restore_checkpoint(str(meta))
    work_dir = run_train.main(TINY + [f"data.pkl_path={pkl}", "training.n_iters=5",
                                      f"checkpoint_path={meta}"])
    steps = parse_log_file(os.path.join(work_dir, "logs"))[0]
    assert steps[-3:] == [3, 4, 5]          # went on from the meta checkpoint's step 3
    final = checkpoints.restore_checkpoint(os.path.join(work_dir, "checkpoints",
                                                        "checkpoint_1.pth"))
    assert final.step == 6 and final.optimizer["count"] == saved.optimizer["count"] + 3
    assert not torch.equal(final.model["out_conv.weight"], saved.model["out_conv.weight"])
