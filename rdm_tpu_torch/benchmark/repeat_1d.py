"""Run the legacy 1-D training CLI several times with one seed and compare
the loss sequences, with PyTorch's default algorithms and with
``torch.use_deterministic_algorithms(True)`` (and
``CUBLAS_WORKSPACE_CONFIG=:4096:8``), each run a process of its own:

    python -m rdm_tpu_torch.benchmark.repeat_1d --runs 2 -- \\
        --data_path datasets/training_data_boundary_80073.pkl --unet_dim 128 \\
        --unet_dim_mults 4,4,8 --embed_class_layers_dims 256,512 --timesteps 500 \\
        --batch_size 512 --max_epoch 1

The arguments after ``--`` are ``train_1d``'s (without ``--result_folder``).
Prints one JSON line: for each mode, whether the runs' losses are bit-equal,
the first step at which they differ, the largest relative difference, each
run's ms a step (host clock between the first and the last step's loss
read-back) and the losses.  The training CLI itself never sets the
deterministic mode; this script sets it in its own child processes.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

_CHILD = """
import sys, torch
if sys.argv[1] == "deterministic":
    torch.use_deterministic_algorithms(True)
from rdm_tpu_torch import train_1d
train_1d.main(sys.argv[2:])
"""


def run_once(mode: str, train_args, folder: str) -> dict:
    env = dict(os.environ)
    if mode == "deterministic":
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    subprocess.run([sys.executable, "-c", _CHILD, mode, *train_args, "--result_folder", folder],
                   env=env, check=True, stdout=subprocess.DEVNULL)
    (path,) = glob.glob(os.path.join(folder, "*", "metrics.jsonl"))
    with open(path) as f:
        steps = [m for m in map(json.loads, f) if "train_loss" in m]
    times = [m["time_s"] for m in steps]
    return {"losses": [m["train_loss"] for m in steps],
            "ms_per_step": 1e3 * (times[-1] - times[0]) / max(len(times) - 1, 1)}


def compare(runs) -> dict:
    a = np.asarray(runs[0]["losses"])
    drift = np.max([np.abs(np.asarray(r["losses"]) - a) / np.abs(a) for r in runs[1:]], axis=0)
    return {"bit_equal": bool((drift == 0).all()),
            "first_differing_step": int(np.argmax(drift > 0)) + 1 if (drift > 0).any() else None,
            "max_rel_diff": float(drift.max()),
            "ms_per_step": [r["ms_per_step"] for r in runs],
            "losses": [r["losses"] for r in runs]}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--modes", type=str, default="default,deterministic")
    args = p.parse_args(argv[:split])
    train_args = argv[split + 1:]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in args.modes.split(","):
            runs = [run_once(mode, train_args, os.path.join(tmp, f"{mode}{i}"))
                    for i in range(args.runs)]
            out[mode] = compare(runs)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
