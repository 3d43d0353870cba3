"""The port's launchers (rdm_tpu_torch/launch/) against the JAX package's
(launch/): the stall supervisor under a stub interpreter that exits 17, 17,
then 0, and the data-generation fan-out for real on the CPU."""
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rdm_tpu_torch import generate_data
from rdm_tpu_torch.datagen import prepare_training_data

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = textwrap.dedent("""\
    #!/usr/bin/env bash
    # a stand-in interpreter: logs its arguments, makes a run directory with
    # a meta checkpoint, and exits with the next of STUB_CODES
    n=$(cat "$STUB_DIR/count" 2>/dev/null || echo 0)
    n=$((n + 1))
    echo "$n" > "$STUB_DIR/count"
    printf '%s\\x1f' "$@" >> "$STUB_DIR/calls"
    echo >> "$STUB_DIR/calls"
    mkdir -p "Training Runs/run$n/checkpoints-meta"
    touch "Training Runs/run$n/checkpoints-meta/checkpoint.pth"
    codes=($STUB_CODES)
    i=$((n - 1))
    [ $i -ge ${#codes[@]} ] && i=$((${#codes[@]} - 1))
    exit ${codes[$i]}
""")


def _supervise(tmp_path, which, codes, **env_extra):
    """Run one package's train_with_resume.sh in a temporary tree with the
    stub first on PATH; returns (exit status, stdout, calls)."""
    base = tmp_path / which
    stub_dir = base / "stub"
    stub_dir.mkdir(parents=True)
    (stub_dir / "python").write_text(STUB)
    (stub_dir / "python").chmod(0o755)
    if which == "jax":       # it cds to the directory above its own
        script = base / "launch" / "train_with_resume.sh"
        script.parent.mkdir()
        shutil.copy(os.path.join(ROOT, "launch", "train_with_resume.sh"), script)
        cwd = base
    else:                    # it runs where the caller stands
        script = base / "rdm_tpu_torch" / "launch" / "train_with_resume.sh"
        script.parent.mkdir(parents=True)
        shutil.copy(os.path.join(ROOT, "rdm_tpu_torch", "launch", "train_with_resume.sh"),
                    script)
        cwd = base / "work"
        cwd.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHON"}
    env.update(PATH=f"{stub_dir}:{env['PATH']}", STUB_DIR=str(stub_dir),
               STUB_CODES=" ".join(map(str, codes)), **env_extra)
    proc = subprocess.run(["bash", str(script), "training.n_iters=5", "model.nf=16"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=60)
    lines = (stub_dir / "calls").read_text().splitlines() if (stub_dir / "calls").exists() \
        else []
    calls = [ln.split("\x1f")[:-1] for ln in lines]
    return proc.returncode, proc.stdout, calls


COMMAND = {"jax": ["run_train.py"], "port": ["-m", "rdm_tpu_torch.run_train"]}


def test_supervisor_restarts_like_the_jax_one(tmp_path):
    runs = {w: _supervise(tmp_path, w, [17, 17, 0]) for w in ("jax", "port")}
    args = {}
    for which, (code, out, calls) in runs.items():
        assert code == 0, out
        assert "[train_with_resume] completed after 2 restart(s)" in out
        assert "restart #1 from Training Runs/run1/checkpoints-meta/checkpoint.pth" in out
        assert len(calls) == 3
        n = len(COMMAND[which])
        assert all(c[:n] == COMMAND[which] for c in calls)
        args[which] = [c[n:] for c in calls]
    assert args["jax"] == args["port"]
    assert args["port"][0] == ["training.n_iters=5", "model.nf=16",
                               "training.stall_timeout_s=600"]
    assert args["port"][2][-1] == "checkpoint_path=Training Runs/run2/checkpoints-meta/checkpoint.pth"


@pytest.mark.parametrize("which", ["jax", "port"])
def test_supervisor_aborts_on_other_failures(tmp_path, which):
    code, out, calls = _supervise(tmp_path, which, [3])
    assert code == 3 and len(calls) == 1
    assert "non-stall failure (exit 3); aborting" in out


@pytest.mark.parametrize("which", ["jax", "port"])
def test_supervisor_gives_up_after_max_restarts(tmp_path, which):
    code, out, calls = _supervise(tmp_path, which, [17], MAX_RESTARTS="1", STALL_TIMEOUT="9")
    assert code == 1 and len(calls) == 2
    assert "gave up after 1 restarts" in out
    assert calls[0][-1] == "training.stall_timeout_s=9"


def _pickle_of(folder):
    (name,) = [f for f in os.listdir(folder) if f.startswith("training_data_boundary_")]
    with open(os.path.join(folder, name), "rb") as f:
        return name, pickle.load(f)


def test_fanout_merges_what_one_call_makes(tmp_path):
    """Two workers of three seeds each (seed 4, the first feasible one of
    the native oracle's uniform guesses, falls to the second), their result
    files merged by the port's prepare_training_data, against one
    generate_data call over seeds 0-5 and the same merge."""
    extra = ["--backend", "native", "--device", "cpu", "--save_infeasible"]
    out = tmp_path / "fan"
    env = dict(os.environ, WORKERS="2", SEEDS_PER_WORKER="3", RESULT_FOLDER=str(out),
               PYTHON=sys.executable, OMP_NUM_THREADS="1")
    proc = subprocess.run(["bash", os.path.join(ROOT, "rdm_tpu_torch", "launch",
                                                "datagen_fanout.sh"), *extra],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = tmp_path / "one"
    generate_data.main(["--seed", "0", "--seed_step", "6", "--result_folder", str(one),
                        *extra])
    assert sorted(os.listdir(out)) == sorted(os.listdir(one)) + [_pickle_of(out)[0]]
    n = prepare_training_data(str(one))
    name, merged = _pickle_of(out)
    assert name == f"training_data_boundary_{n}.pkl" and n >= 1
    want = _pickle_of(one)[1]
    assert merged.shape == (n, 67) and np.isfinite(merged).all()
    np.testing.assert_array_equal(merged, want)
