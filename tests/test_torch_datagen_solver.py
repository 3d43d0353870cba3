"""``generate_data --backend tpu --device cpu`` (the port's float32 GPU solver,
its kernels' plain versions on the CPU) against the root
``generate_data.py --backend tpu`` (the JAX package's ``refine_warmstarts_tpu``
on the CPU), both unedited CLIs on the same warm starts.

The agreement rule is ``tests/test_torch_solver_f32.py``'s: from
near-solutions, one LM iteration at the tolerance 1e-2 (above the float32
solves' floor at the 1e-3 default, where two float32 solvers that round
differently decide a lane either way), the same lanes feasible after the
same number of iterations, and the solved variables within 1e-2 on the lanes
both solved.  The warm starts replace both packages' uniform draws, and the
tolerance both solvers' default, for this test only."""
import functools
import os
import pickle

import numpy as np
import torch

from test_torch_datagen import load_root
from test_torch_solver import near_solutions

import rdm_tpu.datagen as jdatagen
import rdm_tpu.physics.solver_tpu as jsolver
from rdm_tpu_torch import datagen, generate_data
from rdm_tpu_torch.physics import solver_gpu

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def test_tpu_backend_matches_jax_on_cpu(tmp_path, monkeypatch):
    G, H = near_solutions()

    def guesses(self, seed, *args):
        return float(H[seed]), [G[seed].copy()]

    monkeypatch.setattr(datagen.CR3BPInitGenerator, "get_earth_initial_guess", guesses)
    monkeypatch.setattr(jdatagen.CR3BPInitGenerator, "get_earth_initial_guess", guesses)
    monkeypatch.setattr(solver_gpu, "refine_warmstarts_gpu",
                        functools.partial(solver_gpu.refine_warmstarts_gpu, tol=1e-2))
    monkeypatch.setattr(jsolver, "refine_warmstarts_tpu",
                        functools.partial(jsolver.refine_warmstarts_tpu, tol=1e-2))
    root_cli = load_root("generate_data.py", "root_generate_data_tpu")
    args = ["--backend", "tpu", "--seed", "0", "--seed_step", str(len(G)), "--max_iters", "1",
            "--solver_mode", "feasible", "--save_infeasible"]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    summary = generate_data.main(args + ["--device", "cpu", "--result_folder", str(ours)])
    root_cli.main(args + ["--result_folder", str(theirs)])

    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and len(names) == len(G)   # the same verdicts
    assert summary["n_feasible"] >= 3
    assert summary["launches"] == {"shoot_legs": 0, "manifold_target": 0, "shoot_jvp": 0}
    per_iter = solver_gpu.NVAR + solver_gpu._N_LAMBDA
    for name in names:
        with open(ours / name, "rb") as f:
            a = pickle.load(f)[0]
        with open(theirs / name, "rb") as f:
            b = pickle.load(f)[0]
        # the same iterations: 74 shoots an iteration here, the JAX package's 15
        assert a["snopt_control_evaluations"] // per_iter == b["snopt_control_evaluations"] // 15
        assert a["snopt_inform"] == b["snopt_inform"] and a["cost_alpha"] == b["cost_alpha"]
        if a["feasibility"]:
            period = datagen.get_halo_period(a["cost_alpha"])
            x, y = (np.array(r["results.control"]) for r in (a, b))
            x[-2], y[-2] = x[-2] / period, y[-2] / period       # TU -> phase fraction
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-2, err_msg=name)
