"""Float32 data generation from uniform guesses at both packages' defaults
(``--backend tpu``: float32, tol 1e-3, 30 LM iterations, optimal mode):
``generate_data --device cpu`` (the port's kernels' plain versions) against
the root ``generate_data.py`` (the JAX package's ``refine_warmstarts_tpu``
on the CPU) and the native oracle, all three CLIs unedited.

From a uniform guess a float32 solve mostly stalls above the tolerance
where the float64 native oracle converges, and which seeds it solves its
rounding decides (the JAX package's note on float32 Jacobians of sensitive
lanes, ``solver_tpu.py:694-700``).  On this window the two CLIs' feasible
sets are equal, one of the native oracle's four seeds.  The JAX package's
own verdicts on the same seeds change with the size of the tile it solves
them in: seeds 2186, 2192, 2199 and 2207 in tiles of 1024
(``chip_smoke.JAX_F32_FEASIBLE``), 2186, 2192 and 2199 in a tile of 24,
2207 in the CLI's tile of 32.  So on the card, where the port's CLI solves
the 4096 seeds in one tile, ``chip_smoke.py`` phase ``datagen`` holds its
float32 verdicts to the JAX package's in their recall of the native
oracle's feasible seeds, not lane by lane; the slow test below recomputes
the JAX package's verdicts it uses."""
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_datagen import load_root

import chip_smoke
import rdm_tpu.datagen as jdatagen
from rdm_tpu.physics.solver_tpu import refine_warmstarts_tpu
from rdm_tpu_torch import datagen, generate_data
from rdm_tpu_torch.physics import oracle, solver_gpu

torch.set_num_threads(1)  # the suite runs in parallel worker processes

# seeds 2184-2207: the densest run of the JAX package's float32-feasible
# seeds in chip_smoke's 4096 (four of its 42)
WINDOW = range(2184, 2208)
NATIVE_WINDOW = {2194, 2199, 2201, 2207}
F32_WINDOW = {2207}     # both CLIs' float32 verdicts, measured


def feasible_seeds(folder) -> set:
    return {int(name.rsplit("_seed_", 1)[1][:-4]) for name in os.listdir(folder)
            if name.startswith("feasible_")}


def test_uniform_guesses_at_the_defaults_against_jax(tmp_path):
    args = ["--seed", str(WINDOW[0]), "--seed_step", str(len(WINDOW))]
    ours, theirs, native = tmp_path / "ours", tmp_path / "theirs", tmp_path / "native"
    generate_data.main(args + ["--backend", "native", "--result_folder", str(native)])
    summary = generate_data.main(args + ["--backend", "tpu", "--device", "cpu",
                                         "--result_folder", str(ours)])
    load_root("generate_data.py", "root_generate_data_uniform").main(
        args + ["--backend", "tpu", "--result_folder", str(theirs)])
    assert summary["n"] == len(WINDOW)

    nat, port, jax_f32 = (feasible_seeds(f) for f in (native, ours, theirs))
    assert nat == NATIVE_WINDOW
    assert port == jax_f32 == F32_WINDOW
    assert jax_f32 <= set(chip_smoke.JAX_F32_FEASIBLE)
    assert 0 < len(port & nat) <= len(nat) // 2      # a small share of the native oracle's

    # every seed a float32 solve calls feasible is a float64 solution
    rows, energies = [], []
    for folder in (ours, theirs):
        for name in sorted(os.listdir(folder)):
            with open(folder / name, "rb") as f:
                result = pickle.load(f)[0]
            row = np.array(result["results.control"], np.float64)
            row[-2] /= datagen.get_halo_period(result["cost_alpha"])   # TU -> phase fraction
            rows.append(row)
            energies.append(result["cost_alpha"])
    cost = solver_gpu.refine_warmstarts_gpu(np.stack(rows), np.array(energies), max_iters=0,
                                            solver_mode="feasible", precision="f64",
                                            device="cpu")["cost"]
    assert (cost < oracle._DEFECT_TOL_LOOSE).all(), cost


@pytest.mark.slow  # the JAX package's float32 solve of 4096 lanes: about 13 minutes on the CPU
def test_jax_float32_feasible_seeds():
    """``chip_smoke.JAX_F32_FEASIBLE``: the seeds of 0-4095 that the JAX
    package's float32 solve finds feasible at its defaults, in tiles of 1024."""
    gen = jdatagen.CR3BPInitGenerator("uniform_sample", 1.0, 408, 470, 5.0, 11.0)
    drawn = [gen.get_earth_initial_guess(s, 20, 40.0, 0.0) for s in range(chip_smoke.GEN_SEEDS)]
    res = refine_warmstarts_tpu(np.stack([g[0] for _, g in drawn]),
                                np.array([e for e, _ in drawn]), batch_tile=1024)
    assert tuple(np.flatnonzero(res["feasible"])) == chip_smoke.JAX_F32_FEASIBLE
