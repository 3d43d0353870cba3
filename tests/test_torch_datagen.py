"""The port's data generation against the JAX package's: initial guesses,
normalisation, the per-seed CLI on the native oracle, and the fleet script's
draws and state file.

Tolerances: guesses and the native oracle's files are bit-equal (the same
seeds, the same C++ source); normalised rows agree to 1e-6 (each package
reads its own halo family table)."""
import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

import rdm_tpu.datagen as jdatagen
from rdm_tpu_torch import datagen, generate_data
from rdm_tpu_torch.physics.oracle import nlp_box
from rdm_tpu_torch.scripts import generate_dataset

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_root(relpath, name):
    """A script of the JAX package loaded from its file, unedited."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generators(mode="uniform_sample", **kw):
    args = dict(initial_guess_sample_mode=mode, thrust=1.0, min_mass_to_sample=408,
                max_mass_to_sample=470, min_manifold_length=5.0, max_manifold_length=11.0, **kw)
    return datagen.CR3BPInitGenerator(**args), jdatagen.CR3BPInitGenerator(**args)


@pytest.mark.parametrize("seed", [0, 1, 17, 4095, 123456])
def test_uniform_guesses_are_the_jax_packages(seed):
    ours, theirs = generators()
    (e, [g]), (ej, [gj]) = (gen.get_earth_initial_guess(seed, 20, 40.0, 0.0)
                            for gen in (ours, theirs))
    assert e == ej and g.dtype == gj.dtype and np.array_equal(g, gj) and g.shape == (66,)


def test_file_modes_are_the_jax_packages(tmp_path):
    path = tmp_path / "one.pkl"
    with open(path, "wb") as f:
        pickle.dump([{"cost_alpha": 0.05, "results.control": np.arange(66.0)}], f)
    ours, theirs = generators("from_pickle", pickle_path=str(path))
    (e, [g]), (ej, [gj]) = (gen.get_earth_initial_guess(0, 20, 40.0, 0.0)
                            for gen in (ours, theirs))
    assert e == ej and np.array_equal(g, gj)
    gt = np.linspace(0, 1, 66)
    ours, theirs = generators("gt_example", gt_initial_guess=gt)
    assert np.array_equal(ours.get_earth_initial_guess(0, 20, 40, 0)[1][0], gt)
    with pytest.raises(ValueError):
        generators("no_such_mode")[0].get_earth_initial_guess(0, 20, 40, 0)


def test_halo_period_and_normalisation_match_jax():
    energies = [0.008, 0.0167, 0.05, 0.0863, 0.095]
    for e in energies:
        assert abs(datagen.get_halo_period(e) - jdatagen.get_halo_period(e)) <= 1e-9
    rng = np.random.default_rng(0)
    lo, hi = nlp_box()
    for e in energies:
        control = rng.uniform(lo, hi)
        control[-2] *= datagen.get_halo_period(e)
        result = {"results.control": control, "cost_alpha": e}
        ours, theirs = datagen.normalize_result(result), jdatagen.normalize_result(result)
        assert ours.dtype == np.float32 and ours.shape == (67,)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    light = {"results.control": np.full(66, 400.0), "cost_alpha": 0.05}
    assert datagen.normalize_result(light) is None and jdatagen.normalize_result(light) is None


def test_native_backend_writes_the_jax_packages_files(tmp_path):
    """``--backend native`` on 8 seeds: the same file names and, in every
    file, the same controls and fields as the root ``generate_data.py`` (both
    solve on the same C++ oracle source); then ``prepare_training_data``
    of both folders gives the same [N, 67] pickle."""
    root_cli = load_root("generate_data.py", "root_generate_data")
    args = ["--backend", "native", "--seed", "3", "--seed_step", "8", "--save_infeasible"]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    summary = generate_data.main(args + ["--result_folder", str(ours)])
    root_cli.main(args + ["--result_folder", str(theirs)])
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and len(names) == 8
    assert summary["n"] == 8 and summary["n_feasible"] == sum(n.startswith("feasible") for n in names)
    for name in names:
        with open(ours / name, "rb") as f:
            a = pickle.load(f)[0]
        with open(theirs / name, "rb") as f:
            b = pickle.load(f)[0]
        assert set(a) == set(b)
        assert np.array_equal(a["results.control"], b["results.control"])
        for key in set(a) - {"results.control", "solving_time"}:
            assert a[key] == b[key], key
    n = datagen.prepare_training_data(str(ours), str(tmp_path))
    jn = jdatagen.prepare_training_data(str(theirs), str(theirs))
    assert n == jn
    if n:
        with open(tmp_path / f"training_data_boundary_{n}.pkl", "rb") as f:
            a = pickle.load(f)
        with open(theirs / f"training_data_boundary_{n}.pkl", "rb") as f:
            b = pickle.load(f)
        assert a.shape == (n, 67)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_batched_backends_need_a_card_or_the_cpu_named():
    """Without a card, ``tpu`` and ``auto`` raise unless the CPU is asked for;
    ``native`` does not need one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for backend in ("tpu", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_data.resolve_backend(backend)
        assert generate_data.resolve_backend(backend, "cpu") == "tpu"
    assert generate_data.resolve_backend("native") == "native"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_dataset.main(["--out_dir", "unused", "--max_rounds", "0"])


class _Recorder:
    """Stands in for a package's batched solver: records each call's guesses
    and energies, and reports lane 0 of each call feasible with its guess as
    the solution."""

    def __init__(self):
        self.calls = []

    def __call__(self, G, he, **kw):
        G = np.array(G, np.float64)
        self.calls.append((G.copy(), np.array(he, np.float64)))
        feasible = np.zeros(len(G), bool)
        feasible[0] = True
        return {"feasible": feasible, "refined": G, "optimal": feasible,
                "final_mass": G[:, 63]}


def test_fleet_script_draws_and_state_match_jax(tmp_path, monkeypatch):
    """One round of the fleet script in both packages with the solver
    replaced by a recorder: the same bins and the same uniform draws for the
    seed, the same state file; each package resumes the other's state and
    normalises its rows alike."""
    import rdm_tpu.physics.solver_tpu as jsolver
    from rdm_tpu_torch.physics import solver_gpu

    jscript = load_root(os.path.join("scripts", "generate_dataset_tpu.py"), "root_gen_dataset")
    theirs_rec, ours_rec = _Recorder(), _Recorder()
    monkeypatch.setattr(jsolver, "refine_warmstarts_tpu", theirs_rec)
    monkeypatch.setattr(solver_gpu, "refine_warmstarts_gpu", ours_rec)
    common = ["--batch", "64", "--target", "1100", "--max_rounds", "1", "--seed", "11"]
    jscript.main(common + ["--out_dir", str(tmp_path / "theirs")])
    summary = generate_dataset.main(common + ["--out_dir", str(tmp_path / "ours"),
                                              "--device", "cpu"])
    (G, he), (Gj, hej) = ours_rec.calls[0], theirs_rec.calls[0]
    assert np.array_equal(G, Gj) and np.array_equal(he, hej)
    ours_state = np.load(tmp_path / "ours" / "datagen_state.npz")
    theirs_state = np.load(tmp_path / "theirs" / "datagen_state.npz")
    assert set(ours_state.files) == set(theirs_state.files) == {f"bin{b}" for b in range(11)}
    for b in range(11):
        assert np.array_equal(ours_state[f"bin{b}"].reshape(-1, 66),
                              theirs_state[f"bin{b}"].reshape(-1, 66))
    assert summary["rows"] == 1 and sum(summary["bins"]) == 1

    # resume: no new round, each package reads the other's state
    again = ["--max_rounds", "0", "--target", "1100"]
    jscript.main(again + ["--out_dir", str(tmp_path / "j2"),
                          "--state", str(tmp_path / "ours" / "datagen_state.npz")])
    resumed = generate_dataset.main(again + ["--out_dir", str(tmp_path / "o2"), "--device", "cpu",
                                             "--state", str(tmp_path / "theirs" / "datagen_state.npz")])
    assert resumed["bins"] == summary["bins"]
    with open(tmp_path / "o2" / "training_data_boundary_1.pkl", "rb") as f:
        a = pickle.load(f)
    with open(tmp_path / "j2" / "training_data_boundary_1.pkl", "rb") as f:
        b = pickle.load(f)
    assert a.shape == (1, 67) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
