"""The port's host-side oracle studies (budget_sweep, same_oracle_baseline,
second_solver_crosscheck, spiral_sensitivity) against the JAX package's
scripts, loaded from their paths, at the same tiny arguments on the same
samples.  The two packages' native oracles are one C++ source (their files
differ only in comments), so every feasible count must be equal: that is
what the runs bear out, and it is the tolerance."""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from rdm_tpu_torch.datagen import get_halo_period
from rdm_tpu_torch.scripts import (budget_sweep, plot_budget_sweep, same_oracle_baseline,
                                   second_solver_crosscheck, spiral_sensitivity)

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024", "gto_halo",
                        "generated_samples.npy")


def load_script(name, monkeypatch, as_name=None):
    """A JAX script loaded from its path; what it adds to sys.path (its own
    directory, which holds a ``trace.py``) is undone after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(as_name or f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if as_name:
        monkeypatch.setitem(sys.modules, as_name, mod)
    return mod


@pytest.fixture
def ref_samples(tmp_path):
    """Four round-2 samples as a reference artifact stores them: the halo
    period slot in time units."""
    s = np.load(FLAGSHIP)[100:104].copy()
    s[:, -2] *= np.array([get_halo_period(float(h)) for h in s[:, 0]])
    path = tmp_path / "ref" / "samples.npy"
    path.parent.mkdir()
    np.save(path, s)
    return path


def _by(cells, *keys):
    return {tuple(c[k] for k in keys): c for c in cells}


def test_budget_sweep_matches_jax(tmp_path, monkeypatch, ref_samples):
    jbs = load_script("budget_sweep", monkeypatch)
    monkeypatch.setattr(jbs, "REF_SETS", {"ref_small": str(ref_samples)})
    monkeypatch.setattr(jbs, "ITER_GRID", (2,))
    monkeypatch.setattr(jbs, "MBH_GRID", (0, 1))
    monkeypatch.setattr(budget_sweep, "REF_SETS", {"ref_small": "ref/samples.npy"})
    monkeypatch.chdir(ROOT)          # the JAX script's inputs are relative paths
    args = ["--n_flagship", "4", "--n_control", "4"]
    jbs.main([*args, "--out", str(tmp_path / "jax.json")])
    mine = budget_sweep.main([*args, "--iters", "2", "--mbh", "0,1",
                              "--reference_root", str(tmp_path),
                              "--out", str(tmp_path / "port.json")])
    import json
    theirs = json.loads((tmp_path / "jax.json").read_text())
    a, b = (_by(x["cells"], "set", "max_iters", "mbh_rounds") for x in (mine, theirs))
    assert set(a) == set(b) and len(a) == 8
    for k in a:
        assert a[k]["n"] == b[k]["n"] == 4
        assert a[k]["feasible_ratio"] == b[k]["feasible_ratio"], k
        assert a[k]["local_optimal_ratio"] == b[k]["local_optimal_ratio"], k
    assert a[("gt_ceiling", 2, 1)]["feasible_ratio"] > 0
    lines = plot_budget_sweep.main([str(tmp_path / "port.json"), str(tmp_path / "b.png")])
    assert set(lines) == {"flagship_rdm_tpu", "gt_ceiling", "uniform_floor"}
    assert (tmp_path / "b.png").exists()


def test_budget_sweep_skips_an_absent_reference_set(tmp_path, capsys):
    sets = budget_sweep.sample_sets(2, 2, str(tmp_path / "nowhere"))
    assert set(sets) == {"flagship_rdm_tpu", "uniform_floor", "gt_ceiling"}
    assert "set skipped" in capsys.readouterr().out


def test_no_reference_root_reads_no_reference_file(monkeypatch, capsys):
    """Without --reference_root or RDM_REFERENCE_ROOT the reference's sets
    are skipped with a line each, and nothing is looked for around the
    checkout."""
    monkeypatch.delenv("RDM_REFERENCE_ROOT", raising=False)
    looked, exists = [], os.path.exists
    monkeypatch.setattr(os.path, "exists", lambda path: looked.append(str(path)) or exists(path))
    sets = budget_sweep.sample_sets(2, 2, None)
    assert set(sets) == {"flagship_rdm_tpu", "uniform_floor", "gt_ceiling"}
    blob = same_oracle_baseline.main(["--max_iters", "1", "--mbh_rounds", "0"])
    assert blob["rows"] == []
    rels = [*budget_sweep.REF_SETS.values(), same_oracle_baseline.REF_SAMPLES]
    assert not [p for p in looked if any(p.endswith(r) for r in rels)]
    assert capsys.readouterr().out.count("RDM_REFERENCE_ROOT given; set skipped") == 4


def test_same_oracle_baseline_matches_jax(tmp_path, monkeypatch, ref_samples):
    jso = load_script("same_oracle_baseline", monkeypatch)
    args = ["--ref_samples", str(ref_samples), "--max_iters", "3", "--mbh_rounds", "1"]
    jso.main([*args, "--out", str(tmp_path / "jax.json")])
    mine = same_oracle_baseline.main([*args, "--out", str(tmp_path / "port.json")])
    import json
    theirs = json.loads((tmp_path / "jax.json").read_text())
    assert mine["oracle"] == theirs["oracle"] and mine["context"] == theirs["context"]
    (a,), (b,) = mine["rows"], theirs["rows"]
    assert a["n"] == b["n"] == 4
    for k in ("feasible_ratio", "local_optimal_ratio", "avg_final_mass_feasible"):
        assert a[k] == b[k], k


def test_second_solver_crosscheck_matches_jax(tmp_path, monkeypatch):
    jbs = load_script("budget_sweep", monkeypatch, as_name="budget_sweep")   # its import
    monkeypatch.setattr(jbs, "REF_SETS", {})        # the sets below need no reference file
    jss = load_script("second_solver_crosscheck", monkeypatch)
    args = ["--solvers", "trf,slsqp", "--n_flagship", "2", "--n_control", "2", "--mbh", "0,1",
            "--sets", "flagship_rdm_tpu,gt_ceiling"]
    monkeypatch.chdir(ROOT)
    jss.main([*args, "--out", str(tmp_path / "jax.json")])
    mine = second_solver_crosscheck.main([*args, "--reference_root", str(tmp_path),
                                          "--out", str(tmp_path / "port.json")])
    import json
    theirs = json.loads((tmp_path / "jax.json").read_text())
    a, b = (_by(x["cells"], "solver", "set", "mbh_rounds") for x in (mine, theirs))
    assert set(a) == set(b) and len(a) == 8
    for k in a:
        for f in ("n", "feasible_ratio", "median_cost", "avg_final_mass_feasible"):
            assert a[k][f] == b[k][f], (k, f)


def test_spiral_sensitivity_matches_jax(tmp_path, monkeypatch):
    jsp = load_script("spiral_sensitivity", monkeypatch)
    args = ["--n", "3", "--iters", "3", "--mbh", "0"]
    monkeypatch.chdir(ROOT)
    jsp.main([*args, "--out", str(tmp_path / "jax.json")])
    mine = spiral_sensitivity.main([*args, "--out", str(tmp_path / "port.json")])
    import json
    theirs = json.loads((tmp_path / "jax.json").read_text())
    assert mine["spiral_end_baseline"] == theirs["spiral_end_baseline"]
    a, b = (_by(x["cases"], "case") for x in (mine, theirs))
    assert list(a) == list(b) and len(a) == 16
    for k in a:
        for f in ("feasible_ratio", "local_optimal_ratio", "avg_final_mass_feasible"):
            assert a[k][f] == b[k][f], (k, f)
    assert mine["summary"] == theirs["summary"]
