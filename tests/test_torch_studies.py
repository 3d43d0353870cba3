"""The port's card-side study scripts (rdm_tpu_torch/scripts/) on the CPU
at n <= 4 on a tiny run the port trains: each writes finite JSON with the
key set of the JAX package's checked-in artifact where there is one, into a
temporary directory (never into benchmark_results/), with the fixes the
JAX scripts lack: nfe_sweep's oracle labels and timing n, clip_excess's
de-standardisation fallbacks, the truthful moll = 0 label."""
import hashlib
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from rdm_tpu_torch import run_train
from rdm_tpu_torch.benchmark.gto_halo import GTO_MEAN, GTO_STD, THRUST
from rdm_tpu_torch.data import make_synthetic_gto_pkl
from rdm_tpu_torch.scripts import (clip_excess, gt_roundtrip_control, nfe_sweep,
                                   ode_clip_study, plot_nfe_sweep, regrade_benchmark,
                                   sampler_quality_study, study_common)

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "benchmark_results")
ROUND2 = os.path.join(RESULTS, "round2_flagship_1024", "gto_halo")


def _finite(blob):
    if isinstance(blob, dict):
        return all(_finite(v) for v in blob.values())
    if isinstance(blob, list):
        return all(_finite(v) for v in blob)
    return not isinstance(blob, float) or math.isfinite(blob)


def _jax_artifact(name):
    with open(os.path.join(RESULTS, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("study_run")
    pkl = make_synthetic_gto_pkl(str(tmp / "train.pkl"), n=64)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        work = run_train.main(["+device=cpu", "model.nf=16", "model.ch_mult=[1,2]",
                               "model.num_res_blocks=1", f"data.pkl_path={pkl}",
                               "training.batch_size=8", "eval.batch_size=8",
                               "training.n_iters=2", "training.snapshot_freq=2",
                               "training.snapshot_sampling=false", "sde.num_scales=8"])
    finally:
        os.chdir(cwd)
    return str(tmp / work)


def test_default_outputs_stay_out_of_the_jax_artifacts():
    assert study_common.RESULTS == os.path.join(RESULTS, "torch")
    for mod in (nfe_sweep, ode_clip_study, sampler_quality_study, clip_excess,
                gt_roundtrip_control):
        doc = mod.__doc__
        assert "benchmark_results/torch/" in doc, mod.__name__


def test_nfe_sweep_native_and_card_paths(tiny_run, tmp_path):
    out = tmp_path / "nfe.json"
    blob = nfe_sweep.main([tiny_run, "4", "--steps", "3,5", "--max_iters", "2",
                           "--mbh_rounds", "0", "--backend", "native", "--device", "cpu",
                           "--out", str(out)])
    jax_blob = _jax_artifact("nfe_sweep.json")
    assert set(blob) == set(jax_blob)
    want = {k.replace("mbh8", "mbh0") for k in jax_blob["rows"][0]}
    assert [r["steps"] for r in blob["rows"]] == [3, 5]
    for r in blob["rows"]:
        assert want <= set(r) and r["precision"] == "f64" and r["mbh_rounds"] == 0
    assert _finite(blob) and json.loads(out.read_text()) == blob
    # the card's grading path, on the CPU's plain versions (float64, two iterations)
    card = nfe_sweep.main([tiny_run, "2", "--steps", "3", "--max_iters", "2",
                           "--mbh_rounds", "0", "--device", "cpu",
                           "--out", str(tmp_path / "card.json")])
    assert card["oracle"]["backend"] == "tpu" and card["rows"][0]["precision"] == "df32"
    assert _finite(card)


def test_nfe_sweep_keeps_the_labels_of_prior_rows(tiny_run, tmp_path):
    """A grading run into an artifact graded otherwise writes its own oracle
    block and leaves each prior row labelled with the prior block's
    precision and basin hops; --timing_only keeps the artifact's n and
    oracle block and records its own batch as timing_n."""
    out = tmp_path / "nfe.json"
    shutil.copy(os.path.join(RESULTS, "nfe_sweep.json"), out)
    prior = _jax_artifact("nfe_sweep.json")
    blob = nfe_sweep.main([tiny_run, "4", "--steps", "3", "--max_iters", "2", "--mbh_rounds",
                           "0", "--backend", "native", "--device", "cpu", "--out", str(out)])
    assert blob["oracle"]["backend"] == "native" and blob["oracle"]["mbh_rounds"] == 0
    old = [r for r in blob["rows"] if r["steps"] != 3]
    assert len(old) == len(prior["rows"])
    assert all(r["precision"] == "df32" and r["mbh_rounds"] == 8 for r in old)

    shutil.copy(os.path.join(RESULTS, "nfe_sweep.json"), out)
    timed = nfe_sweep.main([tiny_run, "2", "--steps", "100", "--timing_only",
                            "--device", "cpu", "--out", str(out)])
    assert timed["n"] == prior["n"] == 1024 and timed["timing_n"] == 2
    assert timed["oracle"] == prior["oracle"]
    row, was = (next(r for r in b["rows"] if r["steps"] == 100) for b in (timed, prior))
    assert row["timing_n"] == 2 and row["feasible_cold"] == was["feasible_cold"]
    assert row["steady_sampling_s"] != was["steady_sampling_s"]
    with pytest.raises(SystemExit):    # no prior row at 7 steps: a usage error, not a grading
        nfe_sweep.main([tiny_run, "2", "--steps", "7", "--timing_only", "--device", "cpu",
                        "--out", str(out)])


def test_plot_nfe_sweep_reads_the_twin(tiny_run, tmp_path):
    out = tmp_path / "nfe.json"
    nfe_sweep.main([tiny_run, "2", "--steps", "3,5", "--max_iters", "2", "--mbh_rounds", "0",
                    "--backend", "native", "--device", "cpu", "--out", str(out)])
    rows = plot_nfe_sweep.main([str(out), str(tmp_path / "nfe.png")])
    assert [r["steps"] for r in rows] == [3, 5] and (tmp_path / "nfe.png").exists()


def test_sampler_quality_study(tiny_run, tmp_path):
    blob = sampler_quality_study.main([tiny_run, "4", "--max_iters", "2", "--backend",
                                       "native", "--device", "cpu",
                                       "--out", str(tmp_path / "sq.json")])
    assert [r["config"] for r in blob["rows"]] == [c[0] for c in sampler_quality_study.CONFIGS]
    assert _finite(blob) and all(0 <= r["feasible"] <= 1 for r in blob["rows"])


def test_ode_clip_study_rows_and_the_moll0_label(tiny_run, tmp_path):
    blob = ode_clip_study.main([tiny_run, "4", "--grade", "--max_iters", "2", "--backend",
                                "native", "--device", "cpu", "--out", str(tmp_path / "oc.json")])
    jax_rows = _jax_artifact("ode_clip_study.json")["rows"]
    assert set(blob) == {"run_dir", "rows"} and len(blob["rows"]) == len(jax_rows) == 9
    for mine, theirs in zip(blob["rows"], jax_rows):
        assert set(mine) == set(theirs)
        assert {k: mine[k] for k in ("sampler", "steps", "moll", "side_eps") if k in mine} == \
               {k: theirs[k] for k in ("sampler", "steps", "moll", "side_eps") if k in theirs}
    moll0 = next(r for r in blob["rows"] if r.get("moll") == 0)
    assert "multiplied by x" in moll0["label"] and "no mollifier" not in moll0["label"]
    assert _finite(blob)


def test_clip_excess_falls_back_to_the_pipelines_constants(tiny_run, tmp_path):
    rng = np.random.default_rng(0)
    raw = rng.uniform(0, 1, (3, 67))
    u = clip_excess.control_magnitudes(raw, {})
    ctrl = ((raw[:, 4:64] * GTO_STD + GTO_MEAN) * 2 * THRUST - THRUST).reshape(3, 20, 3)
    np.testing.assert_array_equal(u, np.sqrt((ctrl ** 2).sum(-1)))
    ones = clip_excess.control_magnitudes(raw, {"gto_std": 1, "gto_mean": 0})
    assert not np.allclose(u, ones)          # the JAX script's fallbacks (1, 0) differ
    blob = clip_excess.main([tiny_run, "5", "4", "--device", "cpu",
                             "--out", str(tmp_path / "ce.json")])
    assert blob["triples"] == 80 and 0 <= blob["clipped_share"] <= 1 and _finite(blob)


def _digest(folder):
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(folder)):
        for name in sorted(filenames):
            with open(os.path.join(dirpath, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def test_regrade_works_on_a_copy(tmp_path):
    before = _digest(ROUND2)
    gto = tmp_path / "artifact" / "gto_halo"
    gto.mkdir(parents=True)
    np.save(gto / "generated_samples.npy", np.load(os.path.join(ROUND2,
                                                                "generated_samples.npy"))[:4])
    shutil.copy(os.path.join(ROUND2, "gto_halo_results.json"), gto)
    old = json.loads((gto / "gto_halo_results.json").read_text())["physical_validation"]
    (new,) = regrade_benchmark.main([str(tmp_path / "artifact"), "--oracle_backend", "native",
                                     "--mbh_rounds", "0", "--max_iters", "2",
                                     "--solver_mode", "feasible"])
    assert new["oracle_backend"] == "native"
    assert new["regraded_from"]["feasible_ratio"] == old["feasible_ratio"]
    assert new["regraded_from"]["oracle_backend"] == old.get("oracle_backend")
    updated = json.loads((gto / "gto_halo_results.json").read_text())
    assert updated["physical_validation_pre_regrade"] == old
    assert updated["physical_validation"]["total_tested"] == 4
    summary = (gto / "summary.txt").read_text()
    assert "PHYSICAL_VALIDATION" in summary and "PRE_REGRADE" not in summary
    assert _digest(ROUND2) == before


def test_gt_roundtrip_control(tmp_path):
    blob = gt_roundtrip_control.main([study_common.GT_PKL, "4", "native", "--max_iters", "5",
                                      "--out", str(tmp_path / "gt.json")])
    assert blob["n"] == 4 and blob["feasible"] > 0 and _finite(blob)
