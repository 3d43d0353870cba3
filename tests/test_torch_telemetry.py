"""The port's telemetry (rdm_tpu_torch/telemetry/) against the JAX
package's root telemetry/ scripts: trajectory propagation, the training
set's analysis (also without matplotlib) and the loss-log parser on a log
the port's trainer wrote."""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from rdm_tpu_torch import run_train
from rdm_tpu_torch.data import make_synthetic_gto_pkl
from rdm_tpu_torch.telemetry import comprehensive_data_analysis as analysis
from rdm_tpu_torch.telemetry import plot_losses, trajectory_plots

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "telemetry"))
SAMPLES = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024", "gto_halo",
                       "generated_samples.npy")
TRAIN_PKL = os.path.join(ROOT, "datasets", "training_data_boundary_80073.pkl")


def test_propagate_trajectory_matches_jax(monkeypatch):
    """Three round-2 samples propagated in float32 by both packages (RK4,
    8 steps a point, 177 points): the states agree within 5e-4 of the
    trajectory's largest value.  The first two rows agree within 1.5e-6 of
    it; the third comes within 1.9e-4 (float32 rounding of two
    implementations of the same arithmetic, grown over 1,408 steps through
    a close pass).  The JAX propagation is jitted (the same arithmetic as its
    eager scan, which takes about 40 s a row here)."""
    import jax
    import trajectory_plots as jtraj
    from rdm_tpu.physics import cr3bp as jdyn
    monkeypatch.setattr(jdyn, "propagate",
                        jax.jit(jdyn.propagate, static_argnames=("n_steps",)))
    samples = np.load(SAMPLES)[:3]
    for row in samples:
        want = np.asarray(jtraj.propagate_trajectory(row[1:]))
        got = trajectory_plots.propagate_trajectory(row[1:])
        assert got.shape == want.shape == (1 + 8 * 22, 6) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * np.abs(want).max())


def test_plot_trajectories_draws_or_says(tmp_path, monkeypatch, capsys):
    samples = np.load(SAMPLES)[:1]
    out = tmp_path / "t.png"
    trajs = trajectory_plots.plot_trajectories(samples, str(out), n=1)
    assert out.exists() and len(trajs) == 1
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    trajectory_plots.plot_trajectories(samples, str(tmp_path / "u.png"), n=1)
    assert not (tmp_path / "u.png").exists()
    assert "matplotlib is not installed: plots skipped" in capsys.readouterr().out


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (int, float, np.integer, np.floating)) and not isinstance(a, bool):
        assert abs(float(a) - float(b)) <= 1e-6 * max(abs(float(b)), 1e-12), (path, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                       err_msg=path)


def test_analysis_matches_jax_with_and_without_matplotlib(tmp_path, monkeypatch):
    import comprehensive_data_analysis as janalysis
    with open(TRAIN_PKL, "rb") as f:
        rows = np.asarray(pickle.load(f))[:2000]
    pkl = tmp_path / "rows.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(rows, f)
    want = janalysis.analyze(str(pkl), str(tmp_path / "jax"))
    got = analysis.analyze(str(pkl), str(tmp_path / "port"))
    _same(got, want)
    for name in (*analysis.FIGURES, "analysis_results.pkl"):
        assert (tmp_path / "port" / name).exists(), name

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    bare = analysis.analyze(str(pkl), str(tmp_path / "bare"))
    _same(bare, want)
    assert sorted(os.listdir(tmp_path / "bare")) == ["analysis_results.pkl"]
    with open(tmp_path / "bare" / "analysis_results.pkl", "rb") as f:
        _same(pickle.load(f), want)


@pytest.fixture(scope="module")
def port_log(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("log_run")
    pkl = make_synthetic_gto_pkl(str(tmp / "t.pkl"), n=16)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        work = run_train.main(["+device=cpu", "model.nf=16", "model.ch_mult=[1,2]",
                               "model.num_res_blocks=1", f"data.pkl_path={pkl}",
                               "training.batch_size=4", "eval.batch_size=4",
                               "training.n_iters=3", "training.log_freq=1",
                               "training.eval_freq=1", "training.snapshot_freq=3",
                               "training.snapshot_sampling=false", "sde.num_scales=3"])
    finally:
        os.chdir(cwd)
    return tmp, os.path.join(str(tmp), work, "logs")


def test_log_parser_matches_jax_on_a_port_log(port_log):
    import plot_losses as jplot
    _, log = port_log
    got = plot_losses.parse_log_file(log)
    assert got == jplot.parse_log_file(log)
    ts, tl, es, el = got
    assert len(ts) >= 3 and len(es) >= 1 and np.isfinite(tl).all()


def test_plot_losses_finds_the_newest_log(port_log, monkeypatch, capsys):
    tmp, _ = port_log
    monkeypatch.chdir(tmp)
    assert plot_losses.main(["--out", str(tmp / "loss.png")]) == 0
    assert (tmp / "loss.png").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plot_losses.main(["--out", str(tmp / "none.png")]) == 0
    assert not (tmp / "none.png").exists()
    assert "plots skipped" in capsys.readouterr().out


def test_realtime_plot_polls_through_the_package_module(port_log, monkeypatch):
    """The realtime plot reads the log with the package's parser (no path
    games) and redraws; two polls on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    from rdm_tpu_torch.telemetry import plot_losses_realtime
    tmp, log = port_log
    monkeypatch.chdir(tmp)
    polled = []
    monkeypatch.setattr(plot_losses_realtime, "parse_log_file",
                        lambda p: polled.append(p) or plot_losses.parse_log_file(p))
    plot_losses_realtime.main(["0", "--rounds", "2"])
    assert len(polled) == 2 and polled[0].endswith("logs")
