"""The port's evaluation path against the JAX package and the in-tree
round-2 flagship records: the inverse pipeline, the ML and component
statistics, the native CR3BP oracle, the benchmarkers and the
run_benchmark CLI, on the CPU."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rdm_tpu.benchmark import gto_halo as jgto
from rdm_tpu.benchmark import ml_statistics as jml
from rdm_tpu.physics import cr3bp as jcr3bp
from rdm_tpu.physics import oracle as joracle
from rdm_tpu_torch import native, run_benchmark, run_vis
from rdm_tpu_torch.benchmark import gto_halo, ml_statistics
from rdm_tpu_torch.config import load_hydra_config_from_run
from rdm_tpu_torch.physics import cr3bp, oracle

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "Training Runs", "2026.08.17_184657")
ROUND2 = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024")
TRAIN_PKL = os.path.join(ROOT, "datasets", "training_data_boundary_80073.pkl")
RTOL = 1e-9


def _bare(cls, data_cfg):
    """A benchmarker without a model: ``lm.cfg.data`` only."""
    b = cls.__new__(cls)
    b.lm = SimpleNamespace(cfg=SimpleNamespace(data=data_cfg))
    b.total_spherical_clips = 0
    b.total_spherical_elements = 0
    return b


@pytest.fixture(scope="module")
def round2():
    raw = np.load(os.path.join(ROUND2, "ml_statistics", "generated_samples.npy"))
    physical = np.load(os.path.join(ROUND2, "gto_halo", "generated_samples.npy"))
    with open(os.path.join(ROUND2, "ml_statistics", "ml_statistics_results.json")) as f:
        ml = json.load(f)
    with open(os.path.join(ROUND2, "gto_halo", "gto_halo_results.json")) as f:
        gto = json.load(f)
    return raw, physical, ml, gto


def test_inverse_pipeline_reproduces_the_round2_samples(round2):
    """The flagship run's config (gto_mean 0, gto_std 1) maps the stored
    model-space samples onto the stored physical ones; the JAX package's
    pipeline gives the same array bit for bit."""
    raw, physical, _, _ = round2
    data_cfg = load_hydra_config_from_run(FLAGSHIP).data
    assert (data_cfg.gto_mean, data_cfg.gto_std) == (0, 1)
    ours = _bare(gto_halo.GTOHaloBenchmarker, data_cfg)
    out = ours._inverse_pipeline(raw)
    assert out.shape == (1024, 67) and out.dtype == np.float64
    np.testing.assert_allclose(out, physical, rtol=0, atol=1e-8)
    assert (ours.total_spherical_clips, ours.total_spherical_elements) == (2050, 20480)
    theirs = _bare(jgto.GTOHaloBenchmarker, {"gto_mean": 0, "gto_std": 1})
    np.testing.assert_array_equal(out, theirs._inverse_pipeline(raw))
    assert theirs.total_spherical_clips == 2050


def test_ml_statistics_match_the_round2_record(round2):
    raw, _, ml, _ = round2
    reference = ml_statistics.MLStatisticsBenchmarker.__new__(
        ml_statistics.MLStatisticsBenchmarker)
    reference.config = ml_statistics.MLStatisticsConfig(model_path="", data_path=TRAIN_PKL)
    ref = reference.load_reference_data()
    assert ref.shape == (80073, 67) and ref.dtype == np.float32
    ours = reference.compute_standard_metrics(raw, ref)
    jbench = jml.MLStatisticsBenchmarker.__new__(jml.MLStatisticsBenchmarker)
    theirs = jbench.compute_standard_metrics(raw, ref)              # sklearn
    assert ours.keys() == ml["standard_metrics"].keys() == theirs.keys()
    for key, value in ml["standard_metrics"].items():
        assert ours[key] == pytest.approx(value, rel=RTOL), key
        assert ours[key] == pytest.approx(theirs[key], rel=RTOL), key
    assert ours["mse"] == theirs["mse"] and ours["mae"] == theirs["mae"]


def test_component_statistics_match_the_round2_record(round2):
    _, physical, _, gto = round2
    ours = gto_halo.GTOHaloBenchmarker.compute_gto_halo_metrics(None, physical)
    assert ours.keys() == gto["gto_halo_metrics"].keys()
    for key, value in gto["gto_halo_metrics"].items():
        assert ours[key] == pytest.approx(value, rel=RTOL), key


@pytest.mark.parametrize("mbh_rounds", [0, 8])
def test_native_oracle_is_bit_equal_to_the_jax_packages(round2, mbh_rounds):
    """Both packages build the same C++ source on this host and feed it the
    same halo table and spiral endpoint: every field agrees bit for bit."""
    physical = round2[1][:32]
    ours = oracle.evaluate_warmstarts_native(physical[:, 1:], physical[:, 0],
                                             mbh_rounds=mbh_rounds)
    theirs = joracle.evaluate_warmstarts_native(physical[:, 1:], physical[:, 0],
                                                mbh_rounds=mbh_rounds)
    assert ours.keys() == theirs.keys()
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert 0 < int(ours["feasible"].sum()) <= 32
    assert native.library_path().startswith(os.path.join(ROOT, "rdm_tpu_torch", "_build"))


def test_mission_constants_match_the_jax_packages():
    spiral, l1x, e_l1 = oracle._mission_constants(6.48423370092)
    jspiral, jl1x, je_l1 = joracle._mission_constants(6.48423370092)
    np.testing.assert_array_equal(spiral, jspiral)
    assert l1x == jl1x and e_l1 == pytest.approx(je_l1, rel=1e-6)
    assert cr3bp.spiral_to_boundary(6.48423370092).dtype == np.float32
    np.testing.assert_array_equal(cr3bp.get_gto_state_cr3bp(), jcr3bp.get_gto_state_cr3bp())


def test_spiral_off_the_pinned_table_matches_the_jax_packages():
    """A boundary time the pinned table lacks runs scipy's DOP853 and
    rounds to float32 on both sides."""
    ours = cr3bp.spiral_to_boundary(0.5)
    theirs = np.asarray(jcr3bp.spiral_to_boundary(0.5))
    assert ours.dtype == np.float32 and ours.shape == (7,)
    np.testing.assert_array_equal(ours, theirs)


def test_native_bindings_match_the_jax_packages(round2):
    from rdm_tpu import native as jnative

    physical = round2[1][:8]
    spiral = oracle._mission_constants(6.48423370092)[0]
    s0 = np.concatenate([spiral[:6], [700.0]])
    u = np.array([0.6, 0.0, 0.8])
    np.testing.assert_array_equal(native.propagate(s0, u, 0.5, 1.0, 0.3, 40),
                                  jnative.propagate(s0, u, 0.5, 1.0, 0.3, 40))
    assert native.jacobi_energy(s0[:6]) == jnative.jacobi_energy(s0)
    seed = np.array([0.82, 0.0, 0.1, 0.0, 0.25, 0.0])
    vs = np.array([0.5, 0.1, 0.2, 0.3, 0.4, 0.6])
    np.testing.assert_array_equal(native.manifold_target(seed, 2.7, vs, 0.3, 7.0),
                                  jnative.manifold_target(seed, 2.7, vs, 0.3, 7.0))
    np.testing.assert_array_equal(
        native.residual_batch(physical[:, 1:], physical[:, 0], spiral),
        jnative.residual_batch(physical[:, 1:], physical[:, 0], spiral))
    ours = oracle.evaluate_warmstarts_native(physical[:, 1:], physical[:, 0], refine=False)
    theirs = joracle.evaluate_warmstarts_native(physical[:, 1:], physical[:, 0], refine=False)
    for key in ours:
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]), err_msg=key)
    with pytest.raises(ValueError, match="expected \\(N, 66\\)"):
        native.refine_batch(physical[:, :10], physical[:, 0], spiral)


def test_image_metrics_match_the_jax_packages():
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 1, (4, 8, 8, 3))
    noisy = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1)
    for a, b in ((ref, ref), (noisy, ref)):
        assert (ml_statistics.MLStatisticsBenchmarker.compute_image_metrics(a, b)
                == jml.MLStatisticsBenchmarker.compute_image_metrics(a, b))
    same = ml_statistics.MLStatisticsBenchmarker.compute_image_metrics(ref, ref)
    assert same["psnr_mean"] > 60 and same["ssim_mean"] > 0.99


def test_nlp_box_and_mbh_loop_are_monotone_and_deterministic():
    lo, hi = oracle.nlp_box()
    jlo, jhi = joracle.nlp_box()
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert (lo <= hi).all() and lo[0] == 1e-3 and (lo[63], hi[63]) == (408.0, 470.0)

    def solve(G, he):
        """A stand-in solver: cost = distance of the guess to a target,
        feasible below 0.55 (a hop lands closer or farther)."""
        cost = np.abs(G[:, 0] - 20.0) / 20.0 + 0.5 * np.abs(G[:, 64] - 0.5)
        n = len(G)
        return {"feasible": cost < 0.55, "optimal": cost < 0.3, "inform": np.full(n, 3),
                "cost": cost, "pos_err": cost, "vel_err": cost, "refined": G.copy(),
                "final_mass": G[:, 63].copy(), "terminal_mass": G[:, 63].copy(),
                "stationarity": cost, "opt_gain": cost, "iters": np.full(n, 5, np.int32)}

    rng = np.random.default_rng(0)
    guesses = np.clip(lo + rng.uniform(size=(64, 66)) * (hi - lo), lo, hi)
    energies = rng.uniform(0.01, 0.09, size=64)
    cold = solve(guesses, energies)
    runs = [oracle._mbh_loop(solve, guesses, energies, 8, 0.05, 0, lo, hi) for _ in range(2)]
    jrun = joracle._mbh_loop(solve, guesses, energies, 8, 0.05, 0, lo, hi)
    for key in runs[0]:
        np.testing.assert_array_equal(runs[0][key], runs[1][key], err_msg=key)
        np.testing.assert_array_equal(runs[0][key], jrun[key], err_msg=key)
    best = runs[0]
    assert (best["cost"] <= cold["cost"]).all()                 # monotone
    assert (best["feasible"] >= cold["feasible"]).all()
    assert best["feasible"].sum() > cold["feasible"].sum()      # the hops helped
    assert (best["iters"] >= cold["iters"]).all()


def test_simulator_native_backend_matches_the_jax_packages(round2):
    physical = round2[1][:1]
    ours = oracle.CR3BPEarthMissionWarmstartSimulatorBoundary(backend="native").simulate(
        physical[0, 1:], halo_energy=float(physical[0, 0]))
    theirs = joracle.CR3BPEarthMissionWarmstartSimulatorBoundary(backend="native").simulate(
        physical[0, 1:], halo_energy=float(physical[0, 0]))
    assert ours.keys() == theirs.keys()
    for key in ours:
        if key != "solving_time":
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


@pytest.mark.parametrize("backend", ["pydylan", "hybrid", "tpu", "jax"])
def test_unported_backends_raise(backend):
    sim = oracle.CR3BPEarthMissionWarmstartSimulatorBoundary(backend=backend)
    with pytest.raises(NotImplementedError, match="--oracle_backend native"):
        sim.simulate(np.full(66, 0.5), halo_energy=0.05)
    bench = gto_halo.GTOHaloBenchmarker.__new__(gto_halo.GTOHaloBenchmarker)
    bench.config = gto_halo.GTOHaloBenchmarkConfig(model_path="", oracle_backend=backend)
    with pytest.raises(NotImplementedError, match="Queue A item 4|pydylan"):
        bench.compute_physical_validation_metrics(np.full((1, 67), 0.5))


def test_automatic_backend_rule(monkeypatch):
    """An unset backend follows the JAX package's rule: native without a
    card; with one the rule picks hybrid, which raises and names
    ``--oracle_backend native`` instead of running native in its place."""
    bench = gto_halo.GTOHaloBenchmarker.__new__(gto_halo.GTOHaloBenchmarker)
    bench.config = gto_halo.GTOHaloBenchmarkConfig(model_path="")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.oracle_backend() == "native"
    assert oracle.auto_backend(False) == "native"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert oracle.auto_backend(True) == "hybrid"
    with pytest.raises(NotImplementedError, match="'hybrid'.*--oracle_backend native"):
        bench.oracle_backend()
    bench.config.enable_physical_validation = False
    assert bench.compute_physical_validation_metrics(np.zeros((1, 67)))[
        "physical_validation_disabled"]


def test_native_build_failure_raises_with_the_compilers_message(tmp_path, monkeypatch):
    broken = tmp_path / "cr3bp_native.cpp"
    broken.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "_SRC", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.raises(RuntimeError, match="(?s)native oracle build failed.*error"):
        native.jacobi_energy(np.zeros(6))
    with pytest.raises(RuntimeError, match="error"):      # the failure is kept
        oracle.evaluate_warmstarts_native(np.full((1, 66), 0.5), np.full(1, 0.05))
    assert not native.available() and "error" in native.build_error()
    assert not os.listdir(tmp_path / "build")               # no temporary file left


def test_importing_the_native_module_builds_nothing(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    code = ("import rdm_tpu_torch.native as n, rdm_tpu_torch.physics.oracle, "
            "rdm_tpu_torch.run_benchmark; "
            "print(n._lib is None and n._build_error is None)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr[-2000:]


# ---------------------------------------------------------------------------
# the slice as a whole, on a tiny run the port trains

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    from rdm_tpu_torch import run_train
    from rdm_tpu_torch.data import make_synthetic_gto_pkl

    tmp = tmp_path_factory.mktemp("eval_run")
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
    return str(tmp / work), pkl


def test_run_benchmark_cli_writes_both_reports(tiny_run, tmp_path):
    run, pkl = tiny_run
    out = tmp_path / "out"
    results = run_benchmark.main(["--model_path", run, "--data_path", pkl, "--device", "cpu",
                                  "--test_mode", "--sampling_method", "ode",
                                  "--oracle_backend", "native", "--output_dir", str(out)])
    for name in ("ml_statistics_results.json", "summary.txt", "generated_samples.npy"):
        assert (out / "ml_statistics" / name).exists(), name
    for name in ("gto_halo_results.json", "summary.txt", "generated_samples.npy",
                 "generated_samples.pkl", "spherical_clipping_stats.txt"):
        assert (out / "gto_halo" / name).exists(), name
    ml = json.loads((out / "ml_statistics" / "ml_statistics_results.json").read_text())
    gto = json.loads((out / "gto_halo" / "gto_halo_results.json").read_text())
    assert ml == json.loads(json.dumps(results["ml_statistics"]))
    assert all(np.isfinite(v) for v in ml["standard_metrics"].values())
    assert gto["benchmark_config"]["sampling_method"] == "ode"
    assert not gto["gto_halo_metrics"]["has_nan"] and not gto["gto_halo_metrics"]["has_inf"]
    pv = gto["physical_validation"]
    assert pv["oracle_backend"] == "native" and pv["total_tested"] == 10
    assert 0.0 <= pv["feasible_ratio"] <= 1.0
    samples = np.load(out / "gto_halo" / "generated_samples.npy")
    assert samples.shape == (10, 67)
    assert (samples[:, 0] >= 0.008 - 1e-6).all() and (samples[:, 0] <= 0.095 + 1e-6).all()
    assert "STANDARD METRICS" in (out / "ml_statistics" / "summary.txt").read_text()
    assert "PHYSICAL_VALIDATION" in (out / "gto_halo" / "summary.txt").read_text()


def test_run_benchmark_cli_needs_a_card_or_an_explicit_cpu(tiny_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmark.main(["--model_path", tiny_run[0], "--test_mode"])
    with pytest.raises(SystemExit):
        run_benchmark.main(["--model_path", tiny_run[0], "--oracle_backend", "other"])


def test_benchmarkers_agree_with_the_jax_packages_on_injected_samples(tiny_run, tmp_path,
                                                                      monkeypatch, round2):
    """The same model-space samples injected into both packages'
    benchmarkers give equal result blocks, apart from the timings."""
    run, pkl = tiny_run
    raw = round2[0][:24]
    fake = lambda lm, n, b, **kw: (raw[:n].copy(), [0.25, 0.5])     # noqa: E731
    monkeypatch.setattr(gto_halo, "generate_raw_samples", fake)
    monkeypatch.setattr(jgto, "generate_raw_samples", fake)
    monkeypatch.setattr(ml_statistics, "generate_raw_samples", fake)
    monkeypatch.setattr(jml, "generate_raw_samples", fake)
    common = dict(model_path=run, num_samples=24, batch_size=12, sampling_method="ode",
                  save_plots=False)
    gto_kw = dict(common, oracle_backend="native", max_workers=4)
    ours = gto_halo.GTOHaloBenchmarker(gto_halo.GTOHaloBenchmarkConfig(
        **gto_kw, device="cpu", output_dir=str(tmp_path / "ours"))).run_benchmark()
    theirs = jgto.GTOHaloBenchmarker(jgto.GTOHaloBenchmarkConfig(
        **gto_kw, output_dir=str(tmp_path / "theirs"))).run_benchmark()
    assert ours.keys() == theirs.keys()
    timings = ("avg_solving_time", "oracle_wall_time_with_compile_s")
    for section in ours:
        a = {k: v for k, v in ours[section].items() if k not in timings}
        b = {k: v for k, v in theirs[section].items() if k not in timings}
        assert a == b, section
    assert ours["physical_validation"]["total_tested"] == 24

    ml_kw = dict(common, data_path=pkl)
    ours = ml_statistics.MLStatisticsBenchmarker(ml_statistics.MLStatisticsConfig(
        **ml_kw, device="cpu", output_dir=str(tmp_path / "ml_ours"))).run_benchmark()
    theirs = jml.MLStatisticsBenchmarker(jml.MLStatisticsConfig(
        **ml_kw, output_dir=str(tmp_path / "ml_theirs"))).run_benchmark()
    assert ours.keys() == theirs.keys() == {"standard_metrics", "sampling_efficiency"}
    assert ours["sampling_efficiency"] == theirs["sampling_efficiency"]
    for key, value in theirs["standard_metrics"].items():
        assert ours["standard_metrics"][key] == pytest.approx(value, rel=RTOL), key


def test_run_vis_samples_with_the_ode_and_a_trained_denoiser(tiny_run, tmp_path, monkeypatch):
    """``sampling.method=ode sampling.denoiser=network denoiser_path=...``:
    the denoiser run's EMA model (``checkpoints/checkpoint.pth``) ends each
    round with one call at t = eps."""
    run, _ = tiny_run
    denoiser = tmp_path / "denoiser"
    shutil.copytree(os.path.join(run, ".hydra"), denoiser / ".hydra")
    (denoiser / "checkpoints").mkdir()
    shutil.copy(os.path.join(run, "checkpoints", "checkpoint_1.pth"),
                denoiser / "checkpoints" / "checkpoint.pth")
    loaded, calls = [], []
    real = run_vis.LoadedModel

    def load(*args, **kwargs):
        lm = real(*args, **kwargs)
        if loaded:                      # the second model is the denoiser
            lm.model.register_forward_pre_hook(
                lambda module, inputs: calls.append(inputs[1].tolist()))
        loaded.append(lm)
        return lm

    monkeypatch.setattr(run_vis, "LoadedModel", load)
    out = run_vis.main([f"load_dir={run}", "eval.batch_size=2", "eval.rounds=2", "+device=cpu",
                        "sampling.method=ode", "sampling.denoiser=network",
                        f"denoiser_path={denoiser}"], out_root=str(tmp_path / "vis"))
    assert len(loaded) == 2
    assert loaded[1].checkpoint_file == str(denoiser / "checkpoints" / "checkpoint.pth")
    assert np.allclose(calls, [[1e-5, 1e-5]] * 2, rtol=1e-6)
    for r in range(2):
        with np.load(os.path.join(out, "images", f"samples_{r}.npz")) as z:
            assert z["samples"].shape == (2, 9, 9, 1) and z["samples"].dtype == np.uint8
