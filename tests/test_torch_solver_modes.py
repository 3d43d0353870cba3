"""The GPU solver's tiling and optimal mode on the CPU (the kernels' plain
versions), float64, from the near-solutions of test_torch_solver.py."""
import numpy as np
import pytest
import torch

from test_torch_solver import near_solutions

from rdm_tpu_torch.physics import solver_gpu as sg

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(scope="module")
def near():
    return near_solutions()


def test_tiled_equals_untiled(near):
    """Tiles of 2 lanes against one tile of 4: each lane's solve is its own."""
    G, H = near
    a = sg.refine_warmstarts_gpu(G, H, max_iters=1, batch_tile=2, solver_mode="feasible",
                                 precision="df32", device="cpu")
    b = sg.refine_warmstarts_gpu(G, H, max_iters=1, batch_tile=64, solver_mode="feasible",
                                 precision="df32", device="cpu")
    np.testing.assert_allclose(a["refined"], b["refined"], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(a["feasible"], b["feasible"])
    np.testing.assert_array_equal(a["iters"], b["iters"])


def test_optimal_mode_semantics(near, monkeypatch):
    """The ratchet's contract, as the JAX package's test states it, with
    the ascent's budget cut to 3 extra iterations to keep the CPU run
    short: inform 1 exactly where the ratchet's step collapsed below
    ``_OPT_GAIN_TOL``; other feasible lanes inform 3; optimal mode loses no
    lane feasible mode solves (the mass row is inactive until first
    feasibility); the mass only ratchets up from the first feasible point."""
    G, H = near
    monkeypatch.setattr(sg, "_OPT_BUDGET", 3)
    feas = sg.refine_warmstarts_gpu(G, H, max_iters=2, solver_mode="feasible",
                                    precision="df32", device="cpu")
    opt = sg.refine_warmstarts_gpu(G, H, max_iters=2, solver_mode="optimal",
                                   precision="df32", device="cpu")
    assert not (feas["feasible"] & ~opt["feasible"]).any()
    cert = opt["optimal"]
    assert (opt["inform"][cert] == 1).all() and (opt["opt_gain"][cert] < sg._OPT_GAIN_TOL).all()
    assert (opt["inform"][opt["feasible"] & ~cert] == 3).all()
    both = feas["feasible"] & opt["feasible"]
    assert both.any()
    assert (opt["final_mass"][both] - feas["final_mass"][both] >= -1e-9).all()
    # feasible lanes carry the mass-rate diagnostic and the ratchet's last step
    assert np.isfinite(opt["stationarity"][opt["feasible"]]).all()
    assert (opt["stationarity"][opt["feasible"]] < 1e6).all()
    assert (opt["iters"][opt["feasible"]] <= 2 + 3).all()
    assert (feas["opt_gain"] == 1e6).all() and (feas["stationarity"] == 1e6).all()
