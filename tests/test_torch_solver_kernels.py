"""The shooting kernels of ``csrc/cr3bp_shoot.cu`` (``ops/cr3bp.py``).

On the CPU: the wrappers' input checks, that a CPU tensor takes the plain
version without counting a launch, the bound's operation counts, the
thread layouts as ``ops/cr3bp.py`` mirrors them (the manifold chain's lanes
a row, the order of ``shoot_jvp``'s columns, ``shoot_legs_fd``'s legs),
and the plain ``shoot_legs_fd`` against the plain residual of the trial
rows it replaces.
On the card (marker ``gpu``): each kernel against its plain version on
seeded round-2 lanes, two runs bit for bit, the mirrored layout against the
built library, the chain's kernels at 1 row or lane, a ragged count and the
grading's full count, where a slice of rows launched alone equals the same
rows inside the full launch bit for bit, ``shoot_legs_fd`` against
``shoot_legs`` on the trial rows bit for bit, a small solve on the card
against the same solve on the CPU, and a solve split over two parts of the
card from an empty build directory against the unsplit one.  The kernels contract multiplies and
adds into FMAs and the CR3BP arcs amplify a rounding by their sensitivity,
so kernel and plain version are held on quantiles of the per-row error, as
``chip_smoke.py`` holds them (its SHOOT_TOL states the reasons)."""
import os
import re

import numpy as np
import pytest
import torch

from rdm_tpu_torch.ops import cr3bp as shoot_ops
from rdm_tpu_torch.physics import halo, manifold, solver_gpu as sg
from rdm_tpu_torch.physics.oracle import _mission_constants

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROUND2 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmark_results", "round2_flagship_1024", "gto_halo",
                      "generated_samples.npy")


def lanes(n, seed, device):
    physical = np.load(ROUND2)
    idx = np.random.default_rng(seed).choice(len(physical), n, replace=False)
    G, H = physical[idx, 1:], physical[idx, 0]
    theta = sg._clamp_vars(torch.tensor(G, device=device), 20, 40.0, 15.0)
    sd = halo.interp_seed(H)
    d64 = tuple(torch.tensor(np.asarray(a, np.float64), device=device)
                for a in (sd["state0"], sd["period"], sd["vstable"]))
    d32 = manifold.interp_seed(torch.tensor(H, dtype=torch.float32, device=device))
    spiral = torch.tensor(_mission_constants(6.48423370092)[0], device=device)
    return theta, d64, d32, spiral


# ---------------------------------------------------------------------------
# on the CPU

def test_wrappers_check_their_inputs():
    theta, d64, _, sp = lanes(2, 0, "cpu")
    tgt = torch.zeros(2, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        shoot_ops.shoot_legs(theta.half(), tgt.half(), sp.half(), 1.0, 20)
    with pytest.raises(ValueError, match="shape"):
        shoot_ops.shoot_legs(theta, tgt[:1], sp, 1.0, 20)
    with pytest.raises(ValueError, match="tensors on"):
        shoot_ops.manifold_target(*d64[:2], d64[2].float(), theta[:, 64], theta[:, 65])
    with pytest.raises(ValueError, match="dtype"):
        shoot_ops.shoot_jvp(theta, tgt, *d64, sp, 1.0, 20, 5.0, 11.0)
    with pytest.raises(ValueError, match="n_segments"):
        shoot_ops.shoot_legs(theta, tgt, sp, 1.0, 21)
    with pytest.raises(ValueError, match="dtype"):
        shoot_ops.shoot_legs_fd(theta.float(), theta.float(), tgt.float(),
                                tgt[:, None].repeat(1, 2, 1).float(), sp.float(), 1.0, 20)
    with pytest.raises(ValueError, match="shape"):
        shoot_ops.shoot_legs_fd(theta, theta, tgt, tgt, sp, 1.0, 20)


def test_cpu_tensors_take_the_plain_version_uncounted():
    theta, d64, d32, sp = lanes(2, 1, "cpu")
    counted = (shoot_ops.shoot_legs, shoot_ops.manifold_target, shoot_ops.shoot_legs_fd)
    before = [f.launches for f in counted]
    tgt = shoot_ops.manifold_target(*d64, theta[:, 64].contiguous(), theta[:, 65].contiguous())
    r, finite = shoot_ops.shoot_legs(theta, tgt, sp, 1.0, 20)
    r_ref, f_ref = sg._residual_with_target(theta, tgt, sp, 1.0, 20)
    assert torch.equal(r, r_ref) and torch.equal(finite, f_ref)
    h = theta.abs() + 1.0
    rows = shoot_ops.shoot_legs_fd(theta, h, tgt, tgt[:, None].repeat(1, 2, 1), sp, 1.0, 20)
    assert torch.equal(rows, shoot_ops.shoot_legs_fd_reference(
        theta, h, tgt, tgt[:, None].repeat(1, 2, 1), sp, 1.0, 20))
    assert [f.launches for f in counted] == before


def test_operation_counts():
    """The bound's arithmetic: 384 RK4 steps of the low-thrust field a row
    at 20 segments, 256 variational + 1024 ballistic steps a target; the
    Jacobian's legs columns each run one leg but t_shoot's, which runs both."""
    step = shoot_ops.rk4_ops(shoot_ops.OPS_EOM7, 7)
    assert shoot_ops.shoot_legs_ops(10) == 10 * 384 * step
    ball = 1024 * shoot_ops.rk4_ops(shoot_ops.OPS_ODE6, 6)
    assert shoot_ops.manifold_target_ops(1, torch.float64) == (
        256 * shoot_ops.rk4_ops(shoot_ops.OPS_ODE12, 12) + ball)
    legs = 64 * 192 + 192 + 192  # each of 64 columns one leg, t_shoot the other too
    assert shoot_ops.shoot_jvp_ops(1) > shoot_ops.DUAL_OPS * legs * step
    # the float64 Jacobian's rows: the base point's 2 legs and the 67 its
    # 66 columns move (t_shoot both, 64 and 65 the backward one)
    assert shoot_ops.shoot_legs_fd_ops(10) == 10 * 69 * 192 * step


SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rdm_tpu_torch", "csrc", "cr3bp_shoot.cu")


def test_chain_lanes_match_the_source():
    """The mirror's lanes a row (in both types) and block sizes are the
    source's constants (``fd_layout`` pads shoot_legs_fd's legs to whole
    blocks of kFdThreads)."""
    with open(SOURCE) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (kChainLanes64|kChainLanes|kThreads|kFdThreads) "
                             r"= (\d+)", src))
    assert int(consts["kChainLanes"]) == shoot_ops.LANES[torch.float32]
    assert int(consts["kChainLanes64"]) == shoot_ops.LANES[torch.float64]
    assert int(consts["kThreads"]) == int(consts["kFdThreads"]) == shoot_ops.THREADS


def test_jvp_constants_match_the_source():
    """shoot_jvp's start state seed code and the scratch's offsets as the
    mirror has them are the source's."""
    with open(SOURCE) as f:
        src = f.read()
    (seed,) = re.findall(r"constexpr int kSeedState = (\d+);", src)
    assert int(seed) == shoot_ops.SEED_STATE
    (offsets,) = re.findall(r"constexpr int kScrF0 = (\d+), kScrB0 = (\d+), kScrPhi = (\d+), "
                            r"kScrDT = (\d+) \+ (\d+) \* (\d+);", src)
    f0, b0, phi, dt, rows, cols = map(int, offsets)
    at = shoot_ops.JVP_SCRATCH_AT
    assert (f0, b0, phi, dt + rows * cols) == (at["f0"], at["b0"], at["phi"], at["dT"])
    assert "constexpr int kJvpScratch = kScrDT + 2 * 6;" in src
    assert shoot_ops.JVP_SCRATCH == at["dT"] + 12


@pytest.mark.parametrize("n_segments", range(1, 21))
def test_jvp_jobs_seed_each_moved_leg_once(n_segments):
    """shoot_jvp's leg jobs: each column 0-63 is seeded on exactly the legs
    it moves, once each (t_shoot on both, the others on one), the start
    state's six components once on the backward leg, and the forward jobs
    come first."""
    jobs = shoot_ops.jvp_jobs(n_segments)
    seen = {}
    for leg, c in jobs:
        seen[c, leg] = seen.get((c, leg), 0) + 1
    want = {(c, g): 1 for c in range(64) for g in (0, 1) if shoot_ops.moves(c, g, n_segments)}
    want.update({(shoot_ops.SEED_STATE + i, 1): 1 for i in range(6)})
    assert seen == want
    legs = [leg for leg, _ in jobs]
    assert legs == sorted(legs)
    assert len(jobs) == 3 * n_segments + 11


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 37, 100, 511, 1024, 1025,
                               8192, 10240])
def test_target_layout_stores_each_row_component_once(M):
    """manifold_target's grid at ragged row counts, in float32 and float64:
    each (row, component) is stored by exactly one thread, and a warp either
    runs whole or returns whole (the chain's shuffles take the whole warp)."""
    for dtype in (torch.float32, torch.float64):
        G = shoot_ops.LANES[dtype]
        lay = shoot_ops.target_layout(M, dtype)
        assert len(lay["row"]) % shoot_ops.THREADS == 0
        written = np.zeros((M, 6), dtype=int)
        for c in range(0, 6, G):
            t = np.flatnonzero(lay["store"] & (lay["lane"] + c < 6))
            np.add.at(written, (lay["row"][t], lay["lane"][t] + c), 1)
        assert (written == 1).all()
        live = (lay["row"] >= 0).reshape(-1, 32)
        assert (live.all(axis=1) | ~live.any(axis=1)).all()
        # a group's lanes are contiguous and share their row
        rows = lay["row"].reshape(-1, G)
        assert (rows == rows[:, :1]).all()


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 33, 100, 257, 1000, 1023, 1024])
def test_jvp_layout_covers_each_lane_column_once(L):
    """shoot_jvp's two launches at ragged lane counts, at 20 and 7
    segments: each (lane, column, row of J) is stored exactly once (a leg
    job's column by the job; column 0 from t_shoot's forward and backward
    tangents, columns 64 and 65 as -Phi dT, and the columns of segments
    past the last as zeros, by the combine launch, a thread per lane and
    row), each entry of a lane's scratch is written by exactly one thread
    (column 0's two legs, Phi by the start state's jobs, dT by lane j < 6 of
    a target column's group), the target columns' threads come before
    every leg job's, no warp mixes the two target columns or a target
    column with the legs, and the groups past the last lane store
    nothing."""
    at = shoot_ops.JVP_SCRATCH_AT
    for n_segments in (20, 7):
        lay = shoot_ops.jvp_layout(L, n_segments)
        assert len(lay["col"]) % shoot_ops.THREADS == 0
        written = np.zeros((L, 66, 7), dtype=int)
        scratch = np.zeros((L, shoot_ops.JVP_SCRATCH), dtype=int)
        s = np.flatnonzero(lay["store"])
        np.add.at(scratch, (lay["lane"][s], at["dT"] + (lay["col"][s] - 64) * 6 + lay["j"][s]), 1)
        legs = np.flatnonzero(lay["job"] >= 0)
        assert len(legs) == len(shoot_ops.jvp_jobs(n_segments)) * L
        col, lane, fwd = lay["seeded"][legs], lay["lane"][legs], lay["leg"][legs] == 0
        rows = np.arange(7)
        for t in np.flatnonzero((col > 0) & (col < 64)):
            written[lane[t], col[t], rows] += 1
        for t in np.flatnonzero(col == 0):
            scratch[lane[t], (at["f0"] if fwd[t] else at["b0"]) + rows] += 1
        for t in np.flatnonzero(col >= shoot_ops.SEED_STATE):
            assert not fwd[t]
            scratch[lane[t], at["phi"] + rows * 6 + col[t] - shoot_ops.SEED_STATE] += 1
        written[:, [0, 64, 65]] += 1
        written[:, 3 + 3 * n_segments:63] += 1
        assert (written == 1).all() and (scratch == 1).all()
        col = lay["col"]
        targets = np.flatnonzero(col >= 64)
        assert targets.max() < legs.min()
        warps = col[: targets.max() + 1].reshape(-1, 32)
        assert (warps == warps[:, :1]).all()
        live = (lay["job"] >= 0) | (col >= 64)
        assert not live[len(targets) + len(legs):].any()


def test_backward_leg_sensitivity_transports_a_seed():
    """The identity behind shoot_jvp's columns 64 and 65, in float64 on the
    dual numbers of physics/dual.py: the backward leg's sensitivity Phi
    [7 x 6] to its start state (six tangents seeded on the start state)
    times a seed equals that seed carried through the leg as one tangent,
    within 1e-10 of the lane's largest entry, at 20 and 7 segments on 4
    seeded round-2 lanes; the mass row of Phi is zero."""
    from rdm_tpu_torch.physics.dual import Dual

    theta, d64, _, _ = lanes(4, 11, "cpu")
    tgt = shoot_ops.manifold_target(*d64, theta[:, 64].contiguous(), theta[:, 65].contiguous())
    mass = torch.clamp(theta[:, 63], 301.0, 752.0)
    E = torch.eye(6, dtype=torch.float64)[:, :, None]
    v = torch.from_numpy(np.random.default_rng(12).standard_normal((6, 4)))
    for n_segments in (20, 7):
        phi_leg = shoot_ops.backward_leg_plain(
            tuple(Dual(tgt[:, i], E[:, i]) for i in range(6)) + (mass,), theta, 1.0, n_segments)
        one = shoot_ops.backward_leg_plain(
            tuple(Dual(tgt[:, i], v[i]) for i in range(6)) + (mass,), theta, 1.0, n_segments)
        phi = torch.stack([shoot_ops._tangent(x, v) for x in phi_leg])                  # [7, 6, L]
        w = torch.stack([shoot_ops._tangent(x, v[0]) for x in one])                      # [7, L]
        assert (phi[6] == 0).all() and (w[6] == 0).all()
        got = (phi * v[None]).sum(1)
        scale = w.abs().amax(0)
        assert ((got - w).abs().amax(0) / scale).max() < 1e-10


@pytest.mark.parametrize("n_segments", range(1, 21))
def test_fd_layout_covers_each_moved_leg_once(n_segments):
    """shoot_legs_fd's grid of legs at ragged lane counts: each leg a column
    moves and the base point's two legs are run by exactly one thread a
    lane, no other thread runs, and each column's residual takes its own
    leg where it moves it and the base point's where it does not."""
    jobs = shoot_ops.fd_jobs(n_segments)
    assert len(jobs) == 9 + 3 * n_segments
    for L in (1, 3, 33, 1024):
        lay = shoot_ops.fd_layout(L, n_segments)
        assert len(lay["job"]) % shoot_ops.THREADS == 0
        live = lay["job"] >= 0
        assert live.sum() == len(jobs) * L
        ran = {}
        for lane, col, leg in zip(lay["lane"][live], lay["col"][live], lay["leg"][live]):
            ran[lane, col, leg] = ran.get((lane, col, leg), 0) + 1
        want = {(lane, c, g): 1 for lane in range(L) for c in range(-1, 66) for g in (0, 1)
                if c < 0 or shoot_ops.moves(c, g, n_segments)}
        assert ran == want
    for c in range(66):
        for g in (0, 1):
            own = shoot_ops.moves(c, g, n_segments)
            assert jobs[shoot_ops.fd_job_of(c, g, n_segments)] == ((c, g) if own else (-1, g))


@pytest.mark.parametrize("n_segments", [20, 7])
def test_shoot_legs_fd_plain_matches_the_trial_rows(n_segments):
    """The plain shoot_legs_fd (each moved leg once, the base point's legs
    for the rest) against shoot_legs' plain version on the 66 trial rows a
    lane, theta + diag(h), that the solver formed before it, at 3 seeded
    lanes with signed zeros among the variables: within 1e-12 of max(1,
    |r|) per row.  Not bit for bit: the two batch the legs otherwise, and
    the CPU's vectorised sin and cos may round a batch's tail otherwise than
    its body."""
    theta, d64, _, sp = lanes(3, 8, "cpu")
    theta[0, 1] = -0.0
    theta[1, 2] = -0.0
    h = sg._FD_STEP * (theta.abs() + 1.0)
    tgt = shoot_ops.manifold_target(*d64, theta[:, 64].contiguous(), theta[:, 65].contiguous())
    tgt_moved = tgt[:, None, :] + torch.tensor([1e-9, -2e-9], dtype=torch.float64)[None, :, None]
    rows = shoot_ops.shoot_legs_fd(theta, h, tgt, tgt_moved, sp, 1.0, n_segments)
    trial = (theta[:, None, :] + torch.diag_embed(h)).reshape(-1, 66)
    tg = tgt[:, None, :].expand(3, 66, 6).clone()
    tg[:, 64:] = tgt_moved
    ref, _ = shoot_ops.shoot_legs_reference(trial, tg.reshape(-1, 6), sp, 1.0, n_segments)
    assert rows.shape == (3, 66, 7)
    assert rel_rows(rows.reshape(-1, 7), ref).max() < 1e-12


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def quantile(e, q):
    return float(torch.quantile(e.double().cpu(), q))


def rel_rows(a, b):
    f = torch.isfinite(a) & torch.isfinite(b)
    e = (a - b).abs() / b.abs().clamp(min=1.0)
    return torch.where(f, e, torch.zeros_like(e)).amax(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,q50,q90", [(torch.float64, 1e-12, 1e-8),
                                           (torch.float32, 1e-4, 1e-2)])
def test_shoot_legs_matches_plain(cuda_device, dtype, q50, q90):
    theta, d64, d32, sp = lanes(256, 2, cuda_device)
    data = d64 if dtype == torch.float64 else d32
    theta = theta.to(dtype)
    tgt = shoot_ops.manifold_target_reference(*data, theta[:, 64], theta[:, 65])
    r, fin = shoot_ops.shoot_legs(theta, tgt, sp.to(dtype), 1.0, 20)
    r2, fin2 = shoot_ops.shoot_legs(theta, tgt, sp.to(dtype), 1.0, 20)
    assert torch.equal(r, r2) and torch.equal(fin, fin2)
    ref, fref = shoot_ops.shoot_legs_reference(theta, tgt, sp.to(dtype), 1.0, 20)
    assert torch.equal(fin, fref)
    e = rel_rows(r, ref)
    assert quantile(e, 0.5) < q50 and quantile(e, 0.9) < q90
    arc, _ = shoot_ops.shoot_legs(theta, None, sp.to(dtype), 1.0, 20, full=True)
    arc_ref, _ = shoot_ops.shoot_legs_reference(theta, None, sp.to(dtype), 1.0, 20, full=True)
    # the mass depends on the throttles and times only
    torch.testing.assert_close(arc[:, 6], arc_ref[:, 6], rtol=1e-4 if dtype == torch.float32
                               else 1e-12, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,q50,q99", [(torch.float64, 1e-12, 1e-8),
                                           (torch.float32, 1e-4, 3e-2)])
def test_manifold_target_matches_plain(cuda_device, dtype, q50, q99):
    theta, d64, d32, _ = lanes(256, 3, cuda_device)
    data = d64 if dtype == torch.float64 else d32
    theta = theta.to(dtype)
    args = (*data, theta[:, 64].contiguous(), theta[:, 65].contiguous())
    out = shoot_ops.manifold_target(*args)
    assert torch.equal(out, shoot_ops.manifold_target(*args))
    e = (out - shoot_ops.manifold_target_reference(*args)).abs().amax(-1)
    assert quantile(e, 0.5) < q50 and quantile(e, 0.99) < q99


@pytest.mark.gpu
def test_shoot_jvp_matches_plain(cuda_device):
    theta, _, d32, sp = lanes(128, 4, cuda_device)
    theta, sp = theta.float(), sp.float()
    tgt = shoot_ops.manifold_target(*d32, theta[:, 64].contiguous(), theta[:, 65].contiguous())
    args = (theta, tgt, *d32, sp, 1.0, 20, 5.0, 11.0)
    J = shoot_ops.shoot_jvp(*args)
    assert torch.equal(J, shoot_ops.shoot_jvp(*args))
    ref = shoot_ops.shoot_jvp_reference(*args)
    e = (J - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2)).clamp(min=1e-6)
    assert quantile(e, 0.5) < 1e-3 and quantile(e, 0.75) < 2e-2


@pytest.mark.gpu
def test_solve_on_the_card_matches_the_cpu(cuda_device):
    """A float64 solve of four lanes, two iterations: the card's kernels
    against the plain versions on the CPU, the same feasible flags and
    costs within 1e-6."""
    physical = np.load(ROUND2)
    G, H = physical[:4, 1:], physical[:4, 0]
    card = sg.refine_warmstarts_gpu(G, H, max_iters=2, solver_mode="feasible", precision="df32")
    cpu = sg.refine_warmstarts_gpu(G, H, max_iters=2, solver_mode="feasible", precision="df32",
                                   device="cpu")
    np.testing.assert_array_equal(card["feasible"], cpu["feasible"])
    np.testing.assert_allclose(card["cost"], cpu["cost"], rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_split_on_a_fresh_build_directory(cuda_device, tmp_path, monkeypatch):
    """A solve split over two parts of the card whose threads both reach the
    shooting library's first use in an empty build directory: one build,
    and the result of the unsplit solve lane for lane."""
    from rdm_tpu_torch.ops import _build
    physical = np.load(ROUND2)
    G, H = physical[:8, 1:], physical[:8, 0]
    kw = dict(max_iters=2, solver_mode="feasible", precision="df32")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    _build._load.cache_clear()
    try:
        card = torch.device("cuda", 0)
        split = sg.refine_warmstarts_gpu(G, H, device=[card, card], **kw)
    finally:
        _build._load.cache_clear()
    assert [f for f in os.listdir(tmp_path) if f.endswith(".so")] == [
        os.path.basename(_build.library_path("cr3bp_shoot"))]
    one = sg.refine_warmstarts_gpu(G, H, device=card, **kw)
    for k in one:
        np.testing.assert_array_equal(np.asarray(split[k]), np.asarray(one[k]), err_msg=k)


@pytest.mark.gpu
def test_chain_layout_matches_the_built_library(cuda_device):
    """The mirror's lanes a row in both types, and shoot_jvp's leg jobs a
    lane at 1-20 segments and floats of scratch a lane, are the built
    library's."""
    from rdm_tpu_torch.ops import _build
    lib = _build.load_library("cr3bp_shoot")
    assert lib.rdm_shoot_chain_lanes() == shoot_ops.LANES[torch.float32]
    assert lib.rdm_shoot_chain_lanes_f64() == shoot_ops.LANES[torch.float64]
    # shoot_jvp's leg jobs a lane and its scratch
    assert lib.rdm_shoot_jvp_scratch() == shoot_ops.JVP_SCRATCH
    assert [lib.rdm_shoot_jvp_leg_jobs(n) for n in range(1, 21)] == [
        len(shoot_ops.jvp_jobs(n)) for n in range(1, 21)]


@pytest.fixture(scope="module")
def fd_lanes():
    """1024 seeded round-2 lanes of shoot_legs_fd's inputs as one float64
    Jacobian gives them (steps 1e-6 (|theta| + 1), the moved targets of
    columns 64 and 65) and the full launch's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    theta, d64, _, sp = lanes(1024, 9, "cuda")
    h = sg._FD_STEP * (theta.abs() + 1.0)
    tgt = shoot_ops.manifold_target(*d64, theta[:, 64].contiguous(), theta[:, 65].contiguous())
    moved = sg._target(sg._fd_tail(theta, h), [x.repeat_interleave(2, 0) for x in d64], 5.0,
                       11.0).reshape(-1, 2, 6)
    args = (theta, h, tgt, moved)
    return args, sp, shoot_ops.shoot_legs_fd(*args, sp, 1.0, 20)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 33, 1024])
def test_shoot_legs_fd_by_lanes(cuda_device, fd_lanes, L):
    """At 1, 33 and 1024 lanes: the rows equal ``shoot_legs`` on the 66
    trial rows a lane (theta + diag(h), columns 64-65 against their moved
    targets) bit for bit, at 20 segments and at 7 (the unused columns take
    both base legs); two runs bit for bit; the lanes launched alone (the
    first L, and L from lane 500) equal the same lanes of the full launch."""
    args, sp, full = fd_lanes
    for k in (0, 500):
        part = tuple(a[k:k + L].contiguous() for a in args)
        rows = shoot_ops.shoot_legs_fd(*part, sp, 1.0, 20)
        assert torch.equal(rows, shoot_ops.shoot_legs_fd(*part, sp, 1.0, 20))
        assert torch.equal(rows, full[k:k + L])
    theta, h, tgt, moved = (a[:L].contiguous() for a in args)
    trial = (theta[:, None, :] + torch.diag_embed(h)).reshape(-1, 66)
    tg = tgt[:, None, :].expand(L, 66, 6).clone()
    tg[:, 64:] = moved
    for n_segments in (20, 7):
        r, _ = shoot_ops.shoot_legs(trial, tg.reshape(-1, 6), sp, 1.0, n_segments)
        rows = shoot_ops.shoot_legs_fd(theta, h, tgt, moved, sp, 1.0, n_segments)
        assert torch.equal(rows, r.reshape(L, 66, 7))


TARGET_TOL = {torch.float64: {0.5: 1e-12, 0.99: 1e-8}, torch.float32: {0.5: 1e-4, 0.99: 3e-2}}
JVP_TOL = {0.5: 1e-3, 0.75: 2e-2}
# rows (lanes) launched one at a time at size 1, so that the plain version's
# quantiles are over many one-row launches as over many rows
ONE_BY_ONE = 37


def held(e, tol):
    """The per-row errors ``e`` within ``tol`` (quantile -> bound)."""
    return all(quantile(e, q) < bound for q, bound in tol.items())


@pytest.fixture(scope="module")
def chain_rows():
    """10,240 seeded round-2 rows of manifold_target's inputs in each type
    (tau and length moved as the solver's ladder moves them) and the full
    launch's targets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    theta, d64, d32, _ = lanes(1024, 5, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    rep = lambda x: x.repeat_interleave(10, 0).contiguous()
    tau = (rep(theta[:, 64]) + 0.01 * torch.randn(10240, generator=gen, device="cuda",
                                                  dtype=torch.float64)).clamp(0, 1)
    length = (rep(theta[:, 65]) + 0.1 * torch.randn(10240, generator=gen, device="cuda",
                                                    dtype=torch.float64)).clamp(5, 11)
    out = {}
    for dtype, data in ((torch.float64, d64), (torch.float32, d32)):
        args = tuple(rep(x) for x in data) + (tau.to(dtype).contiguous(),
                                              length.to(dtype).contiguous())
        out[dtype] = (args, shoot_ops.manifold_target(*args))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 37, 10240])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_manifold_target_by_rows(cuda_device, chain_rows, dtype, M):
    """At 1 row, at 37 (the last warp's groups partly masked) and at 10,240
    (the grading's largest launch): two runs bit for bit, the rows launched
    alone (the first M, and M in the middle) equal to the same rows of the
    full launch bit for bit, and the per-row error against the plain
    version within the quantiles ``test_manifold_target_matches_plain``
    holds, over 37 one-row launches at size 1."""
    args, full = chain_rows[dtype]
    for k in (0, 5000):
        part = tuple(a[k:k + M].contiguous() for a in args)
        out = shoot_ops.manifold_target(*part)
        assert torch.equal(out, shoot_ops.manifold_target(*part))
        assert torch.equal(out, full[k:k + M])
    n = max(M, ONE_BY_ONE)
    if M == 1:
        out = torch.cat([shoot_ops.manifold_target(*(a[i:i + 1].contiguous() for a in args))
                         for i in range(n)])
    else:
        out = full[:n]
    part = tuple(a[:n].contiguous() for a in args)
    e = (out - shoot_ops.manifold_target_reference(*part)).abs().amax(-1)
    assert held(e, TARGET_TOL[dtype])


@pytest.fixture(scope="module")
def jvp_lanes():
    """1024 seeded round-2 lanes of shoot_jvp's inputs and the full launch's J."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    theta, _, d32, sp = lanes(1024, 7, "cuda")
    theta, sp = theta.float(), sp.float()
    tgt = shoot_ops.manifold_target(*d32, theta[:, 64].contiguous(), theta[:, 65].contiguous())
    args = (theta, tgt, *d32)
    return args, sp, shoot_ops.shoot_jvp(*args, sp, 1.0, 20, 5.0, 11.0)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 33, 1024])
def test_shoot_jvp_by_lanes(cuda_device, jvp_lanes, L):
    """At 1, 33 (ragged: the target groups' last warp partly masked, the
    columns not a multiple of a warp) and 1024 lanes: two runs bit for bit,
    the lanes launched alone (the first L, and L from lane 500) equal to the
    same lanes of the full launch bit for bit, and the per-lane error
    against the plain version within the quantiles
    ``test_shoot_jvp_matches_plain`` holds, over 37 one-lane launches at
    size 1 and 37 lanes at 33."""
    args, sp, full = jvp_lanes
    tail = (sp, 1.0, 20, 5.0, 11.0)
    for k in (0, 500):
        part = tuple(a[k:k + L].contiguous() for a in args)
        J = shoot_ops.shoot_jvp(*part, *tail)
        assert torch.equal(J, shoot_ops.shoot_jvp(*part, *tail))
        assert torch.equal(J, full[k:k + L])
    n = max(L, ONE_BY_ONE)
    if L == 1:
        J = torch.cat([shoot_ops.shoot_jvp(*(a[i:i + 1].contiguous() for a in args), *tail)
                       for i in range(n)])
    else:
        J = full[:n]
    ref = shoot_ops.shoot_jvp_reference(*(a[:n].contiguous() for a in args), *tail)
    e = (J - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2)).clamp(min=1e-6)
    assert held(e, JVP_TOL)
