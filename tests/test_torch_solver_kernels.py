"""The shooting kernels of ``csrc/cr3bp_shoot.cu`` (``ops/cr3bp.py``).

On the CPU: the wrappers' input checks, that a CPU tensor takes the plain
version without counting a launch, the bound's operation counts, and the
manifold chain's thread layouts as ``ops/cr3bp.py`` mirrors them (lanes a
row, the order of ``shoot_jvp``'s columns).
On the card (marker ``gpu``): each kernel against its plain version on
seeded round-2 lanes, two runs bit for bit, the mirrored layout against the
built library, the chain's kernels at 1 row or lane, a ragged count and the
grading's full count, where a slice of rows launched alone equals the same
rows inside the full launch bit for bit, a small solve on the card
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


def test_cpu_tensors_take_the_plain_version_uncounted():
    theta, d64, d32, sp = lanes(2, 1, "cpu")
    before = [f.launches for f in (shoot_ops.shoot_legs, shoot_ops.manifold_target)]
    tgt = shoot_ops.manifold_target(*d64, theta[:, 64].contiguous(), theta[:, 65].contiguous())
    r, finite = shoot_ops.shoot_legs(theta, tgt, sp, 1.0, 20)
    r_ref, f_ref = sg._residual_with_target(theta, tgt, sp, 1.0, 20)
    assert torch.equal(r, r_ref) and torch.equal(finite, f_ref)
    assert [f.launches for f in (shoot_ops.shoot_legs, shoot_ops.manifold_target)] == before


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


SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rdm_tpu_torch", "csrc", "cr3bp_shoot.cu")


def test_chain_lanes_match_the_source():
    """The mirror's lanes a row and block size are the source's constants
    (float64 runs a thread a row)."""
    with open(SOURCE) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (kChainLanes|kThreads) = (\d+);", src))
    assert int(consts["kChainLanes"]) == shoot_ops.LANES[torch.float32]
    assert shoot_ops.LANES[torch.float64] == 1
    assert int(consts["kThreads"]) == shoot_ops.THREADS


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 37, 100, 511, 1024, 1025,
                               8192, 10240])
def test_target_layout_stores_each_row_component_once(M):
    """manifold_target's float32 grid at ragged row counts: each (row,
    component) is stored by exactly one thread, and a warp either runs whole
    or returns whole (the chain's shuffles take the whole warp)."""
    G = shoot_ops.LANES[torch.float32]
    lay = shoot_ops.target_layout(M)
    assert len(lay["row"]) % shoot_ops.THREADS == 0
    written = np.zeros((M, 6), dtype=int)
    t = np.flatnonzero(lay["store"] & (lay["lane"] < 6))
    np.add.at(written, (lay["row"][t], lay["lane"][t]), 1)
    assert (written == 1).all()
    live = (lay["row"] >= 0).reshape(-1, 32)
    assert (live.all(axis=1) | ~live.any(axis=1)).all()
    # a group's lanes are contiguous and share their row
    rows = lay["row"].reshape(-1, G)
    assert (rows == rows[:, :1]).all()


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 33, 100, 257, 1000, 1023, 1024])
def test_jvp_layout_covers_each_lane_column_once(L):
    """shoot_jvp's grid at ragged lane counts: each (lane, column, row of J)
    is written by exactly one thread, the target columns' threads come
    before every leg column's, and no warp mixes two columns of the targets
    or a target column with the legs."""
    lay = shoot_ops.jvp_layout(L)
    written = np.zeros((L, 66, 7), dtype=int)
    s = np.flatnonzero(lay["store"])
    for i in range(7):
        w = s[i % lay["stride"][s] == lay["j"][s]]
        np.add.at(written, (lay["lane"][w], lay["col"][w], i), 1)
    assert (written == 1).all()
    col = lay["col"]
    targets, legs = np.flatnonzero(col >= 64), np.flatnonzero((col >= 0) & (col < 64))
    assert targets.max() < legs.min()
    warps = col[: targets.max() + 1].reshape(-1, 32)
    assert (warps == warps[:, :1]).all()
    assert (lay["stride"][legs] == 1).all() and (lay["j"][legs] == 0).all()


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
    """The mirror's float32 lanes a row are the built library's."""
    from rdm_tpu_torch.ops import _build
    lib = _build.load_library("cr3bp_shoot")
    assert lib.rdm_shoot_chain_lanes() == shoot_ops.LANES[torch.float32]


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
