"""The shooting kernels of ``csrc/cr3bp_shoot.cu`` (``ops/cr3bp.py``).

On the CPU: the wrappers' input checks, that a CPU tensor takes the plain
version without counting a launch, and the bound's operation counts.
On the card (marker ``gpu``): each kernel against its plain version on
seeded round-2 lanes, two runs bit for bit, a small solve on the card
against the same solve on the CPU, and a solve split over two parts of the
card from an empty build directory against the unsplit one.  The kernels contract multiplies and
adds into FMAs and the CR3BP arcs amplify a rounding by their sensitivity,
so kernel and plain version are held on quantiles of the per-row error, as
``chip_smoke.py`` holds them (its SHOOT_TOL states the reasons)."""
import os

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
