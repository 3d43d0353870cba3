"""Multi-process dry run of the three data-parallel programs.

    python -m rdm_tpu_torch.dryrun 2

``dryrun_multichip(n)`` is the twin of the JAX package's
``__graft_entry__.dryrun_multichip``: where that builds an n-device virtual
CPU mesh, this starts n processes on the CPU in one gloo process group
(``parallel.launch``) and certifies, on tiny shapes:

1. one full training step of the flagship config (``configs/train.yaml``)
   on 2 rows a rank: gradients averaged over the ranks, the guarded update,
   and every rank ending with the same parameters, bit for bit;
2. sharded PC sampling (100 steps, w = 0, the EMA weights): each rank
   samples 2 from its own generator and rank 0 gathers 2n samples in the
   unit cube;
3. the split oracle: ``refine_warmstarts_gpu`` with one LM iteration on 2n
   lanes split over n devices (here n parts on the CPU, solved in turn).

Rank 0 prints one OK line a leg, as the JAX version does.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .parallel import launch, mesh


def _oracle_inputs(n_g: int):
    """The JAX dry run's 2n random warm starts and halo energies."""
    rs = np.random.RandomState(0)
    G = np.concatenate([
        rs.uniform(0.0, 40.0, (n_g, 1)),           # t_shoot
        rs.uniform(0.0, 15.0, (n_g, 2)),           # coasts
        rs.uniform(0.0, 1.0, (n_g, 60)),           # controls
        rs.uniform(408.0, 470.0, (n_g, 1)),        # mass
        rs.uniform(0.0, 1.0, (n_g, 1)),            # halo phase
        rs.uniform(5.0, 11.0, (n_g, 1)),           # manifold length
    ], axis=1)
    return G, rs.uniform(0.008, 0.095, n_g)


def _worker() -> None:
    """One rank of the dry run (started by ``dryrun_multichip``)."""
    from .config import load_config
    from .models import create_model
    from .models.registry import get_cf_score_fn
    from .physics.solver_gpu import refine_warmstarts_gpu
    from .sampling import get_pc_sampler
    from .sde import RVESDE, get_sde
    from .training.losses import make_train_step
    from .training.state import init_train_state

    device = mesh.setup("cpu")
    n, rank = mesh.world_size(), mesh.rank()
    if "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    say = print if rank == 0 else (lambda *a, **k: None)

    # 1. one full training step
    cfg = load_config("train")
    model = create_model(cfg).init_weights(torch.Generator().manual_seed(0)).to(device)
    state = init_train_state(model, cfg)
    mesh.broadcast_state_(state)
    batch = torch.linspace(0.05, 0.95, 2 * n * 81).reshape(2 * n, 1, 9, 9)
    labels = batch[:, :, 0, 0].clone()
    step = make_train_step(get_sde(cfg), reduce_mean=cfg.training.reduce_mean,
                           likelihood_weighting=cfg.training.likelihood_weighting)
    gen = torch.Generator().manual_seed(mesh.rank_seed(0))
    loss = float(step(state, mesh.shard_rows(batch), mesh.shard_rows(labels), gen))
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert state.step == 1 and state.optimizer.count == 1
    flat = torch.cat([p.detach().reshape(-1) for p in state.params])
    everyone = mesh.gather_rows(flat[None])
    assert all(torch.equal(everyone[0], row) for row in everyone), \
        "the ranks' parameters differ after the step"
    say(f"dryrun_multichip({n}): OK, loss={loss:.4f}", flush=True)

    # 2. sharded PC sampling from the EMA weights
    sde100 = RVESDE(cfg.sde.sigma_min, cfg.sde.sigma_max, N=100)
    sampler = get_pc_sampler(sde100, (2, 1, 9, 9), predictor="euler_maruyama",
                             corrector="none", denoiser="none", eps=1e-5)
    model.eval()
    sgen = torch.Generator().manual_seed(mesh.rank_seed(1))
    with torch.no_grad(), state.ema.average_parameters(state.params):
        lab = torch.rand((2, 1), generator=sgen)
        x, _ = sampler(get_cf_score_fn(sde100, model, lab, 0.0), sgen)
    xs = mesh.gather_rows(x.float())
    assert xs.shape == (2 * n, 1, 9, 9)
    assert bool(torch.isfinite(xs).all()) and float(xs.min()) >= 0 and float(xs.max()) <= 1
    say(f"dryrun_multichip({n}): sampler OK, batch={2 * n} sharded over {n} ranks, "
        f"mean={float(xs.mean()):.4f}", flush=True)

    # 3. the oracle split over n devices (rank 0; the others wait)
    if rank == 0:
        G, H = _oracle_inputs(2 * n)
        res = refine_warmstarts_gpu(G, H, max_iters=1, solver_mode="feasible",
                                    precision="df32", device=["cpu"] * n)
        assert res["refined"].shape == (2 * n, 66)
        assert np.isfinite(res["cost"]).all()
        say(f"dryrun_multichip({n}): oracle OK, batch={2 * n} split over {n} devices, "
            f"median defect={np.median(res['cost']):.3f}", flush=True)
    mesh.barrier()
    mesh.teardown()


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> list:
    """Run the three legs in ``n_devices`` gloo processes on the CPU; returns
    rank 0's OK lines (and prints them).  Raises when a rank fails."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = launch.run_ranks(["-m", "rdm_tpu_torch.dryrun", "--rank-worker"], n_devices,
                            env=env, timeout=timeout)
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("dryrun_multichip(")]
    if len(lines) != 3:
        raise RuntimeError(f"dry run printed {lines}:\n{outs[0][-4000:]}")
    for ln in lines:
        print(ln)
    return lines


if __name__ == "__main__":
    if sys.argv[1:] == ["--rank-worker"]:
        _worker()
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
