"""CR3BP training-data generation: sample initial guesses, solve each
through the oracle, and pickle the feasible solutions; then
``datagen.prepare_training_data`` turns the folder into the [N, 67]
training pickle.

    python -m rdm_tpu_torch.generate_data --result_folder out --seed 0 --seed_step 4096

Backends (``--backend``):

* ``tpu``: the whole seed range as one tiled batch on the card, through
  ``physics.solver_gpu.refine_warmstarts_gpu`` (float32, the JAX package's
  default precision for this call); ``--n_devices`` splits each tile over
  cards (0: every card).  ``--device cpu`` runs it on the CPU, slowly.
* ``native``: the same seed range on the host's C++ oracle.
* ``pydylan``: the reference's SNOPT solve, one seed at a time, where
  pydylan is installed.
* the defect check (``oracle.DEFECT_CHECK_BACKEND``, the JAX package's name
  for it): each guess checked as it is, no solve.
* ``auto`` (default): pydylan when it is installed, otherwise ``tpu`` on the
  card (or on ``--device``).  ``native`` and the defect check run only when
  asked for.

Without a card, ``tpu`` and ``auto`` raise unless ``--device cpu`` is given.
File names and contents match the JAX package's ``generate_data.py``:
``{feasible|infeasible}_cr3bp_earth_alpha_{E:.4f}_seed_{seed}.pkl``, each a
one-element list of the simulator's result dict.
"""
from __future__ import annotations

import argparse
import os
import pickle

from .physics.oracle import DEFECT_CHECK_BACKEND


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seed_step", type=int, default=100,
                   help="number of seeds to process starting at --seed")
    p.add_argument("--initial_guess_sample_mode", default="uniform_sample",
                   choices=["uniform_sample", "from_pickle", "from_diffusion",
                            "gt_example"])
    p.add_argument("--guess_path", default=None,
                   help="pickle path for from_pickle/from_diffusion modes")
    p.add_argument("--alpha", type=float, default=None,
                   help="fixed normalised halo energy in [0,1]; default random")
    p.add_argument("--number_of_segments", type=int, default=20)
    p.add_argument("--maximum_shooting_time", type=float, default=40.0)
    p.add_argument("--minimum_shooting_time", type=float, default=0.0)
    p.add_argument("--start_bdry", type=float, default=6.48423370092)
    p.add_argument("--end_bdry", type=float, default=8.0)
    p.add_argument("--thrust", type=float, default=1.0)
    p.add_argument("--solver_mode", default="optimal", choices=["feasible", "optimal"],
                   help="reference fixed_alpha.py default: optimal")
    p.add_argument("--min_mass_to_sample", type=float, default=408)
    p.add_argument("--max_mass_to_sample", type=float, default=470)
    p.add_argument("--snopt_time_limit", type=float, default=500.0)
    p.add_argument("--result_folder", required=True)
    p.add_argument("--save_infeasible", action="store_true")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "pydylan", "tpu", "native", DEFECT_CHECK_BACKEND],
                   help="oracle backend; 'tpu' solves the whole seed range as "
                        "batched LM on the card; 'auto' picks pydylan when it is "
                        "installed, otherwise 'tpu' on the card")
    p.add_argument("--batch_tile", type=int, default=4096,
                   help="tpu backend: samples solved at once")
    p.add_argument("--max_iters", type=int, default=30,
                   help="tpu/native backends: LM iteration budget per sample")
    p.add_argument("--n_devices", type=int, default=0,
                   help="tpu backend: split each tile over this many cards (0 = all)")
    p.add_argument("--device", default=None,
                   help="device of the batched backends (default: the card); "
                        "'cpu' runs them on the CPU")
    return p.parse_args(argv)


def resolve_backend(backend: str, device=None) -> str:
    """``auto`` -> pydylan when installed, else ``tpu``.  ``tpu`` checks its
    device now: without a card and without ``device`` it raises."""
    from .device import resolve_device
    from .physics import oracle as oracle_lib

    if backend == "auto":
        backend = "pydylan" if oracle_lib.PYDYLAN_AVAILABLE else "tpu"
    if backend == "tpu":
        resolve_device(device)
    return backend


def main(argv=None):
    args = parse_args(argv)
    from .datagen import CR3BPInitGenerator
    from .physics.oracle import CR3BPEarthMissionWarmstartSimulatorBoundary

    backend = resolve_backend(args.backend, args.device)
    os.makedirs(args.result_folder, exist_ok=True)
    gen = CR3BPInitGenerator(
        initial_guess_sample_mode=args.initial_guess_sample_mode,
        thrust=args.thrust, min_mass_to_sample=args.min_mass_to_sample,
        max_mass_to_sample=args.max_mass_to_sample,
        min_manifold_length=5.0, max_manifold_length=11.0,
        pickle_path=args.guess_path, diffusion_path=args.guess_path)

    if backend in ("tpu", "native") and args.initial_guess_sample_mode == "uniform_sample":
        return _run_batched(args, gen, backend)

    sim = CR3BPEarthMissionWarmstartSimulatorBoundary(
        seed=args.seed, seed_step=args.seed_step,
        number_of_segments=args.number_of_segments,
        maximum_shooting_time=args.maximum_shooting_time,
        minimum_shooting_time=args.minimum_shooting_time,
        start_bdry=args.start_bdry, end_bdry=args.end_bdry,
        thrust=args.thrust, solver_mode=args.solver_mode,
        min_mass_to_sample=args.min_mass_to_sample,
        max_mass_to_sample=args.max_mass_to_sample,
        snopt_time_limit=args.snopt_time_limit,
        result_folder=args.result_folder, backend=backend, device=args.device)
    n_feasible = 0
    for seed in range(args.seed, args.seed + args.seed_step):
        halo_energy, guesses = gen.get_earth_initial_guess(
            seed, args.number_of_segments, args.maximum_shooting_time,
            args.minimum_shooting_time)
        if args.alpha is not None:
            # the reference's fixed-alpha mapping
            halo_energy = 0.008 + args.alpha * (0.095 - 0.008)
        for guess in guesses:
            result = sim.simulate(earth_initial_guess=guess, halo_energy=halo_energy)
            if result["feasibility"] or args.save_infeasible:
                if backend != "pydylan":
                    _period_to_tu(result, halo_energy)
                _write(args.result_folder, result, halo_energy, seed)
                n_feasible += bool(result["feasibility"])
        print(f"seed {seed}: feasible so far {n_feasible}")
    print(f"done: {n_feasible} feasible solutions in {args.result_folder}")
    return {"backend": backend, "n": args.seed_step, "n_feasible": n_feasible}


def _write(folder, result, halo_energy, seed):
    tag = "feasible" if result["feasibility"] else "infeasible"
    path = os.path.join(folder, f"{tag}_cr3bp_earth_alpha_{halo_energy:.4f}_seed_{seed}.pkl")
    with open(path, "wb") as f:
        pickle.dump([result], f)


def _period_to_tu(result, halo_energy):
    """The local solvers refine the halo-period slot as the orbit-phase
    fraction in [0, 1]; SNOPT's control state carries it in TU, which
    ``prepare_training_data`` divides back out.  Convert, so that every
    backend's files normalise alike."""
    from .datagen import get_halo_period
    control = result["results.control"].copy()
    control[-2] = control[-2] * get_halo_period(float(halo_energy))
    result["results.control"] = control


def _run_batched(args, gen, backend):
    """The whole seed range as one tiled batch, in place of the reference's
    per-seed fan-out over a cluster."""
    import time

    import numpy as np

    t0 = time.time()
    guesses, energies, seeds = [], [], []
    for seed in range(args.seed, args.seed + args.seed_step):
        halo_energy, gl = gen.get_earth_initial_guess(
            seed, args.number_of_segments, args.maximum_shooting_time,
            args.minimum_shooting_time)
        if args.alpha is not None:
            halo_energy = 0.008 + args.alpha * (0.095 - 0.008)
        for g in gl:
            guesses.append(g)
            energies.append(halo_energy)
            seeds.append(seed)
    G = np.stack(guesses)
    H = np.asarray(energies)

    launches = None
    if backend == "tpu":
        from .ops import cr3bp as shoot_ops
        from .physics import solver_gpu
        kernels = (shoot_ops.shoot_legs, shoot_ops.manifold_target, shoot_ops.shoot_jvp)
        before = [k.launches for k in kernels]
        res = solver_gpu.refine_warmstarts_gpu(
            G, H, thrust=args.thrust, n_segments=args.number_of_segments,
            start_bdry=args.start_bdry, max_iters=args.max_iters,
            max_shoot=args.maximum_shooting_time,
            min_shoot=args.minimum_shooting_time,
            batch_tile=args.batch_tile, n_devices=args.n_devices,
            min_mass=args.min_mass_to_sample, max_mass=args.max_mass_to_sample,
            solver_mode=args.solver_mode, precision="f32", device=args.device)
        launches = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
        # Shooting work per LM iteration in this solver: the float32 Jacobian
        # transports one forward-mode tangent per variable (66 columns, one
        # shoot_jvp launch), and the damping ladder shoots its 8 trial steps.
        # (The JAX package counts 15: 7 reverse-mode cotangents + 8 trials.)
        shoots_per_iter = solver_gpu.NVAR + solver_gpu._N_LAMBDA
    else:
        from .physics.oracle import evaluate_warmstarts_native
        res = evaluate_warmstarts_native(
            G, H, thrust=args.thrust, n_segments=args.number_of_segments,
            start_bdry=args.start_bdry, max_iters=args.max_iters,
            max_shoot=args.maximum_shooting_time,
            min_shoot=args.minimum_shooting_time,
            min_mass=args.min_mass_to_sample, max_mass=args.max_mass_to_sample,
            solver_mode=args.solver_mode)
        shoots_per_iter = 70   # 66-column finite differences + trials
    solve_s = time.time() - t0
    per_sample = solve_s / len(G)

    n_feasible = 0
    for i in range(len(G)):
        feasible = bool(res["feasible"][i])
        if not feasible and not args.save_infeasible:
            continue
        result = {
            "results.control": res["refined"][i],
            "feasibility": feasible,
            "snopt_control_evaluations": int(res["iters"][i]) * shoots_per_iter,
            "snopt_inform": int(res["inform"][i]),
            "thrust": args.thrust,
            "solving_time": per_sample,
            "cost_alpha": float(H[i]),
        }
        _period_to_tu(result, H[i])
        _write(args.result_folder, result, H[i], seeds[i])
        n_feasible += feasible
    print(f"done ({backend}, batched): {n_feasible}/{len(G)} feasible in "
          f"{args.result_folder} ({per_sample * 1e3:.1f} ms/sample)")
    if launches is not None:
        print(f"shooting kernel launches: {launches}")
    return {"backend": backend, "n": len(G), "n_feasible": int(n_feasible),
            "ms_per_sample": per_sample * 1e3, "launches": launches}


if __name__ == "__main__":
    main()
