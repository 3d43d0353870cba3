"""Mass-produce the GTO -> halo training dataset on the card.

    python -m rdm_tpu_torch.scripts.generate_dataset --target 80000 --out_dir datasets

The reference builds its 100k-row pickle with a CPU fleet: 11 jobs, one per
fixed alpha slice 0.0 .. 1.0, each solving one uniform guess per seed with
SNOPT.  Here every round solves a ``--batch``-wide tile of warm starts at
once with ``physics.solver_gpu.refine_warmstarts_gpu``.  Uniform guesses are
feasible about 1-3 % of the time, so rounds mix two sources:

* explore: uniform draws in the NLP box;
* amplify: Gaussian perturbations (``--sigma`` of each variable's range,
  clipped to the box) of feasible rows already found, whose basins hold far
  more feasible warm starts than the box.

Each lane's alpha bin is drawn with weights proportional to what the bin
still needs, so the 11 bins fill evenly.  ``--optimal_pass`` re-solves every
collected row in ``optimal`` mode (the mass-ascent ratchet from the
feasible point).  The pools are saved to ``datagen_state.npz`` (one float64
array ``bin{b}`` of 66-rows per bin, the JAX script's format) every ten
rounds and at the end, and a run resumes from it.  The output,
``training_data_boundary_{n}.pkl`` ([N, 67] float32 in [0, 1]), goes through
``datagen.normalize_result``, as the per-file workflow's rows do.

The random stream is the JAX script's for a given ``--seed``: round 1's bins
and uniform draws are the same numbers.  ``--device cpu`` runs the solves on
the CPU; without a card and without it, the script raises.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

N_SEG = 20
NVAR = 66
ALPHAS = np.linspace(0.0, 1.0, 11)
HE_OF_ALPHA = 0.008 + ALPHAS * (0.095 - 0.008)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--target", type=int, default=80_000,
                   help="feasible rows to collect (total over 11 alpha bins)")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--max_iters", type=int, default=12,
                   help="LM budget per round (non-converged lanes are retried "
                        "through amplify)")
    p.add_argument("--sigma", type=float, default=0.05,
                   help="amplify perturbation, fraction of each dim's range")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", default="datasets")
    p.add_argument("--state", default=None,
                   help="npz checkpoint path (resume/inspect); default "
                        "<out_dir>/datagen_state.npz")
    p.add_argument("--optimal_pass", action="store_true",
                   help="finish with an optimal-mode re-solve of every row")
    p.add_argument("--optimal_iters", type=int, default=12,
                   help="base feasibility budget of the optimal pass")
    p.add_argument("--max_rounds", type=int, default=10_000)
    p.add_argument("--max_minutes", type=float, default=1e9)
    p.add_argument("--min_mass", type=float, default=408.0)
    p.add_argument("--max_mass", type=float, default=470.0)
    p.add_argument("--explore_frac", type=float, default=0.25,
                   help="fraction of each round kept uniform once amplify is possible")
    p.add_argument("--n_devices", type=int, default=1,
                   help="split each round over this many cards (0 = all)")
    p.add_argument("--device", default=None,
                   help="device of the solves (default: the card); 'cpu' runs on the CPU")
    return p.parse_args(argv)


def draw_round(rng, pools, per_bin, batch, explore_frac, sigma, lo, hi):
    """One round's lanes: (bins [batch], guesses [batch, 66], uniform
    count).  The bins are drawn with weights proportional to each bin's
    need; each lane is a perturbed member of its bin's pool with
    probability ``1 - explore_frac`` when the pool is not empty, else a
    uniform draw in the box (the JAX script's order of draws)."""
    fill = np.array([len(q) for q in pools], float)
    need = np.maximum(per_bin - fill, 0.0)
    bins = rng.choice(len(ALPHAS), size=batch, p=need / need.sum())
    G = np.empty((batch, NVAR))
    n_explore = 0
    for i, b in enumerate(bins):
        pool = pools[b]
        if pool and rng.random() > explore_frac:
            parent = pool[rng.integers(len(pool))]
            G[i] = np.clip(parent + rng.standard_normal(NVAR) * sigma * (hi - lo), lo, hi)
        else:
            G[i] = rng.uniform(lo, hi)
            n_explore += 1
    return bins, G, n_explore


def load_state(path: str) -> list:
    """The pools of a ``datagen_state.npz``: per bin, a list of 66-rows."""
    z = np.load(path, allow_pickle=True)
    return [[r for r in z[f"bin{b}"]] for b in range(len(ALPHAS))]


def save_state(path: str, pools) -> None:
    np.savez_compressed(path, **{f"bin{b}": np.asarray(pools[b], np.float64).reshape(-1, NVAR)
                                 for b in range(len(ALPHAS))})


def normalize_rows(rows66, hes) -> np.ndarray:
    """Solved 66-rows (halo phase as a fraction) and their energies -> the
    [N, 67] float32 training rows of ``datagen.normalize_result``."""
    from ..datagen import get_halo_period, normalize_result

    period = {float(h): get_halo_period(float(h)) for h in np.unique(hes)}
    out = []
    for g, h in zip(rows66, hes):
        control = np.array(g, np.float64)
        control[-2] = control[-2] * period[float(h)]   # phase fraction -> TU
        vec = normalize_result({"results.control": control, "cost_alpha": float(h)})
        if vec is not None:
            out.append(vec)
    return np.asarray(out, np.float32).reshape(-1, 67)


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device
    from ..physics.oracle import nlp_box
    from ..physics.solver_gpu import refine_warmstarts_gpu

    resolve_device(args.device)   # no card and no --device: raise before any work
    solve_kw = dict(min_mass=args.min_mass, max_mass=args.max_mass, batch_tile=args.batch,
                    n_devices=args.n_devices, device=args.device)
    lo, hi = nlp_box(N_SEG, 40.0, 15.0, 0.0, 5.0, 11.0, args.min_mass, args.max_mass)
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    state_path = args.state or os.path.join(args.out_dir, "datagen_state.npz")

    pools = [[] for _ in ALPHAS]
    if os.path.exists(state_path):
        pools = load_state(state_path)
        print(f"resumed: {[len(q) for q in pools]} from {state_path}")

    per_bin = -(-args.target // len(ALPHAS))
    t0 = time.time()
    n_solved = 0
    for rnd in range(args.max_rounds):
        fill = np.array([len(q) for q in pools], float)
        if fill.min() >= per_bin:
            break
        if (time.time() - t0) / 60 > args.max_minutes:
            print("time budget reached")
            break
        bins, G, n_explore = draw_round(rng, pools, per_bin, args.batch, args.explore_frac,
                                        args.sigma, lo, hi)
        res = refine_warmstarts_gpu(G, HE_OF_ALPHA[bins], max_iters=args.max_iters,
                                    solver_mode="feasible", **solve_kw)
        n_solved += args.batch
        feas = res["feasible"]
        for i in np.nonzero(feas)[0]:
            if len(pools[bins[i]]) < per_bin * 2:
                pools[bins[i]].append(res["refined"][i])

        if rnd % 10 == 0 or fill.min() >= per_bin:
            total = int(sum(len(q) for q in pools))
            rate = total / max(time.time() - t0, 1e-9)
            print(f"round {rnd}: +{int(feas.sum())}/{args.batch} "
                  f"(explore {n_explore}) total {total} "
                  f"bins {[len(q) for q in pools]} "
                  f"{rate:.1f} feasible/s", flush=True)
            save_state(state_path, pools)

    save_state(state_path, pools)
    rows66 = np.concatenate(
        [np.asarray(pools[b][:per_bin * 2], np.float64).reshape(-1, NVAR)
         for b in range(len(ALPHAS))])
    hes = np.concatenate(
        [np.full(min(len(pools[b]), per_bin * 2), HE_OF_ALPHA[b])
         for b in range(len(ALPHAS))])
    collect_s = time.time() - t0
    print(f"collected {len(rows66)} feasible rows "
          f"({n_solved} solves, {collect_s / 60:.1f} min)")

    if args.optimal_pass and len(rows66):
        t1 = time.time()
        out_rows, out_hes = [], []
        for lo_i in range(0, len(rows66), args.batch):
            chunk = rows66[lo_i:lo_i + args.batch]
            hchunk = hes[lo_i:lo_i + args.batch]
            res = refine_warmstarts_gpu(chunk, hchunk, max_iters=args.optimal_iters,
                                        solver_mode="optimal", **solve_kw)
            keep = res["feasible"]
            out_rows.append(res["refined"][keep])
            out_hes.append(hchunk[keep])
            mass = res["final_mass"][keep]
            print(f"optimal pass {lo_i + len(chunk)}/{len(rows66)}: "
                  f"feasible {int(keep.sum())}/{len(chunk)} "
                  f"inform1 {int(res['optimal'].sum())} "
                  f"mass mean {mass.mean() if len(mass) else float('nan'):.1f}", flush=True)
        rows66 = np.concatenate(out_rows)
        hes = np.concatenate(out_hes)
        print(f"optimal pass done in {(time.time() - t1) / 60:.1f} min, "
              f"{len(rows66)} rows")

    data = normalize_rows(rows66, hes)
    path = os.path.join(args.out_dir, f"training_data_boundary_{len(data)}.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    wall = time.time() - t0
    print(f"wrote {path} shape {data.shape} "
          f"range [{data.min() if len(data) else float('nan'):.4f}, "
          f"{data.max() if len(data) else float('nan'):.4f}] "
          f"({len(data) / max(wall, 1e-9):.2f} rows/s over {wall:.1f} s)")
    return {"path": path, "rows": len(data), "bins": [len(q) for q in pools],
            "solves": n_solved, "wall_s": wall, "state": state_path}


if __name__ == "__main__":
    main()
