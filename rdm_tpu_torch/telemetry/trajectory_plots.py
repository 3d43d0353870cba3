"""CR3BP trajectory plots: propagate warm-start control schedules through
the port's CR3BP dynamics (``physics/cr3bp.py``) and plot the
rotating-frame trajectories with the Earth, the Moon and L1 marked.

    python -m rdm_tpu_torch.telemetry.trajectory_plots --samples generated_samples.npy \
        --out plots/trajectories.png --n 8

The propagation runs in float32 on the CPU, as the JAX package's does.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..benchmark.ml_statistics import save_plots_or_say
from ..physics import cr3bp as dyn


def propagate_trajectory(guess, n_segments=20, thrust=1.0,
                         start_bdry=6.48423370092, pts_per_seg=8):
    """Integrate [coast 1, ``n_segments`` thrust segments, coast 2] from the
    spiral's boundary state and return the stacked rotating-frame states
    [1 + pts_per_seg * (n_segments + 2), 6]."""
    s = torch.from_numpy(np.asarray(dyn.spiral_to_boundary(start_bdry, thrust_n=1.0),
                                    np.float32))
    t_shoot, t_c1, t_c2 = float(guess[0]), float(guess[1]), float(guess[2])
    ctrl = np.asarray(guess[3:3 + 3 * n_segments]).reshape(n_segments, 3)
    states = [s[:6].numpy().copy()]

    def prop(s, u, throttle, tof, n):
        traj = []
        u = torch.from_numpy(np.asarray(u, np.float32))   # the control in float32
        for _ in range(n):
            s = dyn.propagate(s, u, throttle, thrust, tof / n, n_steps=8)
            traj.append(s[:6].numpy().copy())
        return s, traj

    s, traj = prop(s, np.zeros(3), 0.0, max(t_c1, 1e-3), pts_per_seg)
    states += traj
    seg_dt = max(t_shoot, 1e-3) / n_segments
    for alpha, beta, r in ctrl:
        u = np.array([np.cos(beta) * np.cos(alpha),
                      np.cos(beta) * np.sin(alpha), np.sin(beta)])
        s, traj = prop(s, u, float(np.clip(r, 0, 1)), seg_dt, pts_per_seg)
        states += traj
    s, traj = prop(s, np.zeros(3), 0.0, max(t_c2, 1e-3), pts_per_seg)
    states += traj
    return np.asarray(states)


def plot_trajectories(samples, out_path, n=8) -> list:
    """Propagate the first ``n`` physical warm starts [N, 67] and draw them
    into ``out_path``; returns the trajectories (drawn or not)."""
    trajs = [propagate_trajectory(samples[i, 1:]) for i in range(min(n, len(samples)))]

    def draw(plt):
        fig, ax = plt.subplots(figsize=(8, 7))
        mu = dyn.CR3BP_MU
        for i, traj in enumerate(trajs):
            ax.plot(traj[:, 0], traj[:, 1], lw=0.8, label=f"#{i} (E={samples[i, 0]:.3f})")
        ax.scatter([-mu], [0], s=120, color="DodgerBlue", zorder=5, label="Earth")
        ax.scatter([1 - mu], [0], s=40, color="gray", zorder=5, label="Moon")
        ax.scatter([dyn.l1_position()], [0], marker="x", s=60, color="red", zorder=5,
                   label="L1")
        ax.set_xlabel("x [LU]")
        ax.set_ylabel("y [LU]")
        ax.set_title("warm-start trajectories (rotating frame)")
        ax.legend(fontsize=7, ncol=2)
        ax.set_aspect("equal")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"saved {out_path}")

    save_plots_or_say(draw)
    return trajs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--samples", required=True, help="[N, 67] pkl/npy of physical warm starts")
    p.add_argument("--out", default="plots/trajectories.png")
    p.add_argument("--n", type=int, default=8)
    args = p.parse_args(argv)
    if args.samples.endswith(".npy"):
        samples = np.load(args.samples)
    else:
        with open(args.samples, "rb") as f:
            samples = pickle.load(f)
    return plot_trajectories(np.asarray(samples), args.out, args.n)


if __name__ == "__main__":
    main()
