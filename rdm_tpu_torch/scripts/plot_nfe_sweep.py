"""Draw warm-start quality against the PC step count from ``nfe_sweep``'s
artifact: x = predictor steps (log scale), y = feasible ratio, one line a
grading budget (cold, and with basin hops), each point labelled with its
steady sampling throughput.  Without matplotlib it prints one line and
draws nothing.

    python -m rdm_tpu_torch.scripts.plot_nfe_sweep [nfe_sweep.json] [out.png]
"""
from __future__ import annotations

import argparse
import json
import os

from ..benchmark.ml_statistics import save_plots_or_say
from .study_common import default_out

TEXT, MUTED, GRID = "#333333", "#666666", "#e3e3e3"


def curve_rows(d: dict) -> list:
    """The baseline sweep: seed 0 at the artifact's grading budget, by steps
    (replication and richer-budget rows are tabular evidence)."""
    it0 = d.get("oracle", {}).get("max_iters", 30)
    return sorted((r for r in d["rows"]
                   if r.get("seed", 0) == 0 and r.get("max_iters", it0) == it0),
                  key=lambda r: r["steps"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?", default=default_out("nfe_sweep.json"))
    p.add_argument("out", nargs="?", default=default_out("nfe_sweep.png"))
    args = p.parse_args(argv)
    path, out = args.path, args.out
    with open(path) as f:
        d = json.load(f)
    rows = curve_rows(d)
    steps = [r["steps"] for r in rows]
    mbh_key = next(k for k in rows[0] if k.startswith("feasible_mbh") and "ci95" not in k)
    it0 = d.get("oracle", {}).get("max_iters", 30)
    series = [("feasible_cold", f"LM-{it0} cold", "#eb6834"),
              (mbh_key, f"LM-{it0} + MBH-{mbh_key.split('mbh')[1]}", "#2a78d6")]

    def draw(plt):
        import matplotlib.ticker
        fig, ax = plt.subplots(figsize=(8.4, 4.8), dpi=150)
        for key, label, color in series:
            ys = [r[key] for r in rows]
            ax.plot(steps, ys, "-", lw=2.0, color=color, zorder=3, marker="o", ms=4,
                    mec="white", mew=0.8)
            ax.annotate(label, (steps[-1], ys[-1]), textcoords="offset points",
                        xytext=(8, 0), fontsize=8, color=TEXT, va="center")
        for r in rows:
            ax.annotate(f"{r['traj_per_s']:.0f} traj/s", (r["steps"], r["feasible_cold"]),
                        textcoords="offset points", xytext=(0, -14), fontsize=7.5,
                        color=MUTED, ha="center")
        ax.set_xscale("log")
        ax.set_xticks(steps)
        ax.get_xaxis().set_major_formatter(matplotlib.ticker.ScalarFormatter())
        ax.set_xlim(right=ax.get_xlim()[1] * 4)
        ax.set_ylim(-0.03, 1.06)
        ax.set_xlabel("PC predictor steps (reference default: 1000)", fontsize=9, color=TEXT)
        ax.set_ylabel("feasible ratio (on-card oracle)", fontsize=9, color=TEXT)
        ax.set_title(f"Warm-start quality vs sampler step count, n={d['n']}", fontsize=10,
                     color=TEXT, loc="left")
        ax.grid(True, which="major", color=GRID, lw=0.6, zorder=0)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        for s in ("left", "bottom"):
            ax.spines[s].set_color(MUTED)
        ax.tick_params(colors=MUTED, labelsize=8)
        fig.tight_layout()
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        fig.savefig(out)
        plt.close(fig)
        print("wrote", out)

    save_plots_or_say(draw)
    return rows


if __name__ == "__main__":
    main()
