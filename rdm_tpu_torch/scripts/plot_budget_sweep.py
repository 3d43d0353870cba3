"""Draw feasibility against the oracle budget from ``budget_sweep``'s
artifact: one line a sample set over the grid, x = LM iterations x (1 + basin
hops) a sample (log scale), y = the best feasible ratio within that budget
(the running maximum over the cells ordered by cost).  The uniform floor
and the ground-truth ceiling are neutral dashed lines.  Without matplotlib
it prints one line and draws nothing.

    python -m rdm_tpu_torch.scripts.plot_budget_sweep [budget_sweep.json] [out.png]
"""
from __future__ import annotations

import argparse
import json
import os

from ..benchmark.ml_statistics import save_plots_or_say
from .study_common import default_out

SETS = [  # (key, label, color; None draws a bound)
    ("flagship_rdm_tpu", "flagship (n=1024)", "#2a78d6"),
    ("ref_50samples_16workers", "reference 50-sample set", "#eb6834"),
    ("ref_fast_20250804", "reference fast set", "#1baf7a"),
    ("ref_8samples_8workers", "reference 8-sample set", "#eda100"),
    ("gt_ceiling", "ground-truth ceiling", None),
    ("uniform_floor", "uniform-guess floor", None),
]
TEXT, MUTED, GRID = "#333333", "#666666", "#e3e3e3"


def curves(d: dict) -> dict:
    """key -> (budgets, best feasible ratio within each budget)."""
    lut = {(c["set"], c["max_iters"], c["mbh_rounds"]): c for c in d["cells"]}
    grid = sorted({(c["max_iters"], c["mbh_rounds"]) for c in d["cells"]},
                  key=lambda im: im[0] * (1 + im[1]))
    out = {}
    for key, _, _ in SETS:
        xs, ys, best = [], [], 0.0
        for it, mbh in grid:
            c = lut.get((key, it, mbh))
            if c:
                best = max(best, c["feasible_ratio"])
                xs.append(it * (1 + mbh))
                ys.append(best)
        if xs:
            out[key] = (xs, ys)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", nargs="?", default=default_out("budget_sweep.json"))
    p.add_argument("out", nargs="?", default=default_out("budget_sweep.png"))
    args = p.parse_args(argv)
    path, out = args.path, args.out
    with open(path) as f:
        d = json.load(f)
    lines = curves(d)

    def draw(plt):
        fig, ax = plt.subplots(figsize=(8.4, 4.8), dpi=150)
        end_labels = []
        for key, label, color in SETS:
            if key not in lines:
                continue
            xs, ys = lines[key]
            if color is None:
                ax.plot(xs, ys, "--", lw=1.4, color="#999999", zorder=2)
                ax.annotate(label, (xs[0], ys[0]), textcoords="offset points",
                            xytext=(-2, 7), fontsize=8, color=MUTED, ha="left")
            else:
                ax.plot(xs, ys, "-", lw=2.0, color=color, zorder=3, marker="o", ms=4,
                        mec="white", mew=0.8)
                end_labels.append((ys[-1], xs[-1], label))
        prev = -1.0
        for y, x, label in sorted(end_labels):       # right-edge labels, de-collided
            y_lab = max(y, prev + 0.045)
            prev = y_lab
            ax.annotate(label, (x, y), textcoords="offset points",
                        xytext=(8, (y_lab - y) * 300), fontsize=8, color=TEXT, va="center")
        ax.set_xscale("log")
        ax.set_xlim(right=ax.get_xlim()[1] * 40)
        ax.set_ylim(-0.03, 1.06)
        ax.set_xlabel("grader budget: LM iterations x (1 + MBH rounds) per sample",
                      fontsize=9, color=TEXT)
        ax.set_ylabel("best feasible ratio within budget (native f64 oracle)", fontsize=9,
                      color=TEXT)
        ax.set_title("Warm-start feasibility vs oracle budget", fontsize=10, color=TEXT,
                     loc="left")
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
    return lines


if __name__ == "__main__":
    main()
