"""Plot the training and evaluation loss curves of the newest run's log.
The log lines are the trainer's ``step: N, training_loss: X`` and
``step: N, evaluation_loss: X``.

    python -m rdm_tpu_torch.telemetry.plot_losses [log_file] [--out PNG]
        [--min_step N] [--max_step N]
"""
from __future__ import annotations

import argparse
import glob
import os
import re

from ..benchmark.ml_statistics import save_plots_or_say

TRAIN_RE = re.compile(r"step: (\d+), training_loss: ([\d.e+-]+)")
EVAL_RE = re.compile(r"step: (\d+), evaluation_loss: ([\d.e+-]+)")


def find_latest_log(pattern="Training Runs/*/logs"):
    """The most recently written run log under the working directory."""
    logs = glob.glob(pattern)
    if not logs:
        return None
    logs.sort(key=os.path.getmtime, reverse=True)
    return logs[0]


def parse_log_file(log_file):
    """(train_steps, train_losses, eval_steps, eval_losses) of a run log."""
    train_steps, train_losses, eval_steps, eval_losses = [], [], [], []
    with open(log_file) as f:
        for line in f:
            m = TRAIN_RE.search(line)
            if m:
                train_steps.append(int(m.group(1)))
                train_losses.append(float(m.group(2)))
            m = EVAL_RE.search(line)
            if m:
                eval_steps.append(int(m.group(1)))
                eval_losses.append(float(m.group(2)))
    return train_steps, train_losses, eval_steps, eval_losses


def draw(ax, ts, tl, es, el):
    ax.plot(ts, tl, label="training loss", lw=0.8)
    if es:
        ax.plot(es, el, label="evaluation loss", lw=1.2)
    ax.set_yscale("log")
    ax.legend()


def plot(log_file=None, out="training_loss_plot.png", min_step=None, max_step=None) -> int:
    """Plot ``log_file`` (default: the newest run's) into ``out``; 0 when
    the log has training losses."""
    log_file = log_file or find_latest_log()
    if not log_file:
        print("No log files found.")
        return 1
    print(f"Using log file: {log_file}")
    ts, tl, es, el = parse_log_file(log_file)
    if not ts:
        print("No training loss data found in the log file.")
        return 1
    if min_step is not None or max_step is not None:
        lo = min_step or 0
        hi = max_step or max(ts)
        keep = [(s, l) for s, l in zip(ts, tl) if lo <= s <= hi]
        ts, tl = zip(*keep) if keep else ([], [])
        keep = [(s, l) for s, l in zip(es, el) if lo <= s <= hi]
        es, el = zip(*keep) if keep else ([], [])

    def figure(plt):
        fig, ax = plt.subplots(figsize=(10, 6))
        draw(ax, ts, tl, es, el)
        ax.set_xlabel("step")
        ax.set_ylabel("loss")
        ax.set_title(os.path.dirname(log_file))
        fig.savefig(out, dpi=120, bbox_inches="tight")
        print(f"saved {out}")

    save_plots_or_say(figure)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log_file", nargs="?", default=None)
    p.add_argument("--out", default="training_loss_plot.png")
    p.add_argument("--min_step", type=int, default=None)
    p.add_argument("--max_step", type=int, default=None)
    args = p.parse_args(argv)
    return plot(args.log_file, args.out, args.min_step, args.max_step)


if __name__ == "__main__":
    raise SystemExit(main())
