"""Realtime loss plot: polls the newest run log every ``interval`` seconds
and redraws the figure (needs matplotlib with an interactive backend).

    python -m rdm_tpu_torch.telemetry.plot_losses_realtime [interval] [--rounds N]
"""
from __future__ import annotations

import argparse
import time

from .plot_losses import draw, find_latest_log, parse_log_file


def watch(interval=10.0, rounds=None):
    """Redraw every ``interval`` s; ``rounds`` stops after that many polls
    (default: never)."""
    import matplotlib.pyplot as plt
    plt.ion()
    fig, ax = plt.subplots(figsize=(10, 6))
    n = 0
    while rounds is None or n < rounds:
        log = find_latest_log()
        if log:
            ts, tl, es, el = parse_log_file(log)
            ax.clear()
            if ts:
                draw(ax, ts, tl, es, el)
            ax.set_title(log)
            plt.pause(0.01)
        n += 1
        time.sleep(interval)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("interval", nargs="?", type=float, default=10.0)
    p.add_argument("--rounds", type=int, default=None, help="stop after this many polls")
    args = p.parse_args(argv)
    watch(args.interval, args.rounds)


if __name__ == "__main__":
    main()
