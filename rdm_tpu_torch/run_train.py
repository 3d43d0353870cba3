"""Training CLI.

    python -m rdm_tpu_torch.run_train model=ncsnpp data=gto_halo training.batch_size=4096

Composes ``configs/train.yaml`` with the Hydra-style overrides, creates
``Training Runs/<%Y.%m.%d_%H%M%S>/`` under the working directory with the
``.hydra/config.yaml`` snapshot (the manifest that sampling and
benchmarking read), and runs the training loop on the card.  ``+device=cpu``
runs it on the CPU.
"""
from __future__ import annotations

import os
import sys
from datetime import datetime

from .config import load_config, save_config_snapshot
from .training import trainer
from .utils import get_logger, makedirs


def main(argv=None) -> str:
    """Run the CLI; returns the run directory."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config("train", overrides=argv)

    timestamp = datetime.now().strftime("%Y.%m.%d_%H%M%S")
    work_dir = os.path.join("Training Runs", timestamp)
    makedirs(work_dir)
    save_config_snapshot(cfg, work_dir)

    logger = get_logger(os.path.join(work_dir, "logs"))
    logger.info(f"Training run started at: {timestamp}")
    logger.info(f"Run directory: {work_dir}")

    trainer.run(cfg, work_dir, checkpoint_path=cfg.get("checkpoint_path"))
    return work_dir


if __name__ == "__main__":
    main()
