"""Training CLI.

    python -m rdm_tpu_torch.run_train model=ncsnpp data=gto_halo training.batch_size=4096

Composes ``configs/train.yaml`` with the Hydra-style overrides, creates
``Training Runs/<%Y.%m.%d_%H%M%S>/`` under the working directory with the
``.hydra/config.yaml`` snapshot (the manifest that sampling and
benchmarking read), and runs the training loop on the card.  ``+device=cpu``
runs it on the CPU.

On several cards, one process per card:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m rdm_tpu_torch.run_train training.batch_size=4096

``training.batch_size`` stays the global batch; rank 0 names the run
directory and writes the snapshot, and the process group is left on exit.
"""
from __future__ import annotations

import os
import sys
from datetime import datetime

from .config import load_config, save_config_snapshot
from .parallel import mesh
from .training import trainer
from .utils import get_logger, makedirs


def main(argv=None) -> str:
    """Run the CLI; returns the run directory."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config("train", overrides=argv)
    mesh.setup(cfg.get("device"))
    try:
        timestamp = mesh.broadcast_object(datetime.now().strftime("%Y.%m.%d_%H%M%S"))
        work_dir = os.path.join("Training Runs", timestamp)
        if mesh.rank() == 0:
            makedirs(work_dir)
            save_config_snapshot(cfg, work_dir)
            logger = get_logger(os.path.join(work_dir, "logs"))
            logger.info(f"Training run started at: {timestamp}")
            logger.info(f"Run directory: {work_dir}")
        mesh.barrier()

        trainer.run(cfg, work_dir, checkpoint_path=cfg.get("checkpoint_path"))
    finally:
        mesh.teardown()
    return work_dir


if __name__ == "__main__":
    main()
