#!/usr/bin/env bash
# Single-host training on every local card: one process per card under
# torchrun (the port's form of a single-host data-parallel run,
# rdm_tpu_torch/run_train.py); training.batch_size stays the global batch.
# NPROC overrides the number of processes (default: the cards nvidia-smi
# lists).  Runs from the working directory, with the repository root on
# PYTHONPATH.
#
# Usage: rdm_tpu_torch/launch/train_gpu.sh [run_train overrides...]
set -euo pipefail
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:$PYTHONPATH}"
NPROC="${NPROC:-$(nvidia-smi --list-gpus | wc -l)}"
exec "${PYTHON:-python}" -m torch.distributed.run --standalone --nproc_per_node "$NPROC" \
    -m rdm_tpu_torch.run_train "$@"
