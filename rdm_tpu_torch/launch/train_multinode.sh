#!/usr/bin/env bash
# Multi-node training: run this ON EACH NODE, one process per local card.
# The rendezvous comes from the environment, as torchrun reads it:
# NNODES, NODE_RANK, MASTER_ADDR and MASTER_PORT (defaults: one node,
# rank 0, localhost:29500); NPROC is the processes per node (default: the
# cards nvidia-smi lists).  Every node runs the same program; rank 0 logs
# and checkpoints (rdm_tpu_torch/parallel/mesh.py).
#
# Usage: NNODES=2 NODE_RANK=0 MASTER_ADDR=node0 \
#          rdm_tpu_torch/launch/train_multinode.sh [run_train overrides...]
set -euo pipefail
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:$PYTHONPATH}"
NPROC="${NPROC:-$(nvidia-smi --list-gpus | wc -l)}"
exec "${PYTHON:-python}" -m torch.distributed.run \
    --nnodes "${NNODES:-1}" --node_rank "${NODE_RANK:-0}" \
    --master_addr "${MASTER_ADDR:-localhost}" --master_port "${MASTER_PORT:-29500}" \
    --nproc_per_node "$NPROC" -m rdm_tpu_torch.run_train "$@"
