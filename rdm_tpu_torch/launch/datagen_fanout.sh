#!/usr/bin/env bash
# CR3BP data-generation fan-out: WORKERS parallel workers, each owning a
# disjoint seed range (worker i: seeds i * SEEDS_PER_WORKER onwards), all
# writing into RESULT_FOLDER; then the port's prepare_training_data merges
# the folder into its training pickle.  Arguments are passed on to every
# worker, e.g. `--backend tpu` to solve on the card.  Runs from the
# working directory, with the repository root on PYTHONPATH.
#
# Usage: WORKERS=28 SEEDS_PER_WORKER=100 RESULT_FOLDER=results/datagen \
#          rdm_tpu_torch/launch/datagen_fanout.sh [generate_data arguments...]
# PYTHON names the interpreter (default: python).
set -euo pipefail
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON:-python}"
WORKERS="${WORKERS:-28}"
SEEDS_PER_WORKER="${SEEDS_PER_WORKER:-100}"
RESULT_FOLDER="${RESULT_FOLDER:-results/datagen}"
ALPHA="${ALPHA:-}"
EXTRA=()
[ -n "$ALPHA" ] && EXTRA+=(--alpha "$ALPHA")
pids=()
for i in $(seq 0 $((WORKERS - 1))); do
  "$PY" -m rdm_tpu_torch.generate_data \
    --seed $((i * SEEDS_PER_WORKER)) \
    --seed_step "$SEEDS_PER_WORKER" \
    --result_folder "$RESULT_FOLDER" \
    ${EXTRA[@]+"${EXTRA[@]}"} "$@" &
  pids+=($!)
done
for pid in "${pids[@]}"; do
  wait "$pid"
done
RESULT_FOLDER="$RESULT_FOLDER" "$PY" - <<'PY'
import os

from rdm_tpu_torch.datagen import prepare_training_data

prepare_training_data(os.environ["RESULT_FOLDER"])
PY
