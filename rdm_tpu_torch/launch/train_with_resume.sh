#!/usr/bin/env bash
# Supervised training with automatic stall recovery.
#
# A device call can hang indefinitely; the trainer's stall watchdog
# (training.stall_timeout_s) then exits with status 17
# (rdm_tpu_torch/training/trainer.py: StallWatchdog.EXIT_CODE).  This
# wrapper restarts the run from its rolling meta checkpoint until it
# completes, keeping ONE work dir across restarts by passing the first
# run's checkpoints-meta as the checkpoint_path override.  Only status 17
# restarts; any other failure aborts with its status.
#
# Unlike the JAX package's launcher, this one does not cd to the
# repository root: the port's CLI writes "Training Runs/" under the working
# directory (rdm_tpu_torch/run_train.py), so the runs land where the caller
# stands, and the repository root goes on PYTHONPATH instead.
#
# Usage: rdm_tpu_torch/launch/train_with_resume.sh [run_train overrides...]
# Example:
#   rdm_tpu_torch/launch/train_with_resume.sh training.n_iters=100000 \
#       model.precision=bfloat16 model.attn_pallas=true
# PYTHON names the interpreter (default: python).
set -u

STALL_TIMEOUT="${STALL_TIMEOUT:-600}"   # seconds without a step -> restart
MAX_RESTARTS="${MAX_RESTARTS:-20}"
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:$PYTHONPATH}"

meta=""
for i in $(seq 0 "$MAX_RESTARTS"); do
    args=("$@" "training.stall_timeout_s=${STALL_TIMEOUT}")
    if [[ -n "$meta" && -f "$meta" ]]; then
        args+=("checkpoint_path=${meta}")
        echo "[train_with_resume] restart #$i from $meta"
    fi
    before=$(ls -dt "Training Runs"/*/ 2>/dev/null | head -1)
    "${PYTHON:-python}" -m rdm_tpu_torch.run_train "${args[@]}"
    code=$?
    latest=$(ls -dt "Training Runs"/*/ 2>/dev/null | head -1)
    if [[ "$latest" != "$before" && -n "$latest" ]]; then
        meta="${latest}checkpoints-meta/checkpoint.pth"
    fi
    if [[ $code -eq 0 ]]; then
        echo "[train_with_resume] completed after $i restart(s)"
        exit 0
    elif [[ $code -ne 17 ]]; then
        echo "[train_with_resume] non-stall failure (exit $code); aborting"
        exit "$code"
    fi
done
echo "[train_with_resume] gave up after $MAX_RESTARTS restarts"
exit 1
