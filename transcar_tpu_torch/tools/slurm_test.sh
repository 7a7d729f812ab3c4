#!/usr/bin/env bash
# Slurm eval: srun one task a card (the counterpart of tools/slurm_test.sh);
# samples stride across the ranks, rank 0 writes the submission.
#
#   CARDS=8 CARDS_PER_NODE=8 transcar_tpu_torch/tools/slurm_test.sh \
#       <partition> <job name> <preset> <checkpoint> [cli.test args...]
set -euo pipefail
PARTITION=$1; JOB_NAME=$2; PRESET=$3; CKPT=$4; shift 4
CARDS=${CARDS:-8}
CARDS_PER_NODE=${CARDS_PER_NODE:-8}
MASTER_PORT=${MASTER_PORT:-29500}
export MASTER_PORT
srun -p "$PARTITION" --job-name="$JOB_NAME" --ntasks="$CARDS" \
    --ntasks-per-node="$CARDS_PER_NODE" --gres=gpu:"$CARDS_PER_NODE" \
    --kill-on-bad-exit=1 bash -c '
        MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
        export MASTER_ADDR
        exec python -m transcar_tpu_torch.cli.test "$@"' _ "$PRESET" "$CKPT" "$@"
