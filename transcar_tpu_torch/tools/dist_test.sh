#!/usr/bin/env bash
# Multi-card eval with torchrun, one process a card (the counterpart of
# tools/dist_test.sh): samples stride across the ranks, rank 0 writes and
# scores the submission.
#
# One host:   transcar_tpu_torch/tools/dist_test.sh <preset> <checkpoint> <cards> [cli.test args...]
# Each host of several: NNODES, NODE_RANK and MASTER_ADDR as for dist_train.sh.
set -euo pipefail
PRESET=$1; CKPT=$2; CARDS=$3; shift 3
exec torchrun --nnodes="${NNODES:-1}" --node-rank="${NODE_RANK:-0}" \
    --master-addr="${MASTER_ADDR:-127.0.0.1}" \
    --master-port="${MASTER_PORT:-29500}" --nproc-per-node="$CARDS" \
    -m transcar_tpu_torch.cli.test "$PRESET" "$CKPT" "$@"
