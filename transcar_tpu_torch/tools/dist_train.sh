#!/usr/bin/env bash
# Multi-card training with torchrun, one process a card (the counterpart of
# tools/dist_train.sh, and of the reference's tools/dist_train.sh).
#
# One host:   transcar_tpu_torch/tools/dist_train.sh <preset> <cards> [cli.train args...]
# Each host of several: NNODES=2 NODE_RANK=<0|1> MASTER_ADDR=<host 0> \
#             transcar_tpu_torch/tools/dist_train.sh <preset> <cards a host> [args...]
# The global batch is data.samples_per_device × the card count; add
# --autoscale-lr to scale the lr by the card count / 8.
set -euo pipefail
PRESET=$1; CARDS=$2; shift 2
exec torchrun --nnodes="${NNODES:-1}" --node-rank="${NODE_RANK:-0}" \
    --master-addr="${MASTER_ADDR:-127.0.0.1}" \
    --master-port="${MASTER_PORT:-29500}" --nproc-per-node="$CARDS" \
    -m transcar_tpu_torch.cli.train "$PRESET" "$@"
