#!/usr/bin/env bash
# Data-parallel training over the CUDA cards on the PyTorch port: the
# counterpart of recipes/multihost_v5e16.sh.
#
# torchrun starts one process per card; each runs
# `python -m percepnet_tpu_torch train --distributed`, which reads the
# group from torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK,
# WORLD_SIZE), takes cuda:<rank % cards> and joins an NCCL group (gloo
# with DEVICE=cpu).  Each step all-reduces the gradients; each rank
# reads its own shard of the records; only rank 0 writes checkpoints.
#
# Usage, from the repository root:
#   percepnet_tpu_torch/recipes/multicard.sh <train.lst> <dev.lst> <out_dir> [extra train args]
#
# batch_size below is PER PROCESS: the global batch is 64 x processes.
# Extra arguments are appended to train's (a later --batch-size wins).
#
# Environment:
#   DEVICE         cuda (default) or cpu (gloo, one process per NPROC)
#   NPROC          processes on this host (default: one per card,
#                  `nvidia-smi -L`)
#   TORCHRUN_ARGS  torchrun's rendezvous (default --standalone: one host,
#                  a free local port).  Across hosts, run the script on
#                  each with, e.g.,
#                  TORCHRUN_ARGS="--nnodes 2 --node-rank <0|1>
#                    --rdzv-backend c10d --rdzv-endpoint <host0>:29400"
#                  and an out_dir on a shared filesystem.
set -euo pipefail

train_lst=${1:?train filelist}
dev_lst=${2:?dev filelist}
out_dir=${3:?output dir}
shift 3

device=${DEVICE:-cuda}
nproc=${NPROC:-$(nvidia-smi -L | wc -l)}
read -r -a torchrun_args <<< "${TORCHRUN_ARGS:---standalone}"

exec torchrun "${torchrun_args[@]}" --nproc-per-node "$nproc" \
  -m percepnet_tpu_torch train \
  --train-filelist "$train_lst" \
  --dev-filelist "$dev_lst" \
  --out-dir "$out_dir" \
  --distributed \
  --batch-size 64 \
  --device "$device" \
  "$@"
