#!/usr/bin/env bash
# The CPU run of the quality recipe on the PyTorch port: the counterpart
# of recipes/quality_train_cpu.sh, for a host without a card.
#
# The largest fine-tune that fits a workday on a CPU host:
#   * warm-start from the best raw-feature checkpoint (its GRU stack and
#     heads carry 12k steps of training; its input stack is bit-identical
#     to init because of the saturation bug, README "Training results",
#     so nothing is lost by switching the input transform under it)
#   * both quality fixes at once (log1p compression + linear gain MSE),
#     since there is no budget for two stages
#   * reduced shape (batch 16, seq 1000 = 10 s of context, plenty for
#     PercepNet's sub-second temporal receptive field) and the native
#     C++ prefetch loader (--device-data-mb 0) so RAM stays small
#
# Checkpoints land every 200 steps; gate any of them with
#   python -m percepnet_tpu_torch.tools.quality_gate --weights <ckpt> \
#       --log1p --device cpu ...
# It runs on the CPU whatever DEVICE says (--device cpu).
#
# Usage, from the repository root:
#   percepnet_tpu_torch/recipes/quality_train_cpu.sh <workdir> [pretrain_ckpt] [max_steps]
set -uo pipefail

work=${1:?work dir (e.g. work/dns)}
pretrain=${2:-$work/exp8k/checkpoint-12000.npz}
max_steps=${3:-3000}

exec python -m percepnet_tpu_torch train \
  --train-filelist "$work/lists/train_filelist.txt" \
  --config configs/dns_log1p_cpu.yaml \
  --out-dir "$work/exp_log1p_cpu" \
  --pretrain "$pretrain" \
  --max-steps "$max_steps" \
  --device-data-mb 0 \
  --device cpu
