#!/usr/bin/env bash
# End-to-end DNS-Challenge recipe on the PyTorch/CUDA port: the
# counterpart of recipes/dns_challenge.sh (the reference utils/run.sh
# 5-stage pipeline, run.sh:46-151), every stage a command of
# `python -m percepnet_tpu_torch`.
#
# Stage 1  prepare:   convert DNS wavs to 48 kHz mono s16 raw (sox)
# Stage 2  featgen:   batched feature/label generation on the card
# Stage 3  split:     80/20 train/dev filelists
# Stage 4  train:     training on the card (configs/dns_challenge.yaml)
# Stage 5  export:    weights -> params .npz + nnet_data.cpp for the C++
#                     runtime (replaces dump_percepnet.py)
#
# Usage, from the repository root:
#   percepnet_tpu_torch/recipes/dns_challenge.sh <dns_clean_dir> <dns_noisy_dir> <workdir> [stage]
# From stage 2 on, the pairs are read from <workdir>/pcm/<basename of
# each dir>/*.pcm (stage 1 writes them there).
#
# Environment:
#   DEVICE          cuda (default) or cpu: every command's --device
#   FRAMES_PER_UTT  frames of records per pair (default 2000: 20 s,
#                   run.sh:32)
#   TRAIN_ARGS      extra arguments appended to stage 4's train, for a
#                   small corpus or a test, e.g.
#                   "--max-steps 2 --batch-size 2 --seq-len 100"
#   AUGMENT=1       per-pair random level gain + biquad channel response
#                   at featgen (the reference's dormant augmentation,
#                   denoise.cpp:670-718), seeded per pair index
set -euo pipefail

clean_dir=${1:?clean wav dir}
noisy_dir=${2:?noisy wav dir}
work=${3:?work dir}
stage=${4:-1}

device=${DEVICE:-cuda}
frames_per_utt=${FRAMES_PER_UTT:-2000}
read -r -a train_args <<< "${TRAIN_ARGS:-}"
mkdir -p "$work"/{pcm,feats,lists,exp}

if [ "$stage" -le 1 ]; then
  echo "== stage 1: wav -> 48k mono s16 raw"
  for d in "$clean_dir" "$noisy_dir"; do
    sub=$(basename "$d")
    mkdir -p "$work/pcm/$sub"
    for f in "$d"/*.wav; do
      out="$work/pcm/$sub/$(basename "${f%.wav}").pcm"
      [ -f "$out" ] || sox "$f" -r 48000 -c 1 -b 16 -t raw "$out"
    done
  done
fi

if [ "$stage" -le 2 ]; then
  echo "== stage 2: feature/label generation"
  : > "$work/pairs.txt"
  for c in "$work/pcm/$(basename "$clean_dir")"/*.pcm; do
    id=$(basename "$c")
    n="$work/pcm/$(basename "$noisy_dir")/$id"
    [ -f "$n" ] && echo "$c $n $frames_per_utt" >> "$work/pairs.txt"
  done
  python -m percepnet_tpu_torch featgen --pairs-file "$work/pairs.txt" \
      --out-dir "$work/feats" ${AUGMENT:+--augment} --device "$device"
fi

if [ "$stage" -le 3 ]; then
  echo "== stage 3: train/dev split"
  python -m percepnet_tpu_torch split-dataset "$work/feats" \
      --out-dir "$work/lists" --frac 0.8
fi

if [ "$stage" -le 4 ]; then
  echo "== stage 4: training"
  python -m percepnet_tpu_torch train \
      --train-filelist "$work/lists/train_filelist.txt" \
      --dev-filelist "$work/lists/dev_filelist.txt" \
      --config configs/dns_challenge.yaml \
      --out-dir "$work/exp" --device "$device" "${train_args[@]}"
fi

if [ "$stage" -le 5 ]; then
  echo "== stage 5: export"
  ckpt=$(ls -v "$work/exp"/checkpoint-*.npz | tail -1)
  python -m percepnet_tpu_torch export "$ckpt" \
      "$work/exp/percepnet_weights.npz" --device "$device"
  python -m percepnet_tpu_torch export "$ckpt" \
      "$work/exp/nnet_data.cpp" --device "$device"
  echo "weights: $work/exp/percepnet_weights.npz"
fi
