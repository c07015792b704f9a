"""Headline benchmark: batched end-to-end enhancement throughput on one
CUDA card.

Measures audio-seconds of 48 kHz speech enhanced per wall-clock second
on the full pipeline (analysis front-end -> PercepNet GRU stack -> pitch
filter, band gains and overlap-add), the counterpart of the JAX
package's bench.py at its shape: 512 streams x 200 frames (2 s each) per
call, the bf16 serving tier by default, --f32 for the parity tier.
Random weights from a seeded torch.Generator and a 0.05-scaled normal
signal made on the card; one warm-up call, then 5 timed calls between two
torch.cuda.synchronize().

Usage:
  python -m percepnet_tpu_torch bench [--f32] [--batch=512] [--frames=200]
  python -m percepnet_tpu_torch bench --train [--batch=64] [--seq-len=2000]
      [--steps=3] [--no-remat]

Prints the card's name and power limit and the peak device memory on a
line of their own, then ONE JSON line:
  {"metric": "enhance_throughput_1chip", "value": N,
   "unit": "audio_s_per_s", "vs_baseline": N}
vs_baseline divides by the 10,000 audio-s/s north-star TARGET of
BASELINE.json, a target and not a measurement.  Without a CUDA card it
exits 3 with a message on stderr and prints no JSON.

--train times the training step instead, the single-card counterpart of
tools/scaling_bench.py: seeded uniform features and targets at --batch x
--seq-len (default 64 x 2000, the DNS recipe), f32 with remat as JAX's
loss_fn (--no-remat to compare), 1 warm-up step and --steps timed steps
between synchronizes.  It prints the card's line with the step time and
peak memory, then
  {"metric": "train_throughput_1chip", "value": N, "unit":
   "audio_s_per_s", "step_ms": N, "flops_per_step": N, "bound_ms": N,
   "peak_allocated_bytes": N, "card": "..."}
where audio_s_per_s = steps * B * T * 480 / 48000 / seconds and bound_ms
is the step's matmul FLOPs (train_step_flops) at the card's f32 peak.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.models.percepnet import (LAYERS, PercepNet,
                                                  weight_count)
from percepnet_tpu_torch.utils.profiling import bound_ms

BASELINE_AUDIO_S_PER_S = 10_000.0   # BASELINE.json north-star target
ITERS = 5


def card_label() -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()


def inputs(batch: int, n_frames: int, dtype: torch.dtype,
           dev: torch.device) -> tuple[PercepNet, torch.Tensor, dict]:
    """The bench's seeded model (in the tier's dtype), its [batch,
    n_frames * 480] signal on `dev`, and the enhance_chunk keywords of
    the tier."""
    model = PercepNet(torch.Generator().manual_seed(0)).to(dev)
    kw = {}
    if dtype == torch.bfloat16:
        model = model.to(dtype)     # the serving copy, cast once
        kw["compute_dtype"] = dtype
    gen = torch.Generator(device=dev).manual_seed(1)
    signal = 0.05 * torch.randn((batch, n_frames * C.FRAME_SIZE),
                                generator=gen, device=dev)
    return model, signal, kw


@torch.no_grad()
def run(batch: int = 512, n_frames: int = 200,
        dtype: torch.dtype = torch.bfloat16) -> dict:
    """One warm-up and ITERS timed enhance_chunk calls of batch streams x
    n_frames on the card; returns the metric line's fields plus seconds
    and the peak allocated device memory."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench needs a CUDA card")
    dev = torch.device("cuda")
    n = n_frames * C.FRAME_SIZE
    model, signal, kw = inputs(batch, n_frames, dtype, dev)
    state = pipeline.init_pipeline_state(batch, model_dtype=dtype,
                                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pcm, state = pipeline.enhance_chunk(model, signal, state, device=dev,
                                        **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        pcm, state = pipeline.enhance_chunk(model, signal, state,
                                            device=dev, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(pcm).all()):
        raise RuntimeError("the bench's output is not finite")
    value = ITERS * batch * n / C.SAMPLE_RATE / seconds
    return {"metric": "enhance_throughput_1chip", "value": round(value, 1),
            "unit": "audio_s_per_s",
            "vs_baseline": round(value / BASELINE_AUDIO_S_PER_S, 3),
            "seconds": seconds,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated()}


def train_step_flops(batch: int, seq_len: int, remat: bool = True) -> int:
    """Matmul FLOPs of one training step, from the weights' shapes:
    every weight multiplies once per frame of each sequence in the
    forward pass (2 FLOPs per weight), twice in backward (input and
    weight gradients), and with remat once more for the products inside
    the per-frame GRU step (all but gru1's input projection and the conv
    half of gru_rb's, which are hoisted out of the loop).  Elementwise
    work is left out."""
    per_frame = 3 * 2 * weight_count()
    if remat:
        step = (sum(math.prod(LAYERS[g][w])
                    for g in ("gru2", "gru3", "gru_gb") for w in ("wi", "wh"))
                + math.prod(LAYERS["gru1"]["wh"])
                + math.prod(LAYERS["gru_rb"]["wh"])
                + C.GRU_DIM * LAYERS["gru_rb"]["wi"][1])
        per_frame += 2 * step
    return per_frame * batch * seq_len


def run_train(batch: int = 64, seq_len: int = 2000, steps: int = 3,
              remat: bool = True) -> dict:
    """One warm-up and `steps` timed training steps of batch x seq_len
    on the card (seeded model, uniform features and targets as
    tools/scaling_bench.py); returns the metric line's fields plus
    seconds and the peak allocated device memory."""
    from percepnet_tpu_torch.train import state as ts
    if not torch.cuda.is_available():
        raise RuntimeError("the bench needs a CUDA card")
    dev = torch.device("cuda")
    model = PercepNet(torch.Generator().manual_seed(0)).to(dev)
    opt = ts.make_optimizer(1e-4)
    state = ts.init_train_state(model, opt)
    gen = torch.Generator(device=dev).manual_seed(1)
    feats = torch.rand((batch, seq_len, C.NB_FEATURES), generator=gen,
                       device=dev)
    targs = 0.9 * torch.rand((batch, seq_len, C.NB_TARGETS), generator=gen,
                             device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts.train_step(state, feats, targs, opt, remat=remat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = ts.train_step(state, feats, targs, opt, remat=remat)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("the train bench's loss is not finite")
    flops = train_step_flops(batch, seq_len, remat)
    value = steps * batch * seq_len * C.FRAME_SIZE / C.SAMPLE_RATE / seconds
    return {"metric": "train_throughput_1chip", "value": round(value, 1),
            "unit": "audio_s_per_s", "step_ms": 1e3 * seconds / steps,
            "flops_per_step": flops, "bound_ms": bound_ms(0, flops)[0],
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "seconds": seconds, "steps": steps, "remat": remat,
            "loss": float(loss)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m percepnet_tpu_torch bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true",
                    help="the f32 parity tier (default: bf16 serving tier)")
    ap.add_argument("--batch", type=int,
                    help="streams per call (512), or sequences per "
                         "training step with --train (64)")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--train", action="store_true",
                    help="time the f32 training step instead")
    ap.add_argument("--seq-len", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA card is available; refusing to bench the "
              "host", file=sys.stderr)
        sys.exit(3)
    if args.train:
        batch = args.batch or 64
        res = run_train(batch, args.seq_len, args.steps,
                        remat=not args.no_remat)
        card = card_label()
        print(f"{card} | train f32 | {batch} x {args.seq_len} frames | "
              f"remat {'off' if args.no_remat else 'on'} | {args.steps} "
              f"steps in {res['seconds']:.4f} s | {res['step_ms']:.1f} ms "
              f"per step | peak allocated {res['peak_allocated_bytes']} "
              f"bytes", flush=True)
        print(json.dumps({**{k: res[k] for k in (
            "metric", "value", "unit", "step_ms", "flops_per_step",
            "bound_ms", "peak_allocated_bytes")}, "card": card}),
            flush=True)
        return
    args.batch = args.batch or 512
    dtype = torch.float32 if args.f32 else torch.bfloat16
    res = run(args.batch, args.frames, dtype)
    print(f"{card_label()} | {str(dtype).replace('torch.', '')} | "
          f"{args.batch} x {args.frames} frames | {ITERS} calls in "
          f"{res['seconds']:.4f} s | peak allocated "
          f"{res['peak_allocated_bytes']} bytes", flush=True)
    print(json.dumps({k: res[k] for k in ("metric", "value", "unit",
                                          "vs_baseline")}), flush=True)


if __name__ == "__main__":
    main()
