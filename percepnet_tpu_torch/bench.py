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

Prints the card's name and power limit and the peak device memory on a
line of their own, then ONE JSON line:
  {"metric": "enhance_throughput_1chip", "value": N,
   "unit": "audio_s_per_s", "vs_baseline": N}
vs_baseline divides by the 10,000 audio-s/s north-star TARGET of
BASELINE.json, a target and not a measurement.  Without a CUDA card it
exits 3 with a message on stderr and prints no JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.models.percepnet import PercepNet

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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m percepnet_tpu_torch bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true",
                    help="the f32 parity tier (default: bf16 serving tier)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA card is available; refusing to bench the "
              "host", file=sys.stderr)
        sys.exit(3)
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
