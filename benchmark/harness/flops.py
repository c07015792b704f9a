"""The yardstick's arithmetic: the operations and bytes that the
algorithm needs, counted from its shapes (not from the program), and the
H100's published peaks (NVIDIA's data sheet, SXM, dense, at its 700 W
power limit).

FLOPs of one enhance_chunk call of B streams x T frames, each product
counted as 2 FLOPs per multiply-add:
  model      2 x 7,948,288 weights per stream-frame (every weight
             multiplies once per frame);
  analysis   the 960 x 962 real-DFT product of T + 5 frames (the X
             spectra and the lookahead energies come from one pass);
  comb DFT   the same product of the T comb-filtered windows;
  inverse    the 962 x 960 inverse product of T frames;
  pitch      per frame, the lag-0..384 correlation of the 480-sample
             whitened window (385 x 480) and the coarse search's 147 x 240.
Elementwise work, the band products and the prefix sums are left out, so
the count is a floor on the work.

Each part is held against the peak of the arithmetic the configuration
states for it: f32 at 67 TFLOP/s (TF32 off), bf16 at 989 TFLOP/s.
"""

from __future__ import annotations

import math

from benchmark.reference.percepnet_ref import LAYERS

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

FRAME = 480
WINDOW = 960
FREQ2 = 962                      # [cos | -sin] columns of the real DFT
LOOKAHEAD = 5
PAD = 5280
PITCH_LAGS, PITCH_LEN = 385, 480
COARSE_LAGS, COARSE_LEN = 147, 240


def weight_count() -> int:
    """The network's weights (biases left out)."""
    return sum(math.prod(shape) for _, leaf, shape in LAYERS
               if leaf.startswith("w"))


def call_flops(streams: int, frames: int) -> dict[str, int]:
    """FLOPs of one call of `streams` x `frames`, by part."""
    b, t = streams, frames
    return {
        "model": 2 * weight_count() * b * t,
        "analysis": 2 * WINDOW * FREQ2 * b * (t + LOOKAHEAD),
        "comb_dft": 2 * WINDOW * FREQ2 * b * t,
        "inverse": 2 * FREQ2 * WINDOW * b * t,
        "pitch": 2 * (PITCH_LAGS * PITCH_LEN + COARSE_LAGS * COARSE_LEN)
        * b * t,
    }


def part_precision(precision: dict) -> dict[str, str]:
    """The arithmetic each FLOP part runs in, from a configuration's
    "precision" block."""
    return {"model": precision["model"], "analysis": precision["dft"],
            "comb_dft": precision["dft"], "inverse": precision["dft"],
            "pitch": precision["pitch"]}


def ideal_seconds(streams: int, frames: int, precision: dict) -> float:
    """The least time one call needs on the card: each part's FLOPs at
    its arithmetic's peak, added."""
    kinds = part_precision(precision)
    return sum(n / PEAK_FLOPS[kinds[part]]
               for part, n in call_flops(streams, frames).items())


def comb_bytes(streams: int, frames: int, store: str) -> int:
    """Bytes the comb filter (B1) must move: the padded span read once
    (f32), the periods read once (int32) and the windows written once in
    the store's type."""
    out = 2 if store == "bfloat16" else 4
    return (4 * streams * (frames * FRAME + PAD) + 4 * streams * frames
            + out * streams * frames * WINDOW)
