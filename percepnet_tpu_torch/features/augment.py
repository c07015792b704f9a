"""Opt-in data augmentation for feature generation, on numpy and scipy:
the port's own copy of percepnet_tpu/features/augment.py, drawing the
same numbers from the same np.random.Generator.

The reference carries RNNoise-style augmentation as commented-out code in
`train()` (denoise.cpp:670-718): random speech/noise gains and random
2nd-order IIR channel responses (`rand_resp`, denoise.cpp:596-601)
applied through `biquad` (denoise.cpp:361-370), plus a fixed DC
high-pass (denoise.cpp:606-607).  Here it is adapted to premixed
clean/noisy pairs (`xn = n` at denoise.cpp:721): one random level gain
10^(dB/20), dB ~ U{-40..19}, one random biquad with rand_resp
coefficients and, optionally, the fixed high-pass, applied identically to
both streams, so the oracle g/r math stays coherent.  One draw per pair.

It prepares data on the host, as the sox stage of run.sh does.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

# Fixed DC high-pass of the dormant reference path (denoise.cpp:606-607).
HP_B = (-2.0, 1.0)
HP_A = (-1.99599, 0.99600)


def biquad(x: np.ndarray, b, a) -> np.ndarray:
    """Reference `biquad` (denoise.cpp:361-370), transposed direct-form II
    in double precision:

      y[i] = x[i] + m0
      m0   = m1 + (b0*x[i] - a0*y[i])
      m1   =      (b1*x[i] - a1*y[i])

    i.e. H(z) = (1 + b0 z^-1 + b1 z^-2) / (1 + a0 z^-1 + a1 z^-2), through
    scipy's lfilter; returns f32."""
    b_full = np.array([1.0, b[0], b[1]], np.float64)
    a_full = np.array([1.0, a[0], a[1]], np.float64)
    return lfilter(b_full, a_full,
                   np.asarray(x, np.float64)).astype(np.float32)


def rand_resp(rng: np.random.Generator):
    """Random 2nd-order channel response (rand_resp, denoise.cpp:596-601):
    (a[2], b[2]), each coefficient ~ 0.75*U(-0.5, 0.5)."""
    a = 0.75 * (rng.random(2) - 0.5)
    b = 0.75 * (rng.random(2) - 0.5)
    return a, b


def draw_gain(rng: np.random.Generator) -> float:
    """Level gain 10^(dB/20), dB ~ U{-40..19} (denoise.cpp:674)."""
    return float(10.0 ** (rng.integers(-40, 20) / 20.0))


def augment_pair(clean: np.ndarray, noisy: np.ndarray,
                 rng: np.random.Generator, *, highpass: bool = False):
    """Re-level and channel-filter a premixed (clean, noisy) pair with one
    random draw, the same for both streams.

    Args:
      clean, noisy: int16-amplitude float arrays (featgen scale).
      rng: the caller's numpy Generator (it owns the seeding).
      highpass: also apply the reference's fixed DC high-pass first.
    Returns:
      (clean_aug, noisy_aug) f32 arrays of the inputs' lengths.
    """
    gain = draw_gain(rng)
    a, b = rand_resp(rng)

    def chain(x):
        x = np.asarray(x, np.float32) * gain
        if highpass:
            x = biquad(x, HP_B, HP_A)
        return biquad(x, b, a)

    return chain(clean), chain(noisy)
