"""Cosine ERB/linear filterbank construction (design-prototype parity), on
numpy: the port's own copy of percepnet_tpu/utils/filterbanks.py.

The reference ships utils/filterbanks.py (py_bank) — the NumPy prototype
its C++ `ERBBand::make_filters` (erbband.h:63-97) was derived from.  The
runtime band ops never use the cosine filters (they use triangular
interpolation over the bin borders — see ops.bands), but the filterbank is
part of the reference's API surface, so it is reproduced here, vectorized.

`erb_cosine_filters()` matches the shapes the C++ builds: N+2 filters of
length nfft//2+1 with raised-cosine responses between neighboring cutoffs,
half-cosine edge filters.
"""

from __future__ import annotations

import numpy as np

from percepnet_tpu_torch import constants as C


def erb_space(low_hz: float, high_hz: float, n: int) -> np.ndarray:
    """n cutoffs equally spaced on the Glasberg-Moore ERB-rate scale."""
    lo = C._freq2erb(np.float32(low_hz))
    hi = C._freq2erb(np.float32(high_hz))
    return C._erb2freq(np.linspace(lo, hi, n, dtype=np.float32))


def _cos_filters(cutoffs_hz: np.ndarray, nfft: int,
                 sample_rate: int) -> np.ndarray:
    """[n_filters, nfft//2+1] raised-cosine filters between cutoff triples.

    Filter i spans (cutoffs[i], cutoffs[i+2]) peaking at cutoffs[i+1]
    (erbband.h:76-97); the first/last are half-cosines to the band edges.
    """
    freqs = np.arange(nfft // 2 + 1) * (sample_rate / nfft)
    n = len(cutoffs_hz) - 2
    filters = np.zeros((n + 2, len(freqs)), np.float32)
    for i in range(n):
        lo, mid, hi = cutoffs_hz[i], cutoffs_hz[i + 1], cutoffs_hz[i + 2]
        avg = (lo + hi) / 2
        rnge = hi - lo
        m = (freqs > lo) & (freqs < hi)
        filters[i + 1, m] = np.cos((freqs[m] - avg) / rnge * np.pi)
    # edge filters: complete the leftover energy of the first/last band
    lm = freqs < cutoffs_hz[1]
    filters[0, lm] = np.sqrt(np.maximum(0.0, 1.0 - filters[1, lm] ** 2))
    rm = freqs > cutoffs_hz[-2]
    filters[-1, rm] = np.sqrt(np.maximum(0.0, 1.0 - filters[-2, rm] ** 2))
    return filters


def erb_cosine_filters(nfft: int = C.WINDOW_SIZE,
                       sample_rate: int = C.SAMPLE_RATE,
                       n_bands: int = C.NB_BANDS - 2,
                       low_hz: float = 0.0,
                       high_hz: float = 20_000.0) -> np.ndarray:
    """[n_bands+2, nfft//2+1] ERB-scale cosine filterbank."""
    cutoffs = erb_space(low_hz, high_hz, n_bands + 2)
    return _cos_filters(cutoffs, nfft, sample_rate)


def linear_filters(nfft: int = C.WINDOW_SIZE,
                   sample_rate: int = C.SAMPLE_RATE,
                   n_bands: int = 32,
                   low_hz: float = 0.0,
                   high_hz: float = 20_000.0) -> np.ndarray:
    """[n_bands+2, nfft//2+1] linearly spaced cosine filterbank."""
    cutoffs = np.linspace(low_hz, high_hz, n_bands + 2).astype(np.float32)
    return _cos_filters(cutoffs, nfft, sample_rate)
