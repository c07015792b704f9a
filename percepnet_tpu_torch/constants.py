"""Frame geometry and precomputed DSP tables for the PyTorch port.

A copy of the JAX package's constants, kept here so the port depends on
torch, numpy and the standard library only.  The values mirror the
reference PercepNet constants (denoise.cpp:18-43).  Every table is built
in float64 from its defining formula and cast once, so it is the
exactly-rounded float32 table.

`device_table` turns a table into a float32 (or int) tensor on a device,
once per (table, device): a float64 table would silently promote the
CPU path to double precision.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# --- Frame geometry (denoise.cpp:18-32) -----------------------------------
SAMPLE_RATE = 48_000
FRAME_SIZE = 480            # 10 ms hop
WINDOW_SIZE = 2 * FRAME_SIZE  # 960-sample analysis window (20 ms)
FREQ_SIZE = FRAME_SIZE + 1    # 481 rDFT bins

COMB_M = 3                  # comb filter taps: k in [-3, 3]

PITCH_MIN_PERIOD = 60
PITCH_MAX_PERIOD = 768
PITCH_FRAME_SIZE = 960
PITCH_BUF_SIZE = PITCH_MAX_PERIOD + PITCH_FRAME_SIZE  # 1728

FRAME_LOOKAHEAD = 5
FRAME_LOOKAHEAD_SIZE = FRAME_LOOKAHEAD * FRAME_SIZE
COMB_BUF_SIZE = FRAME_LOOKAHEAD * 2 * FRAME_SIZE + PITCH_FRAME_SIZE  # 5760

NB_BANDS = 34
NB_FEATURES = NB_BANDS * 2 + 2  # 70
NB_TARGETS = NB_BANDS * 2       # 68 (g, r)
RECORD_DIM = NB_FEATURES + NB_TARGETS  # 138 floats per training record

# Pitch-period normalizer for the T feature (denoise.cpp:528)
PITCH_T_NORM = PITCH_MAX_PERIOD - 3 * PITCH_MIN_PERIOD  # 588

FEATURE_SCALE = 30.0  # band-energy features are scaled x30 (denoise.cpp:491-493)

ENVELOPE_POSTFILTERING_BETA = 0.02

# Offset (into the comb ring buffer) of the analysis window of the frame being
# enhanced; the buffer tail holds FRAME_LOOKAHEAD not-yet-enhanced frames.
# denoise.cpp:402,419-422 — window = comb_buf[2400:3360].
X_WINDOW_START = COMB_BUF_SIZE - FRAME_SIZE * FRAME_LOOKAHEAD - WINDOW_SIZE  # 2400

# Model dims (rnn_train.py:111-121)
INPUT_DIM = NB_FEATURES
FC_DIM = 128
CONV_DIM = 512
GRU_DIM = 512
RB_GRU_DIM = 128
CONV1_KERNEL = 5
CONV2_KERNEL = 3


# --- ERB filterbank borders (erbband.h:43-75) ------------------------------

def _freq2erb(freq_hz: np.ndarray) -> np.ndarray:
    """Glasberg–Moore frequency→ERB-rate (erbband.h:56-58), float32 math."""
    freq_hz = np.asarray(freq_hz, np.float32)
    return np.float32(9.265) * np.log1p(freq_hz / np.float32(24.7 * 9.265))


def _erb2freq(n_erb: np.ndarray) -> np.ndarray:
    """ERB-rate→frequency (erbband.h:59-61), float32 math."""
    n_erb = np.asarray(n_erb, np.float32)
    return np.float32(24.7 * 9.265) * (np.exp(n_erb / np.float32(9.265)) - np.float32(1))


@functools.lru_cache(maxsize=None)
def erb_band_borders(nb_bands: int = NB_BANDS,
                     low_hz: float = 0.0,
                     high_hz: float = 20_000.0) -> np.ndarray:
    """FFT-bin borders of the ERB filterbank, shape [nb_bands].

    Mirrors ERBBand(window_size=960, N=nb_bands-2, 0, 20000): N+2 cutoffs
    equally spaced on the ERB scale, each mapped to the nearest 50 Hz bin
    (erbband.h:68-70), then adjusted so every band spans >= 2 bins
    (erbband.h:72-75).  Top border = 20 kHz = bin 400; bins 401..480 fall
    outside all bands by design.
    """
    n = nb_bands - 2
    erb_low = _freq2erb(low_hz)
    erb_high = _freq2erb(high_hz)
    # linspace in float32, exactly as erbband.h:7-32 (last point forced to end)
    num = n + 2
    delta = (erb_high - erb_low) / np.float32(num - 1)
    lims = erb_low + delta * np.arange(num - 1, dtype=np.float32)
    lims = np.concatenate([lims, [erb_high]]).astype(np.float32)
    cutoffs = _erb2freq(lims)
    borders = ((cutoffs + np.float32(25.0)) / np.float32(50.0)).astype(np.int32)
    # impose minimum band width of 2 bins (100 Hz)
    borders = borders.copy()
    for k in range(n):
        if borders[k + 1] - borders[k] < 2:
            borders[k + 1] += 2 - (borders[k + 1] - borders[k])
    return borders


@functools.lru_cache(maxsize=None)
def band_energy_matrix(nb_bands: int = NB_BANDS,
                       freq_size: int = FREQ_SIZE) -> np.ndarray:
    """Dense [nb_bands, freq_size] matrix E with bandE = E @ |X|^2.

    Encodes compute_band_energy's triangular split (denoise.cpp:89-123):
    each bin j in segment i contributes (1-frac) to band i and frac to band
    i+1 with frac = (j - border[i]) / band_size; edge bands are doubled.
    """
    borders = erb_band_borders(nb_bands)
    mat = np.zeros((nb_bands, freq_size), np.float32)
    for i in range(nb_bands - 1):
        size = int(borders[i + 1] - borders[i])
        for j in range(size):
            frac = np.float32(j) / np.float32(size)
            mat[i, borders[i] + j] += 1 - frac
            mat[i + 1, borders[i] + j] += frac
    mat[0] *= 2
    mat[nb_bands - 1] *= 2
    return mat


@functools.lru_cache(maxsize=None)
def band_interp_matrix(nb_bands: int = NB_BANDS,
                       freq_size: int = FREQ_SIZE) -> np.ndarray:
    """Dense [freq_size, nb_bands] matrix T with per-bin gain = T @ bandG.

    Encodes interp_band_gain (denoise.cpp:162-182): linear interpolation of
    band values onto bins [border[0], border[-1]); bins at or above the top
    border (400, i.e. >20 kHz) stay zero.  This intentionally reproduces the
    reference behavior where those bins are never written (callers always
    pass zero-initialized buffers, so the byte-vs-float memset bug at
    denoise.cpp:164 has no further observable effect).
    """
    borders = erb_band_borders(nb_bands)
    mat = np.zeros((freq_size, nb_bands), np.float32)
    for i in range(nb_bands - 1):
        size = int(borders[i + 1] - borders[i])
        for j in range(size):
            frac = np.float32(j) / np.float32(size)
            mat[borders[i] + j, i] = 1 - frac
            mat[borders[i] + j, i + 1] = frac
    return mat


# --- Windows (denoise.cpp:186-214) -----------------------------------------

@functools.lru_cache(maxsize=None)
def half_vorbis_window(frame_size: int = FRAME_SIZE) -> np.ndarray:
    """Half Vorbis window, shape [frame_size] (denoise.cpp:191-192).

    w[i] = sin(pi/2 * sin^2(pi/2 * (i+.5)/frame_size)); applied symmetrically
    to both halves of the 2*frame_size analysis window.
    """
    i = np.arange(frame_size, dtype=np.float64)
    s = np.sin(0.5 * math.pi * (i + 0.5) / frame_size)
    return np.sin(0.5 * math.pi * s * s).astype(np.float32)


@functools.lru_cache(maxsize=None)
def full_window(frame_size: int = FRAME_SIZE) -> np.ndarray:
    """Full symmetric analysis window, shape [2*frame_size]."""
    h = half_vorbis_window(frame_size)
    return np.concatenate([h, h[::-1]]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def comb_hann_window(m: int = COMB_M) -> np.ndarray:
    """Normalized 7-tap Hann comb window, shape [2m+1] (denoise.cpp:200-206)."""
    i = np.arange(1, 2 * m + 2, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * math.pi * i / (2 * m + 2))
    w = (w / w.sum()).astype(np.float32)
    return w


@functools.lru_cache(maxsize=None)
def power_noise_attenuation(m: int = COMB_M) -> float:
    """Sum of squared comb-window taps (denoise.cpp:207-210)."""
    w = comb_hann_window(m).astype(np.float64)
    return float(np.sum(w * w))


N0 = 0.03  # noise-masking-tone threshold (denoise.cpp:211)


# --- Real DFT matrices ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rdft_matrices(n: int = WINDOW_SIZE) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) matrices of shape [freq, n] for the forward real DFT.

    forward_transform (denoise.cpp:291-304) computes FFT(x)/n and keeps bins
    0..n/2; equivalently  Xr = C @ x, Xi = -S @ x  with
    C[k,t] = cos(2 pi k t / n)/n and S[k,t] = sin(2 pi k t / n)/n.
    Computed in float64 and cast, so the tables are exactly-rounded.
    """
    k = np.arange(n // 2 + 1, dtype=np.float64)[:, None]
    t = np.arange(n, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * k * t / n
    c = (np.cos(ang) / n).astype(np.float32)
    s = (np.sin(ang) / n).astype(np.float32)
    return c, s


@functools.lru_cache(maxsize=None)
def irdft_matrices(n: int = WINDOW_SIZE) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) matrices of shape [n, freq] for the inverse real DFT.

    inverse_transform (denoise.cpp:306-324) reconstructs the conjugate-
    symmetric spectrum and returns the *unnormalized* inverse DFT (the
    forward 1/n scale cancels against the explicit x WINDOW_SIZE).  So
    x[t] = sum_k w_k (Xr[k] cos(2 pi k t/n) - Xi[k] sin(2 pi k t/n)) with
    w_k = 1 for k in {0, n/2} and 2 otherwise.
    """
    k = np.arange(n // 2 + 1, dtype=np.float64)[None, :]
    t = np.arange(n, dtype=np.float64)[:, None]
    ang = 2.0 * math.pi * k * t / n
    w = np.full((1, n // 2 + 1), 2.0)
    w[0, 0] = 1.0
    w[0, n // 2] = 1.0
    c = (w * np.cos(ang)).astype(np.float32)
    s = (w * np.sin(ang)).astype(np.float32)
    return c, s


# --- tansig table (tansig_table.h / vec.h:53-70), for compat mode ----------

@functools.lru_cache(maxsize=None)
def tansig_table() -> np.ndarray:
    """201-entry tanh table at 0.04 spacing, float32 (tansig_table.h:4-45).

    The reference table stores tanh values printed with 6 decimal digits, so
    we round to 6 decimals before the float32 cast to match it bit-for-bit.
    """
    return np.round(np.tanh(0.04 * np.arange(201, dtype=np.float64)), 6).astype(np.float32)


# --- tensors on a device ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def device_table(table_fn, device: torch.device) -> torch.Tensor:
    """`table_fn()` (a zero-argument numpy table builder) as a tensor on
    `device`, built once per (table, device).  Float tables must already
    be float32."""
    arr = np.ascontiguousarray(table_fn())
    if arr.dtype.kind == "f" and arr.dtype != np.float32:
        raise TypeError(f"{table_fn.__name__} returned {arr.dtype}, "
                        "expected float32")
    return torch.from_numpy(arr).to(device)
