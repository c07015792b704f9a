"""Objective speech-quality metrics on numpy: SNR, SI-SDR and STOI.

The port's own copy of the JAX package's numpy metrics
(percepnet_tpu/utils/metrics.py), for `cli.evaluate` and the bf16 serving
tier's quality check (bf16 vs f32 enhancement of the same pairs, as
tools/quality_gate.py does).  STOI (Taal et al. 2011) and SI-SDR (Le Roux
et al. 2019) are implemented from their definitions.

All take time-domain signals at `fs` Hz (48 kHz by default; STOI
resamples to 10 kHz as the measure specifies).
"""

from __future__ import annotations

import numpy as np


def snr_db(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Plain signal-to-noise ratio in dB."""
    reference = np.asarray(reference, np.float64)
    estimate = np.asarray(estimate, np.float64)
    noise = estimate - reference
    return 10.0 * np.log10(
        (np.sum(reference ** 2) + 1e-12) / (np.sum(noise ** 2) + 1e-12))


def si_sdr_db(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Scale-invariant SDR (Le Roux et al. 2019, eq. 5)."""
    reference = np.asarray(reference, np.float64)
    estimate = np.asarray(estimate, np.float64)
    reference = reference - reference.mean()
    estimate = estimate - estimate.mean()
    alpha = np.dot(estimate, reference) / (np.dot(reference, reference)
                                           + 1e-12)
    target = alpha * reference
    noise = estimate - target
    return 10.0 * np.log10((np.sum(target ** 2) + 1e-12)
                           / (np.sum(noise ** 2) + 1e-12))


# --- STOI -------------------------------------------------------------------

_STOI_FS = 10_000
_STOI_NFFT = 512
# 256-sample Hann frames with 50% overlap at 10 kHz (25.6 ms), zero-padded
# to 512; third-octave bands 150 Hz..~4.3 kHz (Taal et al. 2011, sec. II)
_STOI_FRAME = 256
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_N = 30             # analysis length: 30 frames (384 ms)
_STOI_BETA = -15.0       # clipping, dB


def _resample(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Polyphase resampling (the measure specifies proper band-limited
    resampling to 10 kHz; linear interp would alias 5-24 kHz content
    into the third-octave bands)."""
    if fs_in == fs_out:
        return x
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(fs_in, fs_out)
    return resample_poly(x, fs_out // g, fs_in // g)


def _third_octave_matrix():
    """Band matrix with the standard's bin assignment (Taal et al. 2011
    MATLAB `thirdoct`, as in pystoi): each band covers FFT bins from the
    bin NEAREST its lower edge up to (exclusive) the bin nearest its
    upper edge — not a simple >=lo/<hi mask, which differs at edges."""
    freqs = np.linspace(0, _STOI_FS / 2, _STOI_NFFT // 2 + 1)
    cf = _STOI_MINFREQ * 2.0 ** (np.arange(_STOI_NBANDS) / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    mat = np.zeros((_STOI_NBANDS, len(freqs)))
    for b in range(_STOI_NBANDS):
        b1 = int(np.argmin(np.abs(freqs - lo[b])))
        b2 = int(np.argmin(np.abs(freqs - hi[b])))
        mat[b, b1:b2] = 1.0
    return mat


def _stft_mag(x: np.ndarray) -> np.ndarray:
    """[n_frames, 257] magnitudes; 256-sample Hann frames, 50% overlap."""
    win = np.hanning(_STOI_FRAME + 2)[1:-1]
    n = (len(x) - _STOI_FRAME) // (_STOI_FRAME // 2) + 1
    frames = np.stack([
        x[i * (_STOI_FRAME // 2): i * (_STOI_FRAME // 2) + _STOI_FRAME] * win
        for i in range(max(n, 0))])
    return np.abs(np.fft.rfft(frames, _STOI_NFFT, axis=-1))


def _remove_silent_frames(x, y, dyn_range=40.0):
    win = np.hanning(_STOI_FRAME + 2)[1:-1]
    hop = _STOI_FRAME // 2
    n = (len(x) - _STOI_FRAME) // hop + 1
    energies = np.array([
        20 * np.log10(np.linalg.norm(
            x[i * hop : i * hop + _STOI_FRAME] * win) + 1e-12)
        for i in range(n)])
    mask = energies > energies.max() - dyn_range
    xs, ys = [], []
    for i in np.nonzero(mask)[0]:
        xs.append(x[i * hop : i * hop + _STOI_FRAME])
        ys.append(y[i * hop : i * hop + _STOI_FRAME])
    if not xs:
        return x, y
    # overlap-add back with 50% overlap
    def ola(frames):
        out = np.zeros((len(frames) + 1) * hop + hop)
        for i, f in enumerate(frames):
            out[i * hop : i * hop + _STOI_FRAME] += f * win
        return out
    return ola(xs), ola(ys)


def stoi(clean: np.ndarray, enhanced: np.ndarray, fs: int = 48_000) -> float:
    """Short-Time Objective Intelligibility (Taal et al. 2011), in [0, 1].

    Classic (non-extended) STOI: third-octave band envelopes over 384 ms
    segments, normalized + clipped, correlated per band/segment.
    """
    x = _resample(np.asarray(clean, np.float64), fs, _STOI_FS)
    y = _resample(np.asarray(enhanced, np.float64), fs, _STOI_FS)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    x, y = _remove_silent_frames(x, y)

    xs = _stft_mag(x)
    ys = _stft_mag(y)
    band = _third_octave_matrix()
    xb = np.sqrt(band @ (xs.T ** 2)).T      # [frames, bands]
    yb = np.sqrt(band @ (ys.T ** 2)).T
    if xb.shape[0] < _STOI_N:
        return float("nan")

    scores = []
    for m in range(_STOI_N, xb.shape[0] + 1):
        xseg = xb[m - _STOI_N : m]          # [N, bands]
        yseg = yb[m - _STOI_N : m]
        # scale + clip the degraded envelope (eq. 3-4)
        alpha = np.sqrt(np.sum(xseg ** 2, axis=0)
                        / (np.sum(yseg ** 2, axis=0) + 1e-12))
        yclip = np.minimum(yseg * alpha,
                           xseg * (1 + 10 ** (-_STOI_BETA / 20.0)))
        xc = xseg - xseg.mean(axis=0)
        yc = yclip - yclip.mean(axis=0)
        denom = (np.linalg.norm(xc, axis=0)
                 * np.linalg.norm(yc, axis=0) + 1e-12)
        scores.append(np.sum(xc * yc, axis=0) / denom)
    return float(np.mean(scores))
