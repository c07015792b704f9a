"""PESQ-style perceptual quality estimate (ITU-T P.862 structure), on
numpy and scipy: the port's own copy of percepnet_tpu/utils/pesq.py.

The DNS-Challenge/PercepNet papers report PESQ; no PESQ library is
vendorable here, so this implements the P.862 processing chain from its
published description:

  level alignment -> time alignment -> 32 ms Hann STFT -> Bark-band
  warping -> partial frequency-response equalization -> short-term gain
  equalization -> Zwicker loudness -> masked symmetric + asymmetric
  disturbances -> L6/L2 two-stage aggregation -> MOS mapping
  (P.862.1-style logistic to MOS-LQO).

HONESTY NOTE: the chain and its psychoacoustic stages follow the
standard, but the ITU reference implementation's exact band tables and
calibration constants are not reproduced and this has NOT been validated
against ITU conformance vectors.  A least-squares fit of the two
aggregation slopes against published speech-in-white-noise anchors
(20/10/5/0 dB -> 2.8/2.1/1.8/1.5 MOS) cannot flatten the curve to the
real P.862 slope — the residual steepness is structural (masking +
aggregation detail), not a constant choice — so the constants below keep
the structurally-motivated values.  Scores are calibrated only coarsely
(clean -> ~4.5, heavy noise -> low); treat them as a perceptually
weighted RELATIVE quality measure ("pesq_like"), not certified P.862
MOS-LQO.  For certified numbers run the ITU reference tool on exported
PCM.  (Reference parity surface: the papers' metric, not reference code —
the reference repo itself computes no metrics.)
"""

from __future__ import annotations

import numpy as np

from percepnet_tpu_torch.utils.metrics import _resample

_FS = 16_000          # internal rate (P.862 wideband operating mode)
_FRAME = 512          # 32 ms
_HOP = 256
_NBANDS = 49          # wideband Bark bands
_F_LO, _F_HI = 50.0, 7_000.0


def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _band_matrix():
    """[nbands, nbins] averaging matrix, uniform in Bark over [50, 7000]."""
    freqs = np.fft.rfftfreq(_FRAME, 1.0 / _FS)
    edges = np.interp(np.linspace(_bark(_F_LO), _bark(_F_HI), _NBANDS + 1),
                      _bark(freqs), freqs)
    mat = np.zeros((_NBANDS, len(freqs)))
    centers = np.zeros(_NBANDS)
    for b in range(_NBANDS):
        sel = (freqs >= edges[b]) & (freqs < edges[b + 1])
        if not np.any(sel):
            sel = np.argmin(np.abs(freqs - 0.5 * (edges[b] + edges[b + 1])))
            sel = np.eye(len(freqs), dtype=bool)[sel]
        mat[b, sel] = 1.0 / np.sum(sel)
        centers[b] = 0.5 * (edges[b] + edges[b + 1])
    return mat, centers


_BAND_MAT, _BAND_CENTER = _band_matrix()


def _abs_threshold_power(f_hz):
    """Absolute hearing threshold (Terhardt), as band power at the
    internal calibration scale."""
    f = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    db = (3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
          + 1e-3 * f ** 4)
    return 10.0 ** (db / 10.0)


_P_ABS = _abs_threshold_power(_BAND_CENTER)
_LOUDNESS_SL = 0.25 * (_P_ABS / 0.5) ** 0.26   # Zwicker scale factor/band
_GAMMA = 0.23                                  # Zwicker power exponent


def _frames(x: np.ndarray) -> np.ndarray:
    n = max((len(x) - _FRAME) // _HOP + 1, 0)
    win = np.hanning(_FRAME)
    return np.stack([x[i * _HOP : i * _HOP + _FRAME] * win
                     for i in range(n)]) if n else np.zeros((0, _FRAME))


def _bark_power(x: np.ndarray) -> np.ndarray:
    """[n_frames, nbands] Bark-band power spectra."""
    spec = np.abs(np.fft.rfft(_frames(x), axis=-1)) ** 2
    return spec @ _BAND_MAT.T


def _level_align(x: np.ndarray) -> np.ndarray:
    """Scale to a fixed active-speech power (P.862 aligns both signals to
    79 dB SPL equivalent over a 350-3250 Hz band-passed version)."""
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / _FS)
    band = np.fft.irfft(spec * ((f >= 350) & (f <= 3250)), len(x))
    p = np.mean(band ** 2)
    return x * np.sqrt(1e4 / (p + 1e-20))


def _time_align(ref: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Single constant-delay alignment via envelope cross-correlation
    (P.862's crude alignment; per-utterance variable-delay splitting is
    not reproduced — our pipelines have constant delay)."""
    hop = 64
    n = min(len(ref), len(deg)) // hop
    er = np.log1p(np.sum(ref[: n * hop].reshape(n, hop) ** 2, -1))
    ed = np.log1p(np.sum(deg[: n * hop].reshape(n, hop) ** 2, -1))
    er -= er.mean()
    ed -= ed.mean()
    corr = np.correlate(ed, er, "full")
    delay = (np.argmax(corr) - (n - 1)) * hop
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        deg = np.concatenate([np.zeros(-delay), deg])
    m = min(len(ref), len(deg))
    return ref[:m], deg[:m]


def _loudness(p: np.ndarray) -> np.ndarray:
    """Zwicker loudness per band (P.862 eq. for specific loudness)."""
    ratio = np.maximum(p / _P_ABS, 0.0)
    s = _LOUDNESS_SL * ((0.5 + 0.5 * ratio) ** _GAMMA - 1.0)
    return np.maximum(s, 0.0)


def pesq_like(clean: np.ndarray, degraded: np.ndarray,
              fs: int = 48_000) -> float:
    """P.862-structured quality score on a 1.0-4.64 MOS-like scale.

    See the module docstring for the calibration caveat.
    """
    ref = _resample(np.asarray(clean, np.float64), fs, _FS)
    deg = _resample(np.asarray(degraded, np.float64), fs, _FS)
    ref, deg = _time_align(_level_align(ref), _level_align(deg))

    pr = _bark_power(ref)
    pd = _bark_power(deg)
    if pr.shape[0] < 4:
        return float("nan")

    # speech-active frames of the reference drive the equalizations
    frame_pow = pr.sum(-1)
    active = frame_pow > 1e-2 * np.max(frame_pow)
    if not active.any():        # silent reference: score undefined
        return float("nan")

    # partial frequency-response equalization: per-band mean ratio over
    # active frames, clipped to +/-20 dB, applied to the reference
    num = pd[active].mean(0) + 1e3
    den = pr[active].mean(0) + 1e3
    eq = np.clip(num / den, 1e-2, 1e2)
    pr_eq = pr * eq

    # short-term gain equalization of the degraded signal (slewed)
    g = (pr_eq.sum(-1) + 5e2) / (pd.sum(-1) + 5e2)
    g = np.clip(g, 3e-4, 5.0)
    for i in range(1, len(g)):                  # slew-rate limit
        g[i] = np.clip(g[i], g[i - 1] / 1.2, g[i - 1] * 1.2)
    pd_eq = pd * g[:, None]

    lr = _loudness(pr_eq)
    ld = _loudness(pd_eq)

    # masked disturbance (deadzone = 0.25 * min loudness per cell)
    diff = ld - lr
    mask = 0.25 * np.minimum(ld, lr)
    d = np.sign(diff) * np.maximum(np.abs(diff) - mask, 0.0)

    width = np.diff(_bark(np.interp(
        np.arange(_NBANDS + 1),
        np.arange(_NBANDS) + 0.5, _BAND_CENTER,
        left=_F_LO, right=_F_HI)))
    d_frame = np.sum(np.abs(d) * width, -1)

    # asymmetry factor: additive degradations (deg > ref) weigh more
    asym = ((pd_eq + 50.0) / (pr_eq + 50.0)) ** 1.2
    asym[asym < 3.0] = 0.0
    asym = np.minimum(asym, 12.0)
    da_frame = np.sum(np.abs(d) * asym * width, -1)

    # two-stage aggregation: L6 over 320 ms split-second intervals, then
    # L2 over time, frames weighted toward audible reference energy
    def agg(dframes):
        w = ((frame_pow + 1e5) / 1e7) ** 0.04
        x = dframes / np.maximum(w, 1e-6)
        k = 10                                   # frames per interval
        pad = (-len(x)) % k
        xi = np.pad(x, (0, pad)).reshape(-1, k)
        l6 = (np.mean(xi ** 6, -1)) ** (1 / 6)
        return float(np.sqrt(np.mean(l6 ** 2)))

    d_sym = agg(d_frame)
    d_asym = agg(da_frame)

    raw = 4.5 - 0.045 * d_sym - 0.014 * d_asym
    # P.862.1-style logistic mapping to MOS-LQO
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
