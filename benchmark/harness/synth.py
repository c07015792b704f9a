"""Speech-like and noise signals for the benchmark's traffic, from a
numpy Generator: a frozen copy of the synthesizer the repository uses
for its training and holdout corpora (a source-filter "speech" with a
per-utterance f0 range, formant resonators, syllabic modulation,
fricative bursts and pauses; white, pink, brown, hum, band-passed and
babble noise).  Speech with real pitch makes the pitch search, the comb
taps and the hysteresis see what speech gives them.  Not real speech.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps

FS = 48_000


def _formant_filter(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """2-4 random resonators (vowel-ish spectral envelope) + tilt."""
    y = x
    for _ in range(rng.integers(2, 5)):
        fc = rng.uniform(300, 3500)
        bw = rng.uniform(80, 300)
        r = np.exp(-np.pi * bw / FS)
        th = 2 * np.pi * fc / FS
        b, a = [1 - r], [1.0, -2 * r * np.cos(th), r * r]
        y = sps.lfilter(b, a, y)
    # gentle spectral tilt
    y = sps.lfilter([1.0], [1.0, -0.6], y)
    return y


def _voiced_segment(n: int, f0_base: float, rng: np.random.Generator):
    t = np.arange(n) / FS
    drift = rng.uniform(-0.15, 0.15)
    vibr = rng.uniform(0.0, 0.03) * np.sin(
        2 * np.pi * rng.uniform(4, 7) * t + rng.uniform(0, 6.28))
    jitter = 0.01 * np.cumsum(rng.normal(0, 1, n)) / np.sqrt(np.arange(1, n + 1))
    # t[-1] is 0 for a 1-sample tail segment; 0/0 there NaN'd the f0
    # track, and the NaN propagated through the utterance normalization,
    # zeroing the WHOLE pair on int16 cast (observed: fileid_4029)
    f0 = f0_base * (1 + drift * t / max(float(t[-1]), 1.0 / FS) + vibr
                    + jitter)
    phase = np.cumsum(f0) / FS
    saw = 2.0 * (phase % 1.0) - 1.0           # all harmonics, 1/k rolloff
    return _formant_filter(saw, rng)


def _unvoiced_segment(n: int, rng: np.random.Generator):
    x = rng.normal(0, 1, n)
    fc = rng.uniform(2500, 7000)
    b, a = sps.butter(2, [fc * 0.6 / (FS / 2), min(fc * 1.6, 20000) / (FS / 2)],
                      "bandpass")
    return sps.lfilter(b, a, x)


def synth_speech(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """One speaker-utterance of speech-like audio in [-1, 1]."""
    n_total = int(seconds * FS)
    f0_base = rng.uniform(85, 280)            # per-"speaker" register
    out = np.zeros(n_total, np.float64)
    pos = 0
    while pos < n_total:
        kind = rng.choice(["voiced", "unvoiced", "pause"],
                          p=[0.55, 0.2, 0.25])
        dur = {"voiced": rng.uniform(0.12, 0.45),
               "unvoiced": rng.uniform(0.05, 0.18),
               "pause": rng.uniform(0.08, 0.5)}[kind]
        n = min(int(dur * FS), n_total - pos)
        if n <= 0:
            break
        if kind == "voiced":
            seg = _voiced_segment(n, f0_base * rng.uniform(0.85, 1.2), rng)
            seg /= np.max(np.abs(seg)) + 1e-9
            seg *= rng.uniform(0.5, 1.0)
        elif kind == "unvoiced":
            seg = _unvoiced_segment(n, rng)
            seg /= np.max(np.abs(seg)) + 1e-9
            seg *= rng.uniform(0.1, 0.35)
        else:
            seg = np.zeros(n)
        # syllabic AM + 10 ms fade to avoid clicks
        if n > 0 and kind != "pause":
            t = np.arange(n) / FS
            am = 1.0 + 0.35 * np.sin(2 * np.pi * rng.uniform(3, 8) * t
                                     + rng.uniform(0, 6.28))
            fade = min(480, n // 4)
            env = np.ones(n)
            env[:fade] = np.linspace(0, 1, fade)
            env[n - fade:] = np.linspace(1, 0, fade)
            seg = seg * am * env
        out[pos : pos + n] = seg
        pos += n
    out /= np.max(np.abs(out)) + 1e-9
    return out


def _shaped_noise(n: int, slope: float, rng: np.random.Generator):
    """FFT-shaped noise: |H(f)| = f^slope (slope -1 pink, -2 brown)."""
    spec = np.fft.rfft(rng.normal(0, 1, n))
    f = np.maximum(np.fft.rfftfreq(n, 1 / FS), 1.0)
    spec *= f ** slope
    x = np.fft.irfft(spec, n)
    return x / (np.std(x) + 1e-9)


def synth_noise(seconds: float, rng: np.random.Generator) -> np.ndarray:
    n = int(seconds * FS)
    kind = rng.choice(["white", "pink", "brown", "hum", "band", "babble"],
                      p=[0.15, 0.25, 0.15, 0.1, 0.15, 0.2])
    if kind == "white":
        x = rng.normal(0, 1, n)
    elif kind == "pink":
        x = _shaped_noise(n, -0.5, rng)
    elif kind == "brown":
        x = _shaped_noise(n, -1.0, rng)
    elif kind == "hum":
        t = np.arange(n) / FS
        f = rng.choice([50.0, 60.0])
        x = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f * k * t)
                for k in range(1, 6))
        x = x + 0.2 * _shaped_noise(n, -0.5, rng)
    elif kind == "band":
        lo = rng.uniform(100, 4000)
        hi = lo * rng.uniform(1.5, 4.0)
        b, a = sps.butter(3, [lo / (FS / 2), min(hi, 20000) / (FS / 2)],
                          "bandpass")
        x = sps.lfilter(b, a, rng.normal(0, 1, n))
    else:  # babble: a few competing low-level speech generators
        x = sum(synth_speech(seconds, rng) for _ in range(3))
    # slow level modulation so noise is not perfectly stationary
    t = np.arange(n) / FS
    x = x * (1.0 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.1, 0.6) * t
                                + rng.uniform(0, 6.28)))
    return x / (np.std(x) + 1e-9)
