"""Raw PCM s16le I/O (the reference's audio format: 48 kHz mono int16),
on numpy: the port's own copy of percepnet_tpu/io/pcm.py."""

from __future__ import annotations

import numpy as np


def read_pcm16(path: str, normalize: bool = False) -> np.ndarray:
    """Read s16le PCM.  normalize=True divides by 32768 (main.cpp:34);
    False keeps raw amplitudes (feature-gen NORM_RATIO=1, denoise.cpp:41)."""
    x = np.fromfile(path, "<i2").astype(np.float32)
    return x / 32768.0 if normalize else x


def write_pcm16(path: str, x: np.ndarray, scale: float = 1.0) -> None:
    """Write float PCM as s16le with C-style truncation toward zero
    (denoise.cpp:724: (short)fmax(-32768, fmin(32767, x)))."""
    y = np.trunc(np.clip(np.asarray(x, np.float64) * scale, -32768, 32767))
    y.astype("<i2").tofile(path)
