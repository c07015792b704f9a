"""Vorbis analysis window (denoise.cpp:186-214, 282-289)."""

from __future__ import annotations

import torch

from percepnet_tpu_torch import constants as C


def apply_window(x: torch.Tensor) -> torch.Tensor:
    """Multiply [..., WINDOW_SIZE] frames by the symmetric Vorbis window.

    Same window for analysis and synthesis (apply_window, denoise.cpp:282).
    """
    if x.shape[-1] != C.WINDOW_SIZE:
        raise ValueError(f"expected [..., {C.WINDOW_SIZE}] frames, "
                         f"got {tuple(x.shape)}")
    return x * C.device_table(C.full_window, x.device)
