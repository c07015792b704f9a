"""Spectral enhancement and overlap-add resynthesis, batched over streams.

Applies the pitch filter (denoise.cpp:436-485), per-bin band gains
(denoise.cpp:539-544) and windowed overlap-add synthesis
(denoise.cpp:352-359) to all frames at once.  The OLA recursion is a
one-frame shift, so it parallelizes trivially.  Spectra are
[B, T, FREQ_SIZE], gains [B, T, NB_BANDS].
"""

from __future__ import annotations

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import bands, dft, window


def pitch_filter(xr, xi, pr, pi, r, silence):
    """X <- interp(1-r)*X + interp(r)*P, skipped on silent frames.

    Bins >= the 20 kHz band border get zero from both interpolation
    passes, so non-silent frames zero them, as the reference does.
    """
    rf = bands.interp_band_gain(r)
    inv_rf = bands.interp_band_gain(1.0 - r)
    yr = inv_rf * xr + rf * pr
    yi = inv_rf * xi + rf * pi
    sil = silence[..., None]
    return torch.where(sil, xr, yr), torch.where(sil, xi, yi)


def apply_gains(xr, xi, g):
    """Per-bin gain multiply: gf = interp(g); X *= gf (denoise.cpp:539-544)."""
    gf = bands.interp_band_gain(g)
    return xr * gf, xi * gf


def synthesize(xr: torch.Tensor, xi: torch.Tensor,
               synthesis_mem: torch.Tensor | None = None,
               serving: bool = False):
    """Windowed inverse DFT + 50% overlap-add (denoise.cpp:352-359).

    Args:
      xr, xi: [B, T, 481] enhanced spectra.
      synthesis_mem: optional [B, 480] carry from the previous chunk.
      serving: the bf16 serving tier: the spectra enter the inverse DFT
        as bf16, with an f32 result (ops.dft).
    Returns:
      (pcm [B, T*480] f32, new_mem [B, 480]).
    """
    if serving:
        xr, xi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
    x = window.apply_window(dft.inverse_dft(xr, xi))   # [B, T, 960]
    first, second = x[..., : C.FRAME_SIZE], x[..., C.FRAME_SIZE :]
    if synthesis_mem is None:
        synthesis_mem = torch.zeros_like(second[:, 0])
    prev = torch.cat([synthesis_mem[:, None], second[:, :-1]], dim=1)
    out = first + prev
    return out.reshape(out.shape[0], -1), second[:, -1].contiguous()


def enhance_spectra(front: dict, g: torch.Tensor, r: torch.Tensor,
                    synthesis_mem: torch.Tensor | None = None,
                    serving: bool = False):
    """Pitch filter -> band gains -> OLA synthesis.

    Args:
      front: features.frontend.analyze_batch output (xr, xi, pr, pi,
        silence).
      g, r: [B, T, 34] gains and strengths (model output or oracle labels).
      serving: the bf16 inverse DFT (see synthesize).
    Returns:
      (pcm [B, T*480], new_synthesis_mem [B, 480]).
    """
    xr, xi = pitch_filter(front["xr"], front["xi"], front["pr"], front["pi"],
                          r, front["silence"])
    xr, xi = apply_gains(xr, xi, g)
    return synthesize(xr, xi, synthesis_mem, serving=serving)
