"""34-band ERB filterbank operations as dense f32 matrix products
(compute_band_energy / compute_band_corr / interp_band_gain,
denoise.cpp:89-182)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from percepnet_tpu_torch import constants as C


@functools.lru_cache(maxsize=None)
def _energy_mat_t() -> np.ndarray:
    return C.band_energy_matrix().T.copy()          # [481, 34]


@functools.lru_cache(maxsize=None)
def _interp_mat_t() -> np.ndarray:
    return C.band_interp_matrix().T.copy()          # [34, 481]


def band_energy(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Per-band energy [..., NB_BANDS] from half spectrum [..., FREQ_SIZE].

    Triangular split of |X|^2 between adjacent bands, edge bands doubled,
    bins >= 20 kHz ignored (compute_band_energy, denoise.cpp:89-123).
    """
    power = xr * xr + xi * xi
    return torch.matmul(power, C.device_table(_energy_mat_t, power.device))


def band_corr(xr: torch.Tensor, xi: torch.Tensor, pr: torch.Tensor,
              pi: torch.Tensor) -> torch.Tensor:
    """Per-band Re<X, P> [..., NB_BANDS] (compute_band_corr,
    denoise.cpp:125-160)."""
    prod = xr * pr + xi * pi
    return torch.matmul(prod, C.device_table(_energy_mat_t, prod.device))


def interp_band_gain(band_g: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of band values onto bins, [..., FREQ_SIZE].

    Bins below the top band border get interpolated gains; bins at or
    above the 20 kHz border (400..480) get exactly zero
    (interp_band_gain, denoise.cpp:162-182).
    """
    return torch.matmul(band_g,
                        C.device_table(_interp_mat_t, band_g.device))
