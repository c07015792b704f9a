"""960-point real DFT as f32 matmuls against exactly-rounded tables.

The reference uses a mixed-radix KISS FFT with a 1/n forward scale and an
unnormalized inverse (denoise.cpp:291-324).  As in the JAX package, the
transform is one dense product per direction; on the card it is a plain
cuBLAS f32 GEMM (TF32 is off, see the package docstring).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from percepnet_tpu_torch import constants as C


@functools.lru_cache(maxsize=None)
def _fwd_table() -> np.ndarray:
    """[960, 962] fused [cos | -sin] forward table (one matmul)."""
    c, s = C.rdft_matrices()
    return np.concatenate([c, -s], axis=0).T.copy()


@functools.lru_cache(maxsize=None)
def _inv_table() -> np.ndarray:
    """[962, 960] fused [cos; -sin] inverse table (one matmul)."""
    c, s = C.irdft_matrices()
    return np.concatenate([c, -s], axis=1).T.copy()


def forward_dft(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward real DFT with 1/n scaling: [..., 960] -> (Xr, Xi) [..., 481].

    Matches the reference forward_transform = FFT(x)/n truncated to the
    half spectrum.
    """
    xcs = torch.matmul(x, C.device_table(_fwd_table, x.device))
    return xcs[..., : C.FREQ_SIZE], xcs[..., C.FREQ_SIZE :]


def inverse_dft(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Unnormalized inverse real DFT: (Xr, Xi) [..., 481] -> [..., 960].

    Matches the reference inverse_transform, so
    inverse_dft(*forward_dft(x)) == x.
    """
    z = torch.cat([xr, xi], dim=-1)
    return torch.matmul(z, C.device_table(_inv_table, z.device))
