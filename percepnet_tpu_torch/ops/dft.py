"""960-point real DFT as f32 matmuls against exactly-rounded tables.

The reference uses a mixed-radix KISS FFT with a 1/n forward scale and an
unnormalized inverse (denoise.cpp:291-324).  As in the JAX package, the
transform is one dense product per direction; on the card it is a plain
cuBLAS f32 GEMM (TF32 is off, see the package docstring).

The bf16 serving tier passes bf16 frames: the table is rounded to bf16
too, and the product of the two bf16 operands is taken in f32, returning
f32 spectra, as the JAX package's bf16 matmul with
preferred_element_type=f32 does.  Every product of two bf16 values is
exact in f32, so an f32 GEMM on the rounded operands is that arithmetic
(torch.matmul of two bf16 tensors would round its result to bf16).
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


@functools.lru_cache(maxsize=None)
def _bf16_rounded(table_fn, device: torch.device) -> torch.Tensor:
    """The f32 table rounded to bf16 and held in f32, once per device."""
    return C.device_table(table_fn, device).to(torch.bfloat16).to(
        torch.float32)


def _product(x: torch.Tensor, table_fn) -> torch.Tensor:
    """x @ table in f32; a bf16 x takes the bf16-rounded table."""
    if x.dtype == torch.bfloat16:
        return torch.matmul(x.to(torch.float32),
                            _bf16_rounded(table_fn, x.device))
    return torch.matmul(x, C.device_table(table_fn, x.device))


def forward_dft(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward real DFT with 1/n scaling: [..., 960] f32 or bf16 ->
    (Xr, Xi) [..., 481] f32.

    Matches the reference forward_transform = FFT(x)/n truncated to the
    half spectrum.
    """
    xcs = _product(x, _fwd_table)
    return xcs[..., : C.FREQ_SIZE], xcs[..., C.FREQ_SIZE :]


def inverse_dft(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Unnormalized inverse real DFT: (Xr, Xi) [..., 481] f32 or bf16 ->
    [..., 960] f32.

    Matches the reference inverse_transform, so
    inverse_dft(*forward_dft(x)) == x.
    """
    return _product(torch.cat([xr, xi], dim=-1), _inv_table)
