"""Pitch comb filter: P(l) = sum_{k=-3..3} w_k x(t - pitch*k).

The reference accumulates 7 shifted copies of the 960-sample analysis
window from its ring buffer (denoise.cpp:419-422), weighted by the
normalized Hann comb window (denoise.cpp:200-206).  The shifts depend on
each frame's pitch period, so the work is a data-dependent gather.

Two implementations of one function:
  comb_ref   plain PyTorch: 7 gathers, accumulated in tap order k=0..6,
             window multiply last (the JAX package's _comb_gather).
  comb_cuda  the hand-written kernel csrc/comb.cu, which replaces the TPU
             kernel percepnet_tpu/ops/comb.py:_comb_pallas.  It rounds
             exactly as comb_ref does.

`comb_filter_windows_batch` takes comb_ref for tensors on the CPU and
launches the kernel for tensors on the card; `launches` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import kernels
from percepnet_tpu_torch.ops.dispatch import resolve_impl

# Kernel launches since the count was last set to 0 (by a caller that
# wants to know whether a run went through the kernel).
launches = 0

_MAX_GRID_Y = 65535


def _check_inputs(s_pad: torch.Tensor, period: torch.Tensor,
                  x_offset: int) -> None:
    if s_pad.dim() != 2 or period.dim() != 2 or \
            s_pad.shape[0] != period.shape[0]:
        raise ValueError(f"expected s_pad [B, n_pad] and period [B, T], got "
                         f"{tuple(s_pad.shape)} and {tuple(period.shape)}")
    t = period.shape[1]
    if x_offset < 0 or (t > 0 and s_pad.shape[1] <
                        (t - 1) * C.FRAME_SIZE + x_offset + C.WINDOW_SIZE):
        raise ValueError(f"x_offset={x_offset} puts the last window of "
                         f"{t} frames outside s_pad of length "
                         f"{s_pad.shape[1]}")
    if period.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"period must be an integer tensor, got "
                        f"{period.dtype}")
    if period.device != s_pad.device:
        raise ValueError("s_pad and period must be on one device")


def comb_ref(s_pad: torch.Tensor, period: torch.Tensor,
             x_offset: int) -> torch.Tensor:
    """Plain PyTorch version: [B, n_pad], [B, T] -> [B, T, 960] f32."""
    _check_inputs(s_pad, period, x_offset)
    bsz, t = period.shape
    dev = s_pad.device
    s = s_pad.to(torch.float32)
    w = C.device_table(C.comb_hann_window, dev)
    base = (torch.arange(t, device=dev) * C.FRAME_SIZE + x_offset)[:, None] \
        + torch.arange(C.WINDOW_SIZE, device=dev)[None, :]       # [T, 960]
    p = period.to(torch.int64)[..., None]                         # [B, T, 1]
    acc = torch.zeros((bsz, t, C.WINDOW_SIZE), dtype=torch.float32,
                      device=dev)
    for kk in range(2 * C.COMB_M + 1):
        idx = base - p * (kk - C.COMB_M)                          # [B, T, 960]
        tap = torch.gather(s, 1, idx.reshape(bsz, -1)).reshape(idx.shape)
        acc = acc + w[kk] * tap
    return acc * C.device_table(C.full_window, dev)


def comb_cuda(s_pad: torch.Tensor, period: torch.Tensor,
              x_offset: int) -> torch.Tensor:
    """The CUDA kernel: s_pad f32 [B, n_pad] and period int32 [B, T],
    both contiguous on the card -> [B, T, 960] f32.  A frame whose
    period reaches outside s_pad comes out as NaN."""
    global launches
    _check_inputs(s_pad, period, x_offset)
    if s_pad.device.type != "cuda":
        raise ValueError(f"comb_cuda needs tensors on the card, got "
                         f"{s_pad.device}")
    if s_pad.dtype != torch.float32 or period.dtype != torch.int32:
        raise TypeError(f"comb_cuda takes f32 s_pad and int32 period, got "
                        f"{s_pad.dtype} and {period.dtype}")
    if not (s_pad.is_contiguous() and period.is_contiguous()):
        raise ValueError("comb_cuda takes contiguous s_pad and period")
    bsz, t = period.shape
    if bsz > _MAX_GRID_Y:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid limit "
                         f"{_MAX_GRID_Y}")
    out = torch.empty((bsz, t, C.WINDOW_SIZE), dtype=torch.float32,
                      device=s_pad.device)
    if bsz == 0 or t == 0:
        return out
    taps = C.device_table(C.comb_hann_window, s_pad.device)
    window = C.device_table(C.full_window, s_pad.device)
    lib = kernels.library()
    with torch.cuda.device(s_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.percepnet_comb_windows_f32(
            s_pad.data_ptr(), period.data_ptr(), taps.data_ptr(),
            window.data_ptr(), out.data_ptr(), bsz, t, s_pad.shape[1],
            x_offset, stream)
    if err != 0:
        raise RuntimeError(f"comb kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def comb_filter_windows_batch(s_pad: torch.Tensor, period: torch.Tensor,
                              x_offset: int,
                              impl: str | None = None) -> torch.Tensor:
    """[B, T, WINDOW_SIZE] analysis-windowed comb outputs for a batch.

    Output = apply_window(comb taps sum), i.e. the windowed P buffer fed
    straight to the DFT (denoise.cpp:419-424).

    Args:
      s_pad: [B, n_pad] f32 padded signals (ring-buffer layout,
        features.frontend.PAD leading zeros).
      period: [B, T] int32 pitch period per frame (60..769 after
        remove_doubling).
      x_offset: padded-sample offset of the analysis window (2400).
      impl: 'ref' / 'cuda' tier; None takes the tier of the tensors'
        device (ops.dispatch).  The bf16 store of the serving tier is not
        ported yet.
    """
    if resolve_impl(impl, s_pad.device) == "cuda":
        return comb_cuda(s_pad, period, x_offset)
    return comb_ref(s_pad, period, x_offset)
