"""Pitch comb filter: P(l) = sum_{k=-3..3} w_k x(t - pitch*k).

The reference accumulates 7 shifted copies of the 960-sample analysis
window from its ring buffer (denoise.cpp:419-422), weighted by the
normalized Hann comb window (denoise.cpp:200-206).  The shifts depend on
each frame's pitch period, so the work is a data-dependent gather.

Three implementations of one function, each storing f32 or (the bf16
serving tier) bf16 rounded once from the f32 value:
  comb_ref        plain PyTorch: 7 gathers, accumulated in tap order
                  k=0..6, window multiply last (the JAX package's
                  _comb_gather), then the cast.
  comb_cuda       the hand-written kernel csrc/comb.cu, which replaces the
                  TPU kernel percepnet_tpu/ops/comb.py:_comb_pallas.  It
                  rounds exactly as comb_ref does.
  comb_cuda_rows  csrc/comb_rows.cu, which replaces _comb_pallas_v2: the
                  same function with a row-layout store ([B, T, 1024],
                  returned as its [..., :960] view).  As in the JAX
                  package it is never dispatched; bench_comb reaches it.

`comb_filter_windows_batch` takes comb_ref for tensors on the CPU and
launches comb_cuda for tensors on the card.  `launches` counts each
kernel entry point's launches.
"""

from __future__ import annotations

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import kernels
from percepnet_tpu_torch.ops.dispatch import resolve_impl

ROW_LEN = 1024                   # comb_cuda_rows' padded row: 8 x 128

_STORES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Launches of each kernel entry point ("windows_f32", "windows_bf16",
# "rows_f32", "rows_bf16") since reset_launches(), for a caller that wants
# to know whether a run went through a kernel.
launches = {f"{layout}_{store}": 0 for layout in ("windows", "rows")
            for store in _STORES.values()}

_MAX_GRID_Y = 65535


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def comb_ref(s_pad: torch.Tensor, period: torch.Tensor, x_offset: int,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: [B, n_pad], [B, T] -> [B, T, 960], computed
    in f32 and cast to out_dtype."""
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
    return (acc * C.device_table(C.full_window, dev)).to(out_dtype)


def _launch(layout: str, width: int, s_pad: torch.Tensor,
            period: torch.Tensor, x_offset: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    """Check the inputs, allocate [B, T, width] and launch the entry point
    percepnet_comb_{layout}_{f32|bf16} on the current stream."""
    _check_inputs(s_pad, period, x_offset)
    if s_pad.device.type != "cuda":
        raise ValueError(f"the comb kernels need tensors on the card, got "
                         f"{s_pad.device}")
    if s_pad.dtype != torch.float32 or period.dtype != torch.int32:
        raise TypeError(f"the comb kernels take f32 s_pad and int32 period, "
                        f"got {s_pad.dtype} and {period.dtype}")
    if out_dtype not in _STORES:
        raise TypeError(f"the comb kernels store f32 or bf16, not "
                        f"{out_dtype}")
    if not (s_pad.is_contiguous() and period.is_contiguous()):
        raise ValueError("the comb kernels take contiguous s_pad and period")
    bsz, t = period.shape
    if bsz > _MAX_GRID_Y:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid limit "
                         f"{_MAX_GRID_Y}")
    out = torch.empty((bsz, t, width), dtype=out_dtype, device=s_pad.device)
    if bsz == 0 or t == 0:
        return out
    name = f"{layout}_{_STORES[out_dtype]}"
    taps = C.device_table(C.comb_hann_window, s_pad.device)
    window = C.device_table(C.full_window, s_pad.device)
    entry = getattr(kernels.library(), f"percepnet_comb_{name}")
    with torch.cuda.device(s_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(s_pad.data_ptr(), period.data_ptr(), taps.data_ptr(),
                    window.data_ptr(), out.data_ptr(), bsz, t,
                    s_pad.shape[1], x_offset, stream)
    if err != 0:
        raise RuntimeError(f"comb kernel {name} launch failed: CUDA error "
                           f"{err}")
    launches[name] += 1
    return out


def comb_cuda(s_pad: torch.Tensor, period: torch.Tensor, x_offset: int,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The CUDA kernel: s_pad f32 [B, n_pad] and period int32 [B, T],
    both contiguous on the card -> [B, T, 960] f32 or bf16.  A frame
    whose period reaches outside s_pad comes out as NaN."""
    return _launch("windows", C.WINDOW_SIZE, s_pad, period, x_offset,
                   out_dtype)


def comb_cuda_rows(s_pad: torch.Tensor, period: torch.Tensor, x_offset: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The row-layout CUDA kernel: takes what comb_cuda takes and returns
    the [B, T, :960] view of its [B, T, 1024] rows (960..1023 are zero),
    equal to comb_cuda's output bit for bit."""
    return _launch("rows", ROW_LEN, s_pad, period, x_offset,
                   out_dtype)[..., : C.WINDOW_SIZE]


def comb_filter_windows_batch(s_pad: torch.Tensor, period: torch.Tensor,
                              x_offset: int,
                              out_dtype: torch.dtype = torch.float32,
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
      out_dtype: the store type: f32, or bf16 for the serving tier (the
        sum stays f32; the bf16 value is its rounding).
      impl: 'ref' / 'cuda' tier; None takes the tier of the tensors'
        device (ops.dispatch).
    """
    if resolve_impl(impl, s_pad.device) == "cuda":
        return comb_cuda(s_pad, period, x_offset, out_dtype)
    return comb_ref(s_pad, period, x_offset, out_dtype)
