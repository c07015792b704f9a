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

A frame whose period lies outside [0, max_period(...)] would read outside
s_pad: all three give NaN for it.  Both kernels stage a tile of frames'
span of s_pad in shared memory (csrc/comb_common.cuh); `tile_grid` picks
the tile and the launch grid, `staged_span` sizes the shared memory.

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
TILE_FRAMES = (12, 8, 4, 2, 1)   # frames a block stages, largest first
CHUNK = 128                      # columns per warp of a block
SMEM_LIMIT = 227 * 1024          # shared memory a block can have (H100)
STATIC_SMEM = 1024               # the kernel's own, beside the span
SMS = 132                        # the H100's streaming multiprocessors
RESIDENT_BLOCKS = 6 * SMS        # blocks of 8 warps the card holds at once

_STORES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Launches of each kernel entry point ("windows_f32", "windows_bf16",
# "rows_f32", "rows_bf16") since reset_launches(), for a caller that wants
# to know whether a run went through a kernel.
launches = {f"{layout}_{store}": 0 for layout in ("windows", "rows")
            for store in _STORES.values()}
# The (entry point, B, T, n_pad) of every launch since reset_launches(),
# for a caller that holds each kernel against its plain version at the
# shapes a run gave it.
launch_shapes: set[tuple[str, int, int, int]] = set()

_MAX_GRID = 65535                # grid y (tiles) and z (batch rows)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    launch_shapes.clear()


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


def max_period(n_frames: int, n_pad: int, x_offset: int) -> int:
    """Largest period whose 7 taps stay inside [0, n_pad) for every frame
    (csrc/comb_common.cuh:max_period): 800 on the main path's geometry,
    n_pad = T*480 + 5280 and x_offset = 2400."""
    room_right = n_pad - C.WINDOW_SIZE - (n_frames - 1) * C.FRAME_SIZE \
        - x_offset
    return min(x_offset, room_right) // C.COMB_M


def staged_span(tt: int, max_p: int, width: int = C.WINDOW_SIZE) -> int:
    """Floats of shared memory a kernel block stages for a tile of tt
    frames and `width` columns at periods up to max_p: the widest span,
    (tt-1)*480 + width + 6*max_p, plus up to 3 floats that align its start
    to 16 bytes, rounded up to 4 (csrc/comb_common.cuh:staged_floats).
    Main path, tt = 8: 9,124 floats, 36,496 bytes."""
    span = (tt - 1) * C.FRAME_SIZE + width + 2 * C.COMB_M * max_p
    return (span + 3 + 3) // 4 * 4


def tile_grid(bsz: int, t: int) -> tuple[int, int]:
    """(frames per tile, column slices per tile) of a launch on [bsz, t]:
    the largest tile of TILE_FRAMES that still makes RESIDENT_BLOCKS
    blocks (the card full at once), else single frames; and where even
    those make fewer blocks than the card has SMs (a serving tick: 64 x 1),
    each tile split into 2 slices of 4 chunks."""
    tt = next((tt for tt in TILE_FRAMES
               if bsz * -(-t // tt) >= RESIDENT_BLOCKS), 1)
    tt = max(1, min(tt, t))
    return tt, 2 if bsz * -(-t // tt) < SMS else 1


def comb_ref(s_pad: torch.Tensor, period: torch.Tensor, x_offset: int,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: [B, n_pad], [B, T] -> [B, T, 960], computed
    in f32 and cast to out_dtype; NaN frames where a period lies outside
    [0, max_period(...)]."""
    _check_inputs(s_pad, period, x_offset)
    bsz, t = period.shape
    dev = s_pad.device
    s = s_pad.to(torch.float32)
    w = C.device_table(C.comb_hann_window, dev)
    base = (torch.arange(t, device=dev) * C.FRAME_SIZE + x_offset)[:, None] \
        + torch.arange(C.WINDOW_SIZE, device=dev)[None, :]       # [T, 960]
    p = period.to(torch.int64)[..., None]                         # [B, T, 1]
    valid = (p >= 0) & (p <= max_period(t, s_pad.shape[1], x_offset))
    p = torch.where(valid, p, 0)
    acc = torch.zeros((bsz, t, C.WINDOW_SIZE), dtype=torch.float32,
                      device=dev)
    for kk in range(2 * C.COMB_M + 1):
        idx = base - p * (kk - C.COMB_M)                          # [B, T, 960]
        tap = torch.gather(s, 1, idx.reshape(bsz, -1)).reshape(idx.shape)
        acc = acc + w[kk] * tap
    out = acc * C.device_table(C.full_window, dev)
    return torch.where(valid, out, torch.nan).to(out_dtype)


def _launch(layout: str, width: int, s_pad: torch.Tensor,
            period: torch.Tensor, x_offset: int,
            out_dtype: torch.dtype,
            grid: tuple[int, int] | None = None) -> torch.Tensor:
    """Check the inputs, allocate [B, T, width] and launch the entry point
    percepnet_comb_{layout}_{f32|bf16} on the current stream, in the
    tiles and slices `grid` gives (tile_grid's by default)."""
    _check_inputs(s_pad, period, x_offset)
    bsz, t = period.shape
    tt, parts = grid or tile_grid(bsz, t)
    chunks = -(-width // CHUNK)
    if not (1 <= tt <= 32 and 1 <= parts <= chunks):
        raise ValueError(f"tiles of 1..32 frames in 1..{chunks} slices, "
                         f"got {tt} and {parts}")
    if bsz > _MAX_GRID or -(-t // tt) > _MAX_GRID:
        raise ValueError(f"[{bsz}, {t}] in tiles of {tt} exceeds the "
                         f"kernel's grid limit {_MAX_GRID}")
    cols = min(-(-chunks // parts) * CHUNK, C.WINDOW_SIZE)
    smem = 4 * staged_span(tt, max_period(t, s_pad.shape[1], x_offset),
                           cols)
    if smem + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"x_offset={x_offset} and s_pad of length "
                         f"{s_pad.shape[1]} allow periods whose span needs "
                         f"{smem} bytes of shared memory, over the "
                         f"{SMEM_LIMIT - STATIC_SMEM} a block can stage")
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
                    s_pad.shape[1], x_offset, tt, parts, stream)
    if err != 0:
        raise RuntimeError(f"comb kernel {name} launch failed: CUDA error "
                           f"{err}")
    launches[name] += 1
    launch_shapes.add((name, bsz, t, s_pad.shape[1]))
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


def comb_filter_windows(s_pad: torch.Tensor, n_frames: int, x_offset: int,
                        period: torch.Tensor) -> torch.Tensor:
    """Single-utterance variant: s_pad [n_pad], period [T] -> [T, 960]
    windowed comb outputs, through comb_filter_windows_batch (n_frames is
    the JAX signature's and is implied by period)."""
    del n_frames
    return comb_filter_windows_batch(s_pad[None], period[None], x_offset)[0]
