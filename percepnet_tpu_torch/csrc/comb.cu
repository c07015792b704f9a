// Pitch comb filter for Hopper (sm_90a), rows of 960: the windowed 7-tap
// comb of every frame of a batch, stored f32 or, for the bf16 serving
// tier, rounded once to bf16 (one template, comb_common.cuh).
//
// Replaces the TPU kernel percepnet_tpu/ops/comb.py:_comb_kernel (:69) /
// _comb_pallas (:252), both of its stores.  That kernel DMAs a tile of
// frames' signal into VMEM and builds each unaligned window from lane
// rotates and selects; its bf16 store needs 8-row blocks (Mosaic's packed
// store alignment) or an f32 store and a cast.  Here a block stages its
// tile's span in shared memory with a TMA bulk copy and reads any offset
// from there; a warp packs its bf16 pairs with two shuffles, so both
// stores take one code path at any tile size.
//
// Bound on this card: bytes.  The function reads s_pad once
// (B*(T*480 + 5280)*4 bytes on the main path) and writes B*T*960 values
// (4 or 2 bytes each), against 3.35 TB/s; at 512 x 200 that is 0.179 ms
// (f32) or 0.121 ms (bf16).  Design, rounding and the NaN rule:
// comb_common.cuh.

#include "comb_common.cuh"

// s_pad [batch, n_pad] f32, period [batch, n_frames] int32, taps [7] f32,
// window [960] f32, out [batch, n_frames, 960] f32 or bf16; all contiguous
// on the device.  Tiles of tt frames (1..32), each split into `parts`
// column slices (1..8).  Launch on `stream`; return a CUDA error code.
extern "C" int percepnet_comb_windows_f32(const float* s_pad, const int* period,
                                          const float* taps, const float* window,
                                          void* out, int batch, int n_frames,
                                          int n_pad, int x_offset, int tt,
                                          int parts, void* stream) {
  return percepnet_comb::launch_tiles<float, percepnet_comb::kWindow>(
      s_pad, period, taps, window, static_cast<float*>(out), batch, n_frames,
      n_pad, x_offset, tt, parts, stream);
}

extern "C" int percepnet_comb_windows_bf16(const float* s_pad, const int* period,
                                           const float* taps, const float* window,
                                           void* out, int batch, int n_frames,
                                           int n_pad, int x_offset, int tt,
                                           int parts, void* stream) {
  return percepnet_comb::launch_tiles<__nv_bfloat16, percepnet_comb::kWindow>(
      s_pad, period, taps, window, static_cast<__nv_bfloat16*>(out), batch,
      n_frames, n_pad, x_offset, tt, parts, stream);
}
