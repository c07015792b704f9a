// Row-layout variant of the pitch comb filter for Hopper (sm_90a): the
// same function as comb.cu (ops/comb.py:comb_ref), stored as padded rows
// out[b, t, 0:1024], of which 0..959 are the windowed comb and 960..1023
// are zero.  The wrapper returns the [..., :960] view.
//
// Replaces the TPU kernel percepnet_tpu/ops/comb.py:_comb_kernel_v2
// (:135) / _comb_pallas_v2 (:202).  There the [8, 128] accumulator of a
// frame is stored as it is, at 8-aligned sublanes of a [T*8, 128] block,
// so f32 and 16-bit stores take one code path; the JAX package uses it to
// show that a bf16 store equals the rounded f32 store bit for bit, and
// never dispatches it (tools/bench_comb.py reaches it).  On the GPU the
// row of 1024 is the kernel of comb_common.cuh with 64 more columns in
// the last warp's chunk, stored as zeros without reading anything, so
// this kernel is comb.cu's plus 64/960 more bytes stored.
//
// Bound on this card: bytes, as comb.cu's; the row layout stores 1024/960
// of the bytes the function needs.

#include "comb_common.cuh"

namespace {
constexpr int kRow = 1024;
}

// s_pad [batch, n_pad] f32, period [batch, n_frames] int32, taps [7] f32,
// window [960] f32, out [batch, n_frames, 1024] f32 or bf16; all
// contiguous on the device.  Tiles of tt frames (1..32), each split into
// `parts` column slices (1..8).  Launch on `stream`; return a CUDA error
// code.
extern "C" int percepnet_comb_rows_f32(const float* s_pad, const int* period,
                                       const float* taps, const float* window,
                                       void* out, int batch, int n_frames,
                                       int n_pad, int x_offset, int tt,
                                       int parts, void* stream) {
  return percepnet_comb::launch_tiles<float, kRow>(
      s_pad, period, taps, window, static_cast<float*>(out), batch, n_frames,
      n_pad, x_offset, tt, parts, stream);
}

extern "C" int percepnet_comb_rows_bf16(const float* s_pad, const int* period,
                                        const float* taps, const float* window,
                                        void* out, int batch, int n_frames,
                                        int n_pad, int x_offset, int tt,
                                        int parts, void* stream) {
  return percepnet_comb::launch_tiles<__nv_bfloat16, kRow>(
      s_pad, period, taps, window, static_cast<__nv_bfloat16*>(out), batch,
      n_frames, n_pad, x_offset, tt, parts, stream);
}
