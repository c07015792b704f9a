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
// never dispatches it (tools/bench_comb.py reaches it).  The GPU
// counterpart of that layout: each frame's row is 1024 elements, 4 KB
// (f32) or 2 KB (bf16) aligned, and each thread stores one aligned 16-byte
// vector, 4 f32 or 8 bf16 values, so one template serves both store types
// and only the packing of the vector differs.  Tap loads stay scalar:
// their offsets depend on the period.  The window is zero beyond 960 (as
// the TPU kernel's _vorbis_rows_np is), so those elements are 0 and their
// taps are not read.
//
// Bound on this card: memory, as comb.cu; the row layout stores 1024/960
// of the bytes the function needs.  Rounding: comb_common.cuh.

#include <stdint.h>

#include "comb_common.cuh"

namespace {

using namespace percepnet_comb;

constexpr int kRow = 1024;

template <typename OutT>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kLen = 4;
  __device__ static uint32_t word(const float (&v)[kLen], int j) {
    return __float_as_uint(v[j]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kLen = 8;
  __device__ static uint32_t word(const float (&v)[kLen], int j) {
    // element 2j at the lower address: the low half of the word
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]));
    return lo | (hi << 16);
  }
};

template <typename OutT>
__global__ void __launch_bounds__(kRow / Vec<OutT>::kLen)
comb_rows_kernel(const float* __restrict__ s_pad,
                 const int* __restrict__ period,
                 const float* __restrict__ taps,
                 const float* __restrict__ window,
                 OutT* __restrict__ out,
                 int n_frames, int n_pad, int x_offset, int max_p) {
  constexpr int kLen = Vec<OutT>::kLen;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int p = period[(size_t)b * n_frames + t];
  const int i0 = threadIdx.x * kLen;
  float v[kLen];
  if (p < 0 || p > max_p) {
#pragma unroll
    for (int j = 0; j < kLen; ++j) v[j] = i0 + j < kWindow ? nan_value() : 0.0f;
  } else {
    const float* src = s_pad + (size_t)b * n_pad + (size_t)t * kHop + x_offset;
    float w[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) w[k] = taps[k];
#pragma unroll
    for (int j = 0; j < kLen; ++j) {
      const int i = i0 + j;
      v[j] = i < kWindow ? __fmul_rn(tap_sum(src, w, p, i), window[i]) : 0.0f;
    }
  }
  uint4 packed;
  packed.x = Vec<OutT>::word(v, 0);
  packed.y = Vec<OutT>::word(v, 1);
  packed.z = Vec<OutT>::word(v, 2);
  packed.w = Vec<OutT>::word(v, 3);
  reinterpret_cast<uint4*>(out + ((size_t)b * n_frames + t) * kRow)[threadIdx.x] =
      packed;
}

template <typename OutT>
int launch(const float* s_pad, const int* period, const float* taps,
           const float* window, OutT* out, int batch, int n_frames,
           int n_pad, int x_offset, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  dim3 grid(n_frames, batch);
  comb_rows_kernel<OutT>
      <<<grid, kRow / Vec<OutT>::kLen, 0, static_cast<cudaStream_t>(stream)>>>(
          s_pad, period, taps, window, out, n_frames, n_pad, x_offset,
          max_period(n_frames, n_pad, x_offset));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s_pad [batch, n_pad] f32, period [batch, n_frames] int32, taps [7] f32,
// window [960] f32, out [batch, n_frames, 1024] f32 or bf16, 16-byte
// aligned; all contiguous on the device.  Launch on `stream`; return
// cudaGetLastError().
extern "C" int percepnet_comb_rows_f32(const float* s_pad, const int* period,
                                       const float* taps, const float* window,
                                       void* out, int batch, int n_frames,
                                       int n_pad, int x_offset, void* stream) {
  return launch(s_pad, period, taps, window, static_cast<float*>(out), batch,
                n_frames, n_pad, x_offset, stream);
}

extern "C" int percepnet_comb_rows_bf16(const float* s_pad, const int* period,
                                        const float* taps, const float* window,
                                        void* out, int batch, int n_frames,
                                        int n_pad, int x_offset, void* stream) {
  return launch(s_pad, period, taps, window, static_cast<__nv_bfloat16*>(out),
                batch, n_frames, n_pad, x_offset, stream);
}
