// Shared by the two comb kernels (comb.cu, comb_rows.cu): the geometry,
// the period limit and the one tap sum both compute, so that their f32
// outputs agree bit for bit.
//
// The adds and multiplies use the _rn intrinsics so that nvcc does not
// contract them into fused multiply-adds: the kernels then round exactly
// as the plain PyTorch version (ops/comb.py:comb_ref) does, bit for bit.
// A bf16 store rounds that f32 value once, to nearest even, so it equals
// comb_ref(...).to(torch.bfloat16) bit for bit too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace percepnet_comb {

constexpr int kHop = 480;
constexpr int kWindow = 960;
constexpr int kTaps = 7;
constexpr int kHalfTaps = 3;

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);
}

// sum_{k=0..6} w[k] * src[i - p*(k-3)], in tap order, no contraction
__device__ __forceinline__ float tap_sum(const float* __restrict__ src,
                                         const float (&w)[kTaps], int p,
                                         int i) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    acc = __fadd_rn(acc, __fmul_rn(w[k], src[i - p * (k - kHalfTaps)]));
  return acc;
}

// Largest period whose 7 taps stay inside [0, n_pad) for every frame; a
// frame with a larger (or negative) period comes out as NaN instead of
// reading out of bounds.
inline int max_period(int n_frames, int n_pad, int x_offset) {
  const int room_left = x_offset;
  const int room_right = n_pad - kWindow - (n_frames - 1) * kHop - x_offset;
  return (room_left < room_right ? room_left : room_right) / kHalfTaps;
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

}  // namespace percepnet_comb
