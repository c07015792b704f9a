// The pitch comb filter for Hopper (sm_90a), shared by its two entry
// files: comb.cu (rows of 960, the TPU kernel _comb_pallas) and
// comb_rows.cu (padded rows of 1024, _comb_pallas_v2).  Both compute
//
//   out[b, t, i] = window[i] * sum_{k=0..6} taps[k] * s_pad[b, t*480 + x_offset - p*(k-3) + i],
//   p = period[b, t], i < 960,
//
// accumulated in f32 in tap order k = 0..6 with the window multiply last,
// and store f32 or, for the bf16 serving tier, that value rounded once to
// bf16.  The adds and multiplies use the _rn intrinsics so that nvcc does
// not contract them into fused multiply-adds: the kernel then rounds
// exactly as the plain PyTorch version (ops/comb.py:comb_ref) does, bit
// for bit, in both stores and both row layouts.
//
// Bound on this card: memory.  15 flops per output against at least 6
// bytes moved (each s_pad sample read once, each output written once in
// f32 or bf16): 2.5 flop/byte, far below the ~295 at which compute would
// bound an H100.  Each output reads 7 taps at offsets that depend on the
// period, so a kernel that loads taps from global memory issues 28 bytes
// of unaligned L1/L2 requests per output and leaves the overlap of the 7
// shifted windows, and of neighbouring frames' windows, to the caches.
//
// Design: a block owns one batch row and a tile of tt consecutive frames
// (at most 32), or one of a few column slices of it (a split that fills
// the card when B*T is small).  Its first warp loads the tile's periods
// and reduces them to the tile's span of s_pad: the union of every tap
// index its in-range frames read.  One thread copies the span's 16-byte
// aligned body into shared memory with one TMA bulk copy
// (cp.async.bulk, completing on an mbarrier); a few threads load the
// unaligned head and tail.  Then every tap is read from shared memory.
// The columns of a frame go in chunks of 128 to one warp each, lane L
// computing columns L + 32m (m < 4): each tap read is 32 consecutive
// words (conflict-free), the 4 columns of a lane share the 7 tap
// addresses, and each store is 128 contiguous bytes per warp (f32 as it
// is, bf16 as __nv_bfloat162 pairs after two shuffles).  A warp keeps its
// window values and the 7 taps in registers over the tile's frames, and
// loads them before the staging so that their latency hides under it.
// A frame whose period lies outside [0, max_p] comes out as NaN, reads
// nothing and does not widen the span.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace percepnet_comb {

constexpr int kHop = 480;
constexpr int kWindow = 960;
constexpr int kTaps = 7;
constexpr int kHalfTaps = 3;
constexpr int kChunk = 128;     // columns per warp and frame
constexpr int kSub = kChunk / 32;                 // columns per lane
constexpr int kRowChunks = 8;   // chunks of a row of 960 or 1024
constexpr int kMaxTile = 32;    // frames per tile: one warp reduces the span
// static shared memory of a block (periods, span bounds, mbarrier), at most
constexpr size_t kStaticSmem = 1024;
constexpr unsigned kFull = 0xffffffffu;

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
// reading out of bounds.  ops/comb.py:max_period is the same formula.
inline int max_period(int n_frames, int n_pad, int x_offset) {
  const int room_left = x_offset;
  const int room_right = n_pad - kWindow - (n_frames - 1) * kHop - x_offset;
  return (room_left < room_right ? room_left : room_right) / kHalfTaps;
}

// Floats of shared memory a block stages: the widest span of a tile of
// tt frames over `width` columns at periods up to max_p, plus up to 3
// floats that align the span's start to 16 bytes, rounded up to 4.
// ops/comb.py:staged_span is the same formula.
inline int staged_floats(int tt, int width, int max_p) {
  return ((tt - 1) * kHop + width + 2 * kHalfTaps * max_p + 3 + 3) / 4 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A one-shot mbarrier that completes when one thread has arrived and the
// bytes it announced have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store 64 columns of a warp's chunk, lane L holding columns L (x) and
// L+32 (y): f32 as two 128-byte warp stores; bf16 as one, lane L storing
// columns 2L and 2L+1 as one pair taken from lanes 2L and 2L+1 (mod 32):
// their x halves for L < 16, their y halves for L >= 16.
__device__ __forceinline__ void store64(float* dst, int lane, float x,
                                        float y) {
  dst[lane] = x;
  dst[lane + 32] = y;
}

__device__ __forceinline__ void store64(__nv_bfloat16* dst, int lane,
                                        float x, float y) {
  const uint32_t xy = bf16_pair(x, y);
  const uint32_t even = __shfl_sync(kFull, xy, (2 * lane) & 31);
  const uint32_t odd = __shfl_sync(kFull, xy, (2 * lane + 1) & 31);
  reinterpret_cast<uint32_t*>(dst)[lane] =
      __byte_perm(even, odd, lane < 16 ? 0x5410 : 0x7632);
}

// One warp's columns over the tile's frames: lane L computes columns
// L + 32m (m < kN) of its chunk, from the staged span; kZero more 32-column
// groups after them are the zero tail of a 1024-element row.  src points
// at the span element of the first frame's column L for tap k = 3;
// frame f's is 480 f further.  dst: the first frame's chunk, row_len
// apart.
template <int kN, int kZero, typename OutT>
__device__ __forceinline__ void chunk_frames(
    const float* src, OutT* dst, int row_len, const int* tile_period,
    int nf, int max_p, const float (&w)[kTaps], const float* win, int lane) {
  static_assert(kN % 2 == 0 && (kN + kZero) % 2 == 0, "64-column groups");
  for (int f = 0; f < nf; ++f, src += kHop, dst += row_len) {
    const int p = tile_period[f];
    float v[kN + kZero];
#pragma unroll
    for (int m = 0; m < kN + kZero; ++m) v[m] = m < kN ? nan_value() : 0.0f;
    if (p >= 0 && p <= max_p) {
#pragma unroll
      for (int m = 0; m < kN; ++m) v[m] = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float* tap = src - p * (k - kHalfTaps);
#pragma unroll
        for (int m = 0; m < kN; ++m)
          v[m] = __fadd_rn(v[m], __fmul_rn(w[k], tap[32 * m]));
      }
#pragma unroll
      for (int m = 0; m < kN; ++m) v[m] = __fmul_rn(v[m], win[m]);
    }
#pragma unroll
    for (int m = 0; m < kN + kZero; m += 2)
      store64(dst + 32 * m, lane, v[m], v[m + 1]);
  }
}

// One block: column chunks [q0, q1) (one warp each) of the frames
// [t0, t0 + nf) of batch row b, for (blockIdx.x, blockIdx.y, blockIdx.z) =
// (column slice, tile, b).  kRow is the stored row length (960, or 1024
// whose columns 960.. are zero).  Dynamic shared memory: staged_floats.
template <typename OutT, int kRow>
__global__ void __launch_bounds__(kRowChunks * 32, 6)
comb_tile_kernel(const float* __restrict__ s_pad,
                 const int* __restrict__ period,
                 const float* __restrict__ taps,
                 const float* __restrict__ window,
                 OutT* __restrict__ out,
                 int n_frames, int n_pad, int x_offset, int max_p, int tt) {
  extern __shared__ __align__(16) float span[];
  __shared__ int tile_period[kMaxTile];
  __shared__ int tile_lo, tile_hi;
  __shared__ __align__(8) uint64_t staged;
  if (threadIdx.x == 0) mbar_init(&staged);

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * tt;
  const int nf = min(tt, n_frames - t0);
  const int q0 = blockIdx.x * (blockDim.x >> 5);
  const int q1 = min(q0 + static_cast<int>(blockDim.x >> 5), kRowChunks);
  const int c0 = q0 * kChunk;                     // columns read: [c0, c1)
  const int c1 = min(q1 * kChunk, kWindow);
  const float* row = s_pad + (size_t)b * n_pad;

  // The periods' load goes first: nothing waits on the taps before it.
  const int f = threadIdx.x;
  const int p_f = f < 32 && f < nf ? period[(size_t)b * n_frames + t0 + f]
                                   : -1;

  // This warp's chunk, its taps and window values: their latency hides
  // under the loads of the periods and the span.
  const int q = q0 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int col = q * kChunk + lane;              // + 32m
  float w[kTaps], win[kSub];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = taps[k];
#pragma unroll
  for (int m = 0; m < kSub; ++m)
    win[m] = q < q1 && col + 32 * m < kWindow ? window[col + 32 * m] : 0.0f;

  // The tile's periods and the span [lo, hi] of its in-range frames.
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    if (f < nf) {
      tile_period[f] = p_f;
      if (p_f >= 0 && p_f <= max_p && c0 < c1) {
        const int base = (t0 + f) * kHop + x_offset;
        lo = base - kHalfTaps * p_f + c0;
        hi = base + kHalfTaps * p_f + c1 - 1;
      }
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (f == 0) {
      tile_lo = lo;
      tile_hi = hi;
    }
  }
  __syncthreads();

  // Stage row[lo..hi] at span[g - lo_al], lo_al being lo rounded down to
  // a 16-byte address: the aligned body [a0, a1) by one TMA bulk copy, the
  // head [lo, a0) and tail [a1, hi] (under 4 floats each) by plain loads.
  // Nothing outside [lo, hi] is read.
  const int lo = tile_lo, hi = tile_hi;
  int lo_al = 0;
  if (lo <= hi) {
    const int mis = static_cast<int>(
        (reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3);
    lo_al = lo - mis;
    const int a0 = mis ? min(lo_al + 4, hi + 1) : lo;
    const int a1 = max(a0, lo_al + ((hi + 1 - lo_al) & ~3));
    if (threadIdx.x == 0)
      bulk_copy(span + (a0 - lo_al), row + a0, 4u * (a1 - a0), &staged);
    const int g = threadIdx.x < 4 ? lo + threadIdx.x : a1 + threadIdx.x - 4;
    if (threadIdx.x < 4 ? g < a0 : threadIdx.x < 8 && g <= hi)
      span[g - lo_al] = row[g];
    mbar_wait(&staged);
  }
  __syncthreads();

  if (q >= q1) return;
  const float* src = span + (t0 * kHop + x_offset - lo_al + col);
  OutT* dst = out + ((size_t)b * n_frames + t0) * kRow + q * kChunk;
  constexpr int kFull4 = kWindow / kChunk;        // chunks of 4 groups: 7
  constexpr int kTailN = (kWindow % kChunk) / 32; // the last one's: 2
  constexpr int kTailZero = (kRow - kWindow) / 32;
  if (q < kFull4)
    chunk_frames<kSub, 0>(src, dst, kRow, tile_period, nf, max_p, w, win,
                          lane);
  else
    chunk_frames<kTailN, kTailZero>(src, dst, kRow, tile_period, nf, max_p,
                                    w, win, lane);
}

// Launch comb_tile_kernel<OutT, kRow> over [batch, n_frames] on `stream`
// in tiles of tt frames, each split into `parts` column slices of whole
// chunks (fewer where the chunks do not divide evenly); returns a CUDA
// error code (cudaErrorInvalidValue for a tile or split the kernel does
// not take, or more shared memory than a block can have).
template <typename OutT, int kRow>
int launch_tiles(const float* s_pad, const int* period, const float* taps,
                 const float* window, OutT* out, int batch, int n_frames,
                 int n_pad, int x_offset, int tt, int parts, void* stream) {
  if (batch <= 0 || n_frames <= 0) return cudaSuccess;
  if (tt < 1 || tt > kMaxTile || parts < 1 || parts > kRowChunks ||
      batch > 65535 || (n_frames + tt - 1) / tt > 65535)
    return cudaErrorInvalidValue;
  const int max_p = std::max(max_period(n_frames, n_pad, x_offset), 0);
  const int warps = (kRowChunks + parts - 1) / parts;
  const size_t smem = sizeof(float) *
      staged_floats(tt, std::min(warps * kChunk, kWindow), max_p);
  auto kernel = comb_tile_kernel<OutT, kRow>;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem + kStaticSmem > static_cast<size_t>(limit))
    return cudaErrorInvalidValue;
  if (smem + kStaticSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((kRowChunks + warps - 1) / warps, (n_frames + tt - 1) / tt,
                  batch);
  kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      s_pad, period, taps, window, out, n_frames, n_pad, x_offset, max_p, tt);
  return cudaGetLastError();
}

}  // namespace percepnet_comb
