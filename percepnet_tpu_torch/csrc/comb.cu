// Pitch comb filter for Hopper (sm_90a): the windowed 7-tap comb of every
// frame of a batch,
//
//   out[b, t, i] = window[i] * sum_{k=0..6} taps[k] * s_pad[b, t*480 + x_offset - p*(k-3) + i],
//   p = period[b, t], i < 960,
//
// accumulated in f32 in tap order k = 0..6 with the window multiply last,
// and stored as f32 or, for the bf16 serving tier, rounded once to bf16.
//
// Replaces the TPU kernel percepnet_tpu/ops/comb.py:_comb_kernel (:69) /
// _comb_pallas (:252), both of its stores.  That kernel stages a tile of
// frames in VMEM and builds each unaligned window from lane rotates and
// selects; a GPU needs neither, since any thread can load any address.
// Its bf16 store needs 8-row blocks (Mosaic's packed-store alignment) or
// an f32 store and a cast; here every thread stores its own element in
// either type, so one kernel, templated on the store type, serves both.
//
// Bound on this card: memory.  The kernel writes B*T*960 values (4 or 2
// bytes) and at best reads s_pad once (B*(T*480 + 5280)*4 bytes), against
// 3.35 TB/s; it does 7 multiply-adds and one multiply per output.  Design:
// one block per (frame, batch row), threads striding over the 960
// outputs, so each tap's 960 loads are contiguous and coalesce.  The 7
// shifted windows of a frame and the windows of its neighbours overlap,
// and L2 serves the overlap; every output is stored once, coalesced.
// (Staging a tile's span in shared memory is the next step if the stores
// stop dominating.)  Rounding: comb_common.cuh.

#include "comb_common.cuh"

namespace {

using namespace percepnet_comb;

constexpr int kThreads = 320;  // 960 / 320 = 3 outputs per thread

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
comb_windows_kernel(const float* __restrict__ s_pad,
                    const int* __restrict__ period,
                    const float* __restrict__ taps,
                    const float* __restrict__ window,
                    OutT* __restrict__ out,
                    int n_frames, int n_pad, int x_offset, int max_p) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int p = period[(size_t)b * n_frames + t];
  OutT* dst = out + ((size_t)b * n_frames + t) * kWindow;
  if (p < 0 || p > max_p) {
    for (int i = threadIdx.x; i < kWindow; i += kThreads)
      store(dst + i, nan_value());
    return;
  }
  const float* src = s_pad + (size_t)b * n_pad + (size_t)t * kHop + x_offset;
  float w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = taps[k];
#pragma unroll
  for (int j = 0; j < kWindow / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    store(dst + i, __fmul_rn(tap_sum(src, w, p, i), window[i]));
  }
}

template <typename OutT>
int launch(const float* s_pad, const int* period, const float* taps,
           const float* window, OutT* out, int batch, int n_frames,
           int n_pad, int x_offset, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  dim3 grid(n_frames, batch);
  comb_windows_kernel<OutT>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          s_pad, period, taps, window, out, n_frames, n_pad, x_offset,
          max_period(n_frames, n_pad, x_offset));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s_pad [batch, n_pad] f32, period [batch, n_frames] int32, taps [7] f32,
// window [960] f32, out [batch, n_frames, 960] f32 or bf16; all contiguous
// on the device.  Launch on `stream`; return cudaGetLastError().
extern "C" int percepnet_comb_windows_f32(const float* s_pad, const int* period,
                                          const float* taps, const float* window,
                                          float* out, int batch, int n_frames,
                                          int n_pad, int x_offset, void* stream) {
  return launch(s_pad, period, taps, window, out, batch, n_frames, n_pad,
                x_offset, stream);
}

extern "C" int percepnet_comb_windows_bf16(const float* s_pad, const int* period,
                                           const float* taps, const float* window,
                                           void* out, int batch, int n_frames,
                                           int n_pad, int x_offset, void* stream) {
  return launch(s_pad, period, taps, window, static_cast<__nv_bfloat16*>(out),
                batch, n_frames, n_pad, x_offset, stream);
}
