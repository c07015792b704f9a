// Pitch comb filter for Hopper (sm_90a): the windowed 7-tap comb of every
// frame of a batch,
//
//   out[b, t, i] = window[i] * sum_{k=0..6} taps[k] * s_pad[b, t*480 + x_offset - p*(k-3) + i],
//   p = period[b, t], i < 960,
//
// accumulated in f32 in tap order k = 0..6 with the window multiply last.
//
// Replaces the TPU kernel percepnet_tpu/ops/comb.py:_comb_kernel (:69) /
// _comb_pallas (:252).  That kernel stages a tile of frames in VMEM and
// builds each unaligned window from lane rotates and selects; a GPU needs
// neither, since any thread can load any address.
//
// Bound on this card: memory.  The kernel writes B*T*960*4 bytes and at
// best reads s_pad once (B*(T*480 + 5280)*4 bytes), against 3.35 TB/s;
// it does 7 multiply-adds and one multiply per output.  Design: one block
// per (frame, batch row), threads striding over the 960 outputs, so each
// tap's 960 loads are contiguous and coalesce.  The 7 shifted windows of
// a frame and the windows of its neighbours overlap, and L2 serves the
// overlap; every output is stored once, coalesced.  (Staging a tile's
// span in shared memory is the next step if the stores stop dominating.)
//
// The adds and multiplies use the _rn intrinsics so that nvcc does not
// contract them into fused multiply-adds: the kernel then rounds exactly
// as the plain PyTorch version (ops/comb.py:comb_ref) does, bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kHop = 480;
constexpr int kWindow = 960;
constexpr int kTaps = 7;
constexpr int kHalfTaps = 3;
constexpr int kThreads = 320;  // 960 / 320 = 3 outputs per thread

__global__ void __launch_bounds__(kThreads)
comb_windows_kernel(const float* __restrict__ s_pad,
                    const int* __restrict__ period,
                    const float* __restrict__ taps,
                    const float* __restrict__ window,
                    float* __restrict__ out,
                    int n_frames, int n_pad, int x_offset, int max_period) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int p = period[(size_t)b * n_frames + t];
  float* dst = out + ((size_t)b * n_frames + t) * kWindow;
  if (p < 0 || p > max_period) {
    // a period outside the padded signal: NaN, never an out-of-bounds read
    for (int i = threadIdx.x; i < kWindow; i += kThreads)
      dst[i] = __int_as_float(0x7fc00000);
    return;
  }
  const float* src = s_pad + (size_t)b * n_pad + (size_t)t * kHop + x_offset;
  float w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = taps[k];
#pragma unroll
  for (int j = 0; j < kWindow / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      acc = __fadd_rn(acc, __fmul_rn(w[k], src[i - p * (k - kHalfTaps)]));
    dst[i] = __fmul_rn(acc, window[i]);
  }
}

}  // namespace

// s_pad [batch, n_pad] f32, period [batch, n_frames] int32, taps [7] f32,
// window [960] f32, out [batch, n_frames, 960] f32; all contiguous on the
// device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int percepnet_comb_windows_f32(const float* s_pad, const int* period,
                                          const float* taps, const float* window,
                                          float* out, int batch, int n_frames,
                                          int n_pad, int x_offset, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  // largest period whose 7 taps stay inside [0, n_pad) for every frame
  const int room_left = x_offset;
  const int room_right = n_pad - kWindow - (n_frames - 1) * kHop - x_offset;
  const int max_period = (room_left < room_right ? room_left : room_right) / kHalfTaps;
  dim3 grid(n_frames, batch);
  comb_windows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s_pad, period, taps, window, out, n_frames, n_pad, x_offset, max_period);
  return static_cast<int>(cudaGetLastError());
}
