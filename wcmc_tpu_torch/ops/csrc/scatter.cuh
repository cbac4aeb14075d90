// The splat in gather form, shared by K3 (the softmax gather's buffer
// gradient, scatter_softmax.cu) and K7 (the SBMC splat, scatter.cu):
//
//   out[b, Y, X, c] = sum_{d < K*K} wt(b, Y - dy, X - dx, d) * x[b, Y - dy, X - dx, c]
//
// over the source pixels p = (Y - dy, X - dx) inside the (h, w) source
// grid, (dy, dx) = (d / K, d % K), onto the (h + K - 1, w + K - 1)
// canvas.  The tap weight wt is the value w[p, d] itself (K7) or, with
// kSoftmax, softmax_d(w[p, :]) from the per-source statistics (max,
// 1 / sum of exp) that K3's first launch writes.
//
// Design: no atomics.  Each output pixel gets a warp whose lanes walk the
// K*K taps; tap d reads the one weight w[Y - dy, X - dx, d] (so over the
// whole canvas every weight is read exactly once) and its source's
// values, and the lanes' sums are reduced in the warp.  Neighbouring
// output pixels (the warps of one block) read neighbouring taps of the
// same source pixels, so most 32-byte sectors are shared through L1 and
// L2.  Offsets are 64-bit: at the SBMC shape the weight tensor holds 462 M
// f32 values per batch, past 2^31 bytes.
#pragma once

#include <math.h>

#include "common.cuh"

namespace wcmc {

template <typename T, bool kSoftmax>
__global__ void __launch_bounds__(kThreads)
    splat_gather_kernel(const float* __restrict__ x, const T* __restrict__ wt,
                        const float2* __restrict__ stats, float* __restrict__ out, int B, int H,
                        int W, int C, int h, int w, int K, long long ws_b, long long ws_y,
                        long long ws_x) {
  const long long q = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= (long long)B * H * W) return;
  const int X = (int)(q % W);
  const int Y = (int)((q / W) % H);
  const int b = (int)(q / ((long long)W * H));
  const int K2 = K * K;

  float acc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;
  for (int d = lane; d < K2; d += 32) {
    const int dy = d / K, dx = d - dy * K;
    const int y = Y - dy, xs = X - dx;
    if (y < 0 || y >= h || xs < 0 || xs >= w) continue;
    const long long p = ((long long)b * h + y) * w + xs;
    float weight = to_f32(wt[b * ws_b + y * ws_y + xs * ws_x + d]);
    if constexpr (kSoftmax) {
      const float2 st = stats[p];
      weight = expf(weight - st.x) * st.y;
    }
    const float* xp = x + p * C;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < C) acc[c] += weight * xp[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < C) {
      const float v = warp_sum(acc[c]);
      if (lane == 0) out[q * C + c] = v;
    }
  }
}

// Launch the splat over the whole canvas of B x (h + K - 1) x (w + K - 1)
// output pixels, one warp each; x (B, h, w, C) f32 contiguous, wt with
// element strides ws_b, ws_y, ws_x and unit tap stride, out contiguous.
template <typename T, bool kSoftmax>
inline cudaError_t launch_splat_gather(const float* x, const T* wt, const float2* stats,
                                       float* out, int B, int h, int w, int C, int K,
                                       long long ws_b, long long ws_y, long long ws_x,
                                       cudaStream_t stream) {
  const int H = h + K - 1, W = w + K - 1;
  const long long n_out = (long long)B * H * W;
  if (n_out == 0) return cudaSuccess;
  const long long blocks = (n_out + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  splat_gather_kernel<T, kSoftmax><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, wt, stats, out, B, H, W, C, h, w, K, ws_b, ws_y, ws_x);
  return cudaGetLastError();
}

}  // namespace wcmc
