// K2: the logits' gradient of the per-pixel softmax kernel application.
//
//   dp[p, d]      = sum_c g[p, c] * buf[p + d, c]                  (f32)
//   P[p, d]       = softmax_d(logits[p, :])
//   dlogits[p, d] = P[p, d] * (dp[p, d] - sum_e P[p, e] * dp[p, e])
//
// Replaces wcmc_tpu/ops/pallas_kernels.py::outer_softmax_tpu (Pallas body
// _outer_softmax_kernel), the logits half of K1's VJP.
//
// What bounds it on the H100: memory.  Each output pixel reads its K*K
// logits once and writes K*K gradients in the logits' dtype (2 x 882
// bytes in bf16 at K = 21) for ~10 flops per tap; the radiance buffer and
// the cotangent (3 channels) stay in L2 and are re-read through L1 by
// neighbouring pixels.
//
// Design: one warp per output pixel, lanes on consecutive taps, the
// logits read through the same strided-view contract as K1 (taps
// contiguous, any pixel strides), so the crop of the channels-last
// convolution output needs no copy.  Each lane keeps its taps' logits
// and dp in registers (at most kMaxTapsPerLane, i.e. K <= 21), so the
// logits are read from memory once and dp stays f32 until the final
// rounding: the Pallas kernel stages dp in an f32 scratch for the same
// reason.  Pass one: max; pass two: sum of exp; pass three: dp and
// sum_e P_e dp_e; pass four: the normalized gradient, rounded once.
#include <math.h>

#include "common.cuh"

namespace wcmc {

constexpr int kMaxTapsPerLane = 14;  // 14 * 32 = 448 >= 21 * 21

template <typename T>
__global__ void __launch_bounds__(kThreads)
    outer_softmax_kernel(const float* __restrict__ g, const float* __restrict__ buf,
                         const T* __restrict__ logits, T* __restrict__ dlogits, int B, int H,
                         int W, int C, int h, int w, int K, long long ls_b, long long ls_y,
                         long long ls_x) {
  const long long pix = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pix >= (long long)B * h * w) return;  // whole warps exit together
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int b = (int)(pix / ((long long)w * h));
  const T* lp = logits + b * ls_b + y * ls_y + x * ls_x;
  const int K2 = K * K;

  float lv[kMaxTapsPerLane];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxTapsPerLane; ++j) {
    const int d = lane + 32 * j;
    lv[j] = d < K2 ? to_f32(lp[d]) : -INFINITY;
    m = fmaxf(m, lv[j]);
  }
  m = warp_max(m);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxTapsPerLane; ++j) {
    lv[j] = lane + 32 * j < K2 ? expf(lv[j] - m) : 0.0f;
    s += lv[j];
  }
  const float inv = 1.0f / warp_sum(s);

  float gc[kMaxChannels];
  const float* gp = g + pix * C;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) gc[c] = c < C ? gp[c] : 0.0f;

  const float* bp = buf + (((long long)b * H + y) * W + x) * C;
  float dp[kMaxTapsPerLane];
  float dot = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxTapsPerLane; ++j) {
    const int d = lane + 32 * j;
    dp[j] = 0.0f;
    if (d < K2) {
      const int dy = d / K, dx = d - dy * K;
      const float* q = bp + ((long long)dy * W + dx) * C;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) dp[j] += gc[c] * q[c];
      }
      lv[j] *= inv;  // the probability P_d
      dot += lv[j] * dp[j];
    }
  }
  dot = warp_sum(dot);

  T* op = dlogits + pix * K2;
#pragma unroll
  for (int j = 0; j < kMaxTapsPerLane; ++j) {
    const int d = lane + 32 * j;
    if (d < K2) store_f32(op + d, lv[j] * (dp[j] - dot));
  }
}

}  // namespace wcmc

using namespace wcmc;

// g (B, h, w, C) f32 contiguous; buf (B, H, W, C) f32 contiguous; logits
// (B, h, w, K*K) with element strides ls_b, ls_y, ls_x and unit tap
// stride, f32 or bf16 (logits_bf16 != 0); dlogits (B, h, w, K*K)
// contiguous, in the logits' dtype; h = H - K + 1, w = W - K + 1; K*K <=
// 448.
extern "C" int wcmc_outer_softmax(const void* g, const void* buf, const void* logits,
                                  int logits_bf16, void* dlogits, int B, int H, int W, int C,
                                  int K, long long ls_b, long long ls_y, long long ls_x,
                                  int device, void* stream) {
  const int h = H - K + 1, w = W - K + 1;
  if (C < 1 || C > kMaxChannels || K < 1 || K * K > 32 * kMaxTapsPerLane || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const long long n_pix = (long long)B * h * w;
  if (n_pix == 0) return cudaSuccess;
  const long long blocks = (n_pix + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_bf16) {
    outer_softmax_kernel<bf16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(buf),
        static_cast<const bf16*>(logits), static_cast<bf16*>(dlogits), B, H, W, C, h, w, K, ls_b,
        ls_y, ls_x);
  } else {
    outer_softmax_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(buf),
        static_cast<const float*>(logits), static_cast<float*>(dlogits), B, H, W, C, h, w, K, ls_b,
        ls_y, ls_x);
  }
  return cudaGetLastError();
}
