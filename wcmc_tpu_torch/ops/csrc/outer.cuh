// The tap-wise outer product, shared by K2 (the softmax gather's logits
// gradient, outer_softmax.cu) and K8 (the splat's weight gradient,
// outer.cu):
//
//   dp[p, d]   = sum_c g[p, c] * buf[p + d, c]                     (f32)
//   out[p, d]  = dp[p, d]                                          (K8)
//   out[p, d]  = P[p, d] * (dp[p, d] - sum_e P[p, e] * dp[p, e])   (K2, kSoftmax)
//   P[p, d]    = softmax_d(logits[p, :])
//
// over the (h, w) pixels p and the K*K taps d = (dy, dx), p + d the
// buffer pixel (y + dy, x + dx).
//
// Design: one warp per output pixel, lanes on consecutive taps, so each
// warp writes 32 consecutive outputs at a time and every output element
// is written exactly once (no atomics).  Each lane keeps its taps' dp (and
// with kSoftmax their probabilities) in registers, at most
// kMaxTapsPerLane (K <= 21), so dp stays f32 until the final rounding to
// the output type: the Pallas kernel stages dp in an f32 scratch for the
// same reason.  With kSoftmax the logits are read once through the
// strided-view contract of K1 (taps contiguous, any pixel strides): pass
// one, max; pass two, sum of exp; pass three, dp and sum_e P_e dp_e; pass
// four, the normalized gradient.  Without it, dp is the output.  Offsets
// are 64-bit: at the SBMC shape K8 writes 462 M f32 values per launch,
// past 2^31 bytes.
#pragma once

#include <math.h>

#include "common.cuh"

namespace wcmc {

constexpr int kMaxTapsPerLane = 14;  // 14 * 32 = 448 >= 21 * 21

template <typename TL, typename TOut, bool kSoftmax>
__global__ void __launch_bounds__(kThreads)
    outer_kernel(const float* __restrict__ g, const float* __restrict__ buf,
                 const TL* __restrict__ logits, TOut* __restrict__ out, int B, int H, int W,
                 int C, int h, int w, int K, long long ls_b, long long ls_y, long long ls_x) {
  const long long pix = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pix >= (long long)B * h * w) return;  // whole warps exit together
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int b = (int)(pix / ((long long)w * h));
  const int K2 = K * K;

  float lv[kMaxTapsPerLane];  // the taps' probabilities (kSoftmax)
  float inv = 1.0f;
  if constexpr (kSoftmax) {
    const TL* lp = logits + b * ls_b + y * ls_y + x * ls_x;
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
    inv = 1.0f / warp_sum(s);
  }

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
      if constexpr (kSoftmax) {
        lv[j] *= inv;  // the probability P_d
        dot += lv[j] * dp[j];
      }
    }
  }
  if constexpr (kSoftmax) dot = warp_sum(dot);

  TOut* op = out + pix * K2;
#pragma unroll
  for (int j = 0; j < kMaxTapsPerLane; ++j) {
    const int d = lane + 32 * j;
    if (d < K2) {
      if constexpr (kSoftmax) {
        store_f32(op + d, lv[j] * (dp[j] - dot));
      } else {
        store_f32(op + d, dp[j]);
      }
    }
  }
}

// Launch over the B x h x w pixels, one warp each: g (B, h, w, C) and buf
// (B, H, W, C) f32 contiguous; logits (kSoftmax only) with element
// strides ls_b, ls_y, ls_x and unit tap stride; out (B, h, w, K*K)
// contiguous; h = H - K + 1, w = W - K + 1; K*K <= 448.
template <typename TL, typename TOut, bool kSoftmax>
inline cudaError_t launch_outer(const float* g, const float* buf, const TL* logits, TOut* out,
                                int B, int H, int W, int C, int K, long long ls_b, long long ls_y,
                                long long ls_x, cudaStream_t stream) {
  const int h = H - K + 1, w = W - K + 1;
  if (C < 1 || C > kMaxChannels || K < 1 || K * K > 32 * kMaxTapsPerLane || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  const long long n_pix = (long long)B * h * w;
  if (n_pix == 0) return cudaSuccess;
  const long long blocks = (n_pix + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  outer_kernel<TL, TOut, kSoftmax><<<(unsigned)blocks, kThreads, 0, stream>>>(
      g, buf, logits, out, B, H, W, C, h, w, K, ls_b, ls_y, ls_x);
  return cudaGetLastError();
}

}  // namespace wcmc
