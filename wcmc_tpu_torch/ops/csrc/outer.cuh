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
// Design: one warp per output pixel, lanes on the taps d = lane + 32 j, so
// each warp writes 32 consecutive outputs at a time and every output
// element is written exactly once (no atomics).  The taps stream through
// the lanes in passes, O(1) registers a lane whatever K (K <= 129, the
// bound of the reference's forward gather), and dp stays f32 until the
// final rounding to the output type: the Pallas kernel stages dp in an f32
// scratch for the same reason.  A tap's dp is recomputed where a pass needs
// it (C <= 8 fused multiply-adds from zero) rather than kept.  With
// kSoftmax the logits are read through the strided-view contract of K1
// (taps contiguous, any pixel strides): pass one, the max; pass two, the
// sum of exp; pass three, sum_e P_e dp_e; pass four, the normalized
// gradient.  Each lane sums its taps in j order and warp_sum joins the
// lanes, the order of the tiled bodies of K2 and K8 (outer_softmax.cu,
// outer.cu), which agree with this body bit for bit at K <= 21.  Without
// kSoftmax, one pass: dp is the output.  Offsets are 64-bit: at the SBMC
// shape K8 writes 462 M f32 values per launch, past 2^31 bytes.
#pragma once

#include <math.h>

#include "common.cuh"

namespace wcmc {

constexpr int kMaxTapsPerLane = 14;  // the tiled bodies' taps a lane: 14 * 32 = 448 >= 21 * 21
constexpr int kOuterMaxK = 129;      // this body's bound, the reference forward's

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

  float gc[kMaxChannels];
  const float* gp = g + pix * C;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) gc[c] = c < C ? gp[c] : 0.0f;
  const float* bp = buf + (((long long)b * H + y) * W + x) * C;
  // tap d's dp: the f32 chain over c = 0 .. C - 1 from zero
  auto dp_of = [&](int d) {
    const int dy = d / K, dx = d - dy * K;
    const float* q = bp + ((long long)dy * W + dx) * C;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < C) acc = __fmaf_rn(gc[c], q[c], acc);
    }
    return acc;
  };

  TOut* op = out + pix * K2;
  if constexpr (!kSoftmax) {
    for (int d = lane; d < K2; d += 32) store_f32(op + d, dp_of(d));
  } else {
    const TL* lp = logits + b * ls_b + y * ls_y + x * ls_x;
    float m = -INFINITY;
    for (int d = lane; d < K2; d += 32) m = fmaxf(m, to_f32(lp[d]));
    m = warp_max(m);
    float s = 0.0f;
    for (int d = lane; d < K2; d += 32) s += expf(to_f32(lp[d]) - m);
    const float inv = 1.0f / warp_sum(s);
    float dot = 0.0f;
    for (int d = lane; d < K2; d += 32) {
      const float p = expf(to_f32(lp[d]) - m) * inv;  // the probability P_d
      dot += p * dp_of(d);
    }
    dot = warp_sum(dot);
    for (int d = lane; d < K2; d += 32) {
      const float p = expf(to_f32(lp[d]) - m) * inv;
      store_f32(op + d, p * (dp_of(d) - dot));
    }
  }
}

// Launch over the B x h x w pixels, one warp each: g (B, h, w, C) and buf
// (B, H, W, C) f32 contiguous; logits (kSoftmax only) with element
// strides ls_b, ls_y, ls_x and unit tap stride; out (B, h, w, K*K)
// contiguous; h = H - K + 1, w = W - K + 1; K <= 129.
template <typename TL, typename TOut, bool kSoftmax>
inline cudaError_t launch_outer(const float* g, const float* buf, const TL* logits, TOut* out,
                                int B, int H, int W, int C, int K, long long ls_b, long long ls_y,
                                long long ls_x, cudaStream_t stream) {
  const int h = H - K + 1, w = W - K + 1;
  if (C < 1 || C > kMaxChannels || K < 1 || K > kOuterMaxK || h < 1 || w < 1)
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
