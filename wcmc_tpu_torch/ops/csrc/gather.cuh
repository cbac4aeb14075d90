// The first port's per-pixel gather, the first body of K1 (the softmax
// gather, gather_softmax.cu) and of K9 (the plain weighted gather, gather.cu):
//
//   out[b, y, x, c] = sum_{d < K*K} p(b, y, x, d) * buf[b, y + d / K, x + d % K, c]
//
// with the tap weight p the value w[b, y, x, d] itself (K9) or, with
// kSoftmax, softmax_d(w[b, y, x, :]) (K1).
//
// Design: one warp per output pixel; the weights stay in the layout their
// producer wrote them (channels-last, taps innermost), so the warp's 32
// lanes read consecutive taps, and they may be a strided view (the crop of
// a convolution output) as long as the taps are contiguous.  With
// kSoftmax, three passes over the pixel's logits (max, sum of exp,
// weighted tap sum; the second and third hit L1); without it, one.  Math
// in f32 from bf16 or f32 weights.  Any batch, frame size and odd K is
// legal.  Offsets are 64-bit: at the SBMC shape the weights of one launch
// hold 462 M values, past 2^31 bytes.
#pragma once

#include <math.h>

#include "common.cuh"

namespace wcmc {

template <typename T, bool kSoftmax>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float* __restrict__ buf, const T* __restrict__ wt,
                  float* __restrict__ out, int B, int H, int W, int C, int h, int w, int K,
                  long long ws_b, long long ws_y, long long ws_x) {
  const long long pix = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pix >= (long long)B * h * w) return;  // whole warps exit together
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int b = (int)(pix / ((long long)w * h));
  const T* lp = wt + b * ws_b + y * ws_y + x * ws_x;
  const int K2 = K * K;

  float m = 0.0f, inv = 1.0f;
  if constexpr (kSoftmax) {
    m = -INFINITY;
    for (int d = lane; d < K2; d += 32) m = fmaxf(m, to_f32(lp[d]));
    m = warp_max(m);
    float s = 0.0f;
    for (int d = lane; d < K2; d += 32) s += expf(to_f32(lp[d]) - m);
    inv = 1.0f / warp_sum(s);
  }

  float acc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;
  const float* bp = buf + (((long long)b * H + y) * W + x) * C;
  for (int d = lane; d < K2; d += 32) {
    float p = to_f32(lp[d]);
    if constexpr (kSoftmax) p = expf(p - m) * inv;
    const int dy = d / K, dx = d - dy * K;
    const float* q = bp + ((long long)dy * W + dx) * C;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < C) acc[c] += p * q[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < C) {
      const float v = warp_sum(acc[c]);
      if (lane == 0) out[pix * C + c] = v;
    }
  }
}

// Launch the gather over the B x h x w output pixels, one warp each; buf
// (B, H, W, C) f32 contiguous, wt with element strides ws_b, ws_y, ws_x
// and unit tap stride, f32 or bf16 (wt_bf16 != 0), out (B, h, w, C) f32
// contiguous; h = H - K + 1, w = W - K + 1.
template <bool kSoftmax>
inline cudaError_t launch_gather(const void* buf, const void* wt, int wt_bf16, void* out, int B,
                                 int H, int W, int C, int K, long long ws_b, long long ws_y,
                                 long long ws_x, int device, void* stream) {
  const int h = H - K + 1, w = W - K + 1;
  if (C < 1 || C > kMaxChannels || K < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const long long n_pix = (long long)B * h * w;
  if (n_pix == 0) return cudaSuccess;
  const long long blocks = (n_pix + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wt_bf16) {
    gather_kernel<bf16, kSoftmax><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(buf), static_cast<const bf16*>(wt), static_cast<float*>(out),
        B, H, W, C, h, w, K, ws_b, ws_y, ws_x);
  } else {
    gather_kernel<float, kSoftmax><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(buf), static_cast<const float*>(wt), static_cast<float*>(out),
        B, H, W, C, h, w, K, ws_b, ws_y, ws_x);
  }
  return cudaGetLastError();
}

}  // namespace wcmc
