// K1: per-pixel softmax kernel application (the KPCN 21x21 gather).
//
//   out[b, y, x, c] = sum_{d < K*K} softmax_d(logits[b, y, x, :]) * buf[b, y + d / K, x + d % K, c]
//
// Replaces wcmc_tpu/ops/pallas_kernels.py::gather_tpu(softmax=True)
// (Pallas bodies _gather_kernel and _softmax_stats).
//
// What bounds it on the H100: memory.  Each output pixel reads its K*K
// logits once (882 bytes in bf16 at K=21) and does ~5 flops per logit, so
// the logits tensor dominates the bytes and the kernel is far below the
// card's flop/byte balance.  The radiance buffer (3 channels, under 1 MB
// per 8-tile batch) stays in L2 and is re-read through L1 by neighbouring
// pixels.
//
// Design: one warp per output pixel; the logits stay in the layout the
// convolution wrote them (channels-last, taps innermost), so the warp's
// 32 lanes read consecutive taps; the TPU kernel's transpose to
// channel-major and its (8, 128) row/lane padding are not needed.  Three
// passes over the pixel's logits (max, sum of exp, weighted tap sum); the
// second and third hit L1.  Softmax math is f32 from bf16 or f32 logits.
// Any batch, frame size and odd K is legal; the logits may be a strided
// view (the crop of the convolution output) as long as taps are
// contiguous.
#include <math.h>

#include "common.cuh"

namespace wcmc {

constexpr int kMaxChannels = 8;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_softmax_kernel(const float* __restrict__ buf, const T* __restrict__ logits,
                          float* __restrict__ out, int B, int H, int W, int C, int h, int w, int K,
                          long long ls_b, long long ls_y, long long ls_x) {
  const long long pix = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pix >= (long long)B * h * w) return;  // whole warps exit together
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int b = (int)(pix / ((long long)w * h));
  const T* lp = logits + b * ls_b + y * ls_y + x * ls_x;
  const int K2 = K * K;

  float m = -INFINITY;
  for (int d = lane; d < K2; d += 32) m = fmaxf(m, to_f32(lp[d]));
  m = warp_max(m);
  float s = 0.0f;
  for (int d = lane; d < K2; d += 32) s += expf(to_f32(lp[d]) - m);
  const float inv = 1.0f / warp_sum(s);

  float acc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;
  const float* bp = buf + (((long long)b * H + y) * W + x) * C;
  for (int d = lane; d < K2; d += 32) {
    const float p = expf(to_f32(lp[d]) - m) * inv;
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

}  // namespace wcmc

using namespace wcmc;

// buf (B, H, W, C) f32 contiguous; logits (B, h, w, K*K) with element
// strides ls_b, ls_y, ls_x and unit tap stride, f32 or bf16
// (logits_bf16 != 0); out (B, h, w, C) f32 contiguous; h = H - K + 1,
// w = W - K + 1.
extern "C" int wcmc_gather_softmax(const void* buf, const void* logits, int logits_bf16, void* out,
                                   int B, int H, int W, int C, int K, long long ls_b, long long ls_y,
                                   long long ls_x, int device, void* stream) {
  const int h = H - K + 1, w = W - K + 1;
  if (C < 1 || C > kMaxChannels || K < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const long long n_pix = (long long)B * h * w;
  if (n_pix == 0) return cudaSuccess;
  const long long blocks = (n_pix + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_bf16) {
    gather_softmax_kernel<bf16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(buf), static_cast<const bf16*>(logits), static_cast<float*>(out),
        B, H, W, C, h, w, K, ls_b, ls_y, ls_x);
  } else {
    gather_softmax_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(buf), static_cast<const float*>(logits), static_cast<float*>(out),
        B, H, W, C, h, w, K, ls_b, ls_y, ls_x);
  }
  return cudaGetLastError();
}

extern "C" const char* wcmc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
