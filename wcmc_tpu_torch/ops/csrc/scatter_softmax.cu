// K3: the buffer's gradient of the per-pixel softmax kernel application.
//
//   dbuf[b, Y, X, c] = sum_{d < K*K} P[b, Y - dy, X - dx, d] * g[b, Y - dy, X - dx, c]
//   P[p, d]          = softmax_d(logits[p, :]),   (dy, dx) = (d / K, d % K)
//
// over the source pixels p = (Y - dy, X - dx) that lie inside the
// (h, w) logits grid.  Replaces wcmc_tpu/ops/pallas_kernels.py::
// scatter_tpu(softmax=True) (Pallas body _scatter_rows_kernel plus the
// y-shift sum in XLA), the buffer half of K1's VJP.
//
// What bounds it on the H100: memory.  The logits (882 bytes per pixel
// in bf16 at K = 21) are read once; the cotangent, the buffer gradient
// and the per-pixel softmax statistics are each under 1 MB at the
// training shape.
//
// Design: gather form, no atomics.  A first launch computes each source
// pixel's softmax statistics (max, 1 / sum of exp) into a (B, h, w, 2)
// f32 scratch, one warp per pixel.  A second launch gives each output
// pixel Y, X a warp whose lanes walk the K*K taps; tap d reads the one
// logit logits[Y - dy, X - dx, d] (so over the whole output every logit
// is read exactly once), its pixel's statistics and cotangent, and the
// lanes' sums are reduced in the warp.  The TPU kernel's split into a
// row pass and a y-shift sum is not needed.  Neighbouring output pixels
// (the warps of one block) read neighbouring taps of the same source
// pixels, so most 32-byte sectors are shared through L1 and L2.
#include <math.h>

#include "common.cuh"

namespace wcmc {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    softmax_stats_kernel(const T* __restrict__ logits, float2* __restrict__ stats, int B, int h,
                         int w, int K2, long long ls_b, long long ls_y, long long ls_x) {
  const long long pix = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pix >= (long long)B * h * w) return;
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int b = (int)(pix / ((long long)w * h));
  const T* lp = logits + b * ls_b + y * ls_y + x * ls_x;
  float m = -INFINITY;
  for (int d = lane; d < K2; d += 32) m = fmaxf(m, to_f32(lp[d]));
  m = warp_max(m);
  float s = 0.0f;
  for (int d = lane; d < K2; d += 32) s += expf(to_f32(lp[d]) - m);
  s = warp_sum(s);
  if (lane == 0) stats[pix] = make_float2(m, 1.0f / s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_softmax_kernel(const float* __restrict__ g, const T* __restrict__ logits,
                           const float2* __restrict__ stats, float* __restrict__ dbuf, int B,
                           int H, int W, int C, int h, int w, int K, long long ls_b,
                           long long ls_y, long long ls_x) {
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
    const int y = Y - dy, x = X - dx;
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const long long p = ((long long)b * h + y) * w + x;
    const float2 st = stats[p];
    const float prob = expf(to_f32(logits[b * ls_b + y * ls_y + x * ls_x + d]) - st.x) * st.y;
    const float* gp = g + p * C;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < C) acc[c] += prob * gp[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < C) {
      const float v = warp_sum(acc[c]);
      if (lane == 0) dbuf[q * C + c] = v;
    }
  }
}

}  // namespace wcmc

using namespace wcmc;

// g (B, h, w, C) f32 contiguous; logits (B, h, w, K*K) with element
// strides ls_b, ls_y, ls_x and unit tap stride, f32 or bf16
// (logits_bf16 != 0); stats (B, h, w, 2) f32 scratch; dbuf (B, H, W, C)
// f32 contiguous; H = h + K - 1, W = w + K - 1.  Two launches on the
// stream: the statistics, then the gather.
extern "C" int wcmc_scatter_softmax(const void* g, const void* logits, int logits_bf16,
                                    void* stats, void* dbuf, int B, int h, int w, int C, int K,
                                    long long ls_b, long long ls_y, long long ls_x, int device,
                                    void* stream) {
  if (C < 1 || C > kMaxChannels || K < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int H = h + K - 1, W = w + K - 1;
  const long long n_src = (long long)B * h * w, n_out = (long long)B * H * W;
  if (n_src == 0) return cudaSuccess;
  const long long blocks_src = (n_src + kWarps - 1) / kWarps;
  const long long blocks_out = (n_out + kWarps - 1) / kWarps;
  if (blocks_out > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
  if (logits_bf16) {
    const bf16* lg = static_cast<const bf16*>(logits);
    softmax_stats_kernel<bf16><<<(unsigned)blocks_src, kThreads, 0, s>>>(lg, st, B, h, w, K * K,
                                                                          ls_b, ls_y, ls_x);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    scatter_softmax_kernel<bf16><<<(unsigned)blocks_out, kThreads, 0, s>>>(
        static_cast<const float*>(g), lg, st, static_cast<float*>(dbuf), B, H, W, C, h, w, K,
        ls_b, ls_y, ls_x);
  } else {
    const float* lg = static_cast<const float*>(logits);
    softmax_stats_kernel<float><<<(unsigned)blocks_src, kThreads, 0, s>>>(lg, st, B, h, w, K * K,
                                                                           ls_b, ls_y, ls_x);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    scatter_softmax_kernel<float><<<(unsigned)blocks_out, kThreads, 0, s>>>(
        static_cast<const float*>(g), lg, st, static_cast<float*>(dbuf), B, H, W, C, h, w, K,
        ls_b, ls_y, ls_x);
  }
  return cudaGetLastError();
}
