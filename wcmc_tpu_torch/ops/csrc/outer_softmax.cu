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
// Design: the tap loop of outer.cuh, shared with K8, with the softmax
// step: one warp per output pixel, lanes on consecutive taps, the logits
// read through the same strided-view contract as K1 (so the crop of the
// channels-last convolution output needs no copy), dp and the
// probabilities kept in registers, and the gradient rounded once to the
// logits' dtype.
#include "outer.cuh"

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
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_bf16) {
    return launch_outer<bf16, bf16, true>(
        static_cast<const float*>(g), static_cast<const float*>(buf),
        static_cast<const bf16*>(logits), static_cast<bf16*>(dlogits), B, H, W, C, K, ls_b, ls_y,
        ls_x, s);
  }
  return launch_outer<float, float, true>(
      static_cast<const float*>(g), static_cast<const float*>(buf),
      static_cast<const float*>(logits), static_cast<float*>(dlogits), B, H, W, C, K, ls_b, ls_y,
      ls_x, s);
}
