// K8: the splat's weight gradient, a tap-wise outer product.
//
//   dw[b, y, x, d] = sum_c g[b, y, x, c] * buf[b, y + d / K, x + d % K, c]
//
// Replaces wcmc_tpu/ops/pallas_kernels.py::outer_tpu (Pallas body
// _outer_kernel), which wcmc_tpu/ops/kernel_apply.py runs for d(w) of the
// splat (_scatter_bwd: dw = outer(x, g), x the splatted values and g the
// canvas cotangent) and of the plain weighted gather (_gather_bwd: dw =
// outer(g, buf)).
//
// What bounds it on the H100: memory.  At the SBMC training shape (8
// patches x 8 spp of 128^2 px, K = 21, radiance and a ones channel, C =
// 4) it writes 1.85 GB of f32 weight gradients once each; the values (17
// MB) and the canvas cotangent (22 MB) are read once from memory and then
// from L1/L2.  About 2 flops per output and channel, far under the f32
// rate: a pure write stream.
//
// Design: the tap loop of outer.cuh, shared with K2, without the softmax
// step: one warp per output pixel, lanes on consecutive taps, so each
// warp store covers 128 contiguous bytes, and every dw element is written
// once (no atomics: the step repeats bit for bit).
#include "outer.cuh"

using namespace wcmc;

// g (B, h, w, C) f32 contiguous; buf (B, H, W, C) f32 contiguous; dw
// (B, h, w, K*K) f32 contiguous; h = H - K + 1, w = W - K + 1; K*K <= 448.
extern "C" int wcmc_outer(const void* g, const void* buf, void* dw, int B, int H, int W, int C,
                          int K, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  return launch_outer<float, float, false>(
      static_cast<const float*>(g), static_cast<const float*>(buf), nullptr,
      static_cast<float*>(dw), B, H, W, C, K, 0, 0, 0, static_cast<cudaStream_t>(stream));
}
