// K7: the SBMC splat.
//
//   out[b, Y, X, c] = sum_{d < K*K} w[b, Y - dy, X - dx, d] * x[b, Y - dy, X - dx, c]
//
// onto the whole (h + K - 1, w + K - 1) canvas (the caller crops its
// centre).  Replaces wcmc_tpu/ops/pallas_kernels.py::scatter_tpu(
// softmax=False) (Pallas body _scatter_rows_kernel plus the y-shift sum
// in XLA), which wcmc_tpu/ops/kernel_apply.py::kernel_scatter runs for
// the splat of wcmc_tpu/ops/splat.py.
//
// What bounds it on the H100: memory.  At the SBMC serving shape (8 tiles
// x 8 spp of 128^2 px, K = 21, radiance and a ones channel, C = 4) it
// reads 1.85 GB of f32 weights, once each; the values and the canvas are
// ~40 MB.  About 2 flops per weight and channel, far under the f32 rate.
//
// Design: the gather form of the splat in scatter.cuh, shared with K3
// (one warp per output pixel walks its K*K source taps; no atomics), on
// plain f32 weights: no softmax statistics launch.
#include "scatter.cuh"

using namespace wcmc;

// x (B, h, w, C) f32 contiguous; wt (B, h, w, K*K) f32 with element
// strides ws_b, ws_y, ws_x and unit tap stride; out (B, h + K - 1,
// w + K - 1, C) f32 contiguous.  One launch on the stream.
extern "C" int wcmc_scatter(const void* x, const void* wt, void* out, int B, int h, int w, int C,
                            int K, long long ws_b, long long ws_y, long long ws_x, int device,
                            void* stream) {
  if (C < 1 || C > kMaxChannels || K < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  return launch_splat_gather<float, false>(
      static_cast<const float*>(x), static_cast<const float*>(wt), nullptr,
      static_cast<float*>(out), B, h, w, C, K, ws_b, ws_y, ws_x,
      static_cast<cudaStream_t>(stream));
}
