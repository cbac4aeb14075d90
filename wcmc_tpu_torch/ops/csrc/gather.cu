// K9: the plain weighted gather.
//
//   out[b, y, x, c] = sum_{d < K*K} w[b, y, x, d] * buf[b, y + d / K, x + d % K, c]
//
// Replaces wcmc_tpu/ops/pallas_kernels.py::gather_tpu(softmax=False)
// (Pallas body _gather_kernel), which wcmc_tpu/ops/kernel_apply.py runs
// for kernel_apply(softmax=False) and for d(x) of the splat
// (_scatter_bwd: dx = gather(g, w)).
//
// What bounds it on the H100: memory.  At the splat's d(x) shape (8
// patches x 8 spp of 128^2 px, K = 21, C = 4) it reads 1.85 GB of f32
// weights once each; the canvas cotangent (22 MB) stays in L2 and is
// re-read through L1 by neighbouring pixels, and the output is 17 MB.
// About 2 flops per weight and channel, far under the f32 rate.
//
// Design: the gather of gather.cuh, shared with K1, without the softmax
// step: one warp per output pixel, lanes on consecutive taps, one pass;
// f32 or bf16 weights through the same strided-view contract as K1.
#include "gather.cuh"

using namespace wcmc;

// buf (B, H, W, C) f32 contiguous; w (B, h, w, K*K) with element strides
// ws_b, ws_y, ws_x and unit tap stride, f32 or bf16 (w_bf16 != 0); out
// (B, h, w, C) f32 contiguous; h = H - K + 1, w = W - K + 1.
extern "C" int wcmc_gather(const void* buf, const void* w, int w_bf16, void* out, int B, int H,
                           int W, int C, int K, long long ws_b, long long ws_y, long long ws_x,
                           int device, void* stream) {
  return launch_gather<false>(buf, w, w_bf16, out, B, H, W, C, K, ws_b, ws_y, ws_x, device,
                              stream);
}
