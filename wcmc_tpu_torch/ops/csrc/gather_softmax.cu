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
// Design: the gather of gather.cuh, shared with K9, with the softmax
// step: one warp per output pixel, lanes on consecutive taps of the
// logits as the convolution wrote them (the TPU kernel's transpose to
// channel-major and its (8, 128) row/lane padding are not needed); three
// passes over the pixel's logits (max, sum of exp, weighted tap sum).
#include "gather.cuh"

using namespace wcmc;

// buf (B, H, W, C) f32 contiguous; logits (B, h, w, K*K) with element
// strides ls_b, ls_y, ls_x and unit tap stride, f32 or bf16
// (logits_bf16 != 0); out (B, h, w, C) f32 contiguous; h = H - K + 1,
// w = W - K + 1.
extern "C" int wcmc_gather_softmax(const void* buf, const void* logits, int logits_bf16, void* out,
                                   int B, int H, int W, int C, int K, long long ls_b, long long ls_y,
                                   long long ls_x, int device, void* stream) {
  return launch_gather<true>(buf, logits, logits_bf16, out, B, H, W, C, K, ls_b, ls_y, ls_x,
                             device, stream);
}

extern "C" const char* wcmc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
