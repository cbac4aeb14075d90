// Landing runs of the softmax gather's logits view in shared memory, shared
// by the redesigned bodies of K1 (gather_softmax.cu), K2 (outer_softmax.cu)
// and K3 (scatter_softmax.cu).
//
// The logits reach the kernels as a strided bf16 (or f32) view whose K*K
// taps are contiguous a pixel but whose pixels start on any 2-byte (4-byte)
// boundary: LBMC's layers are slices of a channels-last kernel head (pixel
// stride 676 bytes, layer 1 at 338), KPCN's logits a crop of a
// channels-last convolution output (pixel stride 882 bytes).  No tensor map
// takes such strides, and the view is never copied.  A pixel's taps land as
// their 16-byte-aligned superset, by 16-byte cp.asyncs, in a slot of
// softmax_lpitch bytes; the reader skips the leading bytes
// (softmax_lead).  No copy reads past the view's last byte: the last chunk
// of the last pixel is cut there and zero-filled (cp.async's source size).
#pragma once

#include "hopper.cuh"

namespace wcmc {

// pixels a run of K1's and K2's tiled bodies, at most
constexpr int kSoftmaxMaxRun = 32;

// floats of a staged buffer-window row of K1's and K2's tiled bodies: (T + K -
// 1) pixels of C, padded to 16 bytes
__host__ __device__ inline int softmax_win_pitch(int T, int C, int K) {
  return round_up((T + K - 1) * C, 4);
}

// bytes of a landed pixel slot: its K*K taps of es bytes, led by at most
// 16 - es bytes of their aligned superset, rounded to 16
__host__ __device__ inline int softmax_lpitch(int K2, int es) {
  return round_up(K2 * es + 16 - es, 16);
}

// The dynamic shared memory of K1's and K9's tiled bodies, in the order they
// carve it: the window ring (K + 1 row slots, each twice), two landed runs of
// K*K taps of es bytes a pixel, two staging tiles of a run's outputs, the
// mbarriers.
inline size_t gather_tiled_smem(int T, int C, int K, int es) {
  return smem_bytes((size_t)2 * (K + 1) * softmax_win_pitch(T, C, K), 4) +
         smem_bytes((size_t)2 * T * softmax_lpitch(K * K, es), 1) +
         smem_bytes((size_t)2 * T * C, 4) + smem_bytes(2, 8);
}

// warp_max and warp_sum (common.cuh) of kP values at once, their shuffles
// interleaved: each value gets the same xor butterfly, so the same bits, as
// it would alone
template <int kP>
__device__ inline void warp_max_n(float (&v)[kP]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kP; ++i) v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
}

template <int kP>
__device__ inline void warp_sum_n(float (&v)[kP]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kP; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

// the offset of a pixel's first tap within its 16-byte-aligned superset
__device__ inline int softmax_lead(const void* taps) {
  return (int)(reinterpret_cast<uintptr_t>(taps) & 15u);
}

// n_floats contiguous f32 values from device memory into shared dst (16-byte
// aligned) by all threads of the block: 16-byte cp.asyncs where src starts on
// 16 bytes (the last one cut at the span's end and zero-filled), 4-byte ones
// otherwise.
__device__ inline void land_span(float* dst, const float* src, int n_floats) {
  if (aligned16(src)) {
    const int bytes = 4 * n_floats;
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
    const unsigned d = smem_addr(dst);
    for (int o = 16 * threadIdx.x; o < bytes; o += 16 * kThreads)
      cp_async16_zfill(d + o, s + o, min(16, bytes - o));
  } else {
    for (int e = threadIdx.x; e < n_floats; e += kThreads)
      cp_async4_zfill(smem_addr(dst + e), src + e, 4);
  }
}

// The K*K taps of n pixels, pixel p's starting at taps0 + p * step elements,
// into slots of lpitch bytes at dst, each as its 16-byte-aligned superset;
// l_end: one past the view's last byte.  All threads of the block take part,
// a warp a pixel, its lanes the 16-byte chunks.
template <typename TL>
__device__ inline void land_logit_run(unsigned char* dst, const TL* taps0, long long step, int n,
                                      int K2, int lpitch, const unsigned char* l_end) {
  const int lane = threadIdx.x % 32;
  for (int p = threadIdx.x / 32; p < n; p += kWarps) {
    const unsigned char* taps = reinterpret_cast<const unsigned char*>(taps0 + p * step);
    const unsigned char* first = taps - softmax_lead(taps);
    const unsigned d = smem_addr(dst + p * lpitch);
    // every chunk up to the pixel's last tap holds at least one tap, so at
    // least one byte before l_end
    for (int ch = lane; 16 * ch < taps + K2 * (int)sizeof(TL) - first; ch += 32)
      cp_async16_zfill(d + 16 * ch, first + 16 * ch,
                       (int)min(16LL, (long long)(l_end - (first + 16 * ch))));
  }
}

}  // namespace wcmc
