// K2: the logits' gradient of the per-pixel softmax kernel application.
//
//   dp[p, d]      = sum_c g[p, c] * buf[p + d, c]                  (f32)
//   P[p, d]       = softmax_d(logits[p, :])
//   dlogits[p, d] = P[p, d] * (dp[p, d] - sum_e P[p, e] * dp[p, e])
//
// Replaces wcmc_tpu/ops/pallas_kernels.py::outer_softmax_tpu (Pallas body
// _outer_softmax_kernel), the logits half of K1's VJP.
//
// What bounds it on the H100: memory.  Each pixel reads its K*K logits once
// and writes K*K gradients in the logits' dtype (2 x 338 bytes in bf16 at
// LBMC's K = 13, 2 x 882 at KPCN's K = 21): at the training shapes 73-89 MB
// of a 2-byte stream for about 14 flops a tap.  The radiance buffer and the
// cotangent (3 channels) are under 2 MB and are read from L2.
//
// Two bodies; the wrapper (ops/kernel_apply.py::outer_softmax_plan) runs the
// tiled one, and the first port's one only when asked (the card tests'
// reference):
//
// * the tiled body (outer_softmax_tiled_kernel), K8's tiled body
//   (outer.cu) with the logits in and the softmax step.  A run is T = 8 to
//   32 pixels of one row (the plan picks T so runs tile the row), so its
//   gradients are one contiguous span; persistent blocks take units of R
//   runs down a column in turn (R from the shape and the SM count, so both
//   path shapes fill the card).  The window of K buffer rows x (T + K - 1)
//   pixels slides down the unit through a ring of K + 1 row slots, each row
//   kept twice; each run lands one new row, its cotangent values and its
//   pixels' logits while the run before computes.  The logits are a strided
//   view whose pixels start on any 2-byte boundary (softmax_runs.cuh): each
//   pixel's taps land as their 16-byte-aligned superset by 16-byte
//   cp.asyncs, and the reader skips the leading bytes.  Window rows and
//   values land 16 bytes at a time where they start on 16 bytes (C = 3 at
//   both path shapes), 4 otherwise.  Warps take the run's pixels, lanes the
//   taps d = lane + 32 j, exactly as the first body does: the max per lane
//   then warp_max, the sum of expf per lane in j order then warp_sum, P = e
//   / sum, dp a fused multiply-add chain over c from zero, the dot per lane
//   in j order then warp_sum, one rounding to the logits' dtype.  So the two
//   bodies agree bit for bit.  Gradients go to a double-buffered staging
//   tile and leave by one 1-D bulk copy a run, which runs while the next run
//   computes (where the span starts and ends on 16 bytes: w a multiple of 8
//   in bf16; otherwise every thread stores).
// * the first port's body, the tap loop of outer.cuh shared with K8: one
//   warp per pixel, its logits read through the strided view and each tap's
//   C buffer values through L1 (about 5 scattered loads a tap).
#include "hopper.cuh"
#include "outer.cuh"
#include "softmax_runs.cuh"

namespace wcmc {

constexpr int kSoftmaxMaxRun = 32;

// floats of a staged buffer-window row: (T + K - 1) pixels of C, padded to 16 bytes
__host__ __device__ inline int softmax_win_pitch(int T, int C, int K) {
  return round_up((T + K - 1) * C, 4);
}

// The tiled body's dynamic shared memory, in the order the kernel carves it:
// the window ring (K + 1 row slots, each twice), two value runs, two landed
// logit runs, two staging tiles, the mbarriers.
inline size_t outer_softmax_tiled_smem(int T, int C, int K, int es) {
  return smem_bytes((size_t)2 * (K + 1) * softmax_win_pitch(T, C, K), 4) +
         smem_bytes((size_t)2 * T * C, 4) + smem_bytes((size_t)2 * T * softmax_lpitch(K * K, es), 1) +
         smem_bytes((size_t)2 * T * K * K, es) + smem_bytes(2, 8);
}

template <typename TL>
struct OuterSoftmaxArgs {
  const float* g;    // (B, h, w, C)
  const float* buf;  // (B, h + K - 1, w + K - 1, C)
  const TL* logits;  // (B, h, w, K*K) view: element strides ls_b, ls_y, ls_x, unit tap stride
  TL* out;           // (B, h, w, K*K) contiguous
  long long ls_b, ls_y, ls_x;
  const unsigned char* l_end;  // one past the view's last byte
  int B, h, w, K, T, R;
};

// kJ: taps a lane, 6 for K <= 13 (three blocks an SM: 60 KB of shared
// memory at LBMC's shape, at most 85 registers), 14 for K <= 21 (two blocks:
// 109 KB at KPCN's, at most 128 registers).  kK: K fixed at compile time for
// the path forms (13, 21: the tap guards and window offsets fold), or 0.
template <typename TL, int kC, int kJ, int kK>
__global__ void __launch_bounds__(kThreads, kJ <= 6 ? 3 : 2)
    outer_softmax_tiled_kernel(OuterSoftmaxArgs<TL> a) {
  constexpr int es = sizeof(TL);
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = kK > 0 ? kK : a.K, K2 = K * K, T = a.T, H = a.h + K - 1, W = a.w + K - 1;
  const int pitch = softmax_win_pitch(T, kC, K), lpitch = softmax_lpitch(K2, es);
  const int slots = K + 1;  // window ring rows; each row is kept twice, at s and s + K + 1
  SmemCarver carve{smem, 0};
  float* s_win = carve.take<float>((size_t)2 * slots * pitch);
  float* s_g = carve.take<float>(2 * T * kC);
  unsigned char* s_lg = carve.take<unsigned char>((size_t)2 * T * lpitch);
  TL* s_out = carve.take<TL>((size_t)2 * T * K2);
  unsigned long long* s_bars = carve.take<unsigned long long>(2);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what outer_softmax_tiled_smem sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nr = (a.w + T - 1) / T, nc = (a.h + a.R - 1) / a.R;
  const int n_units = a.B * nc * nr;  // the entry checks B h nr < 2^31
  const unsigned bar0 = smem_addr(s_bars);
  if (tid == 0) {
    for (int st = 0; st < 2; ++st) mbar_init(bar0 + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the lane's taps d = lane + 32 j as offsets into a pixel's window, whose
  // K rows lie one pitch apart from its first row's ring slot
  int woff[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int d = lane + 32 * j, dy = d / K;
    woff[j] = d < K2 ? dy * pitch + (d - dy * K) * kC : 0;
  }
  auto taps_of = [&](int b, int y, int x) {
    return a.logits + b * a.ls_b + y * a.ls_y + x * a.ls_x;
  };
  const int lstep = (int)((a.ls_x * es) & 15);  // a pixel's step, in bytes mod 16

  // Into buffer st (mbarrier st): the values and logits of run y of the
  // unit at (b, x0), n pixels wide, and buffer rows [r0, r1) of its window
  // (n + K - 1 pixels each) into ring slots r % (K + 1) and r % (K + 1) +
  // K + 1; every thread's cp.asyncs, then its arrival.
  auto fetch = [&](int st, int b, int y, int x0, int n, int r0, int r1) {
    const int len = (n + K - 1) * kC;
    for (int row = r0; row < r1; ++row) {
      const float* rs = a.buf + (((long long)b * H + row) * W + x0) * kC;
      float* slot = s_win + (size_t)(row % slots) * pitch;
      land_span(slot, rs, len);
      land_span(slot + (size_t)slots * pitch, rs, len);
    }
    land_span(s_g + st * T * kC, a.g + (((long long)b * a.h + y) * a.w + x0) * kC, n * kC);
    land_logit_run(s_lg + (size_t)st * T * lpitch, taps_of(b, y, x0), a.ls_x, n, K2, lpitch,
                   a.l_end);
    cp_async_mbar_arrive(bar0 + 8 * st);
  };

  int k = 0;  // the block's runs so far: run k uses buffer k & 1
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int x0 = u % nr * T, n = min(T, a.w - x0);
    const int y0 = u / nr % nc * a.R, y1 = min(a.h, y0 + a.R);
    const int b = u / (nr * nc);
    // the unit's first window whole (the previous unit's reads ended at the
    // barrier before its last store)
    fetch(k & 1, b, y0, x0, n, y0, y0 + K);
    for (int y = y0; y < y1; ++y, ++k) {
      const int st = k & 1;
      // the next run's values, logits and its one new row, into the slot of
      // row y - 1, which run y - 1 was the last to read
      if (y + 1 < y1) fetch(st ^ 1, b, y + 1, x0, n, y + K, y + K + 1);
      mbar_wait(bar0 + 8 * st, (k >> 1) & 1);  // this run's values, logits and rows have landed
      if (tid == 0) bulk_wait_read<1>();       // the store of run k - 2 is done with tile st
      __syncthreads();

      const float* win = s_win + (size_t)(y % slots) * pitch;
      const float* gv = s_g + st * T * kC;
      const unsigned char* lg = s_lg + (size_t)st * T * lpitch;
      TL* out = s_out + (size_t)st * T * K2;
      const int lead0 = softmax_lead(taps_of(b, y, x0));
      for (int p = warp; p < n; p += kWarps) {
        // the first body's softmax: max, then sum of exp, lanes on taps
        const TL* lp = reinterpret_cast<const TL*>(lg + p * lpitch + ((lead0 + p * lstep) & 15));
        float lv[kJ];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int d = lane + 32 * j;
          lv[j] = d < K2 ? to_f32(lp[d]) : -INFINITY;
          m = fmaxf(m, lv[j]);
        }
        m = warp_max(m);
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          lv[j] = lane + 32 * j < K2 ? expf(lv[j] - m) : 0.0f;
          s += lv[j];
        }
        const float inv = 1.0f / warp_sum(s);

        float gc[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) gc[c] = gv[p * kC + c];
        const float* wp = win + p * kC;
        float dp[kJ];
        if constexpr (kJ * kC <= 48) {
          // every tap's window values first, so the loads are all in flight
          // before the first chain needs one
          float q[kJ][kC];
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            if (lane + 32 * j < K2) load_channels<kC>(wp + woff[j], q[j]);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            dp[j] = 0.0f;
            if (lane + 32 * j < K2) {
#pragma unroll
              for (int c = 0; c < kC; ++c) dp[j] = __fmaf_rn(gc[c], q[j][c], dp[j]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            dp[j] = 0.0f;
            if (lane + 32 * j < K2) {
              float q[kC];
              load_channels<kC>(wp + woff[j], q);
#pragma unroll
              for (int c = 0; c < kC; ++c) dp[j] = __fmaf_rn(gc[c], q[c], dp[j]);
            }
          }
        }
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (lane + 32 * j < K2) {
            lv[j] *= inv;  // the probability P_d
            dot += lv[j] * dp[j];
          }
        }
        dot = warp_sum(dot);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int d = lane + 32 * j;
          if (d < K2) store_f32(out + p * K2 + d, lv[j] * (dp[j] - dot));
        }
      }
      fence_proxy_async();  // a bulk store reads the tile through the async proxy
      __syncthreads();
      TL* dst = a.out + (((long long)b * a.h + y) * a.w + x0) * K2;
      const unsigned bytes = (unsigned)(n * K2 * es);
      if (aligned16(dst) && bytes % 16 == 0) {
        if (tid == 0) {
          bulk_store(dst, smem_addr(out), bytes);
          bulk_commit();
        }
      } else {
        for (int e = tid; e < n * K2; e += kThreads) dst[e] = out[e];
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
}

template <typename TL, int kC, int kJ, int kK>
inline cudaError_t launch_outer_softmax_tiled_k(const OuterSoftmaxArgs<TL>& a, int blocks,
                                                int device, cudaStream_t stream) {
  const size_t smem = outer_softmax_tiled_smem(a.T, kC, a.K, sizeof(TL));
  cudaError_t err = set_smem(outer_softmax_tiled_kernel<TL, kC, kJ, kK>, smem, device);
  if (err != cudaSuccess) return err;
  outer_softmax_tiled_kernel<TL, kC, kJ, kK><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TL, int kC>
inline cudaError_t launch_outer_softmax_tiled_c(const OuterSoftmaxArgs<TL>& a, int blocks,
                                                int device, cudaStream_t stream) {
  return a.K * a.K <= 6 * 32
             ? launch_outer_softmax_tiled_k<TL, kC, 6, 0>(a, blocks, device, stream)
             : launch_outer_softmax_tiled_k<TL, kC, 14, 0>(a, blocks, device, stream);
}

template <typename TL>
inline cudaError_t launch_outer_softmax_tiled(const OuterSoftmaxArgs<TL>& a, int C, int blocks,
                                              int device, cudaStream_t s) {
  // the path forms, bf16 logits and 3 channels at LBMC's K and KPCN's
  if constexpr (sizeof(TL) == 2) {
    if (C == 3 && a.K == 13) return launch_outer_softmax_tiled_k<TL, 3, 6, 13>(a, blocks, device, s);
    if (C == 3 && a.K == 21) return launch_outer_softmax_tiled_k<TL, 3, 14, 21>(a, blocks, device, s);
  }
  switch (C) {
    case 1: return launch_outer_softmax_tiled_c<TL, 1>(a, blocks, device, s);
    case 2: return launch_outer_softmax_tiled_c<TL, 2>(a, blocks, device, s);
    case 3: return launch_outer_softmax_tiled_c<TL, 3>(a, blocks, device, s);
    case 4: return launch_outer_softmax_tiled_c<TL, 4>(a, blocks, device, s);
    case 5: return launch_outer_softmax_tiled_c<TL, 5>(a, blocks, device, s);
    case 6: return launch_outer_softmax_tiled_c<TL, 6>(a, blocks, device, s);
    case 7: return launch_outer_softmax_tiled_c<TL, 7>(a, blocks, device, s);
    default: return launch_outer_softmax_tiled_c<TL, 8>(a, blocks, device, s);
  }
}

}  // namespace wcmc

using namespace wcmc;

// g (B, h, w, C) f32 contiguous; buf (B, H, W, C) f32 contiguous; logits
// (B, h, w, K*K) with element strides ls_b, ls_y, ls_x and unit tap
// stride, f32 or bf16 (logits_bf16 != 0); dlogits (B, h, w, K*K)
// contiguous, in the logits' dtype; h = H - K + 1, w = W - K + 1; K*K <=
// 448.  The first port's body: one warp per pixel.
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

// The tiled body's dynamic shared memory for runs of T pixels and logits of
// es bytes (what ops/kernel_apply.py's outer_softmax_plan sums as its total).
extern "C" long long wcmc_outer_softmax_tiled_smem(int T, int C, int K, int es) {
  return (long long)outer_softmax_tiled_smem(T, C, K, es);
}

// The tiled body, with the first port's contract; l_span: the elements from
// the logits' first to one past their last (sum over dims of (size - 1) x
// stride, plus one), the strides non-negative; T: pixels a run (a multiple
// of 8, at most 32); R: runs a unit; n_blocks: the persistent blocks to
// launch at most.
extern "C" int wcmc_outer_softmax_tiled(const void* g, const void* buf, const void* logits,
                                        int logits_bf16, void* dlogits, int B, int H, int W,
                                        int C, int K, long long ls_b, long long ls_y,
                                        long long ls_x, long long l_span, int T, int R,
                                        int n_blocks, int device, void* stream) {
  const int h = H - K + 1, w = W - K + 1;
  if (C < 1 || C > kMaxChannels || K < 1 || K * K > 32 * 14 || h < 1 || w < 1 || B < 0 ||
      T < 8 || T > kSoftmaxMaxRun || T % 8 || R < 1 || n_blocks < 1 || ls_b < 0 || ls_y < 0 ||
      ls_x < 0 || l_span < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const long long nr = (w + T - 1) / T;
  if ((long long)B * h * nr == 0) return cudaSuccess;
  if ((long long)B * h * nr + n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long n_units = (long long)B * ((h + R - 1) / R) * nr;
  const int blocks = (int)(n_units < n_blocks ? n_units : n_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(buf);
  if (logits_bf16) {
    const bf16* lg = static_cast<const bf16*>(logits);
    const OuterSoftmaxArgs<bf16> a{gp, bp, lg, static_cast<bf16*>(dlogits), ls_b, ls_y, ls_x,
                                   reinterpret_cast<const unsigned char*>(lg + l_span), B, h, w,
                                   K, T, R};
    return launch_outer_softmax_tiled(a, C, blocks, device, s);
  }
  const float* lg = static_cast<const float*>(logits);
  const OuterSoftmaxArgs<float> a{gp, bp, lg, static_cast<float*>(dlogits), ls_b, ls_y, ls_x,
                                  reinterpret_cast<const unsigned char*>(lg + l_span), B, h, w,
                                  K, T, R};
  return launch_outer_softmax_tiled(a, C, blocks, device, s);
}
