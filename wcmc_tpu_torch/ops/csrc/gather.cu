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
// weights once each; the canvas cotangent (22 MB) and the output (17 MB)
// are small beside them.  About 2 flops per weight and channel, far under
// the f32 rate: a pure read stream.
//
// Two bodies; the wrapper (ops/kernel_apply.py::gather_plan) runs the tiled
// one up to K = 21, and the first port's one only when asked (the card
// tests' reference) or above K = 21:
//
// * the tiled body (gather_tiled_kernel), K1's tiled body
//   (gather_softmax.cu) without the softmax.  A run is T = 8 to 32 pixels
//   of one row, so its outputs are one contiguous span of T C floats;
//   persistent blocks take units of R runs down a column in turn.  The
//   window of K buffer rows x (T + K - 1) pixels slides down the unit
//   through a ring of K + 1 row slots, each row kept twice; each run lands
//   one new row and its pixels' weights while the run before computes,
//   under an mbarrier a buffer.  A run whose weights are one contiguous
//   span that starts and ends on 16 bytes (the splat's contiguous f32
//   weights) lands by one 1-D bulk copy issued by one thread; any other
//   (a strided view, a misaligned start) lands pixel by pixel as each
//   pixel's 16-byte-aligned superset by 16-byte cp.asyncs
//   (softmax_runs.cuh), the reader skipping the leading bytes.  Warps take
//   the run's pixels, lanes the taps d = lane + 32 j, exactly as the first
//   body does: every tap's weight and window values loaded first, then a
//   fused multiply-add chain a channel per lane in j order, then warp_sum a
//   channel.  So the two bodies agree bit for bit (the first body's `acc +=
//   p * q` is contracted to the same fused multiply-add by nvcc's default
//   -fmad).  Outputs go to a double-buffered staging tile and leave by
//   16-byte stores (plain ones where the span does not start and end on 16
//   bytes), one block barrier a run.
// * the first port's body, the gather of gather.cuh shared with K1: one
//   warp per output pixel, lanes striding the taps in a loop bounded at run
//   time, each tap's C buffer values through L1.
#include "gather.cuh"
#include "hopper.cuh"
#include "softmax_runs.cuh"

namespace wcmc {

template <typename TL>
struct GatherArgs {
  const float* buf;  // (B, h + K - 1, w + K - 1, C)
  const TL* wt;      // (B, h, w, K*K) view: element strides ws_b, ws_y, ws_x, unit tap stride
  float* out;        // (B, h, w, C) contiguous
  long long ws_b, ws_y, ws_x;
  const unsigned char* w_end;  // one past the view's last byte
  int B, h, w, K, T, R;
};

// kJ: taps a lane, 6 for K <= 13 (three blocks an SM), 14 for K <= 21 (two
// blocks, at most 128 registers).  kK: K fixed at compile time for the path
// forms (13, 21: the tap guards fold), or 0.
template <typename TL, int kC, int kJ, int kK>
__global__ void __launch_bounds__(kThreads, kJ <= 6 ? 3 : 2)
    gather_tiled_kernel(GatherArgs<TL> a) {
  constexpr int es = sizeof(TL);
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = kK > 0 ? kK : a.K, K2 = K * K, T = a.T, H = a.h + K - 1, W = a.w + K - 1;
  const int pitch = softmax_win_pitch(T, kC, K), lpitch = softmax_lpitch(K2, es);
  const int slots = K + 1;  // window ring rows; each row is kept twice, at s and s + K + 1
  SmemCarver carve{smem, 0};
  float* s_win = carve.take<float>((size_t)2 * slots * pitch);
  unsigned char* s_wt = carve.take<unsigned char>((size_t)2 * T * lpitch);
  float* s_out = carve.take<float>(2 * T * kC);
  unsigned long long* s_bars = carve.take<unsigned long long>(2);
  // the carve is what gather_tiled_smem sums
  if (carve.offset != dynamic_smem_size()) __trap();

  // the warp index through a shuffle, which the compiler knows to be the same
  // in every lane (the pixel loop's warp sums then compile as warp-uniform)
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int nr = (a.w + T - 1) / T, nc = (a.h + a.R - 1) / a.R;
  const int n_units = a.B * nc * nr;  // the entry checks B h nr < 2^31
  const unsigned bar0 = smem_addr(s_bars);
  if (tid == 0) {
    // every thread's cp.async arrival, and thread 0's arrival with or
    // without the bytes of a bulk copy
    for (int st = 0; st < 2; ++st) mbar_init(bar0 + 8 * st, kThreads + 1);
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
  auto taps_of = [&](int b, int y, int x) { return a.wt + b * a.ws_b + y * a.ws_y + x * a.ws_x; };
  // a run of n pixels whose weights are one span starting and ending on 16
  // bytes lands by one bulk copy
  auto dense = [&](const TL* first, int n) {
    return a.ws_x == K2 && aligned16(first) && (n * K2 * es) % 16 == 0;
  };
  const int lstep = (int)((a.ws_x * es) & 15);  // a pixel's step, in bytes mod 16

  // Into buffer st (mbarrier st): the weights of run y of the unit at (b,
  // x0), n pixels wide, and buffer rows [r0, r1) of its window (n + K - 1
  // pixels each) into ring slots r % (K + 1) and r % (K + 1) + K + 1; every
  // thread's cp.asyncs, then its arrival, and thread 0's bulk copy or plain
  // arrival.
  auto fetch = [&](int st, int b, int y, int x0, int n, int r0, int r1) {
    const int len = (n + K - 1) * kC;
    for (int row = r0; row < r1; ++row) {
      const float* rs = a.buf + (((long long)b * H + row) * W + x0) * kC;
      float* slot = s_win + (size_t)(row % slots) * pitch;
      land_span(slot, rs, len);
      land_span(slot + (size_t)slots * pitch, rs, len);
    }
    const TL* first = taps_of(b, y, x0);
    unsigned char* dst = s_wt + (size_t)st * T * lpitch;
    const unsigned bar = bar0 + 8 * st;
    const bool bulk = dense(first, n);
    if (!bulk) land_logit_run(dst, first, a.ws_x, n, K2, lpitch, a.w_end);
    cp_async_mbar_arrive(bar);
    if (tid == 0) {
      if (bulk) {
        const unsigned bytes = (unsigned)(n * K2 * es);
        mbar_expect_tx(bar, bytes);
        bulk_copy(smem_addr(dst), first, bytes, bar);
      } else {
        mbar_arrive(bar);
      }
    }
  };

  int k = 0;  // the block's runs so far: run k uses buffer k & 1
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int x0 = u % nr * T, n = min(T, a.w - x0);
    const int y0 = u / nr % nc * a.R, y1 = min(a.h, y0 + a.R);
    const int b = u / (nr * nc);
    // the unit's first window whole (the previous unit's reads ended at the
    // barrier after its last run)
    fetch(k & 1, b, y0, x0, n, y0, y0 + K);
    for (int y = y0; y < y1; ++y, ++k) {
      const int st = k & 1;
      // the next run's weights and its one new row, into the slot of row y -
      // 1, which run y - 1 was the last to read
      if (y + 1 < y1) fetch(st ^ 1, b, y + 1, x0, n, y + K, y + K + 1);
      mbar_wait(bar0 + 8 * st, (k >> 1) & 1);  // this run's weights and rows have landed

      const float* win = s_win + (size_t)(y % slots) * pitch;
      const unsigned char* wl = s_wt + (size_t)st * T * lpitch;
      float* o = s_out + st * T * kC;
      // where pixel p's taps start in the landed run: packed K*K apart after
      // a bulk copy, else in slots of lpitch bytes behind their leading bytes
      const TL* first = taps_of(b, y, x0);
      const bool bulk = dense(first, n);
      const int ppitch = bulk ? K2 * es : lpitch;
      const int lead0 = bulk ? 0 : softmax_lead(first), step = bulk ? 0 : lstep;
      for (int p = warp; p < n; p += kWarps) {
        const TL* lp = reinterpret_cast<const TL*>(wl + p * ppitch + ((lead0 + p * step) & 15));
        const float* wp = win + p * kC;
        float acc[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
        if constexpr (kJ * kC <= 56) {
          // every tap's weight and window values first, so the loads are all
          // in flight before the first chain needs one
          float wv[kJ], q[kJ][kC];
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int d = lane + 32 * j;
            if (d < K2) {
              wv[j] = to_f32(lp[d]);
              load_channels<kC>(wp + woff[j], q[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            if (lane + 32 * j < K2) {
#pragma unroll
              for (int c = 0; c < kC; ++c) acc[c] = __fmaf_rn(wv[j], q[j][c], acc[c]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int d = lane + 32 * j;
            if (d < K2) {
              float q[kC];
              load_channels<kC>(wp + woff[j], q);
              const float wj = to_f32(lp[d]);
#pragma unroll
              for (int c = 0; c < kC; ++c) acc[c] = __fmaf_rn(wj, q[c], acc[c]);
            }
          }
        }
        warp_sum_n<kC>(acc);
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kC; ++c) o[p * kC + c] = acc[c];
        }
      }
      // every warp is done with this run's weights, its window row y and the
      // tile st - 2 runs ago stored; the run's outputs are in the tile
      __syncthreads();
      float* dst = a.out + (((long long)b * a.h + y) * a.w + x0) * kC;
      const int nf = n * kC;
      if (aligned16(dst) && nf % 4 == 0) {
        for (int e = tid; e < nf / 4; e += kThreads)
          reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(o)[e];
      } else {
        for (int e = tid; e < nf; e += kThreads) dst[e] = o[e];
      }
    }
  }
}

template <typename TL, int kC, int kJ, int kK>
inline cudaError_t launch_gather_tiled_k(const GatherArgs<TL>& a, int blocks, int device,
                                         cudaStream_t stream) {
  const size_t smem = gather_tiled_smem(a.T, kC, a.K, sizeof(TL));
  cudaError_t err = set_smem(gather_tiled_kernel<TL, kC, kJ, kK>, smem, device);
  if (err != cudaSuccess) return err;
  gather_tiled_kernel<TL, kC, kJ, kK><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TL, int kC>
inline cudaError_t launch_gather_tiled_c(const GatherArgs<TL>& a, int blocks, int device,
                                         cudaStream_t stream) {
  return a.K * a.K <= 6 * 32 ? launch_gather_tiled_k<TL, kC, 6, 0>(a, blocks, device, stream)
                             : launch_gather_tiled_k<TL, kC, 14, 0>(a, blocks, device, stream);
}

template <typename TL>
inline cudaError_t launch_gather_tiled(const GatherArgs<TL>& a, int C, int blocks, int device,
                                       cudaStream_t s) {
  // the path forms: KPCN's and SBMC's K = 21, LBMC's K = 13, radiance (3
  // channels) or radiance and a ones channel (4)
  if (a.K == 21 && C == 4) return launch_gather_tiled_k<TL, 4, 14, 21>(a, blocks, device, s);
  if (a.K == 21 && C == 3) return launch_gather_tiled_k<TL, 3, 14, 21>(a, blocks, device, s);
  if (a.K == 13 && C == 4) return launch_gather_tiled_k<TL, 4, 6, 13>(a, blocks, device, s);
  if (a.K == 13 && C == 3) return launch_gather_tiled_k<TL, 3, 6, 13>(a, blocks, device, s);
  switch (C) {
    case 1: return launch_gather_tiled_c<TL, 1>(a, blocks, device, s);
    case 2: return launch_gather_tiled_c<TL, 2>(a, blocks, device, s);
    case 3: return launch_gather_tiled_c<TL, 3>(a, blocks, device, s);
    case 4: return launch_gather_tiled_c<TL, 4>(a, blocks, device, s);
    case 5: return launch_gather_tiled_c<TL, 5>(a, blocks, device, s);
    case 6: return launch_gather_tiled_c<TL, 6>(a, blocks, device, s);
    case 7: return launch_gather_tiled_c<TL, 7>(a, blocks, device, s);
    default: return launch_gather_tiled_c<TL, 8>(a, blocks, device, s);
  }
}

}  // namespace wcmc

using namespace wcmc;

// buf (B, H, W, C) f32 contiguous; w (B, h, w, K*K) with element strides
// ws_b, ws_y, ws_x and unit tap stride, f32 or bf16 (w_bf16 != 0); out
// (B, h, w, C) f32 contiguous; h = H - K + 1, w = W - K + 1.  The first
// port's body: one warp per pixel.
extern "C" int wcmc_gather(const void* buf, const void* w, int w_bf16, void* out, int B, int H,
                           int W, int C, int K, long long ws_b, long long ws_y, long long ws_x,
                           int device, void* stream) {
  return launch_gather<false>(buf, w, w_bf16, out, B, H, W, C, K, ws_b, ws_y, ws_x, device,
                              stream);
}

// The tiled body's dynamic shared memory for runs of T pixels and weights of
// es bytes (what ops/kernel_apply.py's gather_plan sums as its total).
extern "C" long long wcmc_gather_tiled_smem(int T, int C, int K, int es) {
  return (long long)gather_tiled_smem(T, C, K, es);
}

// The tiled body, with the first port's contract and K*K <= 448; w_span: the
// elements from the weights' first to one past their last (sum over dims of
// (size - 1) x stride, plus one), the strides non-negative; T: pixels a run
// (a multiple of 8, at most 32); R: runs a unit; n_blocks: the persistent
// blocks to launch at most.
extern "C" int wcmc_gather_tiled(const void* buf, const void* w, int w_bf16, void* out, int B,
                                 int H, int W, int C, int K, long long ws_b, long long ws_y,
                                 long long ws_x, long long w_span, int T, int R, int n_blocks,
                                 int device, void* stream) {
  const int h = H - K + 1, wd = W - K + 1;
  if (C < 1 || C > kMaxChannels || K < 1 || K * K > 32 * 14 || h < 1 || wd < 1 || B < 0 ||
      T < 8 || T > kSoftmaxMaxRun || T % 8 || R < 1 || n_blocks < 1 || ws_b < 0 || ws_y < 0 ||
      ws_x < 0 || w_span < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const long long nr = (wd + T - 1) / T;
  if ((long long)B * h * nr == 0) return cudaSuccess;
  if ((long long)B * h * nr + n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long n_units = (long long)B * ((h + R - 1) / R) * nr;
  const int blocks = (int)(n_units < n_blocks ? n_units : n_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(buf);
  float* op = static_cast<float*>(out);
  if (w_bf16) {
    const bf16* wt = static_cast<const bf16*>(w);
    const GatherArgs<bf16> a{bp, wt, op, ws_b, ws_y, ws_x,
                             reinterpret_cast<const unsigned char*>(wt + w_span), B, h, wd, K, T,
                             R};
    return launch_gather_tiled(a, C, blocks, device, s);
  }
  const float* wt = static_cast<const float*>(w);
  const GatherArgs<float> a{bp, wt, op, ws_b, ws_y, ws_x,
                            reinterpret_cast<const unsigned char*>(wt + w_span), B, h, wd, K, T,
                            R};
  return launch_gather_tiled(a, C, blocks, device, s);
}
