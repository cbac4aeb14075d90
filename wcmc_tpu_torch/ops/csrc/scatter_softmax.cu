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
// What bounds it on the H100: memory.  The logits (338 bytes a pixel in
// bf16 at LBMC's K = 13, 44 MB at the training shape) are the stream; the
// cotangent, the buffer gradient and the band partials are a few MB.
//
// Two bodies; the wrapper (ops/kernel_apply.py::scatter_softmax_plan)
// picks one from the shapes, and a launch runs exactly that one:
//
// * the banded body (scatter_softmax_banded_kernel, then
//   scatter_softmax_band_sum_kernel), K7's banded body (splat_banded.cuh)
//   with the softmax folded in.  A block owns a band of R source rows of one
//   image (and a tile of Wt source columns where a canvas row does not fit),
//   R from the shape and the SM count so the bands fill the card in one
//   wave, two blocks an SM.  Each run of 32 source pixels lands -- the
//   pixels' logits as their 16-byte-aligned supersets (softmax_runs.cuh; the
//   view is strided and its pixels start on any 2-byte boundary), their
//   cotangent values 16 bytes at a time where they start on 16 bytes -- in a
//   ring of 3, up to three runs ahead.  As a step begins, its warps turn its
//   run into probabilities, four pixels a warp at once, each in the first
//   body's order (softmax_stats_kernel: max over the lanes' taps then
//   warp_max, the sum of expf over the lanes' taps in order then warp_sum, P
//   = expf(l - m) * (1 / sum)), into a ring of two f32 stages at a pitch of
//   K*K words (odd, so the tap loop's lanes hit 32 banks); after a barrier
//   the tap loop reads this run and the one before.  So every probability is
//   the first body's bit for bit, the logits are read from device memory
//   once, and there is no statistics launch.  The tap loop, the canvas ring
//   and the band sums are K7's; only dbuf's order of sums differs from the
//   gather body's.
// * the gather body of scatter.cuh, shared with K7, after a launch that
//   writes each source pixel's statistics (max, 1 / sum of exp): each canvas
//   pixel's warp walks its K*K source taps (about 5 scattered loads a tap);
//   for K above 15 (KPCN's 21: 14 taps a lane, and one block an SM at
//   most, run slower banded than gathered) and bands that do not fit; the
//   card tests' reference.
#include "hopper.cuh"
#include "scatter.cuh"
#include "softmax_runs.cuh"
#include "splat_banded.cuh"

namespace wcmc {

constexpr int kSoftmaxStages = 2;     // runs in the probability ring: the two a step reads
constexpr int kSoftmaxLand = 3;       // runs in the landing ring
constexpr int kSoftmaxBandMaxK = 15;  // 8 taps a lane

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

// The banded body's dynamic shared memory, in the order the kernel carves
// it: the probability ring, the value ring, the K canvas rows of Wt + K - 1
// cells, the landing ring's logits and values, its mbarriers.
inline size_t scatter_softmax_banded_smem(int Wt, int C, int K, int es) {
  return smem_bytes((size_t)kSoftmaxStages * kSplatRun * K * K, 4) +
         smem_bytes((size_t)kSoftmaxStages * kSplatRun * C, 4) +
         smem_bytes((size_t)K * (Wt + K - 1) * splat_cs(C), 4) +
         smem_bytes((size_t)kSoftmaxLand * kSplatRun * softmax_lpitch(K * K, es), 1) +
         smem_bytes((size_t)kSoftmaxLand * kSplatRun * C, 4) + smem_bytes(kSoftmaxLand, 8);
}

template <typename TL>
struct SoftmaxBandArgs {
  SplatBandArgs band;  // x: the cotangent g (B, h, w, C); wt and vec unused
  const TL* logits;    // (B, h, w, K*K) view: element strides ls_b, ls_y, ls_x, unit tap stride
  long long ls_b, ls_y, ls_x;
  const unsigned char* l_end;  // one past the view's last byte
};

// kK: K fixed at compile time (LBMC's 13: the tap loop unrolled, 6 taps a
// lane), or 0 for any K <= 15.  Two blocks an SM (108 KB of shared memory
// at LBMC's shape), so at most 128 registers.
template <typename TL, int kC, int kK>
__global__ void __launch_bounds__(kThreads, 2)
    scatter_softmax_banded_kernel(SoftmaxBandArgs<TL> sa) {
  constexpr int es = sizeof(TL), kCs = splat_cs(kC), T = kSplatRun, S = kSoftmaxStages;
  constexpr int SL = kSoftmaxLand, kP = T / kWarps;  // pixels a warp converts at once
  constexpr int kMaxK = kK > 0 ? kK : kSoftmaxBandMaxK, kJ = (kMaxK * kMaxK + 31) / 32;
  const SplatBandArgs& a = sa.band;
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = kK > 0 ? kK : a.K, K2 = K * K, Wc = a.Wt + K - 1;
  const int lpitch = softmax_lpitch(K2, es);
  SmemCarver carve{smem, 0};
  float* s_p = carve.take<float>((size_t)S * T * K2);
  float* s_x = carve.take<float>((size_t)S * T * kC);
  float* s_ring = carve.take<float>((size_t)K * Wc * kCs);
  unsigned char* s_lg = carve.take<unsigned char>((size_t)SL * T * lpitch);
  float* s_lx = carve.take<float>((size_t)SL * T * kC);
  unsigned long long* s_bars = carve.take<unsigned long long>(SL);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what the _smem function sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // block: image b, band i of source rows [y0, y0 + rows), tile j of source
  // columns [x0, x0 + cols); the tile's canvas columns are [x0, x0 + wcj)
  const int j = (int)(blockIdx.x % a.nt);
  const int i = (int)((blockIdx.x / a.nt) % a.nb);
  const int b = (int)(blockIdx.x / ((unsigned)a.nt * a.nb));
  const int y0 = i * a.R, rows = min(a.R, a.h - y0);
  const int x0 = j * a.Wt, cols = min(a.Wt, a.w - x0), wcj = cols + K - 1;
  const int nr = (cols + T - 1) / T, n_runs = rows * nr;
  const unsigned bar0 = smem_addr(s_bars);

  for (int k = tid; k < K * Wc * kCs; k += kThreads) s_ring[k] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < SL; ++s) mbar_init(bar0 + 8 * s, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the first tap of run q's first pixel (source row q / nr of the band,
  // run q % nr of the tile)
  auto run_taps = [&](int q) {
    const int yl = q / nr, r = q - yl * nr;
    return sa.logits + b * sa.ls_b + (y0 + yl) * sa.ls_y + (x0 + r * T) * sa.ls_x;
  };
  const int lstep = (int)((sa.ls_x * es) & 15);  // a pixel's step, in bytes mod 16
  // Run q's n pixels' logits and cotangent values into landing stage q % SL;
  // every thread's cp.asyncs, then its arrival.
  auto fetch = [&](int q) {
    const int yl = q / nr, r = q - yl * nr, s = q % SL;
    const int n = min(T, cols - r * T);
    const long long pix = ((long long)b * a.h + y0 + yl) * a.w + x0 + r * T;
    land_span(s_lx + s * T * kC, a.x + pix * kC, n * kC);
    land_logit_run(s_lg + (size_t)s * T * lpitch, run_taps(q), sa.ls_x, n, K2, lpitch, sa.l_end);
    cp_async_mbar_arrive(bar0 + 8 * s);
  };
  // Landed run q into ring stage q % S: each pixel's probabilities, a warp a
  // pixel in the first body's order, and its values.
  auto convert = [&](int q) {
    const int r = q % nr, s = q % SL, n = min(T, cols - r * T);
    mbar_wait(bar0 + 8 * s, (q / SL) & 1);
    const int lead0 = softmax_lead(run_taps(q));
    float* pr = s_p + (size_t)(q % S) * T * K2;
    // the run's T / kWarps pixels of each warp at once, their chains
    // interleaved; each pixel's sums in the first body's order
    bool ok[kP];
    const TL* lp[kP];
    float v[kP][kJ], m[kP], sum[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int p = warp + i * kWarps;
      ok[i] = p < n;
      lp[i] = reinterpret_cast<const TL*>(s_lg + ((size_t)s * T + p) * lpitch +
                                          ((lead0 + p * lstep) & 15));
      m[i] = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int d = lane + 32 * jj;
        if (ok[i] && d < K2) {
          v[i][jj] = to_f32(lp[i][d]);
          m[i] = fmaxf(m[i], v[i][jj]);
        }
      }
    }
    warp_max_n(m);
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      sum[i] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        if (ok[i] && lane + 32 * jj < K2) {
          v[i][jj] = expf(v[i][jj] - m[i]);
          sum[i] += v[i][jj];
        }
      }
    }
    warp_sum_n(sum);
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if (!ok[i]) continue;
      const float inv = 1.0f / sum[i];
      float* pp = pr + (warp + i * kWarps) * K2;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int d = lane + 32 * jj;
        if (d < K2) pp[d] = v[i][jj] * inv;
      }
    }
    float* xv = s_x + (q % S) * T * kC;
    const float* lx = s_lx + s * T * kC;
    for (int e = tid; e < n * kC; e += kThreads) xv[e] = lx[e];
  };

  int next = 0;
  for (; next < SL && next < n_runs; ++next) fetch(next);
  const int ndy = warp < K ? (K - warp + kWarps - 1) / kWarps : 0;

  for (int yl = 0; yl < rows; ++yl) {
    for (int r = 0; r <= nr; ++r) {
      const int g = yl * nr + r;  // the step's run r; also the next row's run 0 at r = nr
      // run g into stage g % 2, which run g - 2 held; the tap loop of step
      // g - 1 was its last reader
      if (r < nr) convert(g);
      __syncthreads();
      // the landing stages of runs converted so far are free
      for (const int done = r < nr ? g + 1 : g; next < n_runs && next < done + SL; ++next)
        fetch(next);
      splat_step<kC, kK, S>(s_p, s_x, s_ring, K, Wc, cols, wcj, yl, r, g, ndy);
      __syncthreads();
      if (r == nr) {  // canvas row yl has all of the band's sums
        splat_flush<kC>(a, s_ring, K, b, i, j, wcj, yl, true);
        __syncthreads();
      }
    }
  }
  for (int L = rows; L < rows + K - 1; ++L) splat_flush<kC>(a, s_ring, K, b, i, j, wcj, L, false);
}

// dbuf[b, Y, X, :]: the band partials summed in band order, then tile order.
__global__ void __launch_bounds__(kThreads)
    scatter_softmax_band_sum_kernel(SplatBandArgs a, float* __restrict__ out, int C) {
  splat_band_sum(a, out, C);
}

template <typename TL, int kC, int kK>
inline cudaError_t launch_softmax_banded_k(const SoftmaxBandArgs<TL>& a, long long blocks,
                                           int device, cudaStream_t stream) {
  const size_t smem = scatter_softmax_banded_smem(a.band.Wt, kC, a.band.K, sizeof(TL));
  cudaError_t err = set_smem(scatter_softmax_banded_kernel<TL, kC, kK>, smem, device);
  if (err != cudaSuccess) return err;
  scatter_softmax_banded_kernel<TL, kC, kK><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TL, int kC>
inline cudaError_t launch_softmax_banded_c(const SoftmaxBandArgs<TL>& a, long long blocks,
                                           int device, cudaStream_t stream) {
  return a.band.K == 13 ? launch_softmax_banded_k<TL, kC, 13>(a, blocks, device, stream)
                        : launch_softmax_banded_k<TL, kC, 0>(a, blocks, device, stream);
}

template <typename TL>
inline cudaError_t launch_softmax_banded(const SoftmaxBandArgs<TL>& a, int C, long long blocks,
                                         int device, cudaStream_t s) {
  switch (C) {
    case 1: return launch_softmax_banded_c<TL, 1>(a, blocks, device, s);
    case 2: return launch_softmax_banded_c<TL, 2>(a, blocks, device, s);
    case 3: return launch_softmax_banded_c<TL, 3>(a, blocks, device, s);
    case 4: return launch_softmax_banded_c<TL, 4>(a, blocks, device, s);
    case 5: return launch_softmax_banded_c<TL, 5>(a, blocks, device, s);
    case 6: return launch_softmax_banded_c<TL, 6>(a, blocks, device, s);
    case 7: return launch_softmax_banded_c<TL, 7>(a, blocks, device, s);
    default: return launch_softmax_banded_c<TL, 8>(a, blocks, device, s);
  }
}

}  // namespace wcmc

using namespace wcmc;

// g (B, h, w, C) f32 contiguous; logits (B, h, w, K*K) with element
// strides ls_b, ls_y, ls_x and unit tap stride, f32 or bf16
// (logits_bf16 != 0); stats (B, h, w, 2) f32 scratch; dbuf (B, H, W, C)
// f32 contiguous; H = h + K - 1, W = w + K - 1.  The gather body: two
// launches on the stream, the statistics, then the gather.
extern "C" int wcmc_scatter_softmax(const void* g, const void* logits, int logits_bf16,
                                    void* stats, void* dbuf, int B, int h, int w, int C, int K,
                                    long long ls_b, long long ls_y, long long ls_x, int device,
                                    void* stream) {
  if (C < 1 || C > kMaxChannels || K < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const long long n_src = (long long)B * h * w;
  if (n_src == 0) return cudaSuccess;
  const long long blocks_src = (n_src + kWarps - 1) / kWarps;
  if (blocks_src > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
  if (logits_bf16) {
    const bf16* lg = static_cast<const bf16*>(logits);
    softmax_stats_kernel<bf16><<<(unsigned)blocks_src, kThreads, 0, s>>>(lg, st, B, h, w, K * K,
                                                                          ls_b, ls_y, ls_x);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_splat_gather<bf16, true>(static_cast<const float*>(g), lg, st,
                                           static_cast<float*>(dbuf), B, h, w, C, K, ls_b, ls_y,
                                           ls_x, s);
  } else {
    const float* lg = static_cast<const float*>(logits);
    softmax_stats_kernel<float><<<(unsigned)blocks_src, kThreads, 0, s>>>(lg, st, B, h, w, K * K,
                                                                           ls_b, ls_y, ls_x);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_splat_gather<float, true>(static_cast<const float*>(g), lg, st,
                                            static_cast<float*>(dbuf), B, h, w, C, K, ls_b, ls_y,
                                            ls_x, s);
  }
}

// The banded body's dynamic shared memory for tiles of Wt source columns and
// logits of es bytes (what ops/kernel_apply.py's scatter_softmax_plan sums as
// its total).
extern "C" long long wcmc_scatter_softmax_banded_smem(int Wt, int C, int K, int es) {
  return (long long)scatter_softmax_banded_smem(Wt, C, K, es);
}

// The banded body: g (B, h, w, C) f32 contiguous; logits as above, with
// l_span the elements from their first to one past their last (sum over dims
// of (size - 1) x stride, plus one), the strides non-negative; part: B * nb *
// nt * (R + K - 1) * (Wt + K - 1) * C f32 of scratch, nb = ceil(h / R)
// bands of R source rows, nt = ceil(w / Wt) tiles of Wt source columns (a
// multiple of 32); dbuf as above.  K <= 15.  Two launches on the stream: the
// bands, then their sums.
extern "C" int wcmc_scatter_softmax_banded(const void* g, const void* logits, int logits_bf16,
                                           void* part, void* dbuf, int B, int h, int w, int C,
                                           int K, long long ls_b, long long ls_y, long long ls_x,
                                           long long l_span, int R, int Wt, int device,
                                           void* stream) {
  if (C < 1 || C > kMaxChannels || K < 1 || K > kSoftmaxBandMaxK || h < 1 || w < 1 || B < 0 ||
      R < 1 || Wt < kSplatRun || Wt % kSplatRun || ls_b < 0 || ls_y < 0 || ls_x < 0 ||
      l_span < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int nb = (h + R - 1) / R, nt = (w + Wt - 1) / Wt;
  const long long blocks = (long long)B * nb * nt;
  if (blocks == 0) return cudaSuccess;
  if ((long long)B * (h + K - 1) * (w + K - 1) > 0x7fffffffLL) return cudaErrorInvalidValue;
  const SplatBandArgs band{static_cast<const float*>(g), nullptr, static_cast<float*>(part), B,
                           h, w, K, R, Wt, nb, nt, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (logits_bf16) {
    const bf16* lg = static_cast<const bf16*>(logits);
    const SoftmaxBandArgs<bf16> a{band, lg, ls_b, ls_y, ls_x,
                                  reinterpret_cast<const unsigned char*>(lg + l_span)};
    err = launch_softmax_banded(a, C, blocks, device, s);
  } else {
    const float* lg = static_cast<const float*>(logits);
    const SoftmaxBandArgs<float> a{band, lg, ls_b, ls_y, ls_x,
                                   reinterpret_cast<const unsigned char*>(lg + l_span)};
    err = launch_softmax_banded(a, C, blocks, device, s);
  }
  if (err != cudaSuccess) return err;
  const long long cells = (long long)B * (h + K - 1) * (w + K - 1);
  scatter_softmax_band_sum_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0,
                                    s>>>(band, static_cast<float*>(dbuf), C);
  return cudaGetLastError();
}
