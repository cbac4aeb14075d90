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
// Two bodies; the wrapper (ops/kernel_apply.py::splat_plan) picks one from
// the shapes and strides, and a launch runs exactly that one:
//
// * the banded body (splat_banded_kernel, then splat_band_sum_kernel), for
//   contiguous weights.  It streams the weights as they lie: a block owns a
//   band of R source rows of one image (and, where a canvas row does not fit
//   in shared memory, a tile of Wt source columns), and lands each row's
//   runs of 32 source pixels -- a contiguous span of 32 x K*K f32 weights
//   and their values -- in a ring of 3 stages, one 1-D bulk copy each
//   (4-byte cp.asyncs where a span does not start on 16 bytes, odd w).
//   Lane l of every warp owns canvas column 32 r + l of the run r it is
//   at; it loads its source value x[X - dx] once per dx and applies it to
//   the taps of the warp's dys (dy = warp, warp + 8, ...), keeping their
//   sums in registers, then adds them into a ring of K canvas rows in
//   shared f32 that only it touches for that column and those rows: sums
//   in a fixed order, no atomics.  The lanes read taps 441 words apart (an
//   odd number: 32 banks).  A canvas row is complete for the band once its
//   source row is done, and goes to a scratch of band partials; the second
//   launch sums each canvas cell's 1-3 partials in band (and tile) order,
//   so two launches repeat bit for bit.  Offsets are 64-bit: a launch's
//   weights pass 2^31 bytes.
// * the gather body of scatter.cuh, shared with K3 (one warp per canvas
//   pixel walks its K*K source taps), for strided weight views and for
//   what the banded body does not take (K > 33, or no band that fits in
//   shared memory); the card tests' reference.
#include "hopper.cuh"
#include "scatter.cuh"

namespace wcmc {

constexpr int kSplatRun = 32;     // source pixels a landed run: a warp's lanes
constexpr int kSplatStages = 3;   // runs in the ring: the two a step reads, one landing
constexpr int kSplatMaxK = kSplatRun + 1;
constexpr int kSplatMaxDy = (kSplatMaxK + kWarps - 1) / kWarps;  // dys a warp

// channels of a canvas cell in shared memory (padded for 16-byte access)
__host__ __device__ constexpr int splat_cs(int C) { return C <= 4 ? 4 : 8; }

// The banded body's dynamic shared memory, in the order the kernel carves
// it: the weight ring, the value ring, the K canvas rows of Wt + K - 1
// cells, the ring's mbarriers.
inline size_t splat_banded_smem(int Wt, int C, int K) {
  return smem_bytes((size_t)kSplatStages * kSplatRun * K * K, 4) +
         smem_bytes((size_t)kSplatStages * kSplatRun * C, 4) +
         smem_bytes((size_t)K * (Wt + K - 1) * splat_cs(C), 4) + smem_bytes(kSplatStages, 8);
}

struct SplatBandArgs {
  const float* x;   // (B, h, w, C)
  const float* wt;  // (B, h, w, K*K)
  float* part;      // (B, nb, nt, R + K - 1, Wt + K - 1, C): the band partials
  int B, h, w, K, R, Wt, nb, nt;
  int vec;  // spans land by bulk copies (w % 4 == 0, x and wt 16-byte aligned)
};

// kK: K fixed at compile time (the SBMC splat's 21: the tap loop unrolled,
// its offsets immediates), or 0 for any K <= 33.
template <int kC, int kK>
__global__ void __launch_bounds__(kThreads, 1) splat_banded_kernel(SplatBandArgs a) {
  constexpr int kCs = splat_cs(kC), T = kSplatRun, S = kSplatStages;
  constexpr int kMaxDy = kK > 0 ? (kK + kWarps - 1) / kWarps : kSplatMaxDy;
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = kK > 0 ? kK : a.K, K2 = K * K, Wc = a.Wt + K - 1;
  SmemCarver carve{smem, 0};
  float* s_w = carve.take<float>((size_t)S * T * K2);
  float* s_x = carve.take<float>((size_t)S * T * kC);
  float* s_ring = carve.take<float>((size_t)K * Wc * kCs);
  unsigned long long* s_bars = carve.take<unsigned long long>(S);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what splat_banded_smem sums

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
    for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s, a.vec ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Run g (source row g / nr of the band, run g % nr of the tile) into
  // ring stage g % S: its n pixels' weights and values as they lie.
  auto fetch = [&](int g) {
    const int yl = g / nr, r = g - yl * nr, s = g % S;
    const int n = min(T, cols - r * T);
    const long long pix = ((long long)b * a.h + y0 + yl) * a.w + x0 + r * T;
    const float* wsrc = a.wt + pix * K2;
    const float* xsrc = a.x + pix * kC;
    float* wdst = s_w + (size_t)s * T * K2;
    float* xdst = s_x + s * T * kC;
    const unsigned bar = bar0 + 8 * s;
    if (a.vec) {
      if (tid == 0) {
        const unsigned wb = 4u * n * K2, xb = 4u * n * kC;
        mbar_expect_tx(bar, wb + xb);
        bulk_copy(smem_addr(wdst), wsrc, wb, bar);
        bulk_copy(smem_addr(xdst), xsrc, xb, bar);
      }
    } else {
      for (int k = tid; k < n * K2; k += kThreads)
        cp_async4_zfill(smem_addr(wdst + k), wsrc + k, 4);
      for (int k = tid; k < n * kC; k += kThreads)
        cp_async4_zfill(smem_addr(xdst + k), xsrc + k, 4);
      cp_async_mbar_arrive(bar);
    }
  };
  // canvas row L of the band (ring row L % K) into the band partials; with
  // `zero`, each cell cleared by the thread that read it
  auto flush = [&](int L, bool zero) {
    float* src = s_ring + (size_t)(L % K) * Wc * kCs;
    float* dst = a.part + ((((size_t)b * a.nb + i) * a.nt + j) * (a.R + K - 1) + L) * Wc * kC;
    for (int k = tid; k < wcj * kC; k += kThreads) {
      const int at = (k / kC) * kCs + k % kC;
      dst[k] = src[at];
      if (zero) src[at] = 0.0f;
    }
  };

  int next = 0;
  for (; next < S && next < n_runs; ++next) fetch(next);
  const int ndy = warp < K ? (K - warp + kWarps - 1) / kWarps : 0;

  // Step (yl, r): canvas columns [32 r, 32 r + 32) of the tile from source
  // row yl; their sources are runs r - 1 and r (the tail step r = nr reads
  // run nr - 1 alone).
  for (int yl = 0; yl < rows; ++yl) {
    for (int r = 0; r <= nr; ++r) {
      const int g = yl * nr + r;  // the step's run r; also the next row's run 0 at r = nr
      if (r < nr) mbar_wait(bar0 + 8 * (g % S), (g / S) & 1);
      const int s_cur = g % S, s_prev = (g + S - 1) % S;
      const int col = r * T + lane;
      float acc[kMaxDy][kC];
#pragma unroll
      for (int q = 0; q < kMaxDy; ++q)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[q][c] = 0.0f;
      if (ndy > 0) {
        // tap dx reads source column col - dx: pixel lane - dx of run r, or
        // (dx > lane) pixel lane - dx + 32 of run r - 1
        const float* wq = s_w + ((size_t)s_cur * T + lane) * K2 + warp * K;
        const float* xq = s_x + (s_cur * T + lane) * kC;
        const int w_back = (s_prev - s_cur + 1) * T * K2, x_back = (s_prev - s_cur + 1) * T * kC;
        auto tap = [&](int dx) {
          if ((unsigned)(col - dx) >= (unsigned)cols) return;
          const bool back = dx > lane;
          const float* wp = wq - dx * (K2 - 1) + (back ? w_back : 0);
          float xv[kC];
          load_channels<kC>(xq - dx * kC + (back ? x_back : 0), xv);
#pragma unroll
          for (int q = 0; q < kMaxDy; ++q) {
            if (q < ndy) {
              const float wv = wp[q * kWarps * K];
#pragma unroll
              for (int c = 0; c < kC; ++c) acc[q][c] = fmaf(wv, xv[c], acc[q][c]);
            }
          }
        };
        if constexpr (kK > 0) {
#pragma unroll
          for (int dx = 0; dx < kK; ++dx) tap(dx);
        } else {
          for (int dx = 0; dx < K; ++dx) tap(dx);
        }
        if (col < wcj) {
#pragma unroll
          for (int q = 0; q < kMaxDy; ++q) {
            if (q < ndy) {
              float4* cell = reinterpret_cast<float4*>(
                  s_ring + ((size_t)((yl + warp + q * kWarps) % K) * Wc + col) * kCs);
#pragma unroll
              for (int v = 0; v < kCs / 4; ++v) {
                float4 t = cell[v];
                if (4 * v < kC) t.x += acc[q][4 * v];
                if (4 * v + 1 < kC) t.y += acc[q][4 * v + 1];
                if (4 * v + 2 < kC) t.z += acc[q][4 * v + 2];
                if (4 * v + 3 < kC) t.w += acc[q][4 * v + 3];
                cell[v] = t;
              }
            }
          }
        }
      }
      __syncthreads();
      // the next step reads run g first (and g + 1): stages of older runs
      // are free
      for (; next < n_runs && next < g + S; ++next) fetch(next);
      if (r == nr) {  // canvas row yl has all of the band's sums
        flush(yl, true);
        __syncthreads();
      }
    }
  }
  for (int L = rows; L < rows + K - 1; ++L) flush(L, false);
}

// out[b, Y, X, :]: the sums of the band partials that hold canvas cell
// (Y, X), in band order and, within a band, in tile order; a thread a cell.
__global__ void __launch_bounds__(kThreads)
    splat_band_sum_kernel(SplatBandArgs a, float* __restrict__ out, int C) {
  const int K = a.K, H = a.h + K - 1, W = a.w + K - 1, Wc = a.Wt + K - 1, Rr = a.R + K - 1;
  const int at = blockIdx.x * kThreads + threadIdx.x;  // the entry checks B H W < 2^31
  if (at >= a.B * H * W) return;
  const int X = at % W, Y = at / W % H, b = at / (W * H);
  const int i_lo = Y >= Rr ? (Y - Rr) / a.R + 1 : 0, i_hi = min(a.nb - 1, Y / a.R);
  const int j_lo = X >= Wc ? (X - Wc) / a.Wt + 1 : 0, j_hi = min(a.nt - 1, X / a.Wt);
  float v[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) v[c] = 0.0f;
  for (int i = i_lo; i <= i_hi; ++i) {
    const int L = Y - i * a.R;
    if (L >= min(a.R, a.h - i * a.R) + K - 1) continue;
    for (int j = j_lo; j <= j_hi; ++j) {
      const int lc = X - j * a.Wt;
      if (lc >= min(a.Wt, a.w - j * a.Wt) + K - 1) continue;
      const float* p = a.part + ((((size_t)b * a.nb + i) * a.nt + j) * Rr + L) * Wc * C +
                       (size_t)lc * C;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < C) v[c] += p[c];
    }
  }
  float* o = out + (size_t)at * C;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    if (c < C) o[c] = v[c];
}

template <int kC, int kK>
inline cudaError_t launch_banded_k(const SplatBandArgs& a, long long blocks, int device,
                                   cudaStream_t stream) {
  const size_t smem = splat_banded_smem(a.Wt, kC, a.K);
  cudaError_t err = set_smem(splat_banded_kernel<kC, kK>, smem, device);
  if (err != cudaSuccess) return err;
  splat_banded_kernel<kC, kK><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kC>
inline cudaError_t launch_banded(const SplatBandArgs& a, long long blocks, int device,
                                 cudaStream_t stream) {
  return a.K == 21 ? launch_banded_k<kC, 21>(a, blocks, device, stream)
                   : launch_banded_k<kC, 0>(a, blocks, device, stream);
}

}  // namespace wcmc

using namespace wcmc;

// x (B, h, w, C) f32 contiguous; wt (B, h, w, K*K) f32 with element
// strides ws_b, ws_y, ws_x and unit tap stride; out (B, h + K - 1,
// w + K - 1, C) f32 contiguous.  The gather body: one launch on the stream.
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

// The banded body's dynamic shared memory for tiles of Wt source columns
// (what ops/kernel_apply.py's splat_plan sums as its total).
extern "C" long long wcmc_scatter_banded_smem(int Wt, int C, int K) {
  return (long long)splat_banded_smem(Wt, C, K);
}

// The banded body: x (B, h, w, C) and wt (B, h, w, K*K) f32 contiguous;
// part: B * nb * nt * (R + K - 1) * (Wt + K - 1) * C f32 of scratch, nb =
// ceil(h / R) bands of R source rows, nt = ceil(w / Wt) tiles of Wt source
// columns (a multiple of 32); out (B, h + K - 1, w + K - 1, C) f32
// contiguous.  K <= 33.  Two launches on the stream: the bands, then their
// sums.
extern "C" int wcmc_scatter_banded(const void* x, const void* wt, void* part, void* out, int B,
                                   int h, int w, int C, int K, int R, int Wt, int device,
                                   void* stream) {
  if (C < 1 || C > kMaxChannels || K < 1 || K > kSplatMaxK || h < 1 || w < 1 || B < 0 ||
      R < 1 || Wt < kSplatRun || Wt % kSplatRun)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int nb = (h + R - 1) / R, nt = (w + Wt - 1) / Wt;
  const long long blocks = (long long)B * nb * nt;
  if (blocks == 0) return cudaSuccess;
  if ((long long)B * (h + K - 1) * (w + K - 1) > 0x7fffffffLL) return cudaErrorInvalidValue;
  const SplatBandArgs a{static_cast<const float*>(x), static_cast<const float*>(wt),
                        static_cast<float*>(part), B, h, w, K, R, Wt, nb, nt,
                        w % 4 == 0 && aligned16(x) && aligned16(wt)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 1: err = launch_banded<1>(a, blocks, device, s); break;
    case 2: err = launch_banded<2>(a, blocks, device, s); break;
    case 3: err = launch_banded<3>(a, blocks, device, s); break;
    case 4: err = launch_banded<4>(a, blocks, device, s); break;
    case 5: err = launch_banded<5>(a, blocks, device, s); break;
    case 6: err = launch_banded<6>(a, blocks, device, s); break;
    case 7: err = launch_banded<7>(a, blocks, device, s); break;
    default: err = launch_banded<8>(a, blocks, device, s); break;
  }
  if (err != cudaSuccess) return err;
  const long long cells = (long long)B * (h + K - 1) * (w + K - 1);
  splat_band_sum_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      a, static_cast<float*>(out), C);
  return cudaGetLastError();
}
