// The banded splat's building blocks, shared by K7's banded body
// (scatter.cu: splat_banded_kernel, splat_band_sum_kernel) and K3's
// (scatter_softmax.cu: scatter_softmax_banded_kernel,
// scatter_softmax_band_sum_kernel).
//
// A block owns a band of R source rows of one image (and a tile of Wt
// source columns) and walks its rows' runs of 32 source pixels in order,
// each run's K*K f32 tap weights (K7: as they lie; K3: the probabilities it
// computed) and C values in ring stage run % 3 (K7) or run % 2 (K3).  Step
// (yl, r) covers canvas columns [32 r, 32 r + 32) of the tile from source
// row yl: lane l owns
// column 32 r + l, loads its source value x[X - dx] once per dx and applies
// it to the taps of the warp's dys (dy = warp, warp + 8, ...), keeping their
// sums in registers, then adds them into a ring of K canvas rows in shared
// f32 that only it touches for that column and those rows: sums in a fixed
// order, no atomics.  The lanes read taps K*K words apart (an odd number: 32
// banks).  A canvas row is complete for the band once its source row is
// done and goes to a scratch of band partials; a second launch sums each
// canvas cell's partials in band (and tile) order, so two launches repeat
// bit for bit.
#pragma once

#include "common.cuh"

namespace wcmc {

constexpr int kSplatRun = 32;     // source pixels a landed run: a warp's lanes
constexpr int kSplatStages = 3;   // runs in the ring: the two a step reads, one landing
constexpr int kSplatMaxK = kSplatRun + 1;
constexpr int kSplatMaxDy = (kSplatMaxK + kWarps - 1) / kWarps;  // dys a warp

// channels of a canvas cell in shared memory (padded for 16-byte access)
__host__ __device__ constexpr int splat_cs(int C) { return C <= 4 ? 4 : 8; }

struct SplatBandArgs {
  const float* x;   // (B, h, w, C)
  const float* wt;  // (B, h, w, K*K) (K7)
  float* part;      // (B, nb, nt, R + K - 1, Wt + K - 1, C): the band partials
  int B, h, w, K, R, Wt, nb, nt;
  int vec;  // K7's spans land by bulk copies (w % 4 == 0, x and wt 16-byte aligned)
};

// Step (yl, r) of the band, its run g = yl * nr + r (also the next row's
// run 0 at the tail step r = nr, which reads run nr - 1 alone): the sums of
// canvas column 32 r + lane into the ring rows of the warp's ndy dys.  s_w
// and s_x: the weight and value rings; cols and wcj: the tile's source and
// canvas columns.  kK: K fixed at compile time (the tap loop unrolled, its
// offsets immediates), or 0 for K given at run time; kS: the stages of the
// weight and value rings (run g in stage g % kS).
template <int kC, int kK, int kS = kSplatStages>
__device__ __forceinline__ void splat_step(const float* s_w, const float* s_x, float* s_ring,
                                           int Kr, int Wc, int cols, int wcj, int yl, int r,
                                           int g, int ndy) {
  constexpr int kCs = splat_cs(kC), T = kSplatRun, S = kS;
  constexpr int kMaxDy = kK > 0 ? (kK + kWarps - 1) / kWarps : kSplatMaxDy;
  const int K = kK > 0 ? kK : Kr, K2 = K * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
}

// canvas row L of band i, tile j of image b (ring row L % K) into the band
// partials; with `zero`, each cell cleared by the thread that read it
template <int kC>
__device__ __forceinline__ void splat_flush(const SplatBandArgs& a, float* s_ring, int K, int b,
                                            int i, int j, int wcj, int L, bool zero) {
  constexpr int kCs = splat_cs(kC);
  const int Wc = a.Wt + K - 1;
  float* src = s_ring + (size_t)(L % K) * Wc * kCs;
  float* dst = a.part + ((((size_t)b * a.nb + i) * a.nt + j) * (a.R + K - 1) + L) * Wc * kC;
  for (int k = threadIdx.x; k < wcj * kC; k += kThreads) {
    const int at = (k / kC) * kCs + k % kC;
    dst[k] = src[at];
    if (zero) src[at] = 0.0f;
  }
}

// out[b, Y, X, :]: the sums of the band partials that hold canvas cell
// (Y, X), in band order and, within a band, in tile order; a thread a cell.
__device__ __forceinline__ void splat_band_sum(const SplatBandArgs& a, float* __restrict__ out,
                                               int C) {
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

}  // namespace wcmc
