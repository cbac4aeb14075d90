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
// Two bodies; the wrapper (ops/kernel_apply.py::outer_plan) runs the tiled
// one up to K = 21 and the first port's one above (up to the reference's K =
// 129), or at any K when asked (the card tests' reference):
//
// * the tiled body (outer_tiled_kernel).  Its run is 32 source pixels of one
//   row, so a run's dw is one contiguous span of 32 x K*K f32.  Persistent
//   blocks take units of 32 runs down a column in turn.  A run reads a
//   window of K canvas-cotangent rows x (32 + K - 1) pixels x C; the window
//   slides down the unit in a ring of K + 1 row slots, so each run lands
//   one new row (and its values) while the run before computes: one bulk
//   copy each, issued by one thread (4-byte cp.asyncs by all threads where a
//   row does not start on 16 bytes: C not a multiple of 4).  Each row is
//   kept twice, at slot s and s + K + 1, so a run's K rows are always
//   consecutive slots.
//   Warps take the run's pixels, lanes the taps, and each output is written
//   into a double-buffered staging tile of the run's span in shared memory;
//   one thread stores the tile with a 1-D bulk copy, which runs while the
//   next run computes (16-byte aligned spans; otherwise, odd w, every thread
//   stores 4 bytes at a time).  Every dw element is the first port's sum
//   exactly -- the f32 chain over c = 0 .. C - 1 from zero, each step one
//   fused multiply-add -- so the two bodies agree bit for bit.
// * the tap loop of outer.cuh, shared with K2 (one warp per pixel, the taps
//   streamed through the lanes 32 at a time, any K up to 129).
#include "hopper.cuh"
#include "outer.cuh"

namespace wcmc {

constexpr int kOuterRun = 32;   // source pixels a run
constexpr int kOuterRows = 32;  // runs down a column a unit

// floats of a staged canvas-cotangent window row: (32 + K - 1) pixels of C,
// padded to 16 bytes
__host__ __device__ inline int outer_win_pitch(int C, int K) {
  return round_up((kOuterRun + K - 1) * C, 4);
}

// The tiled body's dynamic shared memory, in the order the kernel carves
// it: the window ring (K + 1 row slots, each twice), two value runs, two
// staging tiles, the mbarriers.
inline size_t outer_tiled_smem(int C, int K) {
  return smem_bytes((size_t)2 * (K + 1) * outer_win_pitch(C, K), 4) +
         smem_bytes((size_t)2 * kOuterRun * C, 4) +
         smem_bytes((size_t)2 * kOuterRun * K * K, 4) + smem_bytes(2, 8);
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
    outer_tiled_kernel(const float* __restrict__ g, const float* __restrict__ buf,
                       float* __restrict__ dw, int B, int h, int w, int K, int vec) {
  constexpr int T = kOuterRun;
  extern __shared__ __align__(128) unsigned char smem[];
  const int K2 = K * K, H = h + K - 1, W = w + K - 1, pitch = outer_win_pitch(kC, K);
  const int slots = K + 1;  // window ring rows; each row is kept twice, at s and s + K + 1
  SmemCarver carve{smem, 0};
  float* s_win = carve.take<float>((size_t)2 * slots * pitch);
  float* s_g = carve.take<float>(2 * T * kC);
  float* s_out = carve.take<float>((size_t)2 * T * K2);
  unsigned long long* s_bars = carve.take<unsigned long long>(2);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what outer_tiled_smem sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // units: runs of T pixels of one row, kOuterRows rows down a column
  const int nr = (w + T - 1) / T, nc = (h + kOuterRows - 1) / kOuterRows;
  const int n_units = B * nc * nr;  // the entry checks B h nr < 2^31
  // bulk copies of every window row and value run where C is a multiple of
  // 4 and both tensors start on 16 bytes (a pixel's C values then do too)
  const bool vec_in = kC % 4 == 0 && aligned16(buf) && aligned16(g);
  const unsigned bar0 = smem_addr(s_bars);
  if (tid == 0) {
    for (int st = 0; st < 2; ++st) mbar_init(bar0 + 8 * st, vec_in ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the lane's taps d = lane + 32 jj as offsets into a pixel's window, whose
  // K rows lie one pitch apart from its first row's ring slot
  int woff[kMaxTapsPerLane];
#pragma unroll
  for (int jj = 0; jj < kMaxTapsPerLane; ++jj) {
    const int d = lane + 32 * jj, dy = d / K;
    woff[jj] = d < K2 ? dy * pitch + (d - dy * K) * kC : 0;
  }

  // Into buffer st (mbarrier st, values s_g[st]): the values of run y of
  // the unit at (b, x0), n pixels wide, and canvas rows [r0, r1) of its
  // window (n + K - 1 pixels each) into ring slots r % (K + 1) and
  // r % (K + 1) + K + 1; a bulk copy each by one thread, or 4-byte
  // cp.asyncs by all threads.
  auto fetch = [&](int st, int b, int y, int x0, int n, int r0, int r1) {
    const int len = (n + K - 1) * kC;
    const float* src = buf + (((long long)b * H) * W + x0) * kC;
    const float* gsrc = g + (((long long)b * h + y) * w + x0) * kC;
    float* gdst = s_g + st * T * kC;
    const unsigned bar = bar0 + 8 * st;
    if (vec_in) {
      if (tid == 0) {
        mbar_expect_tx(bar, 4u * (2 * (r1 - r0) * len + n * kC));
        for (int row = r0; row < r1; ++row) {
          const float* rs = src + (long long)row * W * kC;
          float* slot = s_win + (size_t)(row % slots) * pitch;
          bulk_copy(smem_addr(slot), rs, 4u * len, bar);
          bulk_copy(smem_addr(slot + (size_t)slots * pitch), rs, 4u * len, bar);
        }
        bulk_copy(smem_addr(gdst), gsrc, 4u * n * kC, bar);
      }
    } else {
      for (int e = tid; e < (r1 - r0) * len; e += kThreads) {
        const int row = r0 + e / len, i = e % len;
        const float* rs = src + (long long)row * W * kC + i;
        float* slot = s_win + (size_t)(row % slots) * pitch + i;
        cp_async4_zfill(smem_addr(slot), rs, 4);
        cp_async4_zfill(smem_addr(slot + (size_t)slots * pitch), rs, 4);
      }
      for (int e = tid; e < n * kC; e += kThreads)
        cp_async4_zfill(smem_addr(gdst + e), gsrc + e, 4);
      cp_async_mbar_arrive(bar);
    }
  };

  int k = 0;  // the block's runs so far: run k uses buffer k & 1
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int x0 = u % nr * T, n = min(T, w - x0);
    const int y0 = u / nr % nc * kOuterRows, y1 = min(h, y0 + kOuterRows);
    const int b = u / (nr * nc);
    // the unit's first window whole (the previous unit's reads ended at the
    // barrier before its last store)
    fetch(k & 1, b, y0, x0, n, y0, y0 + K);
    for (int y = y0; y < y1; ++y, ++k) {
      const int st = k & 1;
      // the next run's values and its one new row, into the slot of row
      // y - 1, which run y - 1 was the last to read
      if (y + 1 < y1) fetch(st ^ 1, b, y + 1, x0, n, y + K, y + K + 1);
      mbar_wait(bar0 + 8 * st, (k >> 1) & 1);     // this run's values and rows have landed
      if (vec && tid == 0) bulk_wait_read<1>();  // the store of run k - 2 is done with tile st
      __syncthreads();

      const float* win = s_win + (size_t)(y % slots) * pitch;
      const float* gv = s_g + st * T * kC;
      float* out = s_out + (size_t)st * T * K2;
      for (int p = warp; p < n; p += kWarps) {
        float gc[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) gc[c] = gv[p * kC + c];
        // every tap's window values first, so the loads are all in flight
        // before the first chain needs one
        const float* wp = win + p * kC;
        float q[kMaxTapsPerLane][kC];
#pragma unroll
        for (int jj = 0; jj < kMaxTapsPerLane; ++jj)
          if (lane + 32 * jj < K2) load_channels<kC>(wp + woff[jj], q[jj]);
#pragma unroll
        for (int jj = 0; jj < kMaxTapsPerLane; ++jj) {
          const int d = lane + 32 * jj;
          if (d < K2) {
            float acc = 0.0f;
#pragma unroll
            for (int c = 0; c < kC; ++c) acc = __fmaf_rn(gc[c], q[jj][c], acc);
            out[p * K2 + d] = acc;
          }
        }
      }
      if (vec) fence_proxy_async();  // the bulk store reads the tile through the async proxy
      __syncthreads();
      float* dst = dw + (((long long)b * h + y) * w + x0) * K2;
      if (vec) {
        if (tid == 0) {
          bulk_store(dst, smem_addr(out), 4u * n * K2);
          bulk_commit();
        }
      } else {
        for (int e = tid; e < n * K2; e += kThreads) dst[e] = out[e];
      }
    }
  }
  if (vec && tid == 0) bulk_wait<0>();
}

template <int kC>
inline cudaError_t launch_outer_tiled(const float* g, const float* buf, float* dw, int B, int h,
                                      int w, int K, int vec, int blocks, int device,
                                      cudaStream_t stream) {
  const size_t smem = outer_tiled_smem(kC, K);
  cudaError_t err = set_smem(outer_tiled_kernel<kC>, smem, device);
  if (err != cudaSuccess) return err;
  outer_tiled_kernel<kC><<<blocks, kThreads, smem, stream>>>(g, buf, dw, B, h, w, K, vec);
  return cudaGetLastError();
}

}  // namespace wcmc

using namespace wcmc;

// g (B, h, w, C) f32 contiguous; buf (B, H, W, C) f32 contiguous; dw
// (B, h, w, K*K) f32 contiguous; h = H - K + 1, w = W - K + 1; K <= 129.
// The first port's body: one warp per pixel.
extern "C" int wcmc_outer(const void* g, const void* buf, void* dw, int B, int H, int W, int C,
                          int K, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  return launch_outer<float, float, false>(
      static_cast<const float*>(g), static_cast<const float*>(buf), nullptr,
      static_cast<float*>(dw), B, H, W, C, K, 0, 0, 0, static_cast<cudaStream_t>(stream));
}

// The tiled body's dynamic shared memory (what ops/kernel_apply.py's
// outer_plan sums as its total).
extern "C" long long wcmc_outer_tiled_smem(int C, int K) {
  return (long long)outer_tiled_smem(C, K);
}

// The tiled body, with the first port's contract but K*K <= 448 (14 taps a
// lane); n_blocks: the most persistent blocks to launch (the SM count).
extern "C" int wcmc_outer_tiled(const void* g, const void* buf, void* dw, int B, int H, int W,
                                int C, int K, int n_blocks, int device, void* stream) {
  const int h = H - K + 1, w = W - K + 1;
  if (C < 1 || C > kMaxChannels || K < 1 || K * K > 32 * kMaxTapsPerLane || h < 1 || w < 1 ||
      B < 0 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const long long n_runs = (long long)B * h * ((w + kOuterRun - 1) / kOuterRun);
  if (n_runs == 0) return cudaSuccess;
  if (n_runs + n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long n_units = (long long)B * ((h + kOuterRows - 1) / kOuterRows) *
                            ((w + kOuterRun - 1) / kOuterRun);
  const int blocks = (int)(n_units < n_blocks ? n_units : n_blocks);
  const int vec = w % 4 == 0 && aligned16(dw);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(buf);
  float* out = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_outer_tiled<1>(gp, bp, out, B, h, w, K, vec, blocks, device, s);
    case 2: return launch_outer_tiled<2>(gp, bp, out, B, h, w, K, vec, blocks, device, s);
    case 3: return launch_outer_tiled<3>(gp, bp, out, B, h, w, K, vec, blocks, device, s);
    case 4: return launch_outer_tiled<4>(gp, bp, out, B, h, w, K, vec, blocks, device, s);
    case 5: return launch_outer_tiled<5>(gp, bp, out, B, h, w, K, vec, blocks, device, s);
    case 6: return launch_outer_tiled<6>(gp, bp, out, B, h, w, K, vec, blocks, device, s);
    case 7: return launch_outer_tiled<7>(gp, bp, out, B, h, w, K, vec, blocks, device, s);
    default: return launch_outer_tiled<8>(gp, bp, out, B, h, w, K, vec, blocks, device, s);
  }
}
