// K5-bwd in float32 on the tensor cores: the gradients of the per-sample head
// over [e | broadcast_S(ctx)] from the cotangents of its output and of its
// two sample moments, for f32 activations (TrainConfig.compute_dtype =
// "float32"), every product in split TF32 (tf32x3.cuh: lo . hi + hi . lo +
// hi . hi of the operands' tf32 halves, about f32's accuracy):
//
//   h1 = a1(e . W1e + ctx . W1c + b1),  h2 = a2(h1 . W2 + b2)
//   gz = a2'(h2, g + gsum + 2 h2 gsq),  g1 = a1'(h1, gz . W2^T)
//   de = g1 . W1e^T,  G = sum_s g1,  dctx = G . W1c^T
//   dW2 = h1^T . gz,  dW1e = e^T . g1,  dW1c = ctx^T . G,  db2 = sum gz,  db1 = sum g1
//
// Replaces wcmc_tpu/ops/pathnet_fused.py::_head_bwd_pallas (pallas_call
// :578) on f32 inputs, where every product is f32.  (The bf16 forms are
// pathnet_head_bwd.cu; the first f32 body, SIMT, is pathnet_f32.cu's
// pathnet_head_bwd_f32_kernel, kept as the card tests' reference.)
//
// What bounds it on the H100: operations.  At KPCN's training shape (8
// images x 8 spp x 128^2 px, [128 | 128] -> 256 -> 6) the backward is 3 .
// (128 . 256 + 256 . 6) multiply-adds a row and 3 . 128 . 256 a pixel, 0.24
// TFLOP: 3.6 ms at the CUDA cores' 67 TFLOP/s, 1.46 ms in split TF32 (three
// tf32 products per f32 one at 495 TFLOP/s); the bytes (e, g, de, the
// context and its gradient, f32) are ~0.4 ms.
//
// Design.  Five forms, templated by (Ce = Cc, C1, Cout padded to kOut):
// KPCN's (128, 256, 8) and the 64-wide PathNet's (64, 128, 8), each also
// with kOut 16 (the PathNet heads the bf16 body takes, Cout up to 16), and
// Multisteps' update chain (128, 128, 128); activations, the cotangent's
// layout (channel-major or channels-last) and which cotangents are present
// at run time.
// - Persistent blocks of 256 threads (8 warps), one an SM, walk tiles of 16
//   pixels of one image; a tile takes its samples in chunks of 4, so every
//   product has 64 rows, sample-major (row r: sample s0 + r / 16, pixel r %
//   16: a sample's 16 pixels are one contiguous run of e, and an m16
//   fragment's rows are the 16 pixels).  Rows past S or HW are zero-filled
//   and their gz forced to zero, so they add nothing.
// - Products on mma.sync m16n8k8 (tf32), every one of them: each operand
//   fragment is loaded from shared memory (the activations) or device
//   memory (the weights) in the layout the product reads, so the weight
//   gradients read e^T, h1^T and ctx^T straight from the row-major tiles
//   (no transposed copy, which tf32 wgmma, K-major only, would need for
//   every tile), and the narrow Cout of KPCN and PathNet is one n8 tile
//   (padded to 8, not to 128).  Activations are split into hi and lo as
//   their fragments are loaded; the weights W1e, W1c, W2, W2^T, W1e^T and
//   W1c^T are packed by the wrapper once per parameter value
//   (ops/pathnet_fused.py, pack_head_tf32) in fragment order, already split:
//   one 16-byte read-only load a lane per n8 tile and k8 step, from L2 and
//   L1.  Row-major A fragments take channels 2t and 2t + 1 as k t and k t +
//   4 (one 8-byte load), the packed weights the same order of k.  In every
//   product each k8 step's three products go into a partial from zero,
//   added to the running sum by one f32 add (tf32x3.cuh): the tensor cores'
//   truncating accumulation then never carries a long sum, which matters
//   most for the weight gradients, summed over a block's whole walk.
// - Weight gradients: dW1e (Ce x C1) and dW2 (C1 x kOut) stay in registers
//   for the block's whole walk (KPCN: 128 + 8 a thread; Multisteps 64 +
//   64); dW1c is formed once per tile (K = the tile's 16 pixels, from G)
//   and added into the block's partial in device memory by the thread that
//   owns each element (every S samples, not every 32 rows); the bias sums in
//   registers, one column a thread.  The partials are summed by
//   reduce_parts in block order: two launches repeat bit for bit.
// - Loads: e and the output cotangent of the next chunk come by cp.async
//   (16 bytes for e, 4 for g) under the chunk's dW1e products, once the
//   chunk's last reader of gz is done (e into the second of two buffers);
//   the context, gsum and gsq per tile, 16 and 4 bytes a copy.  The weight
//   fragments of a product come through each warp's own cp.async ring, two
//   k8 steps ahead of their use, so their latency from L2 (two warps an SM
//   sub-partition to hide it) is not waited on each k8 step; two steps
//   ahead where three do not fit (KPCN's form with kOut 16).
// - Per chunk: h1 = a1(e . W1e + ctx . W1c + b1) (ctx . W1c once per tile),
//   h2 and gz, dW2 and db2, g1 over h1 in place, then db1, G, dW1e and d(e)
//   from g1; per tile d(ctx) and dW1c from G.  Five block barriers a chunk.
// Shared memory (head_bwd_tc_smem): e twice, h1 / g1, g / gz, the context,
// ctx . W1c, G, gsum and gsq, the warps' rings: 231936 bytes for KPCN
// (220672 with kOut 16), 230912 for Multisteps, 145920 for the 64-wide
// PathNet (151040 with kOut 16).
#include "hopper.cuh"
#include "mlp.cuh"
#include "tf32x3.cuh"

namespace wcmc {

constexpr int kHtPix = 16, kHtSamp = 4, kHtRows = kHtPix * kHtSamp;
// a warp's ring of weight fragments: ht_ring k8 steps of up to kHtRingNT n8
// tiles, 16 bytes a lane each
constexpr int kHtRingNT = 4;
constexpr size_t kHtSmemLimit = 232448;  // what a block may opt into

struct HeadTc {
  const float* e;     // (B, S, HW, kCe)
  const float* ctx;   // (B, HW, kCe)
  const float* g;     // (B, S, HW, cout) or (B, S, cout, HW) with cmajor, or null
  const float* gsum;  // (B, HW, cout) or null
  const float* gsq;   // (B, HW, cout) or null
  const float* wp;    // pack_head_tf32: W1e | W1c | W2 | W2^T | W1e^T | W1c^T as fragments
  const float* b1;    // (kC1), zero past C1
  const float* b2;    // (kOut), zero past Cout
  float* de;          // (B, S, HW, kCe)
  float* dctx;        // (B, HW, kCe)
  float* parts;       // per block: dW1e | dW1c | dW2 | db1 | db2
  int B, S, HW, cout, act1, act2, cmajor;
};

__host__ __device__ constexpr int ht_pitch(int c) { return c == 8 ? 8 : c + 8; }

__host__ __device__ constexpr size_t ht_r128(size_t floats) {
  return (4 * floats + 127) / 128 * 128;
}

// the carve without the rings
__host__ __device__ constexpr size_t ht_tiles_smem(int ce, int c1, int kout) {
  return 2 * ht_r128((size_t)kHtRows * ht_pitch(ce)) + ht_r128((size_t)kHtRows * ht_pitch(c1)) +
         ht_r128((size_t)kHtRows * ht_pitch(kout)) + ht_r128((size_t)kHtPix * ht_pitch(ce)) +
         2 * ht_r128((size_t)kHtPix * ht_pitch(c1)) + 2 * ht_r128((size_t)kHtPix * kout);
}

// the rings' depth in k8 steps: three where they fit, else two
__host__ __device__ constexpr int ht_ring(int ce, int c1, int kout) {
  return ht_tiles_smem(ce, c1, kout) + ht_r128((size_t)kWarps * 3 * kHtRingNT * 32 * 4) <=
                 kHtSmemLimit
             ? 3
             : 2;
}

inline size_t head_bwd_tc_smem(int ce, int c1, int kout) {
  return ht_tiles_smem(ce, c1, kout) +
         ht_r128((size_t)kWarps * ht_ring(ce, c1, kout) * kHtRingNT * 32 * 4);
}

__host__ __device__ constexpr long long head_tc_parts(int ce, int c1, int kout) {
  return 2LL * ce * c1 + (long long)c1 * kout + c1 + kout;
}

// acc[mt][nt] += A[16 mt + (g, g + 8)][k] . W[k][8 (jn0 + nt) + g] over k8s
// k8 steps for the warp: A row-major in shared memory at pitch pa from the
// warp's first row, W packed in fragment order (wk8 k8 steps an n8 tile).
// Each lane copies its own B fragments of step ks + kRing - 1 into the
// warp's ring (cp.async, 16 bytes a fragment) as step ks starts, so the
// loads from L2 run kRing - 1 steps ahead of their products; the waits count
// the thread's cp.async groups, so no other group may be pending on entry.
template <int kRing, int MT, int NT>
__device__ inline void mm_rows_w(float (&acc)[MT][NT][4], const float* A, int pa, int k8s,
                                 const float* __restrict__ W, int wk8, int jn0, uint4* ring) {
  static_assert(NT <= kHtRingNT, "a ring step holds kHtRingNT n8 tiles");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  auto fetch = [&](int ks) {
    if (ks < k8s) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        cp_async16_zfill(smem_addr(ring + ((ks % kRing) * kHtRingNT + nt) * 32 + lane),
                         W + ((size_t)(jn0 + nt) * wk8 + ks) * 128 + lane * 4, 16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ks = 0; ks < kRing - 1; ++ks) fetch(ks);
  for (int ks = 0; ks < k8s; ++ks) {
    fetch(ks + kRing - 1);
    cp_async_wait_group<kRing - 1>();  // step ks's fragments have landed
    FragB b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint4 q = ring[((ks % kRing) * kHtRingNT + nt) * 32 + lane];
      b[nt].v[0] = q.x, b[nt].v[1] = q.y, b[nt].v[2] = q.z, b[nt].v[3] = q.w;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* ap = A + (16 * mt + g) * pa + 8 * ks + 2 * t;
      const float2 v0 = *reinterpret_cast<const float2*>(ap);
      const float2 v1 = *reinterpret_cast<const float2*>(ap + 8 * pa);
      FragA a;
      a.set(v0.x, v1.x, v0.y, v1.y);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma3(acc[mt][nt], a, b[nt]);
    }
  }
  cp_async_wait_all();
}

template <int kCe, int kC1, int kOut>
__global__ void __launch_bounds__(kThreads, 1) pathnet_head_bwd_tf32_kernel(HeadTc a) {
  constexpr int pe = ht_pitch(kCe), ph = ht_pitch(kC1), pg = ht_pitch(kOut);
  constexpr int kRing = ht_ring(kCe, kC1, kOut), kRingWarp = kRing * kHtRingNT * 32;
  // packed weights: each K x N matrix 2 K N floats
  constexpr size_t oW1c = 2 * kCe * kC1, oW2 = 2 * oW1c, oW2t = oW2 + 2 * kC1 * kOut;
  constexpr size_t oW1et = oW2t + 2 * kOut * kC1, oW1ct = oW1et + 2 * kC1 * kCe;
  // partials
  constexpr size_t pW1c = (size_t)kCe * kC1, pW2 = 2 * pW1c, pB1 = pW2 + (size_t)kC1 * kOut;
  constexpr size_t pB2 = pB1 + kC1;
  // warp tilings: dW2 and dW1e in registers for the block's walk
  constexpr int WN3 = kOut == 8 ? 1 : 2, MT3 = kC1 / 16 / (8 / WN3), NT3 = kOut / 8 / WN3;
  constexpr int MT5 = kCe / 32, NT5 = kC1 / 32;
  constexpr int NT0 = kC1 / 64, NT7 = kCe / 64;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, tid = threadIdx.x;
  SmemCarver carve{smem, 0};
  float* E[2] = {carve.take<float>(kHtRows * pe), carve.take<float>(kHtRows * pe)};
  float* H = carve.take<float>(kHtRows * ph);   // h1, then g1
  float* GZ = carve.take<float>(kHtRows * pg);  // the output cotangent, then gz
  float* CX = carve.take<float>(kHtPix * pe);
  float* ZC = carve.take<float>(kHtPix * ph);   // ctx . W1c
  float* G = carve.take<float>(kHtPix * ph);    // sum_s g1
  float* GS = carve.take<float>(kHtPix * kOut);
  float* GQ = carve.take<float>(kHtPix * kOut);
  uint4* ring = carve.take<uint4>(kWarps * kRingWarp) + warp * kRingWarp;
  const float* W = a.wp;
  float* part = a.parts + (size_t)blockIdx.x * head_tc_parts(kCe, kC1, kOut);

  const int per_image = (a.HW + kHtPix - 1) / kHtPix, tiles = a.B * per_image;
  const int nch = (a.S + kHtSamp - 1) / kHtSamp;

  // chunk (tile t, samples from s0): e into Ed, the cotangent into GZ
  auto load_e = [&](float* Ed, int t, int s0) {
    const int b = t / per_image, p0 = t % per_image * kHtPix;
    constexpr int kQ = kCe / 4;
    for (int i = tid; i < kHtRows * kQ; i += kThreads) {
      const int r = i / kQ, q = i % kQ, s = s0 + r / kHtPix, p = p0 + r % kHtPix;
      const bool ok = s < a.S && p < a.HW;
      const float* src = ok ? a.e + (((size_t)b * a.S + s) * a.HW + p) * kCe + 4 * q : a.e;
      cp_async16_zfill(smem_addr(Ed + r * pe + 4 * q), src, ok ? 16 : 0);
    }
  };
  auto load_g = [&](int t, int s0) {
    const int b = t / per_image, p0 = t % per_image * kHtPix;
    for (int i = tid; i < kHtRows * kOut; i += kThreads) {
      int r, c;
      if (a.cmajor) {  // consecutive threads on consecutive pixels
        const int j = i / (kOut * kHtPix), rem = i % (kOut * kHtPix);
        c = rem / kHtPix, r = j * kHtPix + rem % kHtPix;
      } else {
        r = i / kOut, c = i % kOut;
      }
      const int s = s0 + r / kHtPix, p = p0 + r % kHtPix;
      const bool ok = a.g != nullptr && s < a.S && p < a.HW && c < a.cout;
      const float* src = a.g;
      if (ok)
        src += a.cmajor ? (((size_t)b * a.S + s) * a.cout + c) * a.HW + p
                        : (((size_t)b * a.S + s) * a.HW + p) * a.cout + c;
      cp_async4_zfill(smem_addr(GZ + r * pg + c), ok ? src : a.e, ok ? 4 : 0);
    }
  };
  auto load_tile = [&](int t) {
    const int b = t / per_image, p0 = t % per_image * kHtPix;
    constexpr int kQ = kCe / 4;
    for (int i = tid; i < kHtPix * kQ; i += kThreads) {
      const int p = i / kQ, q = i % kQ;
      const bool ok = p0 + p < a.HW;
      const float* src = ok ? a.ctx + ((size_t)b * a.HW + p0 + p) * kCe + 4 * q : a.ctx;
      cp_async16_zfill(smem_addr(CX + p * pe + 4 * q), src, ok ? 16 : 0);
    }
    for (int i = tid; i < kHtPix * kOut; i += kThreads) {
      const int p = i / kOut, c = i % kOut;
      const bool ok = p0 + p < a.HW && c < a.cout;
      const size_t at = ((size_t)b * a.HW + p0 + p) * a.cout + c;
      const bool s_ok = ok && a.gsum != nullptr, q_ok = ok && a.gsq != nullptr;
      cp_async4_zfill(smem_addr(GS + i), s_ok ? a.gsum + at : a.e, s_ok ? 4 : 0);
      cp_async4_zfill(smem_addr(GQ + i), q_ok ? a.gsq + at : a.e, q_ok ? 4 : 0);
    }
    for (int i = tid; i < kHtPix * kC1; i += kThreads) G[i / kC1 * ph + i % kC1] = 0.0f;
  };

  float dw2[MT3][NT3][4], dw1e[MT5][NT5][4];
  zero_frags(dw2);
  zero_frags(dw1e);
  float db1 = 0.0f, db2 = 0.0f;
  const int m3 = warp % (8 / WN3) * MT3 * 16, n3 = warp / (8 / WN3) * NT3 * 8;
  const int m5 = warp % 2 * MT5 * 16, n5 = warp / 2 * NT5 * 8;

  bool first = true;
  int q = 0;  // chunks walked: E[q & 1] holds the current one
  if ((int)blockIdx.x < tiles) {
    load_e(E[0], blockIdx.x, 0);
    load_g(blockIdx.x, 0);
    cp_async_commit();
  }
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / per_image, p0 = t % per_image * kHtPix;
    __syncthreads();  // the last tile's readers of CX and G are done
    load_tile(t);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    {  // ctx . W1c once per tile: warp w's NT0 n8 tiles of C1
      float acc[1][NT0][4];
      zero_frags(acc);
      mm_rows_w<kRing>(acc, CX, pe, kCe / 8, W + oW1c, kCe / 8, warp * NT0, ring);
      each_frag(acc, 0, warp * NT0 * 8, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(ZC + r * ph + c) = make_float2(v0, v1);
      });
    }
    for (int ch = 0; ch < nch; ++ch, ++q) {
      const int s0 = ch * kHtSamp;
      float* Ec = E[q & 1];
      cp_async_wait_all();
      __syncthreads();  // e and g landed; ctx . W1c written; the last chunk's readers done
      // the next chunk: this tile's next samples, or the next tile's first
      const int tn = ch + 1 < nch ? t : t + gridDim.x, sn = ch + 1 < nch ? s0 + kHtSamp : 0;

      // h1 = a1((e . W1e + ctx . W1c) + b1), 32 x 32 tiles
      for (int tt = warp; tt < 2 * kC1 / 32; tt += 8) {
        const int m0 = tt % 2 * 32, jn0 = tt / 2 * 4;
        float acc[2][4][4];
        zero_frags(acc);
        mm_rows_w<kRing>(acc, Ec + m0 * pe, pe, kCe / 8, W, kCe / 8, jn0, ring);
        each_frag(acc, m0, jn0 * 8, [&](int r, int c, float v0, float v1) {
          const float* zc = ZC + r % kHtPix * ph + c;
          *reinterpret_cast<float2*>(H + r * ph + c) =
              make_float2(mlp_act(a.act1, (v0 + zc[0]) + a.b1[c]),
                          mlp_act(a.act1, (v1 + zc[1]) + a.b1[c + 1]));
        });
      }
      __syncthreads();
      // h2 = a2(h1 . W2 + b2); gz = a2'(h2, (g + gsum) + 2 h2 gsq), zero on padding
      {
        constexpr int MT2 = kOut <= 16 ? 1 : 2, NT2 = kOut <= 16 ? kOut / 8 : 4;
        constexpr int tasks = (4 / MT2) * (kOut / 8 / NT2);
        if (warp < tasks) {
          const int m0 = warp % (4 / MT2) * 16 * MT2, jn0 = warp / (4 / MT2) * NT2;
          float acc[MT2][NT2][4];
          zero_frags(acc);
          mm_rows_w<kRing>(acc, H + m0 * ph, ph, kC1 / 8, W + oW2, kC1 / 8, jn0, ring);
          each_frag(acc, m0, jn0 * 8, [&](int r, int c, float v0, float v1) {
            const int p = r % kHtPix;
            const bool ok = s0 + r / kHtPix < a.S && p0 + p < a.HW;
            const float v[2] = {v0, v1};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float h2 = mlp_act(a.act2, v[i] + a.b2[c + i]);
              const float gg = (GZ[r * pg + c + i] + GS[p * kOut + c + i]) +
                               2.0f * h2 * GQ[p * kOut + c + i];
              GZ[r * pg + c + i] =
                  ok && c + i < a.cout ? mlp_act_grad(a.act2, h2, gg) : 0.0f;
            }
          });
        }
      }
      __syncthreads();
      if (tid < kOut) {  // db2, rows in order
        float s = 0.0f;
        for (int r = 0; r < kHtRows; ++r) s += GZ[r * pg + tid];
        db2 += s;
      }
      mm_rows_t(dw2, H, ph, m3, GZ, pg, n3, kHtRows / 8);   // dW2 += h1^T . gz
      __syncthreads();  // dW2 has read h1
      // g1 = a1'(h1, gz . W2^T), over h1 in place
      for (int tt = warp; tt < 2 * kC1 / 32; tt += 8) {
        const int m0 = tt % 2 * 32, jn0 = tt / 2 * 4;
        float acc[2][4][4];
        zero_frags(acc);
        mm_rows_w<kRing>(acc, GZ + m0 * pg, pg, kOut / 8, W + oW2t, kOut / 8, jn0, ring);
        each_frag(acc, m0, jn0 * 8, [&](int r, int c, float v0, float v1) {
          float2* hp = reinterpret_cast<float2*>(H + r * ph + c);
          const float2 h = *hp;
          *hp = make_float2(mlp_act_grad(a.act1, h.x, v0), mlp_act_grad(a.act1, h.y, v1));
        });
      }
      __syncthreads();  // g1 written; gz read for the last time
      if (tn < tiles) {  // the next chunk's e and cotangent, under dW1e's products
        load_e(E[(q + 1) & 1], tn, sn);
        load_g(tn, sn);
      }
      cp_async_commit();
      if (tid < kC1) {  // db1, rows in order
        float s = 0.0f;
        for (int r = 0; r < kHtRows; ++r) s += H[r * ph + tid];
        db1 += s;
      }
      for (int i = tid; i < kHtPix * kC1; i += kThreads) {  // G += g1, samples in order
        const int p = i / kC1, c = i % kC1;
        float v = G[p * ph + c];
#pragma unroll
        for (int j = 0; j < kHtSamp; ++j) v += H[(j * kHtPix + p) * ph + c];
        G[p * ph + c] = v;
      }
      mm_rows_t(dw1e, Ec, pe, m5, H, ph, n5, kHtRows / 8);   // dW1e += e^T . g1
      cp_async_wait_all();  // the next chunk's copies, before d(e)'s ring counts its own
      // de = g1 . W1e^T, 32 x 32 tiles
      for (int tt = warp; tt < 2 * kCe / 32; tt += 8) {
        const int m0 = tt % 2 * 32, jn0 = tt / 2 * 4;
        float acc[2][4][4];
        zero_frags(acc);
        mm_rows_w<kRing>(acc, H + m0 * ph, ph, kC1 / 8, W + oW1et, kC1 / 8, jn0, ring);
        each_frag(acc, m0, jn0 * 8, [&](int r, int c, float v0, float v1) {
          const int s = s0 + r / kHtPix, p = p0 + r % kHtPix;
          if (s < a.S && p < a.HW)
            *reinterpret_cast<float2*>(a.de + (((size_t)b * a.S + s) * a.HW + p) * kCe + c) =
                make_float2(v0, v1);
        });
      }
    }
    __syncthreads();  // G summed over the tile's samples
    {  // d(ctx) = G . W1c^T
      float acc[1][NT7][4];
      zero_frags(acc);
      mm_rows_w<kRing>(acc, G, ph, kC1 / 8, W + oW1ct, kC1 / 8, warp * NT7, ring);
      each_frag(acc, 0, warp * NT7 * 8, [&](int r, int c, float v0, float v1) {
        if (p0 + r < a.HW)
          *reinterpret_cast<float2*>(a.dctx + ((size_t)b * a.HW + p0 + r) * kCe + c) =
              make_float2(v0, v1);
      });
    }
    // the block's partial of dW1c += ctx^T . G, 32 x 32 tiles, each element
    // by its owner
    for (int tt = warp; tt < (kCe / 32) * (kC1 / 32); tt += 8) {
      const int m0 = tt % (kCe / 32) * 32, n0 = tt / (kCe / 32) * 32;
      float acc[2][4][4];
      if (first) {
        zero_frags(acc);
      } else {
        load_frags(acc, m0, n0, part + pW1c, kC1);
      }
      mm_rows_t(acc, CX, pe, m0, G, ph, n0, kHtPix / 8);
      each_frag(acc, m0, n0, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(part + pW1c + r * kC1 + c) = make_float2(v0, v1);
      });
    }
    first = false;
  }
  cp_async_wait_all();
  // the block's partials: dW1e and dW2 from registers, the bias sums
  if (first) {  // a block without tiles
    for (int i = tid; i < kCe * kC1; i += kThreads) part[pW1c + i] = 0.0f;
  }
  each_frag(dw1e, m5, n5, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(part + r * kC1 + c) = make_float2(v0, v1);
  });
  each_frag(dw2, m3, n3, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(part + pW2 + r * kOut + c) = make_float2(v0, v1);
  });
  if (tid < kC1) part[pB1 + tid] = db1;
  if (tid < kOut) part[pB2 + tid] = db2;
}

template <int kCe, int kC1, int kOut>
static int launch_head_bwd_tc(const HeadTc& a, int n_blocks, int device, cudaStream_t stream) {
  auto kernel = pathnet_head_bwd_tf32_kernel<kCe, kC1, kOut>;
  const size_t smem = head_bwd_tc_smem(kCe, kC1, kOut);
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of K5-bwd's tensor-core f32 body for the form
// (ce = cc, c1, kout): what ops/pathnet_fused.py's head_bwd_tc_plan totals.
extern "C" long long wcmc_pathnet_head_bwd_tf32_smem(int ce, int c1, int kout) {
  return (long long)head_bwd_tc_smem(ce, c1, kout);
}

// K5-bwd in f32 on the tensor cores: e (B, S, HW, ce) and ctx (B, HW, ce)
// f32, 16-byte aligned; g the output's cotangent (B, S, HW, cout), or (B, S,
// cout, HW) with cmajor, gsum and gsq (B, HW, cout), each f32 or null
// (zero); wp the weights packed by ops/pathnet_fused.py's pack_head_tf32 for
// (ce, c1, kout), 16-byte aligned, b1 (c1) and b2 (kout) f32 zero-padded; de
// (B, S, HW, ce) and dctx (B, HW, ce) f32.  (ce, c1, kout) is (128, 256, 8),
// (128, 256, 16), (64, 128, 8), (64, 128, 16) or (128, 128, 128), cout <=
// kout.  parts: n_blocks partials
// of dW1e | dW1c (ce x c1 each) | dW2 (c1 x kout) | db1 | db2 (scratch); out
// their sum in block order, f32.
extern "C" int wcmc_pathnet_head_bwd_tf32(const void* e, const void* ctx, const void* g,
                                          const void* gsum, const void* gsq, const void* wp,
                                          const void* b1, const void* b2, void* de, void* dctx,
                                          void* parts, void* out, int B, int S, int HW, int ce,
                                          int c1, int kout, int cout, int act1, int act2,
                                          int cmajor, int n_blocks, int device, void* stream) {
  if (B < 1 || S < 1 || HW < 1 || n_blocks < 1 || cout < 1 || cout > kout || act1 < 0 ||
      act1 > 2 || act2 < 0 || act2 > 2 || !aligned16(e) || !aligned16(ctx) || !aligned16(wp))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  HeadTc a{};
  a.e = static_cast<const float*>(e);
  a.ctx = static_cast<const float*>(ctx);
  a.g = static_cast<const float*>(g);
  a.gsum = static_cast<const float*>(gsum);
  a.gsq = static_cast<const float*>(gsq);
  a.wp = static_cast<const float*>(wp);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.de = static_cast<float*>(de);
  a.dctx = static_cast<float*>(dctx);
  a.parts = static_cast<float*>(parts);
  a.B = B, a.S = S, a.HW = HW, a.cout = cout, a.act1 = act1, a.act2 = act2, a.cmajor = cmajor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (ce == 128 && c1 == 256 && kout == 8) {
    err = launch_head_bwd_tc<128, 256, 8>(a, n_blocks, device, s);
  } else if (ce == 128 && c1 == 256 && kout == 16) {
    err = launch_head_bwd_tc<128, 256, 16>(a, n_blocks, device, s);
  } else if (ce == 64 && c1 == 128 && kout == 8) {
    err = launch_head_bwd_tc<64, 128, 8>(a, n_blocks, device, s);
  } else if (ce == 64 && c1 == 128 && kout == 16) {
    err = launch_head_bwd_tc<64, 128, 16>(a, n_blocks, device, s);
  } else if (ce == 128 && c1 == 128 && kout == 128) {
    err = launch_head_bwd_tc<128, 128, 128>(a, n_blocks, device, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return reduce_parts(a.parts, static_cast<float*>(out), n_blocks, head_tc_parts(ce, c1, kout), s);
}
