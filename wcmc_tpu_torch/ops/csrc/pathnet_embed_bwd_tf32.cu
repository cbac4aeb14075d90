// K4-bwd in float32 on the tensor cores: the gradients of the PathNet
// embedding (three layers over per-sample rows) from the cotangents of its
// output and of its sample mean, for f32 activations (TrainConfig.
// compute_dtype = "float32"), every product in split TF32 (tf32x3.cuh: lo .
// hi + hi . lo + hi . hi of the operands' tf32 halves, a partial a k8 step,
// about f32's accuracy):
//
//   h0 = x, h_{i+1} = a_i(h_i . W_i + b_i), the hidden layers recomputed
//   g3 = a_2'(h3, ge + gmean / S),  g2 = a_1'(h2, g3 . W2^T),  g1 = a_0'(h1, g2 . W1^T)
//   dW_i = h_i^T . g_{i+1},  db_i = sum g_{i+1},  d(x) = g1 . W0^T where asked
//
// Replaces wcmc_tpu/ops/pathnet_fused.py::_embed_bwd_pallas (pallas_call
// :222, body :88) on f32 inputs, where every product is f32.  (The bf16
// forms are pathnet_embed_bwd.cu; the first f32 body, SIMT, is
// pathnet_f32.cu's pathnet_embed_bwd_f32_kernel, kept as the card tests'
// reference.)
//
// What bounds it on the H100: operations.  At KPCN's training shape (8
// images x 8 spp x 128^2 px, 36 -> 128^3, relu relu linear, no d(x)) the
// backward is (36 . 128 + 128 . 128) recomputed + 2 . 128 . 128 . 2 + 36 .
// 128 multiply-adds a row, 0.19 TFLOP: 2.9 ms at the CUDA cores' 67
// TFLOP/s, 1.16 ms in split TF32 (three tf32 products an f32 one at 495
// TFLOP/s); the bytes (x and the cotangents, f32) are ~0.2 ms.
//
// Design.  Three forms, templated by (C0 padded to kC0, the hidden width
// kC): (40, 128) KPCN's dual PathNet, (40, 64) the 64-wide PathNet of LBMC
// and SBMC, (96, 128) Multisteps (95 -> 128^3, leaky x 3, with d(x));
// narrower chains zero-padded (exact: a padded channel's weights, bias and
// cotangent are zero, and every activation maps 0 to 0); activations and
// d(x) at run time.
// - Persistent blocks of 256 threads walk tiles of 16 pixels of one image
//   (one block an SM for kC 128, two for kC 64); a tile takes its samples in
//   chunks of 4, so every product has 64 rows, sample-major (row r: sample
//   s0 + r / 16, pixel r % 16), and the tile's gmean is loaded once for its
//   samples.  Rows past S or HW are zero-filled and their g3 forced to zero,
//   so they add nothing.
// - Products on mma.sync m16n8k8 (tf32), every one of them.  The recompute
//   and the d(h) products read the activations row-major from shared memory
//   and the weights packed by the wrapper (ops/pathnet_fused.py,
//   pack_embed_tf32: W0, W1, W2, W2^T, W1^T, W0^T in fragment order, split
//   once per parameter value) by 16-byte read-only loads one k8 step ahead
//   (mm_rows_ldg; no shared ring, so its bytes go to the tiles); the weight
//   gradients read h^T straight from the row-major tiles (mm_rows_t).  wgmma
//   was not used: its tf32 A and B are K-major only, so the weight gradients
//   would need a transposed copy of every tile, and its larger tiles would
//   not fit beside the registers below.
// - Register budget, option (b): dW1 and dW2 (kC x kC each) stay in
//   registers for the block's whole walk, 2 . 128 . 128 / 256 = 128 floats
//   a thread for kC 128 (K5-bwd's tensor-core body held 136 in 255
//   registers); dW0, at most 96 x 128, is summed in shared memory as dW0^T
//   (kC x kC0, the product g1^T . x, whose M kC is a multiple of 16 where
//   C0's 40 is not), each element read, added to and written by the lane
//   that owns it.  Three warpgroups each owning one dW (option (a)) would
//   need 384 threads and pass every cotangent tile between them through
//   barriers; (b) keeps one block of 8 warps and the SIMT body's order of
//   layers.  The bias sums in registers, one column a thread.  Each block
//   writes its partial once, at its end; reduce_parts sums the partials in
//   block order, so two launches repeat bit for bit.
// - Loads by cp.async: the next chunk's x (16 bytes a copy where C0 is a
//   multiple of 4 and x 16-byte aligned, else 4) into the second of two x
//   buffers and its ge into the cotangent buffer, and with a tile's last
//   chunk the next tile's gmean, issued once g3 is read for the last time,
//   so they land under dW1's, d(h1)'s, dW0's and d(x)'s products.
// - Per chunk: h1, h2 (and h3 where a_2 is not linear), g3, db2 and dW2, g2
//   over h2 in place, db1 and dW1, g1 over h1 in place, db0 and dW0^T, d(x).
//   Eight block barriers a chunk.
// Shared memory (embed_bwd_tc_smem): x twice, h1 / g1, h2 / g2, ge / g3 at
// 64 rows, the tile's gmean at 16, dW0^T: 154112 bytes for (40, 128),
// 90624 for (40, 64), 219648 for (96, 128).
#include "hopper.cuh"
#include "mlp.cuh"
#include "tf32x3.cuh"

namespace wcmc {

constexpr int kEtPix = 16, kEtSamp = 4, kEtRows = kEtPix * kEtSamp;

struct EmbedTc {
  const float* x;     // (B, S, HW, c0)
  const float* ge;    // (B, S, HW, kC) or null
  const float* gm;    // (B, HW, kC) or null
  const float* wp;    // pack_embed_tf32: W0 | W1 | W2 | W2^T | W1^T | W0^T as fragments
  const float* bias;  // b0 | b1 | b2, kC each, zero past the widths
  float* dx;          // (B, S, HW, c0) or null
  float* parts;       // per block: dW0 (kC0 x kC) | dW1 | dW2 | db0 | db1 | db2
  int B, S, HW, c0, xvec, act0, act1, act2;
};

// a row pitch of 8 floats past a multiple of 32: the fragment loads of
// eight rows (mm_rows_ldg) and of four (mm_rows_t) then fall on distinct banks
__host__ __device__ constexpr int et_pitch(int c) { return c + (40 - c % 32) % 32; }

__host__ __device__ constexpr size_t et_r128(size_t floats) {
  return (4 * floats + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t embed_bwd_tc_smem(int c0p, int c) {
  return 2 * et_r128((size_t)kEtRows * et_pitch(c0p)) + 3 * et_r128((size_t)kEtRows * et_pitch(c)) +
         et_r128((size_t)kEtPix * et_pitch(c)) + et_r128((size_t)c * et_pitch(c0p));
}

__host__ __device__ constexpr long long embed_tc_parts(int c0p, int c) {
  return (long long)c0p * c + 2LL * c * c + 3LL * c;
}

template <int kC0, int kC>
__global__ void __launch_bounds__(kThreads, kC == 64 ? 2 : 1)
    pathnet_embed_bwd_tf32_kernel(EmbedTc a) {
  constexpr int px = et_pitch(kC0), ph = et_pitch(kC);
  // packed weights: each K x N matrix 2 K N floats
  constexpr size_t oW1 = 2 * kC0 * kC, oW2 = oW1 + 2 * kC * kC, oW2t = oW2 + 2 * kC * kC;
  constexpr size_t oW1t = oW2t + 2 * kC * kC, oW0t = oW1t + 2 * kC * kC;
  // partials
  constexpr size_t pW1 = (size_t)kC0 * kC, pW2 = pW1 + kC * kC, pB = pW2 + kC * kC;
  // warp tilings: the row products (16 MTr) x 32, eight of them; dW1 and
  // dW2 (kC / 2) x (kC / 4) a warp; dW0^T one m16 tile and NT0 n8 tiles a
  // task; d(x) (16 MTx) x (8 NTx) a task
  constexpr int MTr = kC / 64, MTw = kC / 32, NTw = kC / 32;
  constexpr int NT0 = (kC0 / 8) % 4 == 0 ? 4 : kC0 / 8, P0 = kC0 / 8 / NT0;
  constexpr int MTx = kC0 % 32 == 0 ? 2 : 1, NTx = kC0 % 32 == 0 ? 3 : kC0 / 8;
  static_assert(kC0 % 8 == 0 && kC % 64 == 0 && NT0 <= 6 && (kC0 / 8) % NTx == 0, "form");
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, tid = threadIdx.x;
  SmemCarver carve{smem, 0};
  float* X[2] = {carve.take<float>(kEtRows * px), carve.take<float>(kEtRows * px)};
  float* H1 = carve.take<float>(kEtRows * ph);  // h1, then g1
  float* H2 = carve.take<float>(kEtRows * ph);  // h2, then g2
  float* G3 = carve.take<float>(kEtRows * ph);  // the cotangent ge, then g3
  float* GM = carve.take<float>(kEtPix * ph);   // the tile's gmean
  float* DW0 = carve.take<float>(kC * px);      // the block's dW0^T
  const float* W = a.wp;
  const float* b0 = a.bias;
  const float* b1 = a.bias + kC;
  const float* b2 = a.bias + 2 * kC;
  float* part = a.parts + (size_t)blockIdx.x * embed_tc_parts(kC0, kC);

  const int per_image = (a.HW + kEtPix - 1) / kEtPix, tiles = a.B * per_image;
  const int nch = (a.S + kEtSamp - 1) / kEtSamp;

  // chunk (tile t, samples from s0): x into Xd (zero past c0), ge into G3
  auto load_x = [&](float* Xd, int t, int s0) {
    const int b = t / per_image, p0 = t % per_image * kEtPix;
    if (a.xvec) {
      constexpr int kQ = kC0 / 4;
      for (int i = tid; i < kEtRows * kQ; i += kThreads) {
        const int r = i / kQ, q = i % kQ, s = s0 + r / kEtPix, p = p0 + r % kEtPix;
        const bool ok = s < a.S && p < a.HW && 4 * q < a.c0;
        const float* src = ok ? a.x + (((size_t)b * a.S + s) * a.HW + p) * a.c0 + 4 * q : a.wp;
        cp_async16_zfill(smem_addr(Xd + r * px + 4 * q), src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kEtRows * kC0; i += kThreads) {
        const int r = i / kC0, c = i % kC0, s = s0 + r / kEtPix, p = p0 + r % kEtPix;
        const bool ok = s < a.S && p < a.HW && c < a.c0;
        const float* src = ok ? a.x + (((size_t)b * a.S + s) * a.HW + p) * a.c0 + c : a.x;
        cp_async4_zfill(smem_addr(Xd + r * px + c), src, ok ? 4 : 0);
      }
    }
  };
  auto load_ge = [&](int t, int s0) {
    const int b = t / per_image, p0 = t % per_image * kEtPix;
    constexpr int kQ = kC / 4;
    for (int i = tid; i < kEtRows * kQ; i += kThreads) {
      const int r = i / kQ, q = i % kQ, s = s0 + r / kEtPix, p = p0 + r % kEtPix;
      const bool ok = a.ge != nullptr && s < a.S && p < a.HW;
      const float* src = ok ? a.ge + (((size_t)b * a.S + s) * a.HW + p) * kC + 4 * q : a.wp;
      cp_async16_zfill(smem_addr(G3 + r * ph + 4 * q), src, ok ? 16 : 0);
    }
  };
  auto load_gm = [&](int t) {
    const int b = t / per_image, p0 = t % per_image * kEtPix;
    constexpr int kQ = kC / 4;
    for (int i = tid; i < kEtPix * kQ; i += kThreads) {
      const int p = i / kQ, q = i % kQ;
      const bool ok = a.gm != nullptr && p0 + p < a.HW;
      const float* src = ok ? a.gm + ((size_t)b * a.HW + p0 + p) * kC + 4 * q : a.wp;
      cp_async16_zfill(smem_addr(GM + p * ph + 4 * q), src, ok ? 16 : 0);
    }
  };
  // out (64 x kC) = act(A . W + bias) for the row products, A at pitch pa
  // with k8s k8 steps, each output by its owner: f(r, c, v0, v1)
  auto rows_product = [&](const float* A, int pa, int k8s, const float* Wm, auto f) {
    const int m0 = warp % (4 / MTr) * 16 * MTr, jn0 = warp / (4 / MTr) * 4;
    float acc[MTr][4][4];
    zero_frags(acc);
    mm_rows_ldg(acc, A + m0 * pa, pa, k8s, Wm, k8s, jn0);
    each_frag(acc, m0, jn0 * 8, f);
  };
  auto col_sum = [&](const float* T) {  // rows in order, one column a thread
    float s = 0.0f;
    for (int r = 0; r < kEtRows; ++r) s += T[r * ph + tid];
    return s;
  };

  for (int i = tid; i < kC * px; i += kThreads) DW0[i] = 0.0f;
  float dw1[MTw][NTw][4], dw2[MTw][NTw][4];
  zero_frags(dw1);
  zero_frags(dw2);
  float db0 = 0.0f, db1 = 0.0f, db2 = 0.0f;
  const int mw = warp % 2 * (kC / 2), nw = warp / 2 * (kC / 4);

  int q = 0;  // chunks walked: X[q & 1] holds the current one
  if ((int)blockIdx.x < tiles) {
    load_x(X[0], blockIdx.x, 0);
    load_ge(blockIdx.x, 0);
    load_gm(blockIdx.x);
    cp_async_commit();
  }
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / per_image, p0 = t % per_image * kEtPix;
    for (int ch = 0; ch < nch; ++ch, ++q) {
      const int s0 = ch * kEtSamp;
      const float* Xc = X[q & 1];
      cp_async_wait_all();
      __syncthreads();  // x, ge and the tile's gmean landed; the last chunk's readers done;
                        // DW0's zeros
      // the next chunk: this tile's next samples, or the next tile's first
      const int tn = ch + 1 < nch ? t : t + gridDim.x, sn = ch + 1 < nch ? s0 + kEtSamp : 0;
      auto row_ok = [&](int r) { return s0 + r / kEtPix < a.S && p0 + r % kEtPix < a.HW; };

      // h1 = a0(x . W0 + b0)
      rows_product(Xc, px, kC0 / 8, W, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(H1 + r * ph + c) =
            make_float2(mlp_act(a.act0, v0 + b0[c]), mlp_act(a.act0, v1 + b0[c + 1]));
      });
      __syncthreads();
      // h2 = a1(h1 . W1 + b1)
      rows_product(H1, ph, kC / 8, W + oW1, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(H2 + r * ph + c) =
            make_float2(mlp_act(a.act1, v0 + b1[c]), mlp_act(a.act1, v1 + b1[c + 1]));
      });
      __syncthreads();
      // g3 = a2'(h3, ge + gmean / S) (h3 recomputed where a2 is not linear),
      // zero on rows past S or HW
      if (a.act2 != 0) {
        rows_product(H2, ph, kC / 8, W + oW2, [&](int r, int c, float v0, float v1) {
          const bool ok = row_ok(r);
          const float* gm = GM + r % kEtPix * ph + c;
          float* g3 = G3 + r * ph + c;
          const float v[2] = {v0, v1};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float h3 = mlp_act(a.act2, v[i] + b2[c + i]);
            g3[i] = ok ? mlp_act_grad(a.act2, h3, g3[i] + gm[i] / (float)a.S) : 0.0f;
          }
        });
      } else {
        for (int i = tid; i < kEtRows * kC; i += kThreads) {
          const int r = i / kC, c = i % kC;
          float* g3 = G3 + r * ph + c;
          *g3 = row_ok(r) ? *g3 + GM[r % kEtPix * ph + c] / (float)a.S : 0.0f;
        }
      }
      __syncthreads();
      if (tid < kC) db2 += col_sum(G3);
      mm_rows_t(dw2, H2, ph, mw, G3, ph, nw, kEtRows / 8);  // dW2 += h2^T . g3
      __syncthreads();  // dW2 has read h2
      // g2 = a1'(h2, g3 . W2^T), over h2 in place
      rows_product(G3, ph, kC / 8, W + oW2t, [&](int r, int c, float v0, float v1) {
        float2* hp = reinterpret_cast<float2*>(H2 + r * ph + c);
        const float2 h = *hp;
        *hp = make_float2(mlp_act_grad(a.act1, h.x, v0), mlp_act_grad(a.act1, h.y, v1));
      });
      __syncthreads();  // g2 written; g3 read for the last time
      // the next chunk's x and ge, and a next tile's gmean, under the products below
      if (tn < tiles) {
        load_x(X[(q + 1) & 1], tn, sn);
        load_ge(tn, sn);
        if (tn != t) load_gm(tn);
      }
      cp_async_commit();
      if (tid < kC) db1 += col_sum(H2);
      mm_rows_t(dw1, H1, ph, mw, H2, ph, nw, kEtRows / 8);  // dW1 += h1^T . g2
      __syncthreads();  // dW1 has read h1
      // g1 = a0'(h1, g2 . W1^T), over h1 in place
      rows_product(H2, ph, kC / 8, W + oW1t, [&](int r, int c, float v0, float v1) {
        float2* hp = reinterpret_cast<float2*>(H1 + r * ph + c);
        const float2 h = *hp;
        *hp = make_float2(mlp_act_grad(a.act0, h.x, v0), mlp_act_grad(a.act0, h.y, v1));
      });
      __syncthreads();  // g1 written
      if (tid < kC) db0 += col_sum(H1);
      // the block's dW0^T += g1^T . x in shared memory, each element by its owner
      for (int task = warp; task < (kC / 16) * P0; task += kWarps) {
        const int m0 = task % (kC / 16) * 16, n0 = task / (kC / 16) * NT0 * 8;
        float acc[1][NT0][4];
        load_frags(acc, m0, n0, DW0, px);
        mm_rows_t(acc, H1, ph, m0, Xc, px, n0, kEtRows / 8);
        each_frag(acc, m0, n0, [&](int r, int c, float v0, float v1) {
          *reinterpret_cast<float2*>(DW0 + r * px + c) = make_float2(v0, v1);
        });
      }
      if (a.dx != nullptr) {  // d(x) = g1 . W0^T, columns past c0 dropped
        for (int task = warp; task < (4 / MTx) * (kC0 / 8 / NTx); task += kWarps) {
          const int m0 = task % (4 / MTx) * 16 * MTx, jn0 = task / (4 / MTx) * NTx;
          float acc[MTx][NTx][4];
          zero_frags(acc);
          mm_rows_ldg(acc, H1 + m0 * ph, ph, kC / 8, W + oW0t, kC / 8, jn0);
          each_frag(acc, m0, jn0 * 8, [&](int r, int c, float v0, float v1) {
            if (!row_ok(r)) return;
            float* d = a.dx + (((size_t)b * a.S + s0 + r / kEtPix) * a.HW + p0 + r % kEtPix) * a.c0;
            if (c < a.c0) d[c] = v0;
            if (c + 1 < a.c0) d[c + 1] = v1;
          });
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // dW0^T complete
  // the block's partial, once: dW0 from its transpose, dW1 and dW2 from
  // registers, the bias sums
  for (int i = tid; i < kC0 * kC; i += kThreads) part[i] = DW0[i % kC * px + i / kC];
  each_frag(dw1, mw, nw, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(part + pW1 + r * kC + c) = make_float2(v0, v1);
  });
  each_frag(dw2, mw, nw, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(part + pW2 + r * kC + c) = make_float2(v0, v1);
  });
  if (tid < kC) {
    part[pB + tid] = db0;
    part[pB + kC + tid] = db1;
    part[pB + 2 * kC + tid] = db2;
  }
}

template <int kC0, int kC>
static int launch_embed_bwd_tc(const EmbedTc& a, int n_blocks, int device, cudaStream_t stream) {
  auto kernel = pathnet_embed_bwd_tf32_kernel<kC0, kC>;
  const size_t smem = embed_bwd_tc_smem(kC0, kC);
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of K4-bwd's tensor-core f32 body for the form
// (c0p, c): what ops/pathnet_fused.py's embed_bwd_tc_plan totals.
extern "C" long long wcmc_pathnet_embed_bwd_tf32_smem(int c0p, int c) {
  return (long long)embed_bwd_tc_smem(c0p, c);
}

// K4-bwd in f32 on the tensor cores: x (B, S, HW, c0) f32, c0 <= c0p; ge (B,
// S, HW, c) and gmean (B, HW, c) f32, 16-byte aligned, or null (zero); wp
// the weights packed by ops/pathnet_fused.py's pack_embed_tf32 for (c0p,
// c), 16-byte aligned, bias b0 | b1 | b2 (c each) f32 zero-padded; dx (B,
// S, HW, c0) f32 or null (not computed).  (c0p, c) is (40, 128), (40, 64)
// or (96, 128); act_i 0 linear, 1 relu, 2 leaky relu.  parts: n_blocks
// partials of dW0 (c0p x c) | dW1 | dW2 (c x c) | db0 | db1 | db2 (scratch);
// out their sum in block order, f32.
extern "C" int wcmc_pathnet_embed_bwd_tf32(const void* x, const void* ge, const void* gmean,
                                           const void* wp, const void* bias, void* dx,
                                           void* parts, void* out, int B, int S, int HW, int c0,
                                           int c0p, int c, int act0, int act1, int act2,
                                           int n_blocks, int device, void* stream) {
  if (B < 1 || S < 1 || HW < 1 || n_blocks < 1 || c0 < 1 || c0 > c0p || act0 < 0 || act0 > 2 ||
      act1 < 0 || act1 > 2 || act2 < 0 || act2 > 2 || !aligned16(wp) ||
      (ge != nullptr && !aligned16(ge)) || (gmean != nullptr && !aligned16(gmean)))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  EmbedTc a{};
  a.x = static_cast<const float*>(x);
  a.ge = static_cast<const float*>(ge);
  a.gm = static_cast<const float*>(gmean);
  a.wp = static_cast<const float*>(wp);
  a.bias = static_cast<const float*>(bias);
  a.dx = static_cast<float*>(dx);
  a.parts = static_cast<float*>(parts);
  a.B = B, a.S = S, a.HW = HW, a.c0 = c0;
  a.xvec = c0 % 4 == 0 && aligned16(x);
  a.act0 = act0, a.act1 = act1, a.act2 = act2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (c0p == 40 && c == 128) {
    err = launch_embed_bwd_tc<40, 128>(a, n_blocks, device, s);
  } else if (c0p == 40 && c == 64) {
    err = launch_embed_bwd_tc<40, 64>(a, n_blocks, device, s);
  } else if (c0p == 96 && c == 128) {
    err = launch_embed_bwd_tc<96, 128>(a, n_blocks, device, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return reduce_parts(a.parts, static_cast<float*>(out), n_blocks, embed_tc_parts(c0p, c), s);
}
