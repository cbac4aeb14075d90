// K4-fwd: the per-sample embedding MLP with its fused sample mean.
//
//   h_{i+1}        = bf16(act_i(h_i . W_i + b_i)),  h_0 = x[b, s, p, :],  i = 0, 1, 2
//   e[b, s, p, :]  = h_3,   mean[b, p, :] = sum_s f32(e[b, s, p, :]) / S
//
// with a per-layer activation (relu, leaky relu of slope 0.01, or linear;
// mlp_act of mlp.cuh, shared with K10): PathNet runs relu-relu-linear,
// the SBMC Multisteps embedding leaky x 3.  Those two chains are
// template instantiations with the activations fixed at compile time;
// any other chain runs a generic one that reads them at run time.  Replaces
// wcmc_tpu/ops/pathnet_fused.py::_embed_fwd_pallas (Pallas body
// _embed_fwd_kernel).  bf16 inputs and weights, f32 accumulation and f32
// biases, a bf16 rounding after every layer exactly where the TPU kernel
// rounds, and the mean taken over the rounded embedding.
//
// What bounds it on the H100 (bytes over 3.35 TB/s, flops over the 989
// TFLOP/s bf16 dense peak), at the path shapes of 8 images x 8 spp x 128^2
// px (1,048,576 rows), in the three forms the models run:
// - Multisteps' embedding (95 -> 128 -> 128 -> 128, leaky relu x 3; SBMC):
//   x (199 MB) in, e (268 MB) and the mean (67 MB) out: 535 MB, 0.160 ms,
//   against 94 GFLOP, 0.096 ms.  Bytes.
// - KPCN's two PathNet branches merged (36 -> 128 -> 128 -> 128, relu,
//   relu, linear): 75 + 268 + 67 MB, 0.123 ms, against 78 GFLOP (82 at
//   C0 padded to 48), 0.083 ms.  Bytes, the flops close behind.
// - The 64-wide PathNet (LBMC's and SBMC's, 36 -> 64 -> 64 -> 64): 75 +
//   134 + 34 MB, 0.073 ms, against 22 GFLOP.  Bytes.
// A pure stream with no weight gradients, so the design keeps copies in
// flight while the tensor cores work.  Two bodies:
// - The tiled kernel (pathnet_embed_tiled_kernel) runs those three forms
//   (C1 = C2 = C3 = 128 or 64, C0 up to 96).  Persistent blocks of two
//   warpgroups; each warpgroup walks its own (image, 64-pixel) units, so
//   one's epilogues run under the other's products, and takes a unit's
//   samples in order, one sample a product (64 rows, a wgmma's m64): a
//   thread owns the same (pixel, column) elements of every sample, and the
//   mean adds up in its registers in sample order, with no shuffle,
//   barrier or atomic; it leaves once per unit.  Two launches repeat bit
//   for bit.
// - The weights are the pack K4-bwd reads (ops/pathnet_fused.py,
//   pack_embed_weights; one pack per parameter value, shared by a train
//   step's forward and backward): blocked W0 (k0 = 48 or 96 rows), the
//   first C rows of blocked W1 and W2 (their blocked row groups are
//   contiguous), the biases in f32, bulk-copied into shared memory once
//   per block.  The 64-wide form reads the pack's first 64 columns with
//   the same descriptor strides, at n64.
// - A sample's 64 x rows are one contiguous span of 64 C0 bf16 values; it
//   streams through a ring of landing stages per warpgroup (3 stages at k0
//   96, 4 at 48) by 16-byte cp.async with an mbarrier a stage where the
//   span starts on 16 bytes (every path shape: the first pixel is a
//   multiple of 64 and HW C0 2 a multiple of 16), by 2-byte loads
//   otherwise.  A stage is refilled with the item kStages ahead once every
//   warp has read it.
// - The layer chain in registers: layer 1's A fragments are loaded from
//   the landing stage (32-bit loads for an even C0, 2-byte loads for an
//   odd one, whose rows pair on odd offsets; columns past C0 zero), and
//   each layer's m64 accumulator, after bias, activation and the bf16
//   rounding, is already the next layer's A fragment (wgmma with A from
//   registers), so h1 and h2 never touch shared memory and no barrier
//   separates the layers.  Each layer is summed from zero in k16 steps in
//   order and its bias added in the epilogue, as the row-chunk body sums.
// - e is rounded in registers, staged per warpgroup in one of two 64 x C
//   bf16 tiles (16-byte pieces XOR-swizzled by row, so the epilogue's
//   writes and the copy's reads hit 32 banks) and leaves by 16-byte
//   stores, a sample's 64 rows being one contiguous span; the mean leaves
//   once per unit from registers.  One named barrier per warpgroup and
//   sample.
// - Shared memory (EmbedFwdSmem, embed_fwd_plan): 231,040 bytes at k0 96
//   and C 128, 194,176 at k0 48 and C 128, 128,640 at k0 48 and C 64, of
//   the 232,448 a block may opt into: one block per SM.
// - The row-chunk body (pathnet_embed_kernel) keeps every other form:
//   run-time activations, other widths, C0 above 96.  A block owns a tile
//   of 64 pixels of one image and loops over S inside, keeping the f32
//   mean in shared memory and writing it once; no atomics.  Blocks are
//   persistent (one per SM, walking over tiles) and stage the three weight
//   matrices in shared memory once; the layers run on warp-level wmma
//   through shared staging; loads are not pipelined.
#include "hopper.cuh"
#include "mlp.cuh"

namespace wcmc {

constexpr int kEmbedRows = 64;

struct EmbedDims {
  int c0, c1, c2, c3, k0;
  int act0, act1, act2;  // activation codes of mlp_act
};

inline size_t embed_smem(const EmbedDims& d) {
  return smem_bytes((size_t)d.k0 * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)d.c1 * pitch_bf16(d.c2), 2) +
         smem_bytes((size_t)d.c2 * pitch_bf16(d.c3), 2) +
         smem_bytes((size_t)kEmbedRows * pitch_bf16(d.k0), 2) +
         smem_bytes((size_t)kEmbedRows * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)kEmbedRows * pitch_bf16(d.c2), 2) +
         smem_bytes((size_t)kWarps * 256, 4) + smem_bytes((size_t)kEmbedRows * d.c3, 4) +
         smem_bytes(d.c1, 4) + smem_bytes(d.c2, 4) + smem_bytes(d.c3, 4);
}

// kA0..kA2: the layers' activation codes, fixed at compile time for the
// two chains the models run; -1 reads them from d at run time.
template <int kA0, int kA1, int kA2>
__global__ void __launch_bounds__(kThreads)
    pathnet_embed_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                         const float* __restrict__ b0, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, bf16* __restrict__ e,
                         float* __restrict__ mean, int B, int S, int HW, EmbedDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int p_w0 = pitch_bf16(d.c1), p_w1 = pitch_bf16(d.c2), p_w2 = pitch_bf16(d.c3);
  const int p_x = pitch_bf16(d.k0), p_h1 = pitch_bf16(d.c1), p_h2 = pitch_bf16(d.c2);
  SmemCarver carve{smem, 0};
  bf16* s_w0 = carve.take<bf16>((size_t)d.k0 * p_w0);
  bf16* s_w1 = carve.take<bf16>((size_t)d.c1 * p_w1);
  bf16* s_w2 = carve.take<bf16>((size_t)d.c2 * p_w2);
  bf16* s_x = carve.take<bf16>((size_t)kEmbedRows * p_x);
  bf16* s_h1 = carve.take<bf16>((size_t)kEmbedRows * p_h1);
  bf16* s_h2 = carve.take<bf16>((size_t)kEmbedRows * p_h2);
  float* s_stage = carve.take<float>((size_t)kWarps * 256);
  float* s_mean = carve.take<float>((size_t)kEmbedRows * d.c3);
  float* s_b0 = carve.take<float>(d.c1);
  float* s_b1 = carve.take<float>(d.c2);
  float* s_b2 = carve.take<float>(d.c3);

  // weights once per (persistent) block; W0's rows are zero-padded to k0
  load_bf16_tile(s_w0, p_w0, w0, d.c0, d.c1, d.k0, d.c1);
  load_bf16_tile(s_w1, p_w1, w1, d.c1, d.c2, d.c1, d.c2);
  load_bf16_tile(s_w2, p_w2, w2, d.c2, d.c3, d.c2, d.c3);
  for (int i = threadIdx.x; i < d.c1; i += blockDim.x) s_b0[i] = b0[i];
  for (int i = threadIdx.x; i < d.c2; i += blockDim.x) s_b1[i] = b1[i];
  for (int i = threadIdx.x; i < d.c3; i += blockDim.x) s_b2[i] = b2[i];
  __syncthreads();

  const int tiles_per_image = (HW + kEmbedRows - 1) / kEmbedRows;
  const int n_tiles = B * tiles_per_image;
  const float inv_s = 1.0f / (float)S;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_image;
    const int row0 = (t % tiles_per_image) * kEmbedRows;
    const int rows = min(kEmbedRows, HW - row0);
    for (int s = 0; s < S; ++s) {
      const size_t slab = ((size_t)b * S + s) * HW + row0;
      const bf16* xs = x + slab * d.c0;
      for (int i = threadIdx.x; i < kEmbedRows * d.k0; i += blockDim.x) {
        const int r = i / d.k0, c = i % d.k0;
        s_x[r * p_x + c] = (r < rows && c < d.c0) ? xs[(size_t)r * d.c0 + c] : zero;
      }
      __syncthreads();
      tile_mma(s_x, p_x, s_w0, p_w0, kEmbedRows, d.c1, d.k0, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 s_h1[r * p_h1 + c] = __float2bfloat16(fixed_act<kA0>(d.act0, v + s_b0[c]));
               });
      __syncthreads();
      tile_mma(s_h1, p_h1, s_w1, p_w1, kEmbedRows, d.c2, d.c1, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 s_h2[r * p_h2 + c] = __float2bfloat16(fixed_act<kA1>(d.act1, v + s_b1[c]));
               });
      __syncthreads();
      bf16* es = e + slab * d.c3;
      tile_mma(s_h2, p_h2, s_w2, p_w2, kEmbedRows, d.c3, d.c2, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 const bf16 h = __float2bfloat16(fixed_act<kA2>(d.act2, v + s_b2[c]));
                 if (r < rows) es[(size_t)r * d.c3 + c] = h;
                 // rounded as written (never contracted into an fma), as the
                 // tiled body adds
                 const float contrib = __fmul_rn(__bfloat162float(h), inv_s);
                 float* m = s_mean + r * d.c3 + c;
                 *m = (s == 0) ? contrib : __fadd_rn(*m, contrib);
               });
      __syncthreads();
    }
    float* ms = mean + ((size_t)b * HW + row0) * d.c3;
    for (int i = threadIdx.x; i < rows * d.c3; i += blockDim.x) ms[i] = s_mean[i];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The tiled forms: Multisteps' embedding, KPCN's merged PathNet, the 64-wide PathNet
// ---------------------------------------------------------------------------

constexpr int kTPix = 64;       // pixels of one image per unit; one sample a product (m64)
constexpr int kTThreads = 256;  // two warpgroups, each walking its own units
constexpr int kTPackW = 128;    // the pack's columns (pack_embed_weights pads every layer to 128)
constexpr int kTPackRG = kTPackW / 8 * 128;  // bytes between 8-row groups of a packed matrix

// The block's shared memory, buffer by buffer in the order the kernel
// carves them (each a multiple of 128 bytes); ops/pathnet_fused.py's
// embed_fwd_plan lists the same.  kK0: C0 padded (48 or 96); kC: C1 = C2 =
// C3 (128 or 64).  The ring and the e stages: one each per warpgroup.
template <int kK0, int kC, int kStages>
struct EmbedFwdSmem {
  static constexpr int kW0 = kK0 * kTPackW * 2;  // blocked W0, all 128 packed columns
  static constexpr int kW = kC * kTPackW * 2;    // the first kC rows of blocked W1 / W2
  static constexpr int kBias = 3 * kTPackW * 4;  // b0 | b1 | b2, f32
  static constexpr int kStage = kTPix * kK0 * 2;  // a sample's x span (64 C0 <= 64 k0 values)
  static constexpr int kRing = kStages * kStage;
  static constexpr int kOut = kTPix * kC * 2;    // a staged bf16 e tile (two a warpgroup)
  static constexpr int kBars = (1 + 2 * kStages) * 8;
  static size_t total() {
    return smem_bytes(kW0, 1) + 2 * smem_bytes(kW, 1) + smem_bytes(kBias, 1) +
           smem_bytes(2 * kRing, 1) + smem_bytes(4 * kOut, 1) + smem_bytes(kBars, 1);
  }
};

struct EmbedFwdArgs {
  const bf16* x;      // (B, S, HW, c0)
  const bf16* w;      // pack_embed_weights: blocked W0 (k0 x 128) | W1 | W2 (128 x 128)
  const float* bias;  // b0 | b1 | b2, 128 each
  bf16* e;            // (B, S, HW, kC)
  float* mean;        // (B, HW, kC)
  int B, S, HW, c0;
};

// The pair of bf16 values at columns col, col + 1 of a landing-stage row
// (row: its first element), as the low and high halves of a fragment
// register; columns past c0 are zero.  kEven: c0 is even, so the pair is
// one aligned 32-bit word.
template <bool kEven>
__device__ inline unsigned x_pair(const unsigned short* row, int col, int c0) {
  if constexpr (kEven) {
    return col < c0 ? *reinterpret_cast<const unsigned*>(row + col) : 0u;
  } else {
    const unsigned lo = col < c0 ? row[col] : 0u, hi = col + 1 < c0 ? row[col + 1] : 0u;
    return lo | hi << 16;
  }
}

// The epilogue of a hidden layer: bf16(act(acc + bias)) as the next
// layer's A fragments (k16 step k: n8 tiles 2 k and 2 k + 1).
template <int kA, int kN8>
__device__ inline void hidden_epilogue(const float (&acc)[kN8][4], unsigned (&h)[kN8 / 2][4],
                                       const float* bias, int t4) {
#pragma unroll
  for (int j = 0; j < kN8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(mlp_act(kA, acc[j][2 * r] + bb.x),
                                                     mlp_act(kA, acc[j][2 * r + 1] + bb.y));
      h[j / 2][2 * (j % 2) + r] = *reinterpret_cast<const unsigned*>(&v);
    }
  }
}

// kK0: C0 padded (48 or 96); kC: C1 = C2 = C3 (128 or 64); kA0..kA2: the
// layers' activation codes; kStages: the x ring's stages.
template <int kK0, int kC, int kA0, int kA1, int kA2, int kStages>
__global__ void __launch_bounds__(kTThreads, 1) pathnet_embed_tiled_kernel(EmbedFwdArgs a) {
  using Sm = EmbedFwdSmem<kK0, kC, kStages>;
  constexpr int kN8 = kC / 8;        // n8 tiles of a layer's output
  constexpr int kChunks = kC / 8;    // 16-byte pieces of an e row
  static_assert((kK0 == 48 || kK0 == 96) && (kC == 64 || kC == 128), "the tiled forms");
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarver carve{smem, 0};
  unsigned char* s_w0 = carve.take<unsigned char>(Sm::kW0);
  unsigned char* s_w1 = carve.take<unsigned char>(Sm::kW);
  unsigned char* s_w2 = carve.take<unsigned char>(Sm::kW);
  float* s_b = carve.take<float>(3 * kTPackW);
  unsigned char* s_ring = carve.take<unsigned char>(2 * Sm::kRing);
  unsigned char* s_out = carve.take<unsigned char>(4 * Sm::kOut);
  unsigned long long* s_bars = carve.take<unsigned long long>(1 + 2 * kStages);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what EmbedFwdSmem::total() sums

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  const int S = a.S, HW = a.HW, c0 = a.c0;
  const int per_image = (HW + kTPix - 1) / kTPix, n_units = a.B * per_image;
  // warpgroup wg of block x is walker 2 x + wg of 2 gridDim.x: units vb,
  // vb + nvb, ...; a unit's items are its S samples
  const int vb = 2 * (int)blockIdx.x + wg, nvb = 2 * (int)gridDim.x;
  const int n_mine = vb < n_units ? (n_units - vb + nvb - 1) / nvb : 0;
  const int n_items = n_mine * S;

  const unsigned u_w0 = smem_addr(s_w0), u_w1 = smem_addr(s_w1), u_w2 = smem_addr(s_w2);
  unsigned char* const ring = s_ring + wg * Sm::kRing;
  const unsigned u_ring = smem_addr(ring);
  unsigned char* const out = s_out + wg * 2 * Sm::kOut;
  // mbarriers: 0 the weights, then each warpgroup's ring stages
  const unsigned bar_w = smem_addr(s_bars), bar_r = bar_w + 8 * (1 + kStages * wg);
  const int named = 1 + wg;  // the warpgroup's named barrier
  if (tid == 0) {
    mbar_init(bar_w, 1);
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(bar_w + 8 * (1 + i), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_mine == 0) return;  // only the second warpgroup of the last block can lack a unit
  if (tid == 0) {
    mbar_expect_tx(bar_w, Sm::kW0 + 2 * Sm::kW + Sm::kBias);
    bulk_copy(u_w0, a.w, Sm::kW0, bar_w);
    bulk_copy(u_w1, a.w + kK0 * kTPackW, Sm::kW, bar_w);
    bulk_copy(u_w2, a.w + (kK0 + kTPackW) * kTPackW, Sm::kW, bar_w);
    bulk_copy(smem_addr(s_b), a.bias, Sm::kBias, bar_w);
  }

  auto unit_of = [&](int u, int& b, int& p0, int& npx) {
    const int t = vb + u * nvb;
    b = t / per_image;
    p0 = (t % per_image) * kTPix;
    npx = min(kTPix, HW - p0);
  };
  // Item c of the walk (unit c / S, sample c % S) into ring stage c %
  // kStages by the warpgroup's threads: its span of npx C0 values as it
  // lies in memory, 16 bytes a cp.async (the tail piece zero-filled) where
  // it starts on 16 bytes, 2 bytes a load otherwise.  Each thread then
  // arrives on the stage's mbarrier once its copies have landed.
  auto fetch = [&](int c) {
    int b, p0, npx;
    unit_of(c / S, b, p0, npx);
    const bf16* src = a.x + (((size_t)b * S + c % S) * HW + p0) * c0;
    const int st = c % kStages, len = npx * c0;
    if (aligned16(src)) {
      const int bytes = 2 * len;
      for (int i = wt; 16 * i < bytes; i += 128)
        cp_async16_zfill(u_ring + st * Sm::kStage + 16 * i,
                         reinterpret_cast<const char*>(src) + 16 * i, min(16, bytes - 16 * i));
      cp_async_mbar_arrive(bar_r + 8 * st);
    } else {
      bf16* dst = reinterpret_cast<bf16*>(ring + st * Sm::kStage);
      for (int i = wt; i < len; i += 128) dst[i] = src[i];
      mbar_arrive(bar_r + 8 * st);
    }
  };

  for (int c = 0; c < kStages && c < n_items; ++c) fetch(c);
  mbar_wait(bar_w, 0);

  const bool even = c0 % 2 == 0;
  const float inv_s = 1.0f / (float)S;
  float acc[kN8][4];            // a layer's accumulators
  float mean[kN8][4];           // the unit's mean, summed in sample order
  unsigned xf[kK0 / 16][4];     // layer 1's A fragments (the sample's x rows)
  unsigned hf[kN8 / 2][4];      // layer 2's and 3's (h1, then h2)
  // the lane's accumulator elements (n8 tile j, row half r): rows r_lane +
  // 8 r of the unit, columns 8 j + 2 t4 and + 1
  const int r_lane = 16 * warp + g8;

  int c = 0;
  for (int u = 0; u < n_mine; ++u) {
    int b, p0, npx;
    unit_of(u, b, p0, npx);
    for (int s = 0; s < S; ++s, ++c) {
      const int st = c % kStages;
      mbar_wait(bar_r + 8 * st, (c / kStages) & 1);
      // layer 1's A: rows r_lane and r_lane + 8 of the span, columns 16 k +
      // 2 t4 (+ 8) of k16 step k
      const unsigned short* x0 =
          reinterpret_cast<const unsigned short*>(ring + st * Sm::kStage) + r_lane * c0;
      const unsigned short* x1 = x0 + 8 * c0;
#pragma unroll
      for (int k = 0; k < kK0 / 16; ++k) {
        const int col = 16 * k + 2 * t4;
        if (even) {
          xf[k][0] = x_pair<true>(x0, col, c0), xf[k][1] = x_pair<true>(x1, col, c0);
          xf[k][2] = x_pair<true>(x0, col + 8, c0), xf[k][3] = x_pair<true>(x1, col + 8, c0);
        } else {
          xf[k][0] = x_pair<false>(x0, col, c0), xf[k][1] = x_pair<false>(x1, col, c0);
          xf[k][2] = x_pair<false>(x0, col + 8, c0), xf[k][3] = x_pair<false>(x1, col + 8, c0);
        }
      }
      // h1 = bf16(a0(x . W0 + b0)), h2 = bf16(a1(h1 . W1 + b1)): each summed
      // from zero in k16 steps, the bias in the epilogue
      zero_acc(acc);
      fence_acc(acc);
      fence_frag(xf);
      wgmma_fence();
      mm_rs<kN8, kK0 / 16, kTPackRG>(acc, xf, u_w0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      fence_frag(xf);
      hidden_epilogue<kA0>(acc, hf, s_b, t4);
      zero_acc(acc);
      fence_acc(acc);
      fence_frag(hf);
      wgmma_fence();
      mm_rs<kN8, kC / 16, kTPackRG>(acc, hf, u_w1);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      fence_frag(hf);
      hidden_epilogue<kA1>(acc, hf, s_b + kTPackW, t4);
      zero_acc(acc);
      fence_acc(acc);
      fence_frag(hf);
      wgmma_fence();
      mm_rs<kN8, kC / 16, kTPackRG>(acc, hf, u_w2);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      fence_frag(hf);

      // e = bf16(a2(h2 . W2 + b2)) into e stage c % 2 (row-major rows of
      // kC, 16-byte piece j of row r at piece j ^ (r % 8)); the mean adds
      // f32(e) / S in sample order, each product and sum rounded as
      // written (never contracted into an fma)
      unsigned char* const ob = out + (c % 2) * Sm::kOut;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(s_b + 2 * kTPackW + 8 * j + 2 * t4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r_lane + 8 * r;
          const __nv_bfloat162 h = __floats2bfloat162_rn(mlp_act(kA2, acc[j][2 * r] + bb.x),
                                                         mlp_act(kA2, acc[j][2 * r + 1] + bb.y));
          *reinterpret_cast<__nv_bfloat162*>(ob + row * kC * 2 + ((j ^ (row & 7)) * 16) +
                                             4 * t4) = h;
          const float m0 = __fmul_rn(__low2float(h), inv_s);
          const float m1 = __fmul_rn(__high2float(h), inv_s);
          mean[j][2 * r] = s == 0 ? m0 : __fadd_rn(mean[j][2 * r], m0);
          mean[j][2 * r + 1] = s == 0 ? m1 : __fadd_rn(mean[j][2 * r + 1], m1);
        }
      }
      // every warp has read the x stage and written its e rows
      named_sync(named, 128);
      if (c + kStages < n_items) fetch(c + kStages);
      // the sample's e rows: one contiguous span of npx kC values, 16 bytes
      // a store
      uint4* const to = reinterpret_cast<uint4*>(a.e + (((size_t)b * S + s) * HW + p0) * kC);
#pragma unroll
      for (int m = 0; m < kTPix * kChunks / 128; ++m) {
        const int i = wt + 128 * m, row = i / kChunks, pc = i % kChunks;
        if (row < npx)
          to[i] = *reinterpret_cast<const uint4*>(ob + row * kC * 2 + ((pc ^ (row & 7)) * 16));
      }
    }
    // the unit's mean, once
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r_lane + 8 * r;
        if (row < npx)
          *reinterpret_cast<float2*>(a.mean + ((size_t)b * HW + p0 + row) * kC + 8 * j + 2 * t4) =
              make_float2(mean[j][2 * r], mean[j][2 * r + 1]);
      }
  }
}

}  // namespace wcmc

using namespace wcmc;

template <int kA0, int kA1, int kA2>
static cudaError_t launch_embed(const void* x, const void* w0, const void* b0, const void* w1,
                                const void* b1, const void* w2, const void* b2, void* e,
                                void* mean, int B, int S, int HW, const EmbedDims& d,
                                int n_blocks, int device, cudaStream_t stream) {
  const size_t smem = embed_smem(d);
  cudaError_t err = set_smem(pathnet_embed_kernel<kA0, kA1, kA2>, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kEmbedRows - 1) / kEmbedRows);
  if (n_tiles == 0) return cudaSuccess;
  const int grid = (int)(n_tiles < n_blocks ? n_tiles : n_blocks);
  pathnet_embed_kernel<kA0, kA1, kA2><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w0), static_cast<const float*>(b0),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(e), static_cast<float*>(mean), B, S, HW,
      d);
  return cudaGetLastError();
}

template <int kK0, int kC, int kA0, int kA1, int kA2>
static cudaError_t launch_tiled(const EmbedFwdArgs& args, int n_blocks, int device,
                                cudaStream_t stream) {
  constexpr int kStages = kK0 == 96 ? 3 : 4;
  const size_t smem = EmbedFwdSmem<kK0, kC, kStages>::total();
  auto* kernel = pathnet_embed_tiled_kernel<kK0, kC, kA0, kA1, kA2, kStages>;
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long units = (long long)args.B * ((args.HW + kTPix - 1) / kTPix);
  if (units == 0) return cudaSuccess;
  const long long blocks = (units + 1) / 2;  // two warpgroups a block, a unit each at least
  const int grid = (int)(blocks < n_blocks ? blocks : n_blocks);
  kernel<<<grid, kTThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// The tiled form of an embedding (1 Multisteps', leaky relu x 3, 128 wide;
// 2 KPCN's merged PathNet, relu-relu-linear, 128 wide; 3 the 64-wide
// PathNet), or 0 for the row-chunk body.
static int tiled_form(int c0, int c1, int c2, int c3, int act0, int act1, int act2) {
  if (c0 < 1 || c0 > 96 || c1 != c2 || c2 != c3) return 0;
  if (act0 == 2 && act1 == 2 && act2 == 2 && c1 == 128) return 1;
  if (act0 == 1 && act1 == 1 && act2 == 0) return c1 == 128 ? 2 : c1 == 64 ? 3 : 0;
  return 0;
}

// The dynamic shared memory, in bytes, that K4-fwd gives a block of the
// form (the tiled body's, or the row-chunk body's for every other form):
// what ops/pathnet_fused.py's embed_fwd_plan totals.
extern "C" long long wcmc_pathnet_embed_tiled_smem(int c0, int c1, int c2, int c3, int act0,
                                                   int act1, int act2) {
  const int form = tiled_form(c0, c1, c2, c3, act0, act1, act2);
  if (form == 0)
    return (long long)embed_smem(EmbedDims{c0, c1, c2, c3, round_up(c0, 16), act0, act1, act2});
  const bool k96 = c0 > 48;
  if (form == 3)
    return (long long)(k96 ? EmbedFwdSmem<96, 64, 3>::total() : EmbedFwdSmem<48, 64, 4>::total());
  return (long long)(k96 ? EmbedFwdSmem<96, 128, 3>::total() : EmbedFwdSmem<48, 128, 4>::total());
}

// The tiled forms (tiled_form): x (B, S, HW, c0) bf16; wpack, bpack: the
// embedding's parameters as ops/pathnet_fused.py's pack_embed_weights lays
// them out (W0 zero-padded to 48 rows for c0 <= 48, 96 above); e (B, S,
// HW, c3) bf16; mean (B, HW, c3) f32.  All contiguous, every pointer
// 16-byte aligned.  n_blocks: the most persistent blocks to launch (the
// SM count).
extern "C" int wcmc_pathnet_embed_tiled(const void* x, const void* wpack, const void* bpack,
                                        void* e, void* mean, int B, int S, int HW, int c0,
                                        int c1, int c2, int c3, int act0, int act1, int act2,
                                        int n_blocks, int device, void* stream) {
  const int form = tiled_form(c0, c1, c2, c3, act0, act1, act2);
  if (form == 0 || S < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  for (const void* p : {x, wpack, bpack, static_cast<const void*>(e), static_cast<const void*>(mean)})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EmbedFwdArgs args{static_cast<const bf16*>(x), static_cast<const bf16*>(wpack),
                          static_cast<const float*>(bpack), static_cast<bf16*>(e),
                          static_cast<float*>(mean), B, S, HW, c0};
  const bool k96 = c0 > 48;
  if (form == 1)
    return k96 ? launch_tiled<96, 128, 2, 2, 2>(args, n_blocks, device, s)
               : launch_tiled<48, 128, 2, 2, 2>(args, n_blocks, device, s);
  if (form == 2)
    return k96 ? launch_tiled<96, 128, 1, 1, 0>(args, n_blocks, device, s)
               : launch_tiled<48, 128, 1, 1, 0>(args, n_blocks, device, s);
  return k96 ? launch_tiled<96, 64, 1, 1, 0>(args, n_blocks, device, s)
             : launch_tiled<48, 64, 1, 1, 0>(args, n_blocks, device, s);
}

// The row-chunk body: x (B, S, HW, c0) bf16; w0 (c0, c1), w1 (c1, c2), w2 (c2, c3) bf16
// row-major; b0..b2 f32; e (B, S, HW, c3) bf16; mean (B, HW, c3) f32.
// All contiguous; c1, c2, c3 multiples of 16; act0..act2 the layers'
// activation codes (0 linear, 1 relu, 2 leaky relu).  n_blocks:
// persistent blocks to launch (the SM count).
extern "C" int wcmc_pathnet_embed(const void* x, const void* w0, const void* b0, const void* w1,
                                  const void* b1, const void* w2, const void* b2, void* e,
                                  void* mean, int B, int S, int HW, int c0, int c1, int c2, int c3,
                                  int act0, int act1, int act2, int n_blocks, int device,
                                  void* stream) {
  if (c0 < 1 || c1 % 16 || c2 % 16 || c3 % 16 || c1 < 16 || c2 < 16 || c3 < 16 || S < 1 ||
      n_blocks < 1 || act0 < 0 || act0 > 2 || act1 < 0 || act1 > 2 || act2 < 0 || act2 > 2)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const EmbedDims d{c0, c1, c2, c3, round_up(c0, 16), act0, act1, act2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act0 == 1 && act1 == 1 && act2 == 0)  // PathNet: relu, relu, linear
    return launch_embed<1, 1, 0>(x, w0, b0, w1, b1, w2, b2, e, mean, B, S, HW, d, n_blocks,
                                 device, s);
  if (act0 == 2 && act1 == 2 && act2 == 2)  // Multisteps: leaky relu x 3
    return launch_embed<2, 2, 2>(x, w0, b0, w1, b1, w2, b2, e, mean, B, S, HW, d, n_blocks,
                                 device, s);
  return launch_embed<-1, -1, -1>(x, w0, b0, w1, b1, w2, b2, e, mean, B, S, HW, d, n_blocks,
                                  device, s);
}
