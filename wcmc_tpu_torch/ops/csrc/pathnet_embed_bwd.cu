// K4-bwd: the gradients of the per-sample embedding MLP (K4-fwd), from
// the cotangents of its two outputs (the per-sample embedding and its
// sample mean).
//
//   h1 = bf16(a0(x . W0 + b0)),  h2 = bf16(a1(h1 . W1 + b1)),  h3 = bf16(a2(h2 . W2 + b2))
//   g3 = a2'(h3, f32(ge) + gmean / S)
//   g2 = a1'(h2, bf16(g3) . W2^T),  g1 = a0'(h1, bf16(g2) . W1^T)
//   dW2 = h2^T . bf16(g3),  dW1 = h1^T . bf16(g2),  dW0 = x^T . bf16(g1)   (f32, summed over all rows)
//   db2 = sum g3,  db1 = sum g2,  db0 = sum g1                              (f32, unrounded)
//   dx  = bf16(bf16(g1) . W0^T)                                            (only when asked)
//
// a' is taken through the post-activation value (mlp_act_grad of
// mlp.cuh): relu passes where h > 0, leaky relu where h >= 0 (0.01
// elsewhere), linear everywhere.  A cotangent passed as null is zero.
// The hiddens are recomputed from x (nothing was saved in the forward),
// rounded where the forward rounds; a linear output layer is not
// recomputed.  Replaces wcmc_tpu/ops/pathnet_fused.py::_embed_bwd_pallas
// (pallas_call :222, body _embed_bwd_kernel :88, compute_dx False or
// True), which keeps its weight-gradient sums resident in VMEM across a
// sequential grid.  Two forms, each a template instantiation with its
// activations and d(x) fixed at compile time: Multisteps' leaky x 3 with
// d(x) (under use_llpm_buf the features carry the learned p-buffer, so
// d(x) flows to the PathNet) and PathNet's relu-relu-linear without d(x)
// (the paths are data).  Two bodies: the tiled one (below) runs
// Multisteps' form and PathNet's chains up to 128 wide (KPCN's two
// branches merged, LBMC's and SBMC's PathNet); PathNet's wider chains keep
// the row-chunk body of the first port (at the end of the file).
//
// What bounds it on the H100 (8 patches x 8 spp x 128^2 px = 1,048,576
// rows): operations for the Multisteps form, 95 -> 128 -> 128 -> 128 with
// d(x): 135,168 MACs a row, 2.8e11 flops, 0.286 ms at the bf16 dense peak
// (x, ge, dx and gmean ~0.73 GB, 0.22 ms); operations for KPCN's PathNet,
// 36 -> 128 -> 128 -> 128: 0.193 ms; bytes for LBMC's and SBMC's PathNet,
// 36 -> 64 -> 64 -> 64: x and ge ~0.21 GB, 0.073 ms.
//
// The tiled body.  Every chain runs at widths C1 = C2 = C3 = 128 (a
// narrower one zero-padded to them, which is exact: its pad columns stay
// zero through the chain and its pad gradients are cut off by the
// wrapper) and C0 zero-padded to k0 = 48 or 96, or, above 96, to slabs of
// 96 (see "Wide rows" below).
// - Persistent blocks, one per SM, 256 threads (two warpgroups); each
//   takes tiles of 32 pixels of one image in turn, and each tile's samples
//   in chunks of 2: 64 rows per product (a wgmma's m64), sample-major (row
//   r: pixel r % 32 of sample s0 + r / 32), so a sample's rows are one
//   contiguous span of x and of dx.  Each warpgroup owns half of every
//   128-wide product's columns, and half of the rows of each weight
//   gradient.
// - Weight gradients on chip: dW1 and dW2 stay in registers for the
//   block's whole run (each warp 16 of their 128 rows x 128 columns: 2 x 64
//   f32 a thread) and go to the block's partials once, at the end.  dW0^T
//   = g1^T . x is a transient product per chunk (m64n48, once or twice),
//   added into an f32 copy of dW0^T in shared memory by the thread that
//   owns each element.  The bias sums are warp shuffles in a fixed order,
//   kept in 6 registers a thread (the lane of row g takes n8 tile g).
//   Each element of every sum is added by one thread in a fixed order; a
//   second launch adds the blocks' partials in block order: no float
//   atomics, two launches give the same bits.
// - Weights in shared memory: W0, W1 and W2, packed once per parameter
//   value by the wrapper (ops/pathnet_fused.py, pack_embed_weights) as
//   8 x 8 core matrices ("blocked"), zero-padded, the biases beside them in
//   f32, come in by three bulk copies once per block.  One copy of each
//   serves both ways: W is read with its rows along K, W^T with its rows
//   along N.  The chunk's x, h1, h2 and cotangent tiles are blocked too, so
//   h^T and x^T, the operands of the weight gradients, are the same tiles
//   read the other way; no copy is transposed.
// - Copies: a sample's x rows within a tile are one span of npx C0 bf16
//   values; it comes by 16-byte cp.async into a landing stage (the tail
//   piece zero-filled) where it starts on 16 bytes, which it does when the
//   first pixel, the pixel count per image and the tensor are aligned to 8
//   pixels (the training shapes), and by 2-byte loads otherwise; then all
//   threads lay it out into the blocked x tile.  Chunk c + 1's spans land
//   while chunk c computes: the landing stage is free once chunk c is laid
//   out, so a second stage would overlap nothing more (and would not fit
//   beside dW0^T).  ge (rows of C3 bf16, 16-byte aligned) comes by
//   16-byte cp.async straight into its blocked tile, issued as soon as
//   chunk c's cotangent tile is read for the last time; gmean once per
//   pixel tile into a tile of f32 rows (16-byte pieces XOR-swizzled by
//   pixel, so the epilogue's reads hit 32 banks), divided by S there once.
//   Each thread arrives on the buffer's mbarrier once its copies land.
//   d(x) is staged as spans in the freed h2 tile and leaves by 16-byte
//   stores where the span is aligned, 2-byte stores otherwise.
// - Products on wgmma (m64n64k16, m64n128k16, m64n48k16; bf16, f32
//   accumulators), both operands in shared memory through descriptors (no
//   swizzle).  dW2 and the g2 product are one group, dW1 and the g1 product
//   another.
// - Epilogues out of the accumulator registers (each warp's 16 rows in the
//   m16n8 layout): bias adds, activations and their gradients, the add of
//   ge and gmean / S, the bf16 roundings, the bias column sums and the
//   stores of h1, h2, bf16(g3), g2 and g1 as blocked tiles; h3 is never
//   stored (g3 is formed from the registers), g3 overwrites ge, g2 h2 and
//   g1 h1 in place.  Seven block barriers and two warpgroup barriers a
//   chunk.
// Shared memory (bytes, embed_bwd_smem; k0 = 96 / 48): W0 24576 / 12288, W1
// and W2 32768 each, the x landing stage 12288 / 6144, the x tile 12288 /
// 6144, the cotangent tile 16384, h1 / g1 16384, h2 / g2 (also the staged
// d(x)) 16384, dW0^T 49152 / 24576, gmean / S 16384, the biases 1536, 4
// mbarriers: 231040 / 181888 of the 232448 a block may opt into, one block
// per SM (the kernel checks its carve against the launch's size).
// Registers: dW1 and dW2 128 a thread, a product's accumulators 32, the
// bias sums 6; 255 in all (-Xptxas -v), with spills of 124 / 140 bytes
// (stores / loads) in Multisteps' form at k0 96, 176 / 204 at 48 and
// 152 / 192 in slabs of 96, and 16 / 16 in PathNet's at 48 (KPCN, LBMC),
// 36 / 36 at 96, 24 / 24 in slabs.
// Wide rows (C0 above 96, which Multisteps takes with a PathNet output
// wider than 4): an instantiation of k0 = 96 of its own (kWide) with a
// run-time count of slabs of 96 columns.  Per chunk, layer 1's product accumulates over the slabs
// in order, each slab's W0 rows (contiguous in the blocked pack) and the
// chunk's x columns loaded into the same buffers first (16-byte and
// 2-byte loads, no landing stage); after g1, each slab (the last first,
// still loaded) forms dW0^T's slab, added by the owning thread into the
// block's dW0 partial in device memory (zeroed at the start), and d(x)'s
// slab, staged and stored by 2-byte stores.  The products' wgmma counts
// stay those of k0 = 96; only the slab loop runs at run time, and the
// instantiations for C0 up to 96 are the code without slabs.  It costs one reload of W0 and x
// per slab and a read-modify-write of dW0 per chunk, off the models'
// default widths.
#include "hopper.cuh"
#include "mlp.cuh"

namespace wcmc {

constexpr int kEPix = 32;                  // pixels of one image per tile
constexpr int kESamples = 2;               // samples per chunk
constexpr int kERows = kEPix * kESamples;  // rows per product: a wgmma's m64
constexpr int kEW = 128;                   // C1 = C2 = C3 as the kernel runs them
constexpr int kERG = kEW / 8 * 128;        // bytes between 8-row groups of a blocked 128-wide tile
constexpr int kEThreads = 256;             // two warpgroups

__host__ __device__ constexpr long long embed_bwd_parts(int k0) {
  return (long long)k0 * kEW + 2LL * kEW * kEW + 3 * kEW;
}

// The block's shared memory, in the order the kernel carves it;
// ops/pathnet_fused.py's embed_bwd_plan computes the same sum.
inline size_t embed_bwd_smem(int k0) {
  return smem_bytes((size_t)k0 * kEW, 2) + 2 * smem_bytes(kEW * kEW, 2) +
         2 * smem_bytes((size_t)kERows * k0, 2) + 3 * smem_bytes(kERows * kEW, 2) +
         smem_bytes((size_t)kEW * k0, 4) + smem_bytes(kEPix * kEW, 4) + smem_bytes(3 * kEW, 4) +
         smem_bytes(4, 8);
}

struct EmbedBwdArgs {
  const bf16* x;       // (B, S, HW, c0)
  const bf16* ge;      // (B, S, HW, c3) or null
  const float* gmean;  // (B, HW, c3) or null
  const bf16* w;       // pack_embed_weights: blocked W0 (k0 x 128) | W1 | W2 (128 x 128)
  const float* bias;   // b0 | b1 | b2, 128 each
  bf16* dx;            // (B, S, HW, c0) or null
  float* parts;        // gridDim.x partials of embed_bwd_parts(k0) floats
  int B, S, HW, c0, c3;
  int k0;              // W0's packed rows: kK0, or slabs of kK0 = 96 above 96
};

// Column sums of an accumulator pair over the warp's 16 rows (rows g and
// g + 8 of the lane's two columns), in a fixed order: every lane ends with
// its columns' sums.
__device__ inline float2 col_sums(float v0, float v1) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, o);
    v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  return make_float2(v0, v1);
}

// The float2 slot of dW0^T element pair (row, 2 u) in shared memory: u
// XOR-swizzled by row so that a half-warp's 4 rows of 8 pairs hit 32
// banks (for k0 = 96 rows are 96 floats, a multiple of 32 banks; for 48,
// 48 floats, rows 2 apart meet).
template <int kK0>
__device__ inline int dw0_slot(int row, int u) {
  return row * (kK0 / 2) + (u ^ (kK0 == 96 ? (row & 3) << 2 : ((row >> 1) & 1) << 2));
}

// kK0: C0 padded (48 or 96); kA0..kA2: the layers' activation codes
// (mlp_act); kDx: write d(x); kWide: C0 above 96, in slabs of kK0 = 96.
template <int kK0, int kA0, int kA1, int kA2, bool kDx, bool kWide>
__global__ void __launch_bounds__(kEThreads, 1) pathnet_embed_bwd_kernel(EmbedBwdArgs a) {
  static_assert(kK0 == 48 || kK0 == 96, "k0 is 48 or 96");
  constexpr int kXRG = kK0 / 8 * 128;    // bytes between 8-row groups of the x tile
  constexpr int kSpan = kEPix * kK0;     // elements between the samples' spans in a stage
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarver carve{smem, 0};
  bf16* s_w0 = carve.take<bf16>(kK0 * kEW);
  bf16* s_w1 = carve.take<bf16>(kEW * kEW);
  bf16* s_w2 = carve.take<bf16>(kEW * kEW);
  bf16* s_xin = carve.take<bf16>(kERows * kK0);  // the chunk's x spans as they lie in memory
  bf16* s_x = carve.take<bf16>(kERows * kK0);    // the chunk's x (blocked)
  bf16* s_g = carve.take<bf16>(kERows * kEW);    // ge, then bf16(g3) (blocked)
  bf16* s_h1 = carve.take<bf16>(kERows * kEW);   // h1, then g1 (blocked)
  bf16* s_h2 = carve.take<bf16>(kERows * kEW);   // h2, then g2 (blocked); then d(x) spans
  float* s_dw0 = carve.take<float>(kEW * kK0);   // dW0^T (dw0_slot)
  float* s_gm = carve.take<float>(kEPix * kEW);  // gmean / S, 16-byte pieces swizzled
  float* s_b = carve.take<float>(3 * kEW);
  unsigned long long* s_bars = carve.take<unsigned long long>(4);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what embed_bwd_smem() sums
  const unsigned u_w0 = smem_addr(s_w0), u_w1 = smem_addr(s_w1), u_w2 = smem_addr(s_w2);
  const unsigned u_xin = smem_addr(s_xin), u_x = smem_addr(s_x), u_g = smem_addr(s_g);
  const unsigned u_h1 = smem_addr(s_h1), u_h2 = smem_addr(s_h2), u_gm = smem_addr(s_gm);
  // mbarriers: 0 the weights, 1 the x spans, 2 ge, 3 gmean
  const unsigned bar_w = smem_addr(s_bars), bar_x = bar_w + 8, bar_g = bar_w + 16,
                 bar_gm = bar_w + 24;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, q = warp % 4, g8 = lane / 4, t4 = lane % 4;
  const int S = a.S, HW = a.HW, c0 = a.c0, c3 = a.c3;
  // C0 above 96 runs in slabs of kK0 (= 96) columns: W0's slab and the
  // chunk's x slab are loaded for each slab's products, twice a chunk
  static_assert(!kWide || kK0 == 96, "slabs of 96");
  constexpr bool wide = kWide;
  const int n_slabs = kWide ? a.k0 / kK0 : 1;
  const int per_image = (HW + kEPix - 1) / kEPix;
  const int n_tiles = a.B * per_image, n_chunks = (S + kESamples - 1) / kESamples;
  const int n_mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = n_mine * n_chunks;

  auto tile_of = [&](int k, int& b, int& row0, int& npx) {
    const int t = (int)blockIdx.x + k * (int)gridDim.x;
    b = t / per_image;
    row0 = (t % per_image) * kEPix;
    npx = min(kEPix, HW - row0);
  };
  // element offset of chunk c's span of sample s0 + si (rows of c0 values)
  auto span_at = [&](int b, int row0, int s) { return (((size_t)b * S + s) * HW + row0) * c0; };
  auto fetch_x = [&](int c) {
    int b, row0, npx;
    tile_of(c / n_chunks, b, row0, npx);
    const int s0 = (c % n_chunks) * kESamples, len = npx * c0;
    for (int si = 0; si < kESamples && s0 + si < S; ++si) {
      const bf16* src = a.x + span_at(b, row0, s0 + si);
      if (aligned16(src)) {
        const int bytes = 2 * len;
        for (int i = tid; 16 * i < bytes; i += kEThreads)
          cp_async16_zfill(u_xin + 2 * si * kSpan + 16 * i,
                           reinterpret_cast<const char*>(src) + 16 * i, min(16, bytes - 16 * i));
      } else {
        bf16* dst = s_xin + si * kSpan;
        for (int i = tid; i < len; i += kEThreads) dst[i] = src[i];
      }
    }
    cp_async_mbar_arrive(bar_x);
  };
  // ge rows into the blocked cotangent tile, what lies past S, HW or C3
  // zero-filled: 8 threads take one 16-byte piece of 8 rows, so each warp
  // reads 64 contiguous bytes of 8 rows; thread tid copies rows f_r + 16
  // m, m < 4, at column f_col
  const int f_r = 8 * (tid / 128) + tid % 8, f_col = 8 * ((tid / 8) % 16);
  auto fetch_g = [&](int c) {
    int b, row0, npx;
    tile_of(c / n_chunks, b, row0, npx);
    const int s0 = (c % n_chunks) * kESamples;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = f_r + 16 * m, si = r / kEPix, px = r % kEPix;
      const bool ok = s0 + si < S && px < npx && f_col < c3;
      const bf16* from = a.ge + (((size_t)b * S + s0 + si) * HW + row0 + px) * c3 + f_col;
      cp_async16_zfill(u_g + (r / 8) * kERG + (f_col / 8) * 128 + (r % 8) * 16, ok ? from : a.ge,
                       ok ? 16 : 0);
    }
    cp_async_mbar_arrive(bar_g);
  };
  // a tile's gmean rows, 16-byte piece p of pixel px at piece p ^ (px % 8)
  auto fetch_gm = [&](int k) {
    int b, row0, npx;
    tile_of(k, b, row0, npx);
    for (int i = tid; i < kEPix * kEW / 4; i += kEThreads) {
      const int px = i / (kEW / 4), p = i % (kEW / 4);
      const bool ok = px < npx && 4 * p < c3;
      const float* from = a.gmean + ((size_t)b * HW + row0 + px) * c3 + 4 * p;
      cp_async16_zfill(u_gm + px * kEW * 4 + 16 * (p ^ (px & 7)), ok ? from : a.gmean, ok ? 16 : 0);
    }
    cp_async_mbar_arrive(bar_gm);
  };
  // chunk c's d(x), staged as spans in s_h2, out 16 bytes a store where
  // the span starts on 16 bytes (the tail by elements), else by elements
  auto store_dx = [&](int b, int row0, int npx, int s0) {
    const int len = npx * c0;
    for (int si = 0; si < kESamples && s0 + si < S; ++si) {
      bf16* to = a.dx + span_at(b, row0, s0 + si);
      const bf16* from = s_h2 + si * kSpan;
      int done = 0;
      if (aligned16(to)) {
        done = len / 8 * 8;
        for (int i = tid; i < len / 8; i += kEThreads)
          reinterpret_cast<uint4*>(to)[i] = reinterpret_cast<const uint4*>(from)[i];
      }
      for (int i = done + tid; i < len; i += kEThreads) to[i] = from[i];
    }
  };

  float* part = a.parts + (size_t)blockIdx.x * embed_bwd_parts(a.k0);
  // C0 in slabs: W0's slab sl (rows kK0 sl on of the blocked W0, one
  // contiguous piece) into s_w0 and the chunk's x columns of that slab
  // straight into the blocked x tile, by 16-byte loads and 2-byte loads;
  // what lies past C0, S or HW zero
  auto load_slab = [&](int sl, int b, int row0, int npx, int s0) {
    const uint4* wsrc = reinterpret_cast<const uint4*>(a.w + (size_t)sl * kK0 * kEW);
    for (int i = tid; i < kK0 * kEW / 8; i += kEThreads) reinterpret_cast<uint4*>(s_w0)[i] = wsrc[i];
    for (int t = tid; t < kERows * (kK0 / 8); t += kEThreads) {
      const int r = t / (kK0 / 8), cg = t % (kK0 / 8), si = r / kEPix, px = r % kEPix;
      const bool ok = s0 + si < S && px < npx;
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          a.x + (ok ? span_at(b, row0, s0 + si) + (size_t)px * c0 : 0));
      unsigned v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = kK0 * sl + 8 * cg + 2 * u;
        const unsigned lo = ok && col < c0 ? src[col] : 0u;
        const unsigned hi = ok && col + 1 < c0 ? src[col + 1] : 0u;
        v[u] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(s_x) + (r / 8) * kXRG + cg * 128 +
                                (r % 8) * 16) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_proxy_async();
  };
  // chunk c's d(x) of slab sl, staged as rows of kK0 in s_h2, out by 2-byte stores
  auto store_dx_slab = [&](int b, int row0, int npx, int s0, int sl) {
    const int w = min(kK0, c0 - kK0 * sl);
    for (int si = 0; si < kESamples && s0 + si < S; ++si) {
      bf16* to = a.dx + span_at(b, row0, s0 + si) + kK0 * sl;
      const bf16* from = s_h2 + si * kSpan;
      for (int i = tid; i < npx * w; i += kEThreads)
        to[(size_t)(i / w) * c0 + i % w] = from[(i / w) * kK0 + i % w];
    }
  };

  // Zero every staged buffer once (rows never written stay finite, and
  // an absent gmean stays zero); the biases; the mbarriers; above 96
  // columns, the block's dW0 partial (added to chunk by chunk).
  for (uint4* p = reinterpret_cast<uint4*>(s_xin) + tid; p < reinterpret_cast<uint4*>(s_b);
       p += kEThreads)
    *p = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < 3 * kEW; i += kEThreads) s_b[i] = a.bias[i];
  if (wide)
    for (int i = tid; i < a.k0 * kEW; i += kEThreads) part[i] = 0.0f;
  if (tid == 0) {
    mbar_init(bar_w, 1);
    for (int i = 1; i < 4; ++i) mbar_init(bar_w + 8 * i, kEThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (total > 0) {
    if (tid == 0) {
      mbar_expect_tx(bar_w, (kK0 + 2 * kEW) * kEW * 2);
      bulk_copy(u_w0, a.w, kK0 * kEW * 2, bar_w);
      bulk_copy(u_w1, a.w + (size_t)a.k0 * kEW, kEW * kEW * 2, bar_w);
      bulk_copy(u_w2, a.w + (size_t)(a.k0 + kEW) * kEW, kEW * kEW * 2, bar_w);
    }
    if (!wide) fetch_x(0);
    if (a.gmean != nullptr) fetch_gm(0);
    if (a.ge != nullptr) fetch_g(0);
    mbar_wait(bar_w, 0);
  }
  __syncthreads();  // the first chunk's x spans, where they came by 2-byte loads

  float dw1[16][4], dw2[16][4];  // this warp's rows of dW1 and dW2, for the whole run
  zero_acc(dw1);
  zero_acc(dw2);
  float acc[8][4];
  float db[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};  // db0..db2 of n8 tile g8
  // the lane's accumulator elements (h, j): rows 16 q + g8 + 8 h (pixel
  // 16 (q % 2) + g8 + 8 h of sample s0 + q / 2), columns 64 wg + 8 j + 2
  // t4 + {0, 1}; in a blocked 128-wide tile at lane_blk + h kERG + 128 j
  const int lane_blk = 2 * q * kERG + 8 * wg * 128 + g8 * 16 + 4 * t4;
  const int si_lane = q / 2, col0 = 64 * wg + 2 * t4;
  // adds the column sums of the pair (v0, v1) of n8 tile j to layer l's
  // bias sums of the lane that keeps that tile
  auto add_db = [&](int l, int j, float v0, float v1) {
    const float2 cs = col_sums(v0, v1);
    db[l][0] += g8 == j ? cs.x : 0.0f;
    db[l][1] += g8 == j ? cs.y : 0.0f;
  };

  for (int c = 0; c < total; ++c) {
    const int k = c / n_chunks, ci = c % n_chunks, s0 = ci * kESamples;
    int b, row0, npx;
    tile_of(k, b, row0, npx);
    if (!wide) mbar_wait(bar_x, c & 1);
    if (ci == 0 && a.gmean != nullptr) {  // the tile's gmean / S, once
      mbar_wait(bar_gm, k & 1);
      for (int i = tid; i < kEPix * kEW; i += kEThreads) s_gm[i] = __fdiv_rn(s_gm[i], (float)S);
    }
    // lay the spans out into the blocked x tile: one 16-byte piece (8
    // columns of a row) a step
    for (int t = tid; !wide && t < kERows * (kK0 / 8); t += kEThreads) {
      const int r = t / (kK0 / 8), cg = t % (kK0 / 8), si = r / kEPix, px = r % kEPix;
      const bool ok = s0 + si < S && px < npx;
      const unsigned short* src =
          reinterpret_cast<const unsigned short*>(s_xin + si * kSpan + px * c0);
      unsigned v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = 8 * cg + 2 * u;
        const unsigned lo = ok && col < c0 ? src[col] : 0u;
        const unsigned hi = ok && col + 1 < c0 ? src[col + 1] : 0u;
        v[u] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(s_x) + (r / 8) * kXRG + cg * 128 +
                                (r % 8) * 16) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_proxy_async();
    __syncthreads();
    if (!wide && c + 1 < total) fetch_x(c + 1);  // the landing stage is free

    // h1 = bf16(a0(x . W0 + b0)): the warpgroup's 64 C1 columns; above
    // 96 columns of x, summed over the slabs in order
    zero_acc(acc);
    for (int sl = 0; sl < n_slabs; ++sl) {
      if (wide) {
        __syncthreads();  // the last products that read s_x and s_w0 are done
        load_slab(sl, b, row0, npx, s0);
        __syncthreads();
      }
      fence_acc(acc);
      wgmma_fence();
      mm<8, kK0 / 16, false, kXRG, true, kERG>(acc, u_x, u_w0 + 8 * wg * 128);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 bb = *reinterpret_cast<const float2*>(s_b + col0 + 8 * j);
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(s_h1) + lane_blk + h * kERG +
                                           j * 128) =
            __floats2bfloat162_rn(mlp_act(kA0, acc[j][2 * h] + bb.x),
                                  mlp_act(kA0, acc[j][2 * h + 1] + bb.y));
      }
    fence_proxy_async();
    __syncthreads();

    // h2 = bf16(a1(h1 . W1 + b1))
    zero_acc(acc);
    fence_acc(acc);
    wgmma_fence();
    mm<8, kEW / 16, false, kERG, true, kERG>(acc, u_h1, u_w1 + 8 * wg * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 bb = *reinterpret_cast<const float2*>(s_b + kEW + col0 + 8 * j);
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(s_h2) + lane_blk + h * kERG +
                                           j * 128) =
            __floats2bfloat162_rn(mlp_act(kA1, acc[j][2 * h] + bb.x),
                                  mlp_act(kA1, acc[j][2 * h + 1] + bb.y));
      }
    fence_proxy_async();
    __syncthreads();

    // g3 = a2'(h3, ge + gmean / S) with h3 = bf16(a2(h2 . W2 + b2)) held in
    // registers (a linear output layer needs no h3), zero on rows past S or
    // HW; over ge in place; db2 += its column sums
    if constexpr (kA2 != 0) {
      zero_acc(acc);
      fence_acc(acc);
      wgmma_fence();
      mm<8, kEW / 16, false, kERG, true, kERG>(acc, u_h2, u_w2 + 8 * wg * 128);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
    }
    if (a.ge != nullptr) mbar_wait(bar_g, c & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 8 * j;
      float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = 16 * (q % 2) + g8 + 8 * h;
        const bool ok = s0 + si_lane < S && px < npx;
        auto* gp = reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(s_g) + lane_blk +
                                                     h * kERG + j * 128);
        const float2 gv = a.ge != nullptr ? __bfloat1622float2(*gp) : make_float2(0.0f, 0.0f);
        const float2 mv = *reinterpret_cast<const float2*>(
            s_gm + px * kEW + 4 * ((col / 4) ^ (px & 7)) + col % 4);
        float v0 = gv.x + mv.x, v1 = gv.y + mv.y;
        if constexpr (kA2 != 0) {
          const float2 bb = *reinterpret_cast<const float2*>(s_b + 2 * kEW + col);
          const float2 h3 = __bfloat1622float2(__floats2bfloat162_rn(
              mlp_act(kA2, acc[j][2 * h] + bb.x), mlp_act(kA2, acc[j][2 * h + 1] + bb.y)));
          v0 = mlp_act_grad(kA2, h3.x, v0);
          v1 = mlp_act_grad(kA2, h3.y, v1);
        }
        v0 = ok ? v0 : 0.0f;
        v1 = ok ? v1 : 0.0f;
        cs0 += v0;
        cs1 += v1;
        *gp = __floats2bfloat162_rn(v0, v1);
      }
      add_db(2, j, cs0, cs1);
    }
    fence_proxy_async();
    __syncthreads();
    if (a.gmean != nullptr && ci == n_chunks - 1 && k + 1 < n_mine) fetch_gm(k + 1);

    // dW2 += h2^T . bf16(g3): the warpgroup's C2 rows [64 wg, 64 wg + 64);
    // and g2 = a1'(h2, bf16(g3) . W2^T): the warpgroup's 64 C2 columns,
    // written over its h2 once its dW2 products are done with them
    zero_acc(acc);
    fence_acc(dw2);
    fence_acc(acc);
    wgmma_fence();
    mm<16, kERows / 16, true, kERG, true, kERG>(dw2, u_h2 + 8 * wg * 128, u_g);
    mm<8, kEW / 16, false, kERG, false, kERG>(acc, u_g, u_w2 + 8 * wg * kERG);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(dw2);
    fence_acc(acc);
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        auto* p = reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(s_h2) + lane_blk +
                                                    h * kERG + j * 128);
        const float2 hv = __bfloat1622float2(*p);
        const float v0 = mlp_act_grad(kA1, hv.x, acc[j][2 * h]);
        const float v1 = mlp_act_grad(kA1, hv.y, acc[j][2 * h + 1]);
        cs0 += v0;
        cs1 += v1;
        *p = __floats2bfloat162_rn(v0, v1);
      }
      add_db(1, j, cs0, cs1);
    }
    fence_proxy_async();
    __syncthreads();
    if (a.ge != nullptr && c + 1 < total) fetch_g(c + 1);  // bf16(g3) is read

    // dW1 += h1^T . bf16(g2) and g1 = a0'(h1, bf16(g2) . W1^T), over h1
    zero_acc(acc);
    fence_acc(dw1);
    fence_acc(acc);
    wgmma_fence();
    mm<16, kERows / 16, true, kERG, true, kERG>(dw1, u_h1 + 8 * wg * 128, u_h2);
    mm<8, kEW / 16, false, kERG, false, kERG>(acc, u_h2, u_w1 + 8 * wg * kERG);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(dw1);
    fence_acc(acc);
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        auto* p = reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(s_h1) + lane_blk +
                                                    h * kERG + j * 128);
        const float2 hv = __bfloat1622float2(*p);
        const float v0 = mlp_act_grad(kA0, hv.x, acc[j][2 * h]);
        const float v1 = mlp_act_grad(kA0, hv.y, acc[j][2 * h + 1]);
        cs0 += v0;
        cs1 += v1;
        *p = __floats2bfloat162_rn(v0, v1);
      }
      add_db(0, j, cs0, cs1);
    }
    fence_proxy_async();
    __syncthreads();

    // dW0^T += bf16(g1)^T . x: the warpgroup's C1 rows, k0 columns 48 at a
    // time, added from the accumulators into s_dw0 by the owning thread
    // (above 96 columns: slab by slab, last first, into the block's dW0
    // partial in device memory, by the owning thread likewise)
    for (int sl = n_slabs - 1; sl >= 0; --sl) {
      if (wide && sl != n_slabs - 1) {
        __syncthreads();  // the slab's products and d(x) stores are done
        load_slab(sl, b, row0, npx, s0);
        __syncthreads();
      }
#pragma unroll
      for (int hh = 0; hh < kK0 / 48; ++hh) {
        zero_acc(acc);
        fence_acc(acc);
        wgmma_fence();
        mm<6, kERows / 16, true, kERG, true, kXRG>(acc, u_h1 + 8 * wg * 128, u_x + 6 * hh * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 64 * wg + 16 * q + g8 + 8 * h;
            if (wide) {
              float* p = part + (size_t)(kK0 * sl + 48 * hh + 8 * j + 2 * t4) * kEW + row;
              p[0] += acc[j][2 * h];
              p[kEW] += acc[j][2 * h + 1];
            } else {
              float2* p =
                  reinterpret_cast<float2*>(s_dw0) + dw0_slot<kK0>(row, 24 * hh + 4 * j + t4);
              float2 v = *p;
              v.x += acc[j][2 * h];
              v.y += acc[j][2 * h + 1];
              *p = v;
            }
          }
      }
      if constexpr (kDx) {
        // dx = bf16(bf16(g1) . W0^T): x columns 48 wg on (k0 96), or all 48
        // by both warpgroups and staged by the first (k0 48); into s_h2
        // (free since the last barrier) as spans of c0-wide rows, or of
        // the slab's kK0-wide rows above 96 columns
        constexpr int kDxSplit = kK0 == 96 ? 1 : 0;
        const int pitch = wide ? kK0 : c0, lim = wide ? min(kK0, c0 - kK0 * sl) : c0;
        zero_acc(acc);
        fence_acc(acc);
        wgmma_fence();
        mm<6, kEW / 16, false, kERG, false, kERG>(acc, u_h1, u_w0 + 6 * kDxSplit * wg * kERG);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
        if (kDxSplit == 1 || wg == 0) {
          bf16* stage = s_h2 + si_lane * kSpan;
#pragma unroll
          for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int px = 16 * (q % 2) + g8 + 8 * h, col = 48 * kDxSplit * wg + 8 * j + 2 * t4;
              if (col < lim) stage[px * pitch + col] = __float2bfloat16(acc[j][2 * h]);
              if (col + 1 < lim) stage[px * pitch + col + 1] = __float2bfloat16(acc[j][2 * h + 1]);
            }
        }
        if (wide) {
          __syncthreads();  // the slab's d(x) is staged
          store_dx_slab(b, row0, npx, s0, sl);
        }
      }
    }
    __syncthreads();  // x and g1 are read; d(x) is staged
    if constexpr (kDx)
      if (!wide) store_dx(b, row0, npx, s0);
  }

  // The block's partials: dW0 (k0 x 128, from dW0^T) | dW1 | dW2 | db0 |
  // db1 | db2.  Bias sums: each warp's into s_xin (free), then added in
  // warp order.
  float* s_db = reinterpret_cast<float*>(s_xin);  // [3][8 warps][64]
  __syncthreads();
#pragma unroll
  for (int l = 0; l < 3; ++l)
    *reinterpret_cast<float2*>(s_db + (l * 8 + warp) * 64 + 8 * g8 + 2 * t4) =
        make_float2(db[l][0], db[l][1]);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = (size_t)(64 * wg + 16 * q + g8 + 8 * h) * kEW + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(part + (size_t)a.k0 * kEW + at) =
          make_float2(dw1[j][2 * h], dw1[j][2 * h + 1]);
      *reinterpret_cast<float2*>(part + (size_t)(a.k0 + kEW) * kEW + at) =
          make_float2(dw2[j][2 * h], dw2[j][2 * h + 1]);
    }
  __syncthreads();
  for (int i = tid; !wide && i < kK0 * kEW; i += kEThreads) {
    const int kk = i / kEW, cc = i % kEW;
    part[i] = s_dw0[2 * dw0_slot<kK0>(cc, kk / 2) + kk % 2];
  }
  for (int i = tid; i < 3 * kEW; i += kEThreads) {
    const int l = i / kEW, cc = i % kEW, w4 = 4 * (cc / 64);
    float v = 0.0f;
    for (int w = 0; w < 4; ++w) v += s_db[(l * 8 + w4 + w) * 64 + cc % 64];
    part[(size_t)(a.k0 + 2 * kEW) * kEW + i] = v;
  }
}

// ---------------------------------------------------------------------------
// The row-chunk body: PathNet's chains wider than 128, which no model runs.
// Unchanged from the first port but for the branches of Multisteps' form,
// which runs the tiled body.  A block owns a tile of 16 pixels of one image and takes
// its S samples in chunks of up to 8 (128 rows); each weight-gradient
// product is added into the block's f32 partial in device memory (read,
// added to and written back per chunk, by the warp that owns the
// fragment); weights are read through L1/L2 by the wmma fragment loads;
// 2-byte copies of x and ge; bias gradients by per-fragment column sums in
// fixed order.
// ---------------------------------------------------------------------------

constexpr int kRowPix = 16;     // pixels per tile
constexpr int kRowChunk = 8;    // samples per chunk
constexpr int kRowRows = kRowPix * kRowChunk;

struct RowBwdDims {
  int c0, c1, c2, c3, k0;  // k0: c0 rounded up to 16 (W0 comes zero-padded to k0 rows)
};

__host__ __device__ inline long long row_bwd_parts(const RowBwdDims& d) {
  return (long long)d.k0 * d.c1 + (long long)d.c1 * d.c2 + (long long)d.c2 * d.c3 + d.c1 + d.c2 +
         d.c3;
}

inline size_t row_bwd_smem(const RowBwdDims& d) {
  const int cmax = d.c1 > d.c2 ? d.c1 : d.c2;
  return smem_bytes((size_t)kRowRows * pitch_bf16(d.k0), 2) +
         smem_bytes((size_t)kRowRows * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)kRowRows * pitch_bf16(d.c2), 2) +
         smem_bytes((size_t)kRowRows * pitch_bf16(d.c3), 2) +
         smem_bytes((size_t)kRowPix * d.c3, 4) + smem_bytes((size_t)kWarps * 256, 4) +
         smem_bytes((size_t)kRowChunk * cmax, 4) + smem_bytes(d.c1, 4) + smem_bytes(d.c2, 4) +
         smem_bytes(d.c3, 4) + smem_bytes(d.c1, 4) + smem_bytes(d.c2, 4);
}

// acc += the partial (ldp columns) at (r0, c0); mma; store back.
template <typename LA, typename LB>
__device__ inline void partial_mma(float* part, int ldp, const bf16* A, int lda, const bf16* Bm,
                                   int ldb, int r0, int c0, int K) {
  Acc acc;
  float* p = part + (size_t)r0 * ldp + c0;
  wmma::load_matrix_sync(acc, p, ldp, wmma::mem_row_major);
  frag_mma<LA, LB>(acc, A, lda, Bm, ldb, r0, c0, K);
  wmma::store_matrix_sync(p, acc, ldp, wmma::mem_row_major);
}

// G = a'(H, A . W^T) for the (rows x n) fragments, written in place over
// H (bf16), with each fragment's column sums of the unrounded G in
// dbpart[row block][col].
template <int kAct>
__device__ inline void backprop_act(const bf16* A, int lda, const bf16* w, int ldw, int k,
                                    bf16* H, int ldh, int rows, int n, float* stage,
                                    float* dbpart) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_col = n / 16, n_frag = (rows / 16) * n_col;
  for (int f = warp; f < n_frag; f += kWarps) {
    const int r0 = (f / n_col) * 16, c0 = (f % n_col) * 16;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    frag_mma<wmma::row_major, wmma::col_major>(acc, A, lda, w, ldw, r0, c0, k);
    float* st = stage_frag(acc, stage);
    for (int i = lane; i < 256; i += 32) {
      bf16* h = H + (size_t)(r0 + i / 16) * ldh + c0 + i % 16;
      const float v = mlp_act_grad(kAct, __bfloat162float(*h), st[i]);
      st[i] = v;
      *h = __float2bfloat16(v);
    }
    __syncwarp();
    const float cs = stage_col_sum(st);
    if (lane < 16) dbpart[(r0 / 16) * n + c0 + lane] = cs;
    __syncwarp();
  }
}

// H = bf16(a(A . W + bias)) for the (rows x n) fragments.
template <int kAct>
__device__ inline void forward_act(const bf16* A, int lda, const bf16* w, int ldw, int k,
                                   const float* bias, bf16* H, int ldh, int rows, int n,
                                   float* stage) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_col = n / 16, n_frag = (rows / 16) * n_col;
  for (int f = warp; f < n_frag; f += kWarps) {
    const int r0 = (f / n_col) * 16, c0 = (f % n_col) * 16;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    frag_mma<wmma::row_major, wmma::row_major>(acc, A, lda, w, ldw, r0, c0, k);
    float* st = stage_frag(acc, stage);
    for (int i = lane; i < 256; i += 32) {
      const int c = c0 + i % 16;
      H[(size_t)(r0 + i / 16) * ldh + c] = __float2bfloat16(mlp_act(kAct, st[i] + bias[c]));
    }
    __syncwarp();
  }
}

// part += A^T . G over `rows` rows, for the (m x n) partial.
__device__ inline void accumulate_dw(float* part, const bf16* A, int lda, const bf16* G, int ldg,
                                     int m, int n, int rows) {
  const int warp = threadIdx.x / 32;
  const int n_col = n / 16, n_frag = (m / 16) * n_col;
  for (int f = warp; f < n_frag; f += kWarps) {
    const int r0 = (f / n_col) * 16, c0 = (f % n_col) * 16;
    partial_mma<wmma::col_major, wmma::row_major>(part, n, A, lda, G, ldg, r0, c0, rows);
  }
}

// PathNet's chain: relu, relu, linear (the output layer is not recomputed).
__global__ void __launch_bounds__(kThreads)
    pathnet_embed_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ge,
                                  const float* __restrict__ gmean, const bf16* __restrict__ w0,
                                  const float* __restrict__ b0, const bf16* __restrict__ w1,
                                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                                  float* __restrict__ parts, int B, int S, int HW, RowBwdDims d) {
  constexpr int kA0 = 1, kA1 = 1;  // relu
  extern __shared__ __align__(128) unsigned char smem[];
  const int p_x = pitch_bf16(d.k0), p_h1 = pitch_bf16(d.c1), p_h2 = pitch_bf16(d.c2);
  const int p_g3 = pitch_bf16(d.c3);
  const int cmax = d.c1 > d.c2 ? d.c1 : d.c2;
  SmemCarver carve{smem, 0};
  bf16* s_x = carve.take<bf16>((size_t)kRowRows * p_x);
  bf16* s_h1 = carve.take<bf16>((size_t)kRowRows * p_h1);
  bf16* s_h2 = carve.take<bf16>((size_t)kRowRows * p_h2);
  bf16* s_g3 = carve.take<bf16>((size_t)kRowRows * p_g3);  // g3
  float* s_gm = carve.take<float>((size_t)kRowPix * d.c3);
  float* s_stage = carve.take<float>((size_t)kWarps * 256);
  float* s_dbpart = carve.take<float>((size_t)kRowChunk * cmax);
  float* s_db0 = carve.take<float>(d.c1);
  float* s_db1 = carve.take<float>(d.c2);
  float* s_db2 = carve.take<float>(d.c3);
  float* s_b0 = carve.take<float>(d.c1);
  float* s_b1 = carve.take<float>(d.c2);

  const long long n_parts = row_bwd_parts(d);
  float* part = parts + (size_t)blockIdx.x * n_parts;
  float* p_dw0 = part;
  float* p_dw1 = p_dw0 + (size_t)d.k0 * d.c1;
  float* p_dw2 = p_dw1 + (size_t)d.c1 * d.c2;
  float* p_db = p_dw2 + (size_t)d.c2 * d.c3;
  for (long long i = threadIdx.x; i < n_parts; i += blockDim.x) part[i] = 0.0f;
  for (int i = threadIdx.x; i < d.c1; i += blockDim.x) s_db0[i] = 0.0f, s_b0[i] = b0[i];
  for (int i = threadIdx.x; i < d.c2; i += blockDim.x) s_db1[i] = 0.0f, s_b1[i] = b1[i];
  for (int i = threadIdx.x; i < d.c3; i += blockDim.x) s_db2[i] = 0.0f;
  __syncthreads();

  const int tiles_per_image = (HW + kRowPix - 1) / kRowPix;
  const int n_tiles = B * tiles_per_image;
  const float inv_s = 1.0f / (float)S;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_image;
    const int row0 = (t % tiles_per_image) * kRowPix;
    const int rows = min(kRowPix, HW - row0);
    for (int i = threadIdx.x; i < kRowPix * d.c3; i += blockDim.x) {
      const int r = i / d.c3, c = i % d.c3;
      s_gm[i] = r < rows ? gmean[((size_t)b * HW + row0 + r) * d.c3 + c] * inv_s : 0.0f;
    }
    for (int s0 = 0; s0 < S; s0 += kRowChunk) {
      const int sc = min(kRowChunk, S - s0), n_rows = kRowPix * sc;
      for (int i = threadIdx.x; i < n_rows * d.k0; i += blockDim.x) {
        const int r = i / d.k0, c = i % d.k0, pr = r % kRowPix;
        const size_t row = ((size_t)b * S + s0 + r / kRowPix) * HW + row0 + pr;
        s_x[r * p_x + c] = (pr < rows && c < d.c0) ? x[row * d.c0 + c] : zero;
      }
      __syncthreads();  // s_gm and s_x
      // g3 = ge + gmean / S (a linear output layer); db2 in row order
      for (int c = threadIdx.x; c < d.c3; c += blockDim.x) {
        float sum = 0.0f;
        for (int r = 0; r < n_rows; ++r) {
          const int pr = r % kRowPix;
          float v = 0.0f;
          if (pr < rows) {
            const size_t row = ((size_t)b * S + s0 + r / kRowPix) * HW + row0 + pr;
            v = __bfloat162float(ge[row * d.c3 + c]) + s_gm[pr * d.c3 + c];
          }
          s_g3[r * p_g3 + c] = __float2bfloat16(v);
          sum += v;
        }
        s_db2[c] += sum;
      }
      forward_act<kA0>(s_x, p_x, w0, d.c1, d.k0, s_b0, s_h1, p_h1, n_rows, d.c1, s_stage);
      __syncthreads();
      forward_act<kA1>(s_h1, p_h1, w1, d.c2, d.c1, s_b1, s_h2, p_h2, n_rows, d.c2, s_stage);
      __syncthreads();
      accumulate_dw(p_dw2, s_h2, p_h2, s_g3, p_g3, d.c2, d.c3, n_rows);
      __syncthreads();  // h2 is read; g2 overwrites it
      backprop_act<kA1>(s_g3, p_g3, w2, d.c3, d.c3, s_h2, p_h2, n_rows, d.c2, s_stage, s_dbpart);
      __syncthreads();
      for (int c = threadIdx.x; c < d.c2; c += blockDim.x) {
        float sum = 0.0f;
        for (int rb = 0; rb < sc; ++rb) sum += s_dbpart[rb * d.c2 + c];
        s_db1[c] += sum;
      }
      accumulate_dw(p_dw1, s_h1, p_h1, s_h2, p_h2, d.c1, d.c2, n_rows);
      __syncthreads();  // h1 and dbpart are read; g1 overwrites them
      backprop_act<kA0>(s_h2, p_h2, w1, d.c2, d.c2, s_h1, p_h1, n_rows, d.c1, s_stage, s_dbpart);
      __syncthreads();
      for (int c = threadIdx.x; c < d.c1; c += blockDim.x) {
        float sum = 0.0f;
        for (int rb = 0; rb < sc; ++rb) sum += s_dbpart[rb * d.c1 + c];
        s_db0[c] += sum;
      }
      accumulate_dw(p_dw0, s_x, p_x, s_h1, p_h1, d.k0, d.c1, n_rows);
      __syncthreads();  // before the next chunk overwrites the tiles
    }
  }
  for (int c = threadIdx.x; c < d.c1; c += blockDim.x) p_db[c] = s_db0[c];
  for (int c = threadIdx.x; c < d.c2; c += blockDim.x) p_db[d.c1 + c] = s_db1[c];
  for (int c = threadIdx.x; c < d.c3; c += blockDim.x) p_db[d.c1 + d.c2 + c] = s_db2[c];
}

}  // namespace wcmc

using namespace wcmc;

template <int kK0, int kA0, int kA1, int kA2, bool kDx, bool kWide>
static cudaError_t launch_embed_bwd(const EmbedBwdArgs& args, void* out, int n_blocks, int device,
                                    cudaStream_t stream) {
  const size_t smem = embed_bwd_smem(kK0);
  auto* kernel = pathnet_embed_bwd_kernel<kK0, kA0, kA1, kA2, kDx, kWide>;
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)args.B * ((args.HW + kEPix - 1) / kEPix);
  const int grid = (int)(n_tiles < n_blocks ? (n_tiles > 0 ? n_tiles : 1) : n_blocks);
  kernel<<<grid, kEThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(args.parts, static_cast<float*>(out), grid, embed_bwd_parts(args.k0), stream);
}

template <int kA0, int kA1, int kA2, bool kDx>
static cudaError_t launch_form(const EmbedBwdArgs& args, void* out, int n_blocks, int device,
                               cudaStream_t stream) {
  if (args.c0 <= 48)
    return launch_embed_bwd<48, kA0, kA1, kA2, kDx, false>(args, out, n_blocks, device, stream);
  if (args.c0 <= 96)
    return launch_embed_bwd<96, kA0, kA1, kA2, kDx, false>(args, out, n_blocks, device, stream);
  return launch_embed_bwd<96, kA0, kA1, kA2, kDx, true>(args, out, n_blocks, device, stream);
}

static cudaError_t launch_embed_bwd_rows(const void* x, const void* ge, const void* gmean,
                                         const void* w0, const void* b0, const void* w1,
                                         const void* b1, const void* w2, void* parts, void* out,
                                         int B, int S, int HW, const RowBwdDims& d, int n_blocks,
                                         int device, cudaStream_t stream) {
  const size_t smem = row_bwd_smem(d);
  cudaError_t err = set_smem(pathnet_embed_bwd_rows_kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kRowPix - 1) / kRowPix);
  const int grid = (int)(n_tiles < n_blocks ? (n_tiles > 0 ? n_tiles : 1) : n_blocks);
  pathnet_embed_bwd_rows_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ge), static_cast<const float*>(gmean),
      static_cast<const bf16*>(w0), static_cast<const float*>(b0), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<float*>(parts), B,
      S, HW, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(static_cast<const float*>(parts), static_cast<float*>(out), grid,
                      row_bwd_parts(d), stream);
}

// The row-chunk body for PathNet's chain (relu, relu, linear, no d(x)):
// x (B, S, HW, c0) bf16; ge (B, S, HW, c3) bf16; gmean (B, HW, c3) f32;
// w0 (k0, c1) bf16, W0 zero-padded to k0 = c0 rounded up to 16 rows; w1
// (c1, c2), w2 (c2, c3) bf16; b0, b1 f32.  All contiguous; c1, c2, c3
// multiples of 16.  parts: n_blocks partials of row_bwd_parts floats each
// (scratch); out: their sum, laid out as dW0 (k0, c1) | dW1 (c1, c2) | dW2
// (c2, c3) | db0 | db1 | db2, f32.
extern "C" int wcmc_pathnet_embed_bwd_rows(const void* x, const void* ge, const void* gmean,
                                           const void* w0, const void* b0, const void* w1,
                                           const void* b1, const void* w2, void* parts, void* out,
                                           int B, int S, int HW, int c0, int c1, int c2, int c3,
                                           int n_blocks, int device, void* stream) {
  if (c0 < 1 || c1 % 16 || c2 % 16 || c3 % 16 || c1 < 16 || c2 < 16 || c3 < 16 || S < 1 ||
      n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const RowBwdDims d{c0, c1, c2, c3, round_up(c0, 16)};
  return launch_embed_bwd_rows(x, ge, gmean, w0, b0, w1, b1, w2, parts, out, B, S, HW, d,
                               n_blocks, device, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory, in bytes, that wcmc_pathnet_embed_bwd gives
// a block for rows of c0 values: what ops/pathnet_fused.py's
// embed_bwd_plan totals.
extern "C" long long wcmc_pathnet_embed_bwd_smem(int c0) {
  return (long long)embed_bwd_smem(c0 <= 48 ? 48 : 96);
}

// x (B, S, HW, c0) bf16, any c0; ge (B, S, HW, c3) bf16 and gmean (B,
// HW, c3) f32, c3 a multiple of 16 up to 128, either may be null (zero),
// each 16-byte aligned; wpack, bpack: the chain's parameters as
// ops/pathnet_fused.py's pack_embed_weights lays them out (widths
// zero-padded to 128, W0 to k0 = 48 for c0 <= 48, else to a multiple of
// 96 rows), 16-byte
// aligned.  act0..act2: the layers' activation codes; the two forms are
// relu, relu, linear with dx null (PathNet) and leaky relu x 3 with dx
// (B, S, HW, c0) bf16 (Multisteps); others are refused.  parts: n_blocks
// partials of embed_bwd_parts(k0) floats each (scratch); out: their sum,
// laid out as dW0 (k0, 128) | dW1 (128, 128) | dW2 (128, 128) | db0 | db1
// | db2 (128 each), f32.  All contiguous.  n_blocks: persistent blocks to
// launch (the SM count).
extern "C" int wcmc_pathnet_embed_bwd(const void* x, const void* ge, const void* gmean,
                                      const void* wpack, const void* bpack, void* dx, void* parts,
                                      void* out, int B, int S, int HW, int c0, int c3, int act0,
                                      int act1, int act2, int n_blocks, int device, void* stream) {
  if (c0 < 1 || c3 < 16 || c3 > kEW || c3 % 16 || S < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  for (const void* p : {ge, gmean, wpack, bpack})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const EmbedBwdArgs args{static_cast<const bf16*>(x), static_cast<const bf16*>(ge),
                          static_cast<const float*>(gmean), static_cast<const bf16*>(wpack),
                          static_cast<const float*>(bpack), static_cast<bf16*>(dx),
                          static_cast<float*>(parts), B, S, HW, c0, c3,
                          c0 <= 48 ? 48 : round_up(c0, 96)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act0 == 1 && act1 == 1 && act2 == 0 && dx == nullptr)  // PathNet: relu, relu, linear
    return launch_form<1, 1, 0, false>(args, out, n_blocks, device, s);
  if (act0 == 2 && act1 == 2 && act2 == 2 && dx != nullptr)  // Multisteps: leaky x 3, d(x)
    return launch_form<2, 2, 2, true>(args, out, n_blocks, device, s);
  return cudaErrorInvalidValue;
}
