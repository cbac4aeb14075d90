// K5-bwd: the gradients of the per-sample head over [e | broadcast_S(ctx)]
// (K5-fwd), from the cotangents of its output and of its two sample
// moments.
//
//   h1 = bf16(a1(e . W1e + ctx . W1c + b1)),  h2 = a2(h1 . W2 + b2)          (h2 f32)
//   gz2 = a2'(h2, g + gsum + 2 h2 gsq)
//   g1  = a1'(h1, bf16(gz2) . W2^T)
//   de  = bf16(bf16(g1) . W1e^T)                 per sample
//   dctx = sum_s bf16(g1) . W1c^T                f32, summed over S
//   dW2 = h1^T . bf16(gz2), dW1e = e^T . bf16(g1), dW1c = ctx^T . bf16(g1)   f32, over all rows
//   db2 = sum gz2, db1 = sum g1                  f32, unrounded
//
// a' is taken through the post-activation value (mlp_act_grad of
// mlp.cuh).  A cotangent passed as null is zero.  The context is the same
// for all samples of a pixel, so ctx . W1c + b1 is computed once per pixel
// tile and starts each sample's layer-1 accumulator, and the context's
// gradients come from G = sum_s bf16(g1) per pixel, once rather than S
// times: dctx = G . W1c^T, dW1c = ctx^T . G.  G is an f32 sum, so it
// enters the bf16 tensor cores as two terms, G = hi + lo with hi =
// bf16(G) and lo = bf16(G - hi) (relative error ~2^-16).  Each persistent
// block sums its weight and bias gradients into its own f32 partials,
// each element by one thread in a fixed order, and a second launch adds
// those in block order: no float atomics, so two launches give the same
// bits.  Replaces
// wcmc_tpu/ops/pathnet_fused.py::_head_bwd_pallas (pallas_call :578, body
// _head_bwd_kernel :343), which keeps its weight-gradient sums resident in
// VMEM across a sequential grid.  Two forms, chosen by the C entry point:
//
// The tiled form: Multisteps' update chain, leaky-leaky, [128 | 128] ->
// 128 -> 128, a bf16 channels-last output cotangent, with `gsum` (steps 0
// and 1) or no moments (step 2).  What bounds it on the H100: bytes, ~0.97
// GB per launch at the SBMC training shape (8 patches x 8 spp x 128^2 px:
// e, g and de in bf16, ~268 MB each, the context, its f32 gradient and
// gsum) over 3.35 TB/s, 0.29 ms, against ~2.2e11 flops (six 128 x 128
// products per row and three per pixel), 0.22 ms at the bf16 dense peak.
// Design:
// - Tiles of 32 pixels of one image; samples in chunks of 2, so every
//   product has 64 rows (a wgmma's m64), pixel-major (row r: pixel r / 2
//   of sample s0 + r % 2).  256 threads, two warpgroups; each warpgroup
//   owns half of every 128-wide product's columns (m64n64) or of the
//   weight gradients' rows (m64n128).
// - dW2 and dW1e stay in registers for the block's whole persistent run
//   (each warp 16 of their 128 rows x 128 columns: 2 x 64 f32 a thread)
//   and are written to the block's partials once, at the end.  dW1c is
//   formed once per pixel tile (K = 2 x 32: ctx^T . G_hi + ctx^T . G_lo)
//   and added to the block's partial then, straight from the
//   accumulators by plain loads, adds and stores of the thread that owns
//   each element (the first tile stores); d(ctx) is written once per tile.
// - W1e and W2, packed once per parameter value by the wrapper
//   (ops/pathnet_fused.py, pack_head_weights) as 8 x 8 core matrices
//   ("blocked"), are staged in shared memory once per block by two bulk
//   copies.  One copy of each serves both ways: B = W is read with its
//   rows along K (transposed), B = W^T with its rows along N.  W1c is read
//   twice per tile only (ctx . W1c and G . W1c^T), as mma.m16n8k16 B
//   fragments straight from device memory, in the order the warps load
//   them (8 contiguous bytes a lane).
// - Products on wgmma (m64n64k16 and m64n128k16, bf16, f32 accumulators),
//   both operands in shared memory through descriptors (no swizzle): e,
//   h1, bf16(gz2) and g1 are blocked tiles like the weights, so e^T and
//   h1^T, the A operands of the weight gradients, are the same tiles read
//   with their rows along K; no copy is transposed.  dW2 and the g1
//   product are issued as one group, dW1e and the de product as another.
// - Copies: every row of e and g comes in by 16-byte cp.async into the
//   blocked tiles (8 threads cover one 16-byte piece of 8 rows, so a warp
//   reads 64 contiguous bytes of 8 rows), what lies past S or HW
//   zero-filled, each thread then arriving on the buffer's mbarrier once
//   its copies have landed; the context and gsum come the same way as
//   padded rows (16 bytes of pad keep ldmatrix reads of 8 rows in 8 bank
//   groups).  e through a 2-stage ring (chunk c + 2 is fetched once chunk
//   c's last product has read its stage), g into one buffer refilled as
//   soon as the chunk's cotangent is formed, the context into two buffers
//   by tile, gsum into one refilled after a tile's last cotangent.  d(e)
//   is staged as padded rows in the freed bf16(gz2) buffer and leaves in
//   16-byte stores.  (One 1-D bulk copy or store per 256-byte row, issued
//   by one warp, cost more than all the products of a chunk.)
// - Epilogues work on the accumulators in registers (each warp's 16 rows
//   in the m16n8 layout): the activations and their gradients, the bf16
//   roundings, the bias column sums (warp shuffles in a fixed order into
//   each warp's running sums, added in warp order at the end), G's update
//   (the two samples of a pixel sit in lanes 4 apart: one shuffle, added
//   in sample order) and the stores of h1, bf16(gz2) and g1 as blocked
//   tiles; g1 overwrites h1 in place.  A cotangent that is absent is a
//   buffer left zero, read like the others.  Four block barriers and one
//   warpgroup barrier per chunk.
// - ctx . W1c, d(ctx) and dW1c (at most 2 x 32 rows of K each) run on
//   mma.sync with ldmatrix.
// Shared memory (bytes, tiled_smem): W1e 32768, W2 32768, the e ring
// 32768, g 16384, h1 / g1 (also [G_hi | G_lo]) 16896, bf16(gz2) (also the
// staged d(e)) 17408, two context tiles 17408, ctx . W1c + b1 17408, G
// 17408, gsum 17408, b2, the warps' bias sums and the mbarriers: 223360
// of the 232448 a block may opt into, one block per SM (the kernel
// checks its carve against the launch's size).  Registers: dW2 and dW1e
// 128 a thread, a 64 x 64 product's accumulators 32 more; 255 in all, no
// spills (-Xptxas -v).
//
// PathNet's form: relu-relu, Cout <= 16 (zero-padded to 16), an f32
// cotangent, channel-major for the KPCN training head, channels-last for
// LBMC's and SBMC's PathNet.  At the KPCN training shape (Ce = Cc = 128,
// 256 -> 256 -> 6, both branches merged) it is bound by operations,
// closely followed by bytes: ~730 MB (e and de in bf16, the f32 context
// gradient) for ~232 GFLOP.  Its body is unchanged from the first port:
// a block owns 16 pixels and takes their samples in chunks of 8 (128
// rows per weight-gradient product) on wmma, adding the weight gradients
// into its partials in device memory chunk by chunk, weights read through
// L1/L2 by the fragment loads; its weights come packed like the tiled
// form's (W2 and b2 zero-padded once per parameter value, not per call).
#include "hopper.cuh"
#include "mlp.cuh"

namespace wcmc {

constexpr int kBwdPix = 16;

struct HeadBwdDims {
  int ce, cc, c1, cout;
};

__host__ __device__ inline long long head_bwd_parts(const HeadBwdDims& d, int kout) {
  return (long long)d.ce * d.c1 + (long long)d.cc * d.c1 + (long long)d.c1 * kout + d.c1 + kout;
}

inline size_t pathnet_bwd_smem(const HeadBwdDims& d, int kout, int chunk) {
  const int rows = kBwdPix * chunk;
  return smem_bytes((size_t)kBwdPix * pitch_bf16(d.cc), 2) +
         smem_bytes((size_t)kBwdPix * pitch_f32(d.c1), 4) +
         smem_bytes((size_t)rows * pitch_bf16(d.ce), 2) +
         smem_bytes((size_t)rows * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)rows * pitch_bf16(kout), 2) + smem_bytes((size_t)rows * kout, 4) +
         2 * smem_bytes((size_t)kBwdPix * kout, 4) + smem_bytes((size_t)kBwdPix * d.c1, 4) +
         2 * smem_bytes((size_t)kBwdPix * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)kWarps * 256, 4) + smem_bytes((size_t)chunk * d.c1, 4) +
         2 * smem_bytes(d.c1, 4) + 2 * smem_bytes(kout, 4);
}

// PathNet's form.  TG: the output cotangent's type; kA1, kA2: the
// layers' activation codes; kOut: W2's staged width (Cout zero-padded);
// kChunk: samples per chunk.
template <typename TG, int kA1, int kA2, int kOut, int kChunk>
__global__ void __launch_bounds__(kThreads)
    pathnet_head_bwd_kernel(const bf16* __restrict__ e, const bf16* __restrict__ ctx,
                            const TG* __restrict__ g, const float* __restrict__ gsum,
                            const float* __restrict__ gsq, const bf16* __restrict__ w1,
                            const float* __restrict__ b1, const bf16* __restrict__ w2,
                            const float* __restrict__ b2, bf16* __restrict__ de,
                            float* __restrict__ dctx, float* __restrict__ parts, int B, int S,
                            int HW, HeadBwdDims d, int cmajor) {
  constexpr int kRows = kBwdPix * kChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  using row = wmma::row_major;
  using col = wmma::col_major;
  const int p_ctx = pitch_bf16(d.cc), p_z = pitch_f32(d.c1), p_e = pitch_bf16(d.ce);
  const int p_h = pitch_bf16(d.c1), p_gz = pitch_bf16(kOut);
  SmemCarver carve{smem, 0};
  bf16* s_ctx = carve.take<bf16>((size_t)kBwdPix * p_ctx);
  float* s_ctxz = carve.take<float>((size_t)kBwdPix * p_z);
  bf16* s_e = carve.take<bf16>((size_t)kRows * p_e);
  bf16* s_h = carve.take<bf16>((size_t)kRows * p_h);   // h1, then g1
  bf16* s_gz = carve.take<bf16>((size_t)kRows * p_gz);  // bf16(gz2)
  float* s_gf = carve.take<float>((size_t)kRows * kOut);  // g, then gz2 in f32
  float* s_gsum = carve.take<float>((size_t)kBwdPix * kOut);
  float* s_gsq = carve.take<float>((size_t)kBwdPix * kOut);
  float* s_gacc = carve.take<float>((size_t)kBwdPix * d.c1);  // sum_s bf16(g1)
  bf16* s_ghi = carve.take<bf16>((size_t)kBwdPix * p_h);
  bf16* s_glo = carve.take<bf16>((size_t)kBwdPix * p_h);
  float* s_stage = carve.take<float>((size_t)kWarps * 256);
  float* s_dbpart = carve.take<float>((size_t)kChunk * d.c1);
  float* s_db1 = carve.take<float>(d.c1);
  float* s_b1 = carve.take<float>(d.c1);
  float* s_db2 = carve.take<float>(kOut);
  float* s_b2 = carve.take<float>(kOut);

  const bf16* w1e = w1;
  const bf16* w1c = w1 + (size_t)d.ce * d.c1;
  const long long n_parts = head_bwd_parts(d, kOut);
  float* part = parts + (size_t)blockIdx.x * n_parts;
  float* p_dw1e = part;
  float* p_dw1c = p_dw1e + (size_t)d.ce * d.c1;
  float* p_dw2 = p_dw1c + (size_t)d.cc * d.c1;
  float* p_db = p_dw2 + (size_t)d.c1 * kOut;
  for (long long i = threadIdx.x; i < n_parts; i += blockDim.x) part[i] = 0.0f;
  for (int i = threadIdx.x; i < d.c1; i += blockDim.x) s_db1[i] = 0.0f, s_b1[i] = b1[i];
  for (int i = threadIdx.x; i < kOut; i += blockDim.x) s_db2[i] = 0.0f, s_b2[i] = b2[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_per_image = (HW + kBwdPix - 1) / kBwdPix;
  const int n_tiles = B * tiles_per_image;
  const int n_col1 = d.c1 / 16, n_colo = kOut / 16;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_image;
    const int row0 = (t % tiles_per_image) * kBwdPix;
    const int rows = min(kBwdPix, HW - row0);
    const size_t pix0 = (size_t)b * HW + row0;
    for (int i = threadIdx.x; i < kBwdPix * d.cc; i += blockDim.x) {
      const int r = i / d.cc, c = i % d.cc;
      s_ctx[r * p_ctx + c] = r < rows ? ctx[(pix0 + r) * d.cc + c] : zero;
    }
    for (int i = threadIdx.x; i < kBwdPix * kOut; i += blockDim.x) {
      const int r = i / kOut, c = i % kOut;
      const bool ok = r < rows && c < d.cout;
      s_gsum[i] = ok && gsum != nullptr ? gsum[(pix0 + r) * d.cout + c] : 0.0f;
      s_gsq[i] = ok && gsq != nullptr ? gsq[(pix0 + r) * d.cout + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < kBwdPix * d.c1; i += blockDim.x) s_gacc[i] = 0.0f;
    __syncthreads();
    // ctx . W1c + b1, once per pixel
    for (int f = warp; f < n_col1; f += kWarps) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      frag_mma<row, row>(acc, s_ctx, p_ctx, w1c, d.c1, 0, f * 16, d.cc);
      float* st = stage_frag(acc, s_stage);
      for (int i = lane; i < 256; i += 32) {
        const int c = f * 16 + i % 16;
        s_ctxz[(i / 16) * p_z + c] = st[i] + s_b1[c];
      }
      __syncwarp();
    }

    for (int s0 = 0; s0 < S; s0 += kChunk) {
      const int sc = min(kChunk, S - s0), n_rows = kBwdPix * sc;
      for (int i = threadIdx.x; i < n_rows * d.ce; i += blockDim.x) {
        const int r = i / d.ce, c = i % d.ce, pr = r % kBwdPix;
        const size_t rw = ((size_t)b * S + s0 + r / kBwdPix) * HW + row0 + pr;
        s_e[r * p_e + c] = pr < rows ? e[rw * d.ce + c] : zero;
      }
      // the output cotangent in its own layout, the loads along its
      // contiguous axis: pixels for channel-major, channels otherwise
      if (cmajor) {
        for (int i = threadIdx.x; i < n_rows * kOut; i += blockDim.x) {
          const int pr = i % kBwdPix, c = (i / kBwdPix) % kOut, si = i / (kBwdPix * kOut);
          s_gf[(si * kBwdPix + pr) * kOut + c] =
              (g != nullptr && pr < rows && c < d.cout)
                  ? to_f32(g[(((size_t)b * S + s0 + si) * d.cout + c) * HW + row0 + pr])
                  : 0.0f;
        }
      } else {
        for (int i = threadIdx.x; i < n_rows * kOut; i += blockDim.x) {
          const int r = i / kOut, c = i % kOut, pr = r % kBwdPix;
          const size_t rw = ((size_t)b * S + s0 + r / kBwdPix) * HW + row0 + pr;
          s_gf[i] = (g != nullptr && pr < rows && c < d.cout) ? to_f32(g[rw * d.cout + c]) : 0.0f;
        }
      }
      __syncthreads();  // s_ctxz, s_e, s_gf
      // h1 = a1(e . W1e + ctx . W1c + b1)
      for (int f = warp; f < sc * n_col1; f += kWarps) {
        const int r0 = (f / n_col1) * 16, c0 = (f % n_col1) * 16;
        Acc acc;
        wmma::load_matrix_sync(acc, s_ctxz + c0, p_z, wmma::mem_row_major);
        frag_mma<row, row>(acc, s_e, p_e, w1e, d.c1, r0, c0, d.ce);
        float* st = stage_frag(acc, s_stage);
        for (int i = lane; i < 256; i += 32)
          s_h[(r0 + i / 16) * p_h + c0 + i % 16] = __float2bfloat16(mlp_act(kA1, st[i]));
        __syncwarp();
      }
      __syncthreads();
      // h2 (f32) and the output cotangent with the moments folded in
      for (int f = warp; f < sc * n_colo; f += kWarps) {
        const int r0 = (f / n_colo) * 16, c0 = (f % n_colo) * 16;
        Acc acc;
        wmma::fill_fragment(acc, 0.0f);
        frag_mma<row, row>(acc, s_h, p_h, w2, kOut, r0, c0, d.c1);
        float* st = stage_frag(acc, s_stage);
        for (int i = lane; i < 256; i += 32) {
          const int r = r0 + i / 16, c = c0 + i % 16, pr = r % kBwdPix;
          const float h2 = mlp_act(kA2, st[i] + s_b2[c]);
          const float gg = s_gf[r * kOut + c] + s_gsum[pr * kOut + c] +
                           2.0f * h2 * s_gsq[pr * kOut + c];
          const float gz = c < d.cout ? mlp_act_grad(kA2, h2, gg) : 0.0f;
          s_gf[r * kOut + c] = gz;
          s_gz[r * p_gz + c] = __float2bfloat16(gz);
        }
        __syncwarp();
      }
      __syncthreads();
      for (int c = threadIdx.x; c < kOut; c += blockDim.x) {
        float sum = 0.0f;
        for (int r = 0; r < n_rows; ++r) sum += s_gf[r * kOut + c];
        s_db2[c] += sum;
      }
      // dW2 += h1^T . bf16(gz2)
      for (int f = warp; f < n_col1 * n_colo; f += kWarps) {
        const int r0 = (f / n_colo) * 16, c0 = (f % n_colo) * 16;
        Acc acc;
        float* p = p_dw2 + (size_t)r0 * kOut + c0;
        wmma::load_matrix_sync(acc, p, kOut, wmma::mem_row_major);
        frag_mma<col, row>(acc, s_h, p_h, s_gz, p_gz, r0, c0, n_rows);
        wmma::store_matrix_sync(p, acc, kOut, wmma::mem_row_major);
      }
      __syncthreads();  // h1 is read; g1 overwrites it
      // g1 = a1'(h1, bf16(gz2) . W2^T), with its column sums
      for (int f = warp; f < sc * n_col1; f += kWarps) {
        const int r0 = (f / n_col1) * 16, c0 = (f % n_col1) * 16;
        Acc acc;
        wmma::fill_fragment(acc, 0.0f);
        frag_mma<row, col>(acc, s_gz, p_gz, w2, kOut, r0, c0, kOut);
        float* st = stage_frag(acc, s_stage);
        for (int i = lane; i < 256; i += 32) {
          bf16* h = s_h + (r0 + i / 16) * p_h + c0 + i % 16;
          const float v = mlp_act_grad(kA1, __bfloat162float(*h), st[i]);
          st[i] = v;
          *h = __float2bfloat16(v);
        }
        __syncwarp();
        const float cs = stage_col_sum(st);
        if (lane < 16) s_dbpart[(r0 / 16) * d.c1 + c0 + lane] = cs;
        __syncwarp();
      }
      __syncthreads();
      for (int c = threadIdx.x; c < d.c1; c += blockDim.x) {
        float sum = 0.0f;
        for (int rb = 0; rb < sc; ++rb) sum += s_dbpart[rb * d.c1 + c];
        s_db1[c] += sum;
      }
      for (int i = threadIdx.x; i < kBwdPix * d.c1; i += blockDim.x) {
        const int pr = i / d.c1, c = i % d.c1;
        float v = s_gacc[i];
        for (int si = 0; si < sc; ++si) v += __bfloat162float(s_h[(si * kBwdPix + pr) * p_h + c]);
        s_gacc[i] = v;
      }
      // de = bf16(g1) . W1e^T, per sample
      const int n_cole = d.ce / 16;
      for (int f = warp; f < sc * n_cole; f += kWarps) {
        const int r0 = (f / n_cole) * 16, c0 = (f % n_cole) * 16;
        Acc acc;
        wmma::fill_fragment(acc, 0.0f);
        frag_mma<row, col>(acc, s_h, p_h, w1e, d.c1, r0, c0, d.c1);
        float* st = stage_frag(acc, s_stage);
        for (int i = lane; i < 256; i += 32) {
          const int r = r0 + i / 16, pr = r % kBwdPix;
          if (pr < rows) {
            const size_t rw = ((size_t)b * S + s0 + r / kBwdPix) * HW + row0 + pr;
            de[rw * d.ce + c0 + i % 16] = __float2bfloat16(st[i]);
          }
        }
        __syncwarp();
      }
      // dW1e += e^T . bf16(g1)
      for (int f = warp; f < n_cole * n_col1; f += kWarps) {
        const int r0 = (f / n_col1) * 16, c0 = (f % n_col1) * 16;
        Acc acc;
        float* p = p_dw1e + (size_t)r0 * d.c1 + c0;
        wmma::load_matrix_sync(acc, p, d.c1, wmma::mem_row_major);
        frag_mma<col, row>(acc, s_e, p_e, s_h, p_h, r0, c0, n_rows);
        wmma::store_matrix_sync(p, acc, d.c1, wmma::mem_row_major);
      }
      __syncthreads();  // before the next chunk overwrites the tiles
    }

    // the context's gradients from G = sum_s bf16(g1) = hi + lo
    for (int i = threadIdx.x; i < kBwdPix * d.c1; i += blockDim.x) {
      const int pr = i / d.c1, c = i % d.c1;
      const float v = s_gacc[i];
      const bf16 hi = __float2bfloat16(v);
      s_ghi[pr * p_h + c] = hi;
      s_glo[pr * p_h + c] = __float2bfloat16(v - __bfloat162float(hi));
    }
    __syncthreads();
    const int n_colc = d.cc / 16;
    for (int f = warp; f < n_colc; f += kWarps) {
      Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      frag_mma<row, col>(acc, s_ghi, p_h, w1c, d.c1, 0, f * 16, d.c1);
      frag_mma<row, col>(acc, s_glo, p_h, w1c, d.c1, 0, f * 16, d.c1);
      float* st = stage_frag(acc, s_stage);
      for (int i = lane; i < 256; i += 32) {
        const int r = i / 16;
        if (r < rows) dctx[(pix0 + r) * d.cc + f * 16 + i % 16] = st[i];
      }
      __syncwarp();
    }
    for (int f = warp; f < n_colc * n_col1; f += kWarps) {
      const int r0 = (f / n_col1) * 16, c0 = (f % n_col1) * 16;
      Acc acc;
      float* p = p_dw1c + (size_t)r0 * d.c1 + c0;
      wmma::load_matrix_sync(acc, p, d.c1, wmma::mem_row_major);
      frag_mma<col, row>(acc, s_ctx, p_ctx, s_ghi, p_h, r0, c0, kBwdPix);
      frag_mma<col, row>(acc, s_ctx, p_ctx, s_glo, p_h, r0, c0, kBwdPix);
      wmma::store_matrix_sync(p, acc, d.c1, wmma::mem_row_major);
    }
    __syncthreads();  // before the next tile overwrites the context tiles
  }
  for (int c = threadIdx.x; c < d.c1; c += blockDim.x) p_db[c] = s_db1[c];
  for (int c = threadIdx.x; c < kOut; c += blockDim.x) p_db[d.c1 + c] = s_db2[c];
}

// ---------------------------------------------------------------------------
// The tiled form (Multisteps' update chain)
// ---------------------------------------------------------------------------

constexpr int kTPix = 32;                    // pixels of one image per tile
constexpr int kTSamples = 2;                 // samples per chunk
constexpr int kTRows = kTPix * kTSamples;    // rows per product: a wgmma's m64
constexpr int kTW = 128;                     // Ce = Cc = C1 = W2's staged width
constexpr int kTPitch = kTW + 8;             // padded bf16 row of a staged tile (272 bytes)
constexpr int kTPitchF = kTW + 8;            // padded f32 row (544 bytes)
constexpr int kTHiLo = 2 * kTW + 8;          // a [G_hi | G_lo] row (528 bytes)
constexpr int kTThreads = 256;               // two warpgroups
constexpr int kTBlocked = kTW / 8 * 128;     // bytes between 8-row groups of a blocked matrix
constexpr long long kTParts = 3LL * kTW * kTW + 2 * kTW;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The block's shared memory, in the order the kernel carves it;
// ops/pathnet_fused.py's head_bwd_plan computes the same sum.
inline size_t tiled_smem() {
  return 2 * smem_bytes((size_t)kTW * kTW, 2) + smem_bytes(2 * kTRows * kTW, 2) +
         smem_bytes(kTRows * kTW, 2) + smem_bytes(cmax(kTRows * kTW, kTPix * kTHiLo), 2) +
         smem_bytes(cmax(kTRows * kTW, kTRows * kTPitch), 2) +
         smem_bytes(2 * kTPix * kTPitch, 2) + 3 * smem_bytes(kTPix * kTPitchF, 4) +
         smem_bytes(kTW, 4) + smem_bytes(2 * 8 * 64, 4) + smem_bytes(7, 8);
}

struct TiledArgs {
  const bf16* e;      // (B, S, HW, 128)
  const bf16* ctx;    // (B, HW, 128)
  const bf16* g;      // (B, S, HW, 128) or null
  const float* gsum;  // (B, HW, 128) or null
  const float* gsq;   // (B, HW, 128) or null
  const bf16* w;      // pack_head_weights: blocked W1e | blocked W2 | W1c and W1c^T fragments
  const float* bias;  // b1 (128) | b2 (128)
  bf16* de;           // (B, S, HW, 128)
  float* dctx;        // (B, HW, 128)
  float* parts;       // gridDim.x partials of kTParts floats
  int B, S, HW, cout;
};

// Byte offset of element (r, c) of a blocked 128-wide bf16 matrix (8 x 8
// core matrices, 8-row groups kTBlocked bytes apart; c a multiple of 2).
__device__ inline unsigned blk(int r, int c) {
  return (r / 8) * kTBlocked + (c / 8) * 128 + (r % 8) * 16 + (c % 8) * 2;
}

// A lane's ldmatrix address of an A operand, the warp's 16 rows (m0 on)
// at k16 step 0, in a tile of bf16 rows `pitch` bytes apart; transposed
// (kTrans), A(m, k) = X[k][m] and the 16 rows are X's columns m0 on.
template <bool kTrans>
__device__ inline unsigned a_lane(unsigned base, int m0, int pitch) {
  const int lane = threadIdx.x % 32, r8 = lane & 7, i = lane >> 3;
  const int r = kTrans ? 8 * (i >> 1) + r8 : m0 + r8 + 8 * (i & 1);
  const int c = kTrans ? m0 + 8 * (i & 1) : 8 * (i >> 1);
  return base + r * pitch + 2 * c;
}

// acc (this warp's 16 rows x 8 kN8 columns) += A . B over kK16 k16
// steps, on mma.sync.  A comes through ldmatrix (kATrans: transposed) at
// a + ks kAStep; B is 8 x 8 blocks in shared memory from b (its first
// column), kBK bytes apart along K, kBN along N, their rows kBRow apart
// and running along K when kBMN (then read transposed), along N
// otherwise.
template <int kN8, int kK16, bool kATrans, int kAStep, bool kBMN, int kBK, int kBN, int kBRow>
__device__ inline void product(float (&acc)[kN8][4], unsigned a, unsigned b) {
  const int lane = threadIdx.x % 32, i = lane >> 3;
  const unsigned b_lane = b + (i & 1) * kBK + (i >> 1) * kBN + (lane & 7) * kBRow;
#pragma unroll
  for (int ks = 0; ks < kK16; ++ks) {
    unsigned af[4];
    ldsm_x4<kATrans>(af, a + ks * kAStep);
#pragma unroll
    for (int jj = 0; jj < kN8 / 2; ++jj) {
      unsigned bf[4];
      ldsm_x4<kBMN>(bf, b_lane + 2 * ks * kBK + 2 * jj * kBN);
      mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (this warp's 16 rows x 8 kN8 columns) += A . B on mma.sync, for a
// 128-deep B read from device memory in frag_order (pack_head_weights):
// its n8 tiles j0 on, each lane's 8 bytes of a fragment one load.  A comes
// through ldmatrix at a + ks a_step; with a_two, A . B + A2 . B with A2
// at a + a_two + ks a_step, the two sharing B's fragments.
template <int kN8>
__device__ inline void product_frag(float (&acc)[kN8][4], unsigned a, int a_step, int a_two,
                                    const bf16* __restrict__ wf, int j0) {
  const uint2* f = reinterpret_cast<const uint2*>(wf) + threadIdx.x % 32;
#pragma unroll 2
  for (int ks = 0; ks < kTW / 16; ++ks) {
    uint2 bf[kN8];
#pragma unroll
    for (int j = 0; j < kN8; ++j) bf[j] = __ldg(f + (ks * (kTW / 8) + j0 + j) * 32);
    unsigned af[4];
    ldmatrix_x4(af, a + ks * a_step);
#pragma unroll
    for (int j = 0; j < kN8; ++j) mma_bf16(acc[j], af, bf[j].x, bf[j].y);
    if (a_two != 0) {
      ldmatrix_x4(af, a + a_two + ks * a_step);
#pragma unroll
      for (int j = 0; j < kN8; ++j) mma_bf16(acc[j], af, bf[j].x, bf[j].y);
    }
  }
}

// A blocked 128-wide matrix as a wgmma operand: read K-major (its rows
// along M or N, 16 bytes of K each), or transposed (its rows along K).
__device__ inline uint64_t desc_k(unsigned addr) { return smem_desc(addr, 128, kTBlocked); }
__device__ inline uint64_t desc_t(unsigned addr) { return smem_desc(addr, kTBlocked, 128); }

// Issues acc += A . B over kK16 k16 steps for the warpgroup, a and b the
// descriptors of step 0, advanced kAStep and kBStep bytes a step.
template <int kN8, int kK16, int kTA, int kTB, int kAStep, int kBStep>
__device__ inline void wg_issue(float (&acc)[kN8][4], uint64_t a, uint64_t b) {
#pragma unroll
  for (int ks = 0; ks < kK16; ++ks) {
    const uint64_t da = a + (uint64_t)((ks * kAStep) >> 4), db = b + (uint64_t)((ks * kBStep) >> 4);
    if constexpr (kN8 == 8) {
      wgmma_ss_n64<kTA, kTB>(acc, da, db);
    } else {
      wgmma_ss_n128<kTA, kTB>(acc, da, db);
    }
  }
}

// K-major operands step 2 core matrices (256 bytes) along K per k16,
// transposed ones 2 row groups
constexpr int kStepK = 256, kStepT = 2 * kTBlocked;

// Column sums over the warp's 16 rows of an accumulator pair (rows g and
// g + 8 of the lane's two columns), in a fixed order, added to the warp's
// running sums at col (the pair's first column).  The 8 lanes of a column
// end with the same sum and write the same value: no divergent branch.
__device__ inline void add_col_sums(float* sums, int col, float v0, float v1) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, o);
    v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  float2* p = reinterpret_cast<float2*>(sums + col);
  float2 v = *p;
  v.x += v0;
  v.y += v1;
  __syncwarp();  // every lane has read before any writes
  *p = v;
}

// kA: both layers' activation code; kGsq: whether a gsq cotangent is given.
template <int kA, bool kGsq>
__global__ void __launch_bounds__(kTThreads, 1) pathnet_head_bwd_tiled_kernel(TiledArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarver carve{smem, 0};
  bf16* s_w1e = carve.take<bf16>(kTW * kTW);
  bf16* s_w2 = carve.take<bf16>(kTW * kTW);
  bf16* s_e = carve.take<bf16>(2 * kTRows * kTW);      // the e ring (blocked)
  bf16* s_g = carve.take<bf16>(kTRows * kTW);          // the output cotangent (blocked)
  bf16* s_h = carve.take<bf16>(cmax(kTRows * kTW, kTPix * kTHiLo));  // h1, then g1; [G_hi | G_lo]
  // bf16(gz2) (blocked); then d(e) as padded rows
  bf16* s_gz = carve.take<bf16>(cmax(kTRows * kTW, kTRows * kTPitch));
  bf16* s_ctx = carve.take<bf16>(2 * kTPix * kTPitch);
  float* s_zc = carve.take<float>(kTPix * kTPitchF);   // ctx . W1c + b1
  float* s_G = carve.take<float>(kTPix * kTPitchF);    // sum_s bf16(g1)
  float* s_gsum = carve.take<float>(kTPix * kTPitchF);
  float* s_b2 = carve.take<float>(kTW);
  float* s_db = carve.take<float>(2 * 8 * 64);         // per warp: db1 | db2 running sums
  unsigned long long* s_bars = carve.take<unsigned long long>(7);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what tiled_smem() sums
  const unsigned u_w1e = smem_addr(s_w1e), u_w2 = smem_addr(s_w2), u_e = smem_addr(s_e);
  const unsigned u_g = smem_addr(s_g), u_h = smem_addr(s_h), u_gz = smem_addr(s_gz);
  const unsigned u_ctx = smem_addr(s_ctx), u_zc = smem_addr(s_zc), u_gsum = smem_addr(s_gsum);
  // mbarriers: 0 the weights, 1-2 the e ring, 3 g, 4-5 the context tiles, 6 gsum
  const unsigned bar0 = smem_addr(s_bars);
  constexpr unsigned kEBytes = kTRows * kTW * 2, kCtxBytes = kTPix * kTPitch * 2;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, q = warp % 4, g8 = lane / 4, t4 = lane % 4;
  const int S = a.S, HW = a.HW;
  const int per_image = (HW + kTPix - 1) / kTPix;
  const int n_tiles = a.B * per_image, n_chunks = (S + kTSamples - 1) / kTSamples;
  const int n_mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = n_mine * n_chunks;
  float* part = a.parts + (size_t)blockIdx.x * kTParts;
  float* p_dw1c = part + kTW * kTW;

  auto tile_of = [&](int k, int& b, int& row0, int& npx) {
    const int t = (int)blockIdx.x + k * (int)gridDim.x;
    b = t / per_image;
    row0 = (t % per_image) * kTPix;
    npx = min(kTPix, HW - row0);
  };
  // Copies, by every thread: 16 bytes a cp.async, what lies past S or HW
  // zero-filled; each thread then arrives on the buffer's mbarrier once
  // its copies have landed (every mbarrier but the weights' expects all
  // 256 arrivals).  A chunk's rows are pixel-major: row r is pixel r / 2
  // of sample s0 + r % 2.  e and g go into blocked stages; 8 threads take
  // one 16-byte piece of 8 rows, so each warp reads 64 contiguous bytes of
  // 8 rows and writes 4 whole core matrices: thread tid copies rows f_r +
  // 16 m, m < 4, at column f_col.
  const int f_r = 8 * (tid / 128) + tid % 8, f_col = 8 * ((tid / 8) % 16);
  const int f_si = f_r % kTSamples, f_px = f_r / kTSamples;
  const unsigned f_dst = blk(f_r, f_col);
  auto fetch_rows = [&](const bf16* src, unsigned dst, unsigned bar, int c) {
    int b, row0, npx;
    tile_of(c / n_chunks, b, row0, npx);
    const int s0 = (c % n_chunks) * kTSamples;
    const bool s_in = s0 + f_si < S;
    const bf16* from = src + (((size_t)b * S + s0 + f_si) * HW + row0 + f_px) * kTW + f_col;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const bool ok = s_in && f_px + 8 * m < npx;
      cp_async16_zfill(dst + f_dst + 2 * m * kTBlocked, ok ? from + 8 * m * kTW : src,
                       ok ? 16 : 0);
    }
    cp_async_mbar_arrive(bar);
  };
  // a tile's pixels of the context (bf16) or of gsum (f32), as padded rows
  auto fetch_pix = [&](const void* src, int elem, unsigned dst, int pitch, unsigned bar, int k) {
    int b, row0, npx;
    tile_of(k, b, row0, npx);
    const int pieces = kTW * elem / 16;
    for (int i = tid; i < kTPix * pieces; i += kTThreads) {
      const int px = i / pieces, p = i % pieces;
      const bool ok = px < npx;
      const char* from = static_cast<const char*>(src) +
                         (ok ? ((size_t)b * HW + row0 + px) * kTW * elem + 16 * p : 0);
      cp_async16_zfill(dst + px * pitch + 16 * p, from, ok ? 16 : 0);
    }
    cp_async_mbar_arrive(bar);
  };
  auto fetch_e = [&](int c) { fetch_rows(a.e, u_e + (c & 1) * kEBytes, bar0 + 8 * (1 + (c & 1)), c); };
  auto fetch_g = [&](int c) { fetch_rows(a.g, u_g, bar0 + 24, c); };
  auto fetch_ctx = [&](int k) {
    fetch_pix(a.ctx, 2, u_ctx + (k & 1) * kCtxBytes, kTPitch * 2, bar0 + 8 * (4 + (k & 1)), k);
  };
  auto fetch_gsum = [&](int k) { fetch_pix(a.gsum, 4, u_gsum, kTPitchF * 4, bar0 + 48, k); };
  // a chunk's d(e), staged as padded rows in s_gz, out 16 bytes a store
  // (16 threads a row): thread tid stores rows d_r + 16 m, m < 4, at
  // column d_col
  const int d_r = tid / 16, d_col = 8 * (tid % 16), d_si = d_r % kTSamples, d_px = d_r / kTSamples;
  auto store_de = [&](int b, int row0, int npx, int s0) {
    if (s0 + d_si >= S) return;
    bf16* to = a.de + (((size_t)b * S + s0 + d_si) * HW + row0 + d_px) * kTW + d_col;
    const bf16* from = s_gz + d_r * kTPitch + d_col;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (d_px + 8 * m < npx)
        *reinterpret_cast<uint4*>(to + 8 * m * kTW) =
            *reinterpret_cast<const uint4*>(from + 16 * m * kTPitch);
  };

  // Zero every staged buffer once so that rows never written stay finite.
  for (uint4* p = reinterpret_cast<uint4*>(s_e) + tid; p < reinterpret_cast<uint4*>(s_b2);
       p += kTThreads)
    *p = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < 2 * 8 * 64; i += kTThreads) s_db[i] = 0.0f;
  for (int i = tid; i < kTW; i += kTThreads) s_b2[i] = a.bias[kTW + i];
  if (tid == 0) {
    for (int i = 0; i < 7; ++i) mbar_init(bar0 + 8 * i, i == 0 ? 1 : kTThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (total > 0) {
    if (tid == 0) {
      mbar_expect_tx(bar0, 2 * kTW * kTW * 2);
      bulk_copy(u_w1e, a.w, kTW * kTW * 2, bar0);
      bulk_copy(u_w2, a.w + kTW * kTW, kTW * kTW * 2, bar0);
    }
    fetch_ctx(0);
    if (a.gsum != nullptr) fetch_gsum(0);
    fetch_e(0);
    if (total > 1) fetch_e(1);
    if (a.g != nullptr) fetch_g(0);
    mbar_wait(bar0, 0);
  }

  float dw2[16][4], dw1e[16][4];  // this warp's rows of dW2 and dW1e, for the whole run
  zero_acc(dw2);
  zero_acc(dw1e);
  float acc[8][4];
  const int col0 = 64 * wg + 2 * t4;  // the lane's first column of the warpgroup's half
  float* db1w = s_db + warp * 64;
  float* db2w = s_db + 8 * 64 + warp * 64;
  // the lane's rows of a chunk: 16 q + g8 + 8 h, pixel px0 + 4 h of sample s0 + si;
  // its accumulator elements (h, j) in a blocked tile at lane + h kTBlocked
  // + 128 j bytes, in an f32 pixel tile at lf + h kPxStep + 8 j floats
  const int si = g8 % kTSamples, px0 = 8 * q + g8 / kTSamples;
  const int blk0 = 2 * q * kTBlocked + 8 * wg * 128 + g8 * 16 + 4 * t4;
  char* const h_lane = reinterpret_cast<char*>(s_h) + blk0;
  char* const gz_lane = reinterpret_cast<char*>(s_gz) + blk0;
  const char* const g_lane = reinterpret_cast<const char*>(s_g) + blk0;
  char* const de_lane = reinterpret_cast<char*>(s_gz) + ((16 * q + g8) * kTPitch + col0) * 2;
  const int lf = px0 * kTPitchF + col0;
  constexpr int kPxStep = 4 * kTPitchF;

  for (int k = 0; k < n_mine; ++k) {
    int b, row0, npx;
    tile_of(k, b, row0, npx);
    const unsigned ctx_buf = u_ctx + (k & 1) * kCtxBytes;
    mbar_wait(bar0 + 8 * (4 + (k & 1)), (k >> 1) & 1);
    {  // ctx . W1c + b1 (32 x 128), once per tile: warp -> 16 pixels x 32 columns
      const int mb = warp & 1, nb = warp >> 1;
      float z[4][4];
      zero_acc(z);
      product_frag<4>(z, a_lane<false>(ctx_buf, 16 * mb, kTPitch * 2), 32, 0,
                         a.w + 2 * kTW * kTW, 4 * nb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * nb + 8 * j + 2 * t4;
        const float2 bb = *reinterpret_cast<const float2*>(a.bias + col);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(s_zc + (16 * mb + g8 + 8 * h) * kTPitchF + col) =
              make_float2(z[j][2 * h] + bb.x, z[j][2 * h + 1] + bb.y);
      }
    }
    __syncthreads();
    if (k + 1 < n_mine) fetch_ctx(k + 1);

    for (int ci = 0; ci < n_chunks; ++ci) {
      const int c = k * n_chunks + ci, st = c & 1, s0 = ci * kTSamples;
      const unsigned e_buf = u_e + st * kEBytes;
      const bool s_ok = s0 + si < S;
      mbar_wait(bar0 + 8 * (1 + st), (c >> 1) & 1);
      fence_proxy_async();  // e came by cp.async; the wgmmas read it through the async proxy

      // h1 = bf16(act(ctx . W1c + b1 + e . W1e)): the warpgroup's 64 C1 columns
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 z = *reinterpret_cast<const float2*>(s_zc + lf + h * kPxStep + 8 * j);
          acc[j][2 * h] = z.x;
          acc[j][2 * h + 1] = z.y;
        }
      fence_acc(acc);
      wgmma_fence();
      wg_issue<8, 8, 0, 1, kStepK, kStepT>(acc, desc_k(e_buf), desc_t(u_w1e + 8 * wg * 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(h_lane + h * kTBlocked + j * 128) =
              __floats2bfloat162_rn(mlp_act(kA, acc[j][2 * h]), mlp_act(kA, acc[j][2 * h + 1]));
      fence_proxy_async();  // h1 is read by wgmmas next
      __syncthreads();

      // h2 = act(h1 . W2 + b2) (f32) and the cotangent of its
      // pre-activation, gz2 = act'(h2, g + gsum + 2 h2 gsq), zero on rows
      // past S or HW and on columns past Cout; db2 += its column sums
      zero_acc(acc);
      fence_acc(acc);
      wgmma_fence();
      wg_issue<8, 8, 0, 1, kStepK, kStepT>(acc, desc_k(u_h), desc_t(u_w2 + 8 * wg * 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      if (a.g != nullptr) mbar_wait(bar0 + 24, c & 1);
      if (a.gsum != nullptr) mbar_wait(bar0 + 48, k & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + 8 * j;
        const float2 bb = *reinterpret_cast<const float2*>(s_b2 + col);
        float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = px0 + 4 * h;
          const bool ok = s_ok && px < npx;
          const float h0 = mlp_act(kA, acc[j][2 * h] + bb.x);
          const float h1 = mlp_act(kA, acc[j][2 * h + 1] + bb.y);
          // s_g and s_gsum stay zero when their cotangent is absent
          const float2 gv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(g_lane + h * kTBlocked + j * 128));
          const float2 sv = *reinterpret_cast<const float2*>(s_gsum + lf + h * kPxStep + 8 * j);
          float g0 = gv.x + sv.x, g1 = gv.y + sv.y;
          if (kGsq && ok) {
            const float2 v = *reinterpret_cast<const float2*>(
                a.gsq + ((size_t)b * HW + row0 + px) * kTW + col);
            g0 += 2.0f * h0 * v.x;
            g1 += 2.0f * h1 * v.y;
          }
          const float z0 = ok && col < a.cout ? mlp_act_grad(kA, h0, g0) : 0.0f;
          const float z1 = ok && col + 1 < a.cout ? mlp_act_grad(kA, h1, g1) : 0.0f;
          cs0 += z0;
          cs1 += z1;
          *reinterpret_cast<__nv_bfloat162*>(gz_lane + h * kTBlocked + j * 128) =
              __floats2bfloat162_rn(z0, z1);
        }
        add_col_sums(db2w, 8 * j + 2 * t4, cs0, cs1);
      }
      fence_proxy_async();
      __syncthreads();
      if (a.g != nullptr && c + 1 < total) fetch_g(c + 1);
      if (a.gsum != nullptr && ci == n_chunks - 1 && k + 1 < n_mine) fetch_gsum(k + 1);

      // dW2 += h1^T . bf16(gz2): the warpgroup's C1 rows [64 wg, 64 wg + 64);
      // and g1 = act'(h1, bf16(gz2) . W2^T): the warpgroup's 64 C1 columns,
      // written over its h1 once its dW2 products are done with them
      zero_acc(acc);
      fence_acc(dw2);
      fence_acc(acc);
      wgmma_fence();
      wg_issue<16, 4, 1, 1, kStepT, kStepT>(dw2, desc_t(u_h + 8 * wg * 128), desc_t(u_gz));
      wg_issue<8, 8, 0, 0, kStepK, kStepK>(acc, desc_k(u_gz), desc_k(u_w2 + 8 * wg * kTBlocked));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(dw2);
      fence_acc(acc);
      named_sync(1 + wg, 128);
      // db1 += the column sums of g1; G += bf16(g1) of the pixel's two
      // samples, in sample order: the lane 4 away holds the other sample
      // of the same pixels, and of the lane's two pixels (h = 0, 1) the
      // sample-s0 lane adds the first, the other lane the second
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float cs0 = 0.0f, cs1 = 0.0f;
        float2 mine[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          auto* p = reinterpret_cast<__nv_bfloat162*>(h_lane + h * kTBlocked + j * 128);
          const float2 hv = __bfloat1622float2(*p);
          const float v0 = mlp_act_grad(kA, hv.x, acc[j][2 * h]);
          const float v1 = mlp_act_grad(kA, hv.y, acc[j][2 * h + 1]);
          cs0 += v0;
          cs1 += v1;
          const __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
          *p = r;
          mine[h] = __bfloat1622float2(r);
        }
        const float2 send = si == 0 ? mine[1] : mine[0];
        const float2 other = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 4),
                                         __shfl_xor_sync(0xffffffffu, send.y, 4));
        const float2 first = si == 0 ? mine[0] : other, second = si == 0 ? other : mine[1];
        float2* gp = reinterpret_cast<float2*>(s_G + lf + si * kPxStep + 8 * j);
        float2 gv = *gp;
        gv.x = gv.x + first.x + second.x;
        gv.y = gv.y + first.y + second.y;
        *gp = gv;
        add_col_sums(db1w, 8 * j + 2 * t4, cs0, cs1);
      }
      fence_proxy_async();
      __syncthreads();

      // dW1e += e^T . bf16(g1): the warpgroup's Ce rows [64 wg, 64 wg + 64);
      // and de = bf16(bf16(g1) . W1e^T): the warpgroup's 64 Ce columns,
      // staged as padded rows in s_gz (free since the last barrier)
      zero_acc(acc);
      fence_acc(dw1e);
      fence_acc(acc);
      wgmma_fence();
      wg_issue<16, 4, 1, 1, kStepT, kStepT>(dw1e, desc_t(e_buf + 8 * wg * 128), desc_t(u_h));
      wg_issue<8, 8, 0, 0, kStepK, kStepK>(acc, desc_k(u_h), desc_k(u_w1e + 8 * wg * kTBlocked));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(dw1e);
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(de_lane + h * 8 * kTPitch * 2 + j * 16) =
              __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
      __syncthreads();
      store_de(b, row0, npx, s0);  // e's stage is free: the next chunk but one's e
      if (c + 2 < total) fetch_e(c + 2);
    }

    // [G_hi | G_lo] rows into s_h (free since the last barrier), 4 columns
    // a thread and a warp a row; G zeroed for the next tile
    for (int f = tid; f < kTPix * kTW / 4; f += kTThreads) {
      const int px = f / (kTW / 4), c4 = 4 * (f % (kTW / 4));
      float4* gp = reinterpret_cast<float4*>(s_G + px * kTPitchF + c4);
      const float4 v = *gp;
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y), h23 = __floats2bfloat162_rn(v.z, v.w);
      const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
      bf16* hp = s_h + px * kTHiLo + c4;
      reinterpret_cast<__nv_bfloat162*>(hp)[0] = h01;
      reinterpret_cast<__nv_bfloat162*>(hp)[1] = h23;
      reinterpret_cast<__nv_bfloat162*>(hp + kTW)[0] = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
      reinterpret_cast<__nv_bfloat162*>(hp + kTW)[1] = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
      *gp = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    {  // d(ctx) = G_hi . W1c^T + G_lo . W1c^T (32 x 128): warp -> 16 pixels x 32 columns
      const int mb = warp & 1, nb = warp >> 1;
      float z[4][4];
      zero_acc(z);
      product_frag<4>(z, a_lane<false>(u_h, 16 * mb, kTHiLo * 2), 32, kTW * 2,
                         a.w + 3 * kTW * kTW, 4 * nb);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = 16 * mb + g8 + 8 * h;
          if (px < npx)
            *reinterpret_cast<float2*>(a.dctx + ((size_t)b * HW + row0 + px) * kTW + 32 * nb +
                                       8 * j + 2 * t4) = make_float2(z[j][2 * h], z[j][2 * h + 1]);
        }
    }
    // dW1c += ctx^T . G_hi + ctx^T . G_lo (128 x 128, K 2 x 32), in two
    // rounds of 64 Cc rows: warp -> 16 rows x 64 columns, added from the
    // accumulators into the block's partial in device memory by plain
    // loads, adds and stores (the first tile stores): each element by the
    // one thread that owns it, once per tile, so the order of the adds,
    // and the bits, are fixed.
#pragma unroll 1
    for (int rd = 0; rd < 2; ++rd) {
      const int r0 = 64 * rd + 16 * (warp % 4), n0 = 64 * (warp / 4);
      const unsigned ctx_t = a_lane<true>(ctx_buf, r0, kTPitch * 2);
      zero_acc(acc);
      product<8, 2, true, 16 * kTPitch * 2, true, 8 * kTHiLo * 2, 16, kTHiLo * 2>(
          acc, ctx_t, u_h + 2 * n0);
      product<8, 2, true, 16 * kTPitch * 2, true, 8 * kTHiLo * 2, 16, kTHiLo * 2>(
          acc, ctx_t, u_h + 2 * (kTW + n0));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p = reinterpret_cast<float2*>(p_dw1c + (size_t)(r0 + g8 + 8 * h) * kTW + n0 +
                                                8 * j + 2 * t4);
          float2 v = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          if (k > 0) {
            const float2 o = *p;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *p = v;
        }
    }
  }

  if (n_mine == 0)
    for (int i = tid; i < kTW * kTW; i += kTThreads) p_dw1c[i] = 0.0f;
  // the block's partials: dW1e | dW1c (above) | dW2 | db1 | db2
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = (size_t)(64 * wg + 16 * q + g8 + 8 * h) * kTW + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(part + at) = make_float2(dw1e[j][2 * h], dw1e[j][2 * h + 1]);
      *reinterpret_cast<float2*>(part + 2 * kTW * kTW + at) =
          make_float2(dw2[j][2 * h], dw2[j][2 * h + 1]);
    }
  __syncthreads();
  if (tid < kTW) {
    const int w4 = 4 * (tid / 64), cl = tid % 64;
    float d1 = 0.0f, d2 = 0.0f;
    for (int i = 0; i < 4; ++i) {
      d1 += s_db[(w4 + i) * 64 + cl];
      d2 += s_db[8 * 64 + (w4 + i) * 64 + cl];
    }
    part[3 * kTW * kTW + tid] = d1;
    part[3 * kTW * kTW + kTW + tid] = d2;
  }
}

}  // namespace wcmc

using namespace wcmc;

template <typename TG, int kA1, int kA2, int kOut, int kChunk>
static cudaError_t launch_pathnet_bwd(const void* e, const void* ctx, const void* g,
                                      const void* gsum, const void* gsq, const void* w1,
                                      const void* b1, const void* w2, const void* b2, void* de,
                                      void* dctx, void* parts, void* out, int B, int S, int HW,
                                      const HeadBwdDims& d, int cmajor, int n_blocks, int device,
                                      cudaStream_t stream) {
  if (d.cout > kOut) return cudaErrorInvalidValue;
  const size_t smem = pathnet_bwd_smem(d, kOut, kChunk);
  cudaError_t err =
      set_smem(pathnet_head_bwd_kernel<TG, kA1, kA2, kOut, kChunk>, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kBwdPix - 1) / kBwdPix);
  const int grid = (int)(n_tiles < n_blocks ? (n_tiles > 0 ? n_tiles : 1) : n_blocks);
  pathnet_head_bwd_kernel<TG, kA1, kA2, kOut, kChunk><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(ctx), static_cast<const TG*>(g),
      static_cast<const float*>(gsum), static_cast<const float*>(gsq),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(de), static_cast<float*>(dctx),
      static_cast<float*>(parts), B, S, HW, d, cmajor);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(static_cast<const float*>(parts), static_cast<float*>(out), grid,
                      head_bwd_parts(d, kOut), stream);
}

template <int kA, bool kGsq>
static cudaError_t launch_tiled(const TiledArgs& args, void* out, int n_blocks, int device,
                                cudaStream_t stream) {
  const size_t smem = tiled_smem();
  cudaError_t err = set_smem(pathnet_head_bwd_tiled_kernel<kA, kGsq>, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)args.B * ((args.HW + kTPix - 1) / kTPix);
  const int grid = (int)(n_tiles < n_blocks ? (n_tiles > 0 ? n_tiles : 1) : n_blocks);
  pathnet_head_bwd_tiled_kernel<kA, kGsq><<<grid, kTThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(args.parts, static_cast<float*>(out), grid, kTParts, stream);
}

// The dynamic shared memory, in bytes, that wcmc_pathnet_head_bwd gives
// a block of the form of act (2: the tiled form, at its own widths; 1:
// PathNet's at ce, cc, c1): what ops/pathnet_fused.py's head_bwd_plan
// totals.
extern "C" long long wcmc_pathnet_head_bwd_smem(int act, int ce, int cc, int c1) {
  return (long long)(act == 2 ? tiled_smem() : pathnet_bwd_smem(HeadBwdDims{ce, cc, c1, 16}, 16, 8));
}

// e (B, S, HW, ce) bf16; ctx (B, HW, cc) bf16; g the output cotangent,
// (B, S, cout, HW) with cmajor, else (B, S, HW, cout); gsum, gsq (B, HW,
// cout) f32; any of g, gsum, gsq may be null (zero).  wpack, bpack: the
// head's parameters as ops/pathnet_fused.py's pack_head_weights lays them
// out for the form.  The two forms: act1 = act2 = relu (1), kout 16, g f32
// (PathNet); act1 = act2 = leaky relu (2), kout 128, g bf16, ce = cc = c1
// = 128, channels-last, every cotangent 128 channels wide and every
// pointer 16-byte aligned (the tiled form; the wrapper pads to it); others
// are refused.  de (B, S, HW, ce) bf16 and dctx (B, HW, cc) f32 out.
// parts: n_blocks partials of head_bwd_parts floats (scratch); out: their
// sum, laid out as dW1e (ce, c1) | dW1c (cc, c1) | dW2 (c1, kout) | db1
// (c1) | db2 (kout), f32.  All contiguous; ce, cc, c1 multiples of 16.
extern "C" int wcmc_pathnet_head_bwd(const void* e, const void* ctx, const void* g,
                                     const void* gsum, const void* gsq, const void* wpack,
                                     const void* bpack, void* de, void* dctx, void* parts,
                                     void* out, int B, int S, int HW, int ce, int cc, int c1,
                                     int cout, int act1, int act2, int kout, int cmajor,
                                     int n_blocks, int device, void* stream) {
  if (ce % 16 || cc % 16 || c1 % 16 || ce < 16 || cc < 16 || c1 < 16 || cout < 1 || S < 1 ||
      n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const HeadBwdDims d{ce, cc, c1, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const bf16*>(wpack);
  const auto* bias = static_cast<const float*>(bpack);
  if (act1 == 1 && act2 == 1 && kout == 16)  // PathNet: relu, relu, Cout <= 16, f32 g
    return launch_pathnet_bwd<float, 1, 1, 16, 8>(
        e, ctx, g, gsum, gsq, w, bias, w + (size_t)(ce + cc) * c1, bias + c1, de, dctx, parts,
        out, B, S, HW, d, cmajor, n_blocks, device, s);
  if (act1 == 2 && act2 == 2 && kout == kTW && ce == kTW && cc == kTW && c1 == kTW &&
      cout <= kTW && !cmajor) {  // Multisteps: leaky x 2, the tiled form
    for (const void* p : {e, ctx, g, static_cast<const void*>(gsum),
                          static_cast<const void*>(gsq), wpack, bpack,
                          static_cast<const void*>(de), static_cast<const void*>(dctx)})
      if (!aligned16(p)) return cudaErrorInvalidValue;
    const TiledArgs args{static_cast<const bf16*>(e), static_cast<const bf16*>(ctx),
                         static_cast<const bf16*>(g), static_cast<const float*>(gsum),
                         static_cast<const float*>(gsq), w, bias, static_cast<bf16*>(de),
                         static_cast<float*>(dctx), static_cast<float*>(parts), B, S, HW, cout};
    return gsq != nullptr ? launch_tiled<2, true>(args, out, n_blocks, device, s)
                          : launch_tiled<2, false>(args, out, n_blocks, device, s);
  }
  return cudaErrorInvalidValue;
}
