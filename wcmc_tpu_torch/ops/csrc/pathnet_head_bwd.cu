// K5-bwd: the gradients of the PathNet head over [e | broadcast_S(ctx)],
// from the cotangents of its output (channel-major) and of its two
// sample moments.
//
//   h1 = bf16(relu(e . W1e + ctx . W1c + b1)),  h2 = relu(h1 . W2 + b2)      (h2 f32)
//   gz2 = [h2 > 0] * (g + gsum + 2 h2 gsq)
//   g1  = [h1 > 0] * (bf16(gz2) . W2^T)
//   de  = bf16(bf16(g1) . W1e^T)                 per sample
//   dctx = sum_s bf16(g1) . W1c^T                f32, summed over S
//   dW2 = h1^T . bf16(gz2), dW1e = e^T . bf16(g1), dW1c = ctx^T . bf16(g1)   f32, over all rows
//   db2 = sum gz2, db1 = sum g1                  f32, unrounded
//
// Replaces wcmc_tpu/ops/pathnet_fused.py::_head_bwd_pallas (Pallas body
// _head_bwd_kernel) with moments=True and cmajor=True, the training
// head: g is (B, S, cout, HW) f32.
//
// What bounds it on the H100: operations, closely followed by bytes.  At
// the training shape (8 patches x 8 spp x 128^2 px, Ce = Cc = 128, 256 ->
// 256 -> 6, both branches merged) it reads the bf16 embedding (268 MB)
// and writes its bf16 gradient (268 MB) and the f32 context gradient
// (134 MB), ~730 MB, for ~232 GFLOP with the context terms taken once per
// pixel.
//
// Design: as in K4-bwd, each persistent block adds its weight gradients
// into its own f32 partials in a workspace and a second launch sums them
// in block order (deterministic, no float atomics); a block owns a tile
// of 16 pixels of one image and takes its samples in chunks of up to 8
// (128 rows per weight-gradient product).  The context is the same for
// all samples of a pixel, so, as in K5-fwd, ctx . W1c + b1 is computed
// once per tile and starts each sample's layer-1 accumulator; and the
// context's gradients are formed from G = sum_s bf16(g1) per pixel, once
// rather than S times: dctx = G . W1c^T and dW1c = ctx^T . G.  G is an
// f32 sum, so it enters the bf16 tensor cores as two terms, G = hi + lo
// with hi = bf16(G) and lo = bf16(G - hi) (relative error ~2^-16).  W2's
// cout <= 16 columns come zero-padded to 16.  Weights are read through
// L1/L2 by the fragment loads; the tile's e, hiddens and cotangents stay
// in shared memory.  No TMA, wgmma or pipelining yet.
#include "common.cuh"

namespace wcmc {

constexpr int kBwdPix = 16;
constexpr int kBwdChunk = 8;
constexpr int kBwdRows = kBwdPix * kBwdChunk;
constexpr int kOut = 16;  // padded output width

struct HeadBwdDims {
  int ce, cc, c1, cout;
};

__host__ __device__ inline long long head_bwd_parts(const HeadBwdDims& d) {
  return (long long)d.ce * d.c1 + (long long)d.cc * d.c1 + (long long)d.c1 * kOut + d.c1 + kOut;
}

inline size_t head_bwd_smem(const HeadBwdDims& d) {
  return smem_bytes((size_t)kBwdPix * pitch_bf16(d.cc), 2) +
         smem_bytes((size_t)kBwdPix * pitch_f32(d.c1), 4) +
         smem_bytes((size_t)kBwdRows * pitch_bf16(d.ce), 2) +
         smem_bytes((size_t)kBwdRows * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)kBwdRows * pitch_bf16(kOut), 2) +
         smem_bytes((size_t)kBwdRows * kOut, 4) + 2 * smem_bytes((size_t)kBwdPix * kOut, 4) +
         smem_bytes((size_t)kBwdPix * d.c1, 4) +
         2 * smem_bytes((size_t)kBwdPix * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)kWarps * 256, 4) + smem_bytes((size_t)kBwdChunk * d.c1, 4) +
         2 * smem_bytes(d.c1, 4) + 2 * smem_bytes(kOut, 4);
}

__global__ void __launch_bounds__(kThreads)
    pathnet_head_bwd_kernel(const bf16* __restrict__ e, const bf16* __restrict__ ctx,
                            const float* __restrict__ g, const float* __restrict__ gsum,
                            const float* __restrict__ gsq, const bf16* __restrict__ w1,
                            const float* __restrict__ b1, const bf16* __restrict__ w2,
                            const float* __restrict__ b2, bf16* __restrict__ de,
                            float* __restrict__ dctx, float* __restrict__ parts, int B, int S,
                            int HW, HeadBwdDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  using row = wmma::row_major;
  using col = wmma::col_major;
  const int p_ctx = pitch_bf16(d.cc), p_z = pitch_f32(d.c1), p_e = pitch_bf16(d.ce);
  const int p_h = pitch_bf16(d.c1), p_gz = pitch_bf16(kOut);
  SmemCarver carve{smem, 0};
  bf16* s_ctx = carve.take<bf16>((size_t)kBwdPix * p_ctx);
  float* s_ctxz = carve.take<float>((size_t)kBwdPix * p_z);
  bf16* s_e = carve.take<bf16>((size_t)kBwdRows * p_e);
  bf16* s_h = carve.take<bf16>((size_t)kBwdRows * p_h);   // h1, then g1
  bf16* s_gz = carve.take<bf16>((size_t)kBwdRows * p_gz);  // bf16(gz2)
  float* s_gf = carve.take<float>((size_t)kBwdRows * kOut);  // g, then gz2 in f32
  float* s_gsum = carve.take<float>((size_t)kBwdPix * kOut);
  float* s_gsq = carve.take<float>((size_t)kBwdPix * kOut);
  float* s_gacc = carve.take<float>((size_t)kBwdPix * d.c1);  // sum_s bf16(g1)
  bf16* s_ghi = carve.take<bf16>((size_t)kBwdPix * p_h);
  bf16* s_glo = carve.take<bf16>((size_t)kBwdPix * p_h);
  float* s_stage = carve.take<float>((size_t)kWarps * 256);
  float* s_dbpart = carve.take<float>((size_t)kBwdChunk * d.c1);
  float* s_db1 = carve.take<float>(d.c1);
  float* s_b1 = carve.take<float>(d.c1);
  float* s_db2 = carve.take<float>(kOut);
  float* s_b2 = carve.take<float>(kOut);

  const bf16* w1e = w1;
  const bf16* w1c = w1 + (size_t)d.ce * d.c1;
  const long long n_parts = head_bwd_parts(d);
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
  const int n_col1 = d.c1 / 16;
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
      s_gsum[i] = ok ? gsum[(pix0 + r) * d.cout + c] : 0.0f;
      s_gsq[i] = ok ? gsq[(pix0 + r) * d.cout + c] : 0.0f;
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

    for (int s0 = 0; s0 < S; s0 += kBwdChunk) {
      const int sc = min(kBwdChunk, S - s0), n_rows = kBwdPix * sc;
      for (int i = threadIdx.x; i < n_rows * d.ce; i += blockDim.x) {
        const int r = i / d.ce, c = i % d.ce, pr = r % kBwdPix;
        const size_t rw = ((size_t)b * S + s0 + r / kBwdPix) * HW + row0 + pr;
        s_e[r * p_e + c] = pr < rows ? e[rw * d.ce + c] : zero;
      }
      // g is channel-major: pixels fastest, so the loads are contiguous
      for (int i = threadIdx.x; i < n_rows * kOut; i += blockDim.x) {
        const int pr = i % kBwdPix, c = (i / kBwdPix) % kOut, si = i / (kBwdPix * kOut);
        s_gf[(si * kBwdPix + pr) * kOut + c] =
            (pr < rows && c < d.cout)
                ? g[(((size_t)b * S + s0 + si) * d.cout + c) * HW + row0 + pr]
                : 0.0f;
      }
      __syncthreads();  // s_ctxz, s_e, s_gf
      // h1 = relu(e . W1e + ctx . W1c + b1)
      for (int f = warp; f < sc * n_col1; f += kWarps) {
        const int r0 = (f / n_col1) * 16, c0 = (f % n_col1) * 16;
        Acc acc;
        wmma::load_matrix_sync(acc, s_ctxz + c0, p_z, wmma::mem_row_major);
        frag_mma<row, row>(acc, s_e, p_e, w1e, d.c1, r0, c0, d.ce);
        float* st = stage_frag(acc, s_stage);
        for (int i = lane; i < 256; i += 32)
          s_h[(r0 + i / 16) * p_h + c0 + i % 16] = __float2bfloat16(fmaxf(st[i], 0.0f));
        __syncwarp();
      }
      __syncthreads();
      // h2 (f32) and the output cotangent with the moments folded in
      for (int f = warp; f < sc; f += kWarps) {
        const int r0 = f * 16;
        Acc acc;
        wmma::fill_fragment(acc, 0.0f);
        frag_mma<row, row>(acc, s_h, p_h, w2, kOut, r0, 0, d.c1);
        float* st = stage_frag(acc, s_stage);
        for (int i = lane; i < 256; i += 32) {
          const int r = r0 + i / 16, c = i % 16, pr = r % kBwdPix;
          const float h2 = fmaxf(st[i] + s_b2[c], 0.0f);
          const float gg = s_gf[r * kOut + c] + s_gsum[pr * kOut + c] +
                           2.0f * h2 * s_gsq[pr * kOut + c];
          const float gz = (c < d.cout && h2 > 0.0f) ? gg : 0.0f;
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
      for (int f = warp; f < n_col1; f += kWarps) {
        Acc acc;
        float* p = p_dw2 + (size_t)f * 16 * kOut;
        wmma::load_matrix_sync(acc, p, kOut, wmma::mem_row_major);
        frag_mma<col, row>(acc, s_h, p_h, s_gz, p_gz, f * 16, 0, n_rows);
        wmma::store_matrix_sync(p, acc, kOut, wmma::mem_row_major);
      }
      __syncthreads();  // h1 is read; g1 overwrites it
      // g1 = [h1 > 0] * (bf16(gz2) . W2^T), with its column sums
      for (int f = warp; f < sc * n_col1; f += kWarps) {
        const int r0 = (f / n_col1) * 16, c0 = (f % n_col1) * 16;
        Acc acc;
        wmma::fill_fragment(acc, 0.0f);
        frag_mma<row, col>(acc, s_gz, p_gz, w2, kOut, r0, c0, kOut);
        float* st = stage_frag(acc, s_stage);
        for (int i = lane; i < 256; i += 32) {
          bf16* h = s_h + (r0 + i / 16) * p_h + c0 + i % 16;
          const float v = __bfloat162float(*h) > 0.0f ? st[i] : 0.0f;
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

}  // namespace wcmc

using namespace wcmc;

// e (B, S, HW, ce) bf16; ctx (B, HW, cc) bf16; g (B, S, cout, HW) f32;
// gsum, gsq (B, HW, cout) f32; w1 (ce + cc, c1) bf16 with the e rows
// first; b1 (c1) f32; w2 (c1, 16) bf16 and b2 (16) f32, zero-padded from
// cout <= 16 columns.  de (B, S, HW, ce) bf16 and dctx (B, HW, cc) f32
// out.  parts: n_blocks partials of head_bwd_parts floats (scratch); out:
// their sum, laid out as dW1e (ce, c1) | dW1c (cc, c1) | dW2 (c1, 16) |
// db1 (c1) | db2 (16), f32.  All contiguous; ce, cc, c1 multiples of 16.
extern "C" int wcmc_pathnet_head_bwd(const void* e, const void* ctx, const void* g,
                                     const void* gsum, const void* gsq, const void* w1,
                                     const void* b1, const void* w2, const void* b2, void* de,
                                     void* dctx, void* parts, void* out, int B, int S, int HW,
                                     int ce, int cc, int c1, int cout, int n_blocks, int device,
                                     void* stream) {
  if (ce % 16 || cc % 16 || c1 % 16 || ce < 16 || cc < 16 || c1 < 16 || cout < 1 ||
      cout > kOut || S < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const HeadBwdDims d{ce, cc, c1, cout};
  const size_t smem = head_bwd_smem(d);
  cudaError_t err = set_smem(pathnet_head_bwd_kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kBwdPix - 1) / kBwdPix);
  const int grid = (int)(n_tiles < n_blocks ? (n_tiles > 0 ? n_tiles : 1) : n_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pathnet_head_bwd_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(ctx), static_cast<const float*>(g),
      static_cast<const float*>(gsum), static_cast<const float*>(gsq),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(de), static_cast<float*>(dctx),
      static_cast<float*>(parts), B, S, HW, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(static_cast<const float*>(parts), static_cast<float*>(out), grid,
                      head_bwd_parts(d), s);
}
