// K4-bwd: the weight gradients of the PathNet embedding MLP, from the
// cotangents of its two outputs (the per-sample embedding and its sample
// mean).
//
//   h1 = bf16(relu(x . W0 + b0)),  h2 = bf16(relu(h1 . W1 + b1)),  e = h2 . W2 + b2
//   g3 = f32(ge) + gmean / S                   (linear output layer)
//   g2 = [h2 > 0] * (bf16(g3) . W2^T),  g1 = [h1 > 0] * (bf16(g2) . W1^T)
//   dW2 = h2^T . bf16(g3),  dW1 = h1^T . bf16(g2),  dW0 = x^T . bf16(g1)   (f32, summed over all rows)
//   db2 = sum g3,  db1 = sum g2,  db0 = sum g1                              (f32, unrounded)
//
// Replaces wcmc_tpu/ops/pathnet_fused.py::_embed_bwd_pallas (Pallas body
// _embed_bwd_kernel) with compute_dx=False: the paths are data, so no
// d(x).  The hiddens are recomputed from x (nothing was saved in the
// forward), rounded where the forward rounds; the output layer is linear,
// so it is not recomputed at all.
//
// What bounds it on the H100: operations.  At the training shape (8
// patches x 8 spp x 128^2 px, 36 -> 128 -> 128 -> 128, both branches
// merged) it reads x, the bf16 embedding cotangent and the f32 mean
// cotangent (~410 MB) and does ~190 GFLOP on the tensor cores.
//
// Design: the Pallas grid runs in sequence and adds every step's dW into
// one output block.  CUDA blocks do not run in sequence, so each
// persistent block (one per SM) adds into its own f32 partial dW / db in
// a workspace, and a second launch sums the partials in block order:
// deterministic, no float atomics.  A block owns a tile of 16 pixels of
// one image and takes its S samples in chunks of up to 8, so the tile's
// gmean / S is loaded once per pixel and each weight-gradient product
// runs over 128 rows at a time.  The partials live in device memory
// (L2-resident) and are read, added to and written back once per chunk
// by the warp that owns the fragment.  The weights are read through
// L1/L2 by the fragment loads; the tile's x, hiddens and cotangents stay
// in shared memory; the backward chain overwrites each hidden with its
// gradient in place.  Bias gradients go through per-fragment column sums
// in fixed order.  No TMA, wgmma or pipelining yet.
#include "common.cuh"

namespace wcmc {

constexpr int kBwdPix = 16;     // pixels per tile
constexpr int kBwdChunk = 8;    // samples per chunk
constexpr int kBwdRows = kBwdPix * kBwdChunk;

struct EmbedBwdDims {
  int c0, c1, c2, c3, k0;  // k0: c0 rounded up to 16 (W0 comes zero-padded to k0 rows)
};

__host__ __device__ inline long long embed_bwd_parts(const EmbedBwdDims& d) {
  return (long long)d.k0 * d.c1 + (long long)d.c1 * d.c2 + (long long)d.c2 * d.c3 + d.c1 + d.c2 +
         d.c3;
}

inline size_t embed_bwd_smem(const EmbedBwdDims& d) {
  const int cmax = d.c1 > d.c2 ? d.c1 : d.c2;
  return smem_bytes((size_t)kBwdRows * pitch_bf16(d.k0), 2) +
         smem_bytes((size_t)kBwdRows * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)kBwdRows * pitch_bf16(d.c2), 2) +
         smem_bytes((size_t)kBwdRows * pitch_bf16(d.c3), 2) +
         smem_bytes((size_t)kBwdPix * d.c3, 4) + smem_bytes((size_t)kWarps * 256, 4) +
         smem_bytes((size_t)kBwdChunk * cmax, 4) + smem_bytes(d.c1, 4) + smem_bytes(d.c2, 4) +
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

// G = [H > 0] * (A . W^T) for the (rows x n) fragments, written in place
// over H (bf16), with each fragment's column sums of the unrounded G in
// dbpart[row block][col].
__device__ inline void backprop_relu(const bf16* A, int lda, const bf16* w, int ldw, int k,
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
      const float v = __bfloat162float(*h) > 0.0f ? st[i] : 0.0f;
      st[i] = v;
      *h = __float2bfloat16(v);
    }
    __syncwarp();
    const float cs = stage_col_sum(st);
    if (lane < 16) dbpart[(r0 / 16) * n + c0 + lane] = cs;
    __syncwarp();
  }
}

// H = bf16(relu(A . W + bias)) for the (rows x n) fragments.
__device__ inline void forward_relu(const bf16* A, int lda, const bf16* w, int ldw, int k,
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
      H[(size_t)(r0 + i / 16) * ldh + c] = __float2bfloat16(fmaxf(st[i] + bias[c], 0.0f));
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

__global__ void __launch_bounds__(kThreads)
    pathnet_embed_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ge,
                             const float* __restrict__ gmean, const bf16* __restrict__ w0,
                             const float* __restrict__ b0, const bf16* __restrict__ w1,
                             const float* __restrict__ b1, const bf16* __restrict__ w2,
                             float* __restrict__ parts, int B, int S, int HW, EmbedBwdDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int p_x = pitch_bf16(d.k0), p_h1 = pitch_bf16(d.c1), p_h2 = pitch_bf16(d.c2);
  const int p_g3 = pitch_bf16(d.c3);
  const int cmax = d.c1 > d.c2 ? d.c1 : d.c2;
  SmemCarver carve{smem, 0};
  bf16* s_x = carve.take<bf16>((size_t)kBwdRows * p_x);
  bf16* s_h1 = carve.take<bf16>((size_t)kBwdRows * p_h1);
  bf16* s_h2 = carve.take<bf16>((size_t)kBwdRows * p_h2);
  bf16* s_g3 = carve.take<bf16>((size_t)kBwdRows * p_g3);
  float* s_gm = carve.take<float>((size_t)kBwdPix * d.c3);
  float* s_stage = carve.take<float>((size_t)kWarps * 256);
  float* s_dbpart = carve.take<float>((size_t)kBwdChunk * cmax);
  float* s_db0 = carve.take<float>(d.c1);
  float* s_db1 = carve.take<float>(d.c2);
  float* s_db2 = carve.take<float>(d.c3);
  float* s_b0 = carve.take<float>(d.c1);
  float* s_b1 = carve.take<float>(d.c2);

  const long long n_parts = embed_bwd_parts(d);
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

  const int tiles_per_image = (HW + kBwdPix - 1) / kBwdPix;
  const int n_tiles = B * tiles_per_image;
  const float inv_s = 1.0f / (float)S;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_image;
    const int row0 = (t % tiles_per_image) * kBwdPix;
    const int rows = min(kBwdPix, HW - row0);
    for (int i = threadIdx.x; i < kBwdPix * d.c3; i += blockDim.x) {
      const int r = i / d.c3, c = i % d.c3;
      s_gm[i] = r < rows ? gmean[((size_t)b * HW + row0 + r) * d.c3 + c] * inv_s : 0.0f;
    }
    for (int s0 = 0; s0 < S; s0 += kBwdChunk) {
      const int sc = min(kBwdChunk, S - s0), n_rows = kBwdPix * sc;
      for (int i = threadIdx.x; i < n_rows * d.k0; i += blockDim.x) {
        const int r = i / d.k0, c = i % d.k0, pr = r % kBwdPix;
        const size_t row = ((size_t)b * S + s0 + r / kBwdPix) * HW + row0 + pr;
        s_x[r * p_x + c] = (pr < rows && c < d.c0) ? x[row * d.c0 + c] : zero;
      }
      __syncthreads();  // s_gm and s_x
      // g3 = ge + gmean / S (the output layer is linear); db2 in row order
      for (int c = threadIdx.x; c < d.c3; c += blockDim.x) {
        float sum = 0.0f;
        for (int r = 0; r < n_rows; ++r) {
          const int pr = r % kBwdPix;
          float v = 0.0f;
          if (pr < rows) {
            const size_t row = ((size_t)b * S + s0 + r / kBwdPix) * HW + row0 + pr;
            v = __bfloat162float(ge[row * d.c3 + c]) + s_gm[pr * d.c3 + c];
          }
          s_g3[r * p_g3 + c] = __float2bfloat16(v);
          sum += v;
        }
        s_db2[c] += sum;
      }
      forward_relu(s_x, p_x, w0, d.c1, d.k0, s_b0, s_h1, p_h1, n_rows, d.c1, s_stage);
      __syncthreads();
      forward_relu(s_h1, p_h1, w1, d.c2, d.c1, s_b1, s_h2, p_h2, n_rows, d.c2, s_stage);
      __syncthreads();
      accumulate_dw(p_dw2, s_h2, p_h2, s_g3, p_g3, d.c2, d.c3, n_rows);
      __syncthreads();  // h2 is read; g2 overwrites it
      backprop_relu(s_g3, p_g3, w2, d.c3, d.c3, s_h2, p_h2, n_rows, d.c2, s_stage, s_dbpart);
      __syncthreads();
      for (int c = threadIdx.x; c < d.c2; c += blockDim.x) {
        float sum = 0.0f;
        for (int rb = 0; rb < sc; ++rb) sum += s_dbpart[rb * d.c2 + c];
        s_db1[c] += sum;
      }
      accumulate_dw(p_dw1, s_h1, p_h1, s_h2, p_h2, d.c1, d.c2, n_rows);
      __syncthreads();  // h1 and dbpart are read; g1 overwrites them
      backprop_relu(s_h2, p_h2, w1, d.c2, d.c2, s_h1, p_h1, n_rows, d.c1, s_stage, s_dbpart);
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

// x (B, S, HW, c0) bf16; ge (B, S, HW, c3) bf16; gmean (B, HW, c3) f32;
// w0 (k0, c1) bf16, W0 zero-padded to k0 = c0 rounded up to 16 rows;
// w1 (c1, c2), w2 (c2, c3) bf16; b0, b1 f32.  All contiguous; c1, c2, c3
// multiples of 16.  parts: n_blocks partials of
// embed_bwd_parts floats each (scratch); out: their sum, laid out as
// dW0 (k0, c1) | dW1 (c1, c2) | dW2 (c2, c3) | db0 | db1 | db2, f32.
// n_blocks: persistent blocks to launch (the SM count).
extern "C" int wcmc_pathnet_embed_bwd(const void* x, const void* ge, const void* gmean,
                                      const void* w0, const void* b0, const void* w1,
                                      const void* b1, const void* w2, void* parts, void* out,
                                      int B, int S, int HW, int c0, int c1, int c2, int c3,
                                      int n_blocks, int device, void* stream) {
  if (c0 < 1 || c1 % 16 || c2 % 16 || c3 % 16 || c1 < 16 || c2 < 16 || c3 < 16 || S < 1 ||
      n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const EmbedBwdDims d{c0, c1, c2, c3, round_up(c0, 16)};
  const size_t smem = embed_bwd_smem(d);
  cudaError_t err = set_smem(pathnet_embed_bwd_kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kBwdPix - 1) / kBwdPix);
  const int grid = (int)(n_tiles < n_blocks ? (n_tiles > 0 ? n_tiles : 1) : n_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pathnet_embed_bwd_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ge), static_cast<const float*>(gmean),
      static_cast<const bf16*>(w0), static_cast<const float*>(b0), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<float*>(parts), B,
      S, HW, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(static_cast<const float*>(parts), static_cast<float*>(out), grid,
                      embed_bwd_parts(d), s);
}
