// SIMT float32 products over 32-row tiles, shared by the f32 bodies of K4 and
// K5 (pathnet_f32.cu) and of K10 (mlp_f32.cu): every product is a full-f32
// fused multiply-add chain over k from its initial value, no TF32.
//
// A product (mm32) gives each thread of a 256-thread block 4 rows x kCJ
// columns of a 32 x (32 kCJ) output tile: rows warp + 8 i (so a warp's A
// loads are one broadcast), columns lane + 32 j (so its B loads are
// consecutive); a thread owns the same output elements in every call of the
// same shape and kCJ, so an epilogue can keep running sums (a sample mean,
// moments, weight gradients) without a barrier or an atomic.  The value of
// an output does not depend on kCJ: it is the same chain in the same order.
// The weight-gradient helpers add a tile's contribution into a partial that
// the same threads own from tile to tile (a block's partial in device
// memory); reduce_parts (common.cuh) then sums the blocks' partials in block
// order, so two launches repeat bit for bit.
#pragma once

#include "common.cuh"

namespace wcmc {

constexpr int kF32Rows = 32;    // rows of a tile: the rows of a product
constexpr int kF32Cols = 128;   // columns of mm32's default output tile (kCJ = 4)

struct Zero {
  __device__ float operator()(int, int) const { return 0.0f; }
};

// acc(r, c) = init(r, c) + sum_{k < K} A(r, k) * B[k * ldb + c], each a fused
// multiply-add chain in k order from init (zero by default), for r < M and c <
// N; A(r, k) = A[r * lda + k * ak] (a row-major tile, or the transpose of
// one), B row-major.  Then epi(r, c, acc) for every output, each by one
// thread, the same for the same (M, N, kCJ).  The init values are read before
// the chain, so a read from device memory runs under it.
template <int kCJ = 4, typename Epi, typename Init = Zero>
__device__ inline void mm32(const float* A, int lda, int ak, int M, const float* __restrict__ B,
                            int ldb, int N, int K, Epi epi, Init init = Init()) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m0 = 0; m0 < M; m0 += kF32Rows) {
    for (int n0 = 0; n0 < N; n0 += 32 * kCJ) {
      const float* ap[4];
      bool rok[4], cok[kCJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + warp + 8 * i;
        rok[i] = r < M;
        ap[i] = A + (size_t)(rok[i] ? r : 0) * lda;
      }
#pragma unroll
      for (int j = 0; j < kCJ; ++j) cok[j] = n0 + lane + 32 * j < N;
      float acc[4][kCJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j)
          acc[i][j] = rok[i] && cok[j] ? init(m0 + warp + 8 * i, n0 + lane + 32 * j) : 0.0f;
      const float* bp = B + n0 + lane;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float a[4], b[kCJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = rok[i] ? ap[i][(size_t)k * ak] : 0.0f;
#pragma unroll
        for (int j = 0; j < kCJ; ++j) b[j] = cok[j] ? bp[(size_t)k * ldb + 32 * j] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCJ; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j)
          if (rok[i] && cok[j]) epi(m0 + warp + 8 * i, n0 + lane + 32 * j, acc[i][j]);
    }
  }
}

// The tile's 32 rows of a (rows, c) f32 row-major span into dst (pitch c),
// rows >= n and a null src zero.
__device__ inline void load_tile(float* dst, const float* __restrict__ src, int n, int c) {
  for (int i = threadIdx.x; i < kF32Rows * c; i += blockDim.x)
    dst[i] = src != nullptr && i / c < n ? src[i] : 0.0f;
}

// part[c] += the column sums of a 32 x n tile (rows in order).
__device__ inline void add_col_sums(float* part, const float* t, int n) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < kF32Rows; ++r) s += t[r * n + c];
    part[c] += s;
  }
}

// part (m x n) += A^T . G over the tile's 32 rows: A a 32 x m tile, G 32 x n;
// each element's chain starts from its partial, read before the products.
template <int kCJ = 4>
__device__ inline void add_outer(float* part, const float* A, int m, const float* G, int n) {
  mm32<kCJ>(A, 1, m, m, G, n, n, kF32Rows,
            [&](int r, int c, float v) { part[(size_t)r * n + c] = v; },
            [&](int r, int c) { return part[(size_t)r * n + c]; });
}

__device__ inline void zero_part(float* part, long long n) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) part[i] = 0.0f;
}

// Launch an f32 body over `blocks` blocks of kThreads with `smem` bytes of
// dynamic shared memory (opted into where above 48 KB).
template <typename Kernel, typename Args>
inline cudaError_t launch_f32(Kernel kernel, const Args& a, size_t smem, int blocks, int device,
                              cudaStream_t stream) {
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wcmc
