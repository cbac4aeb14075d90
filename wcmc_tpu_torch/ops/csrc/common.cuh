// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every kernel is exported through a plain C function that takes raw
// pointers, sizes, the device index and a cudaStream_t, launches on that
// stream, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.  The Python side (ops/_build.py) compiles each
// .cu file of this directory with nvcc and loads the shared library with
// ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace wcmc {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// most radiance channels the per-pixel kernel-application kernels take
constexpr int kMaxChannels = 8;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Row pitch (in elements) of a bf16 / f32 tile in shared memory.  The
// 16-byte pad spreads rows over the banks; a pointer to row r0 (r0 a
// multiple of 16) and column c0 (a multiple of 16) stays 32-byte
// aligned, which wmma fragment loads require.
__host__ __device__ inline int pitch_bf16(int cols) { return cols + 8; }
__host__ __device__ inline int pitch_f32(int cols) { return cols + 4; }

// Bump allocator over the dynamic shared memory; every buffer starts on a
// 128-byte boundary.
struct SmemCarver {
  unsigned char* base;
  size_t offset;
  template <typename T>
  __device__ T* take(size_t count) {
    T* p = reinterpret_cast<T*>(base + offset);
    offset += (count * sizeof(T) + 127) / 128 * 128;
    return p;
  }
};

inline size_t smem_bytes(size_t count, size_t elem) { return (count * elem + 127) / 128 * 128; }

// Loads and stores of f32 or bf16 values, with the math in f32.
__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline void store_f32(float* p, float v) { *p = v; }
__device__ inline void store_f32(bf16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// kC consecutive f32 values into registers, 16 bytes at a time where kC is
// a multiple of 4 (p then 16-byte aligned), 8 where kC is 2 (p 8-byte aligned)
template <int kC>
__device__ inline void load_channels(const float* p, float (&v)[kC]) {
  if constexpr (kC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kC / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
    }
  } else if constexpr (kC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = p[c];
  }
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copy a row-major (rows x cols) bf16 matrix from device memory into a
// shared tile of (rows_pad x cols_pad) with the given pitch, zero-filling
// the padding.  All threads of the block take part.
__device__ inline void load_bf16_tile(bf16* dst, int pitch, const bf16* src, int rows, int cols,
                                      int rows_pad, int cols_pad) {
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < rows_pad * cols_pad; i += blockDim.x) {
    const int r = i / cols_pad, c = i % cols_pad;
    dst[r * pitch + c] = (r < rows && c < cols) ? src[(size_t)r * cols + c] : zero;
  }
}

// out[r][c] = init[r][c] + sum_k A[r][k] * W[k][c] over an (M x K) bf16
// tile A and a (K x N) bf16 matrix W, both in shared memory, with f32
// accumulation on the tensor cores (M, N, K multiples of 16; init may be
// null for zero).  The block's warps take the 16x16 output fragments in
// turn; each fragment goes through `stage` (this warp's 16x16 f32
// scratch) and every element is handed to epi(row, col, value) exactly
// once, always by the same thread for a given (row, col), so an epilogue
// may keep per-element running sums in shared memory without races.
template <typename Epilogue>
__device__ inline void tile_mma(const bf16* A, int lda, const bf16* W, int ldw, int M, int N, int K,
                                const float* init, int ldi, float* stage, Epilogue epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_col = N / 16, n_frag = (M / 16) * n_col;
  float* st = stage + warp * 256;
  for (int f = warp; f < n_frag; f += kWarps) {
    const int r0 = (f / n_col) * 16, c0 = (f % n_col) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (init != nullptr) {
      wmma::load_matrix_sync(acc, init + r0 * ldi + c0, ldi, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.0f);
    }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + r0 * lda + k, lda);
      wmma::load_matrix_sync(b, W + k * ldw + c0, ldw);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) epi(r0 + i / 16, c0 + i % 16, st[i]);
    __syncwarp();
  }
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += A[r0 : r0 + 16, 0 : K] . B[0 : K, c0 : c0 + 16] on the tensor
// cores (bf16 in, f32 accumulate), for one warp.  A is stored row-major
// (LA = wmma::row_major, A(r, k) = A[r * lda + k]) or as its transpose
// (LA = wmma::col_major, A(r, k) = A[k * lda + r]); likewise B
// (row_major: B(k, c) = B[k * ldb + c]; col_major: B(k, c) = B[c * ldb +
// k]).  So a backward pass reads X^T, W^T and friends straight from the
// stored X and W, in shared or device memory.  r0, c0 and K are
// multiples of 16; lda and ldb multiples of 8, with 16 rows of either
// spanning a multiple of 32 bytes (pitch_bf16 rows and unpadded widths
// that are multiples of 16 both do).
template <typename LA, typename LB>
__device__ inline void frag_mma(Acc& acc, const bf16* A, int lda, const bf16* B, int ldb, int r0,
                                int c0, int K) {
  constexpr bool a_rows = std::is_same<LA, wmma::row_major>::value;
  constexpr bool b_rows = std::is_same<LB, wmma::row_major>::value;
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
    wmma::load_matrix_sync(a, a_rows ? A + (size_t)r0 * lda + k : A + (size_t)k * lda + r0, lda);
    wmma::load_matrix_sync(b, b_rows ? B + (size_t)k * ldb + c0 : B + (size_t)c0 * ldb + k, ldb);
    wmma::mma_sync(acc, a, b, acc);
  }
}

// Stage a finished fragment in this warp's 16x16 f32 scratch (row-major)
// so that its lanes can read any element of it.
__device__ inline float* stage_frag(const Acc& acc, float* stage) {
  float* st = stage + (threadIdx.x / 32) * 256;
  wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
  __syncwarp();
  return st;
}

// Column sums of a staged 16x16 fragment, lane j < 16 getting column j's
// (rows in order: the sum is deterministic).
__device__ inline float stage_col_sum(const float* st) {
  const int lane = threadIdx.x % 32;
  float v = 0.0f;
  if (lane < 16) {
    for (int r = 0; r < 16; ++r) v += st[r * 16 + lane];
  }
  return v;
}

// out[j] = sum_{k < n_parts} parts[k * n + j], summed in the order of k:
// the deterministic second pass that reduces the per-block partial weight
// gradients of the backward kernels (no float atomics anywhere).
static __global__ void __launch_bounds__(kThreads)
    reduce_parts_kernel(const float* __restrict__ parts, float* __restrict__ out, int n_parts,
                        long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float v = 0.0f;
  for (int k = 0; k < n_parts; ++k) v += parts[(size_t)k * n + j];
  out[j] = v;
}

static inline cudaError_t reduce_parts(const float* parts, float* out, int n_parts, long long n,
                                cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  reduce_parts_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      parts, out, n_parts, n);
  return cudaGetLastError();
}

// Makes `device` the calling thread's current device for the guard's
// lifetime and restores the caller's device afterwards, so a launch on a
// tensor of another card leaves the thread's current device as it was.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB needs
// the attribute) after checking the device's per-block limit.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes, int device) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace wcmc
