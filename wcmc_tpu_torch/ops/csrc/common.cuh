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

namespace wcmc {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

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
