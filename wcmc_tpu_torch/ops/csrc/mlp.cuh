// Shared pieces of K10-fwd and K10-bwd, the fused per-pixel MLP: the
// layer description passed by value to both kernels, the activations and
// their gradients, and row-tile copies between device and shared memory.
// The activation switch (mlp_act, and fixed_act for activations set at
// compile time) also serves the PathNet-shaped K4-fwd and K5-fwd.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace wcmc {

constexpr int kMlpRows = 128;     // rows per tile
constexpr int kMlpMaxLayers = 4;
constexpr int kMlpMaxWidth = 64;

struct MlpLayers {
  const bf16* w[kMlpMaxLayers];   // (dims[i], dims[i + 1]) row-major; W0's rows zero-padded to k0
  const float* b[kMlpMaxLayers];  // (dims[i + 1]) f32
  int dims[kMlpMaxLayers + 1];    // k0 (c0 rounded up to 16), c1, ..., cL
  int act[kMlpMaxLayers];         // 0 linear, 1 relu, 2 leaky relu (slope 0.01)
  int n_layers, c0, cmax;         // cmax: the widest of dims
};

__device__ inline float mlp_act(int code, float z) {
  return code == 1 ? fmaxf(z, 0.0f) : code == 2 ? (z >= 0.0f ? z : 0.01f * z) : z;
}

// A layer's activation fixed at compile time (kCode >= 0), or read from
// `code` at run time (kCode < 0: the kernels' generic instantiation).
template <int kCode>
__device__ __forceinline__ float fixed_act(int code, float z) {
  return mlp_act(kCode >= 0 ? kCode : code, z);
}

// The activation's gradient through its post-activation value h: for relu
// and leaky relu the sign of h is the sign of the pre-activation.
__device__ inline float mlp_act_grad(int code, float h, float g) {
  return code == 1 ? (h > 0.0f ? g : 0.0f) : code == 2 ? (h >= 0.0f ? g : 0.01f * g) : g;
}

// Rows [0, rows) of a (., c) bf16 row-major matrix into a kMlpRows x cpad
// shared tile of the given pitch, zero-filling rows >= rows and columns
// >= c.  With vec (c % 8 == 0 and src 16-byte aligned) the copy moves 16
// bytes a thread.
__device__ inline void load_rows(bf16* dst, int pitch, const bf16* __restrict__ src, int rows,
                                 int c, int cpad, bool vec) {
  const bf16 zero = __float2bfloat16(0.0f);
  if (vec) {
    const int chunks = c / 8;
    for (int i = threadIdx.x; i < kMlpRows * chunks; i += blockDim.x) {
      const int r = i / chunks, k = i % chunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) v = reinterpret_cast<const uint4*>(src + (size_t)r * c)[k];
      reinterpret_cast<uint4*>(dst + r * pitch)[k] = v;
    }
    const int extra = cpad - c;
    for (int i = threadIdx.x; i < kMlpRows * extra; i += blockDim.x)
      dst[(i / extra) * pitch + c + i % extra] = zero;
  } else {
    for (int i = threadIdx.x; i < kMlpRows * cpad; i += blockDim.x) {
      const int r = i / cpad, k = i % cpad;
      dst[r * pitch + k] = (r < rows && k < c) ? src[(size_t)r * c + k] : zero;
    }
  }
}

// Rows [0, rows) and columns [0, c) of a shared tile into a (., c) bf16
// row-major matrix; vec as for load_rows (dst 16-byte aligned).
__device__ inline void store_rows(bf16* __restrict__ dst, const bf16* src, int pitch, int rows,
                                  int c, bool vec) {
  if (vec) {
    const int chunks = c / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, k = i % chunks;
      reinterpret_cast<uint4*>(dst + (size_t)r * c)[k] =
          reinterpret_cast<const uint4*>(src + r * pitch)[k];
    }
  } else {
    for (int i = threadIdx.x; i < rows * c; i += blockDim.x) {
      const int r = i / c, k = i % c;
      dst[(size_t)r * c + k] = src[r * pitch + k];
    }
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Fill and check the layer description from the C arguments; false for
// what the kernels do not compute.
inline bool mlp_layers(MlpLayers& L, const void* const* w, const void* const* b, int c0,
                       int n_layers, const int* widths, const int* acts) {
  if (n_layers < 1 || n_layers > kMlpMaxLayers || c0 < 1 || c0 > kMlpMaxWidth) return false;
  L.n_layers = n_layers;
  L.c0 = c0;
  L.dims[0] = round_up(c0, 16);
  L.cmax = L.dims[0];
  for (int i = 0; i < kMlpMaxLayers; ++i) {
    L.w[i] = nullptr;
    L.b[i] = nullptr;
    L.act[i] = 0;
    L.dims[i + 1] = 0;
  }
  for (int i = 0; i < n_layers; ++i) {
    if (widths[i] < 16 || widths[i] > kMlpMaxWidth || widths[i] % 16 || acts[i] < 0 ||
        acts[i] > 2 || w[i] == nullptr || b[i] == nullptr)
      return false;
    L.w[i] = static_cast<const bf16*>(w[i]);
    L.b[i] = static_cast<const float*>(b[i]);
    L.dims[i + 1] = widths[i];
    L.act[i] = acts[i];
    if (widths[i] > L.cmax) L.cmax = widths[i];
  }
  return true;
}

// Persistent blocks: as many as fit on the card at once, at most `cap`
// and at most one per tile (at least one).
template <typename Kernel>
inline cudaError_t mlp_grid(Kernel kernel, size_t smem, int device, int cap, long long n_tiles,
                            int* grid) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long g = (long long)per_sm * sms;
  if (g > cap) g = cap;
  if (g > n_tiles) g = n_tiles;
  *grid = (int)(g > 0 ? g : 1);
  return cudaSuccess;
}

}  // namespace wcmc
