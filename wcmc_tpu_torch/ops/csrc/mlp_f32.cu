// K10 in float32: the fused per-pixel MLP and its backward for f32 rows
// (TrainConfig.compute_dtype = "float32"), every form the bf16 bodies take:
//
//   h_{i+1} = act_i(h_i . W_i + b_i), h_0 = x (N, c0), i < L; y = h_L
//
// 1 to 4 layers, c0 from 1 to 64, widths multiples of 16 up to 64, the
// activations linear, relu and leaky relu (0.01).  The backward recomputes
// the hidden layers, takes each activation's gradient through its
// post-activation value, sums dW and db in f32 and writes d(x) in f32.
//
// Replaces wcmc_tpu/ops/mlp_fused.py::_mlp_fwd_pallas and _mlp_bwd_pallas on
// f32 inputs: there every product is f32 and nothing is rounded between
// layers, and so here.  (The bf16 forms are mlp_fused.cu and
// mlp_fused_bwd.cu.)
//
// What bounds it on the H100: operations.  LayerNet's embedding 32 -> 32^3
// over LBMC's 1,048,576 rows is 6.44 GFLOP forward, 0.096 ms at the 67
// TFLOP/s f32 rate of the CUDA cores (the 268 MB of x and y take 0.080 ms);
// the backward with d(x) 19.3 GFLOP, 0.288 ms (403 MB, 0.120 ms).
//
// Design, the f32 bodies of K4 and K5 (pathnet_f32.cu) at K10's widths:
// persistent blocks of 256 threads walk tiles of 32 rows (the plan's grid).
// The weights and biases are staged once into shared memory and stay there
// for the whole launch (LayerNet's 12.4 KB; at most 66.5 KB), the backward
// also the weights' transposes, which it stages itself.  Activations are
// 32-row f32 tiles in shared memory.  A product is mm32 (f32_mm.cuh), 32 or
// 64 columns a pass (one or two columns a lane), full f32 fused
// multiply-adds from zero in k order, then the bias and the activation.  The
// backward adds each tile's weight and bias gradients into the block's f32
// partial in device memory, by the thread that owns each element in every
// tile; a second launch (reduce_parts) sums the partials in block order, so
// two launches repeat bit for bit.
#include "f32_mm.cuh"
#include "mlp.cuh"

namespace wcmc {

constexpr int kMlpF32Blocks = 4;  // blocks an SM the kernels are compiled for

struct MlpF32 {
  const float* x;                   // (n, c0)
  const float* g;                   // (n, cL), the output's cotangent (backward)
  const float* w[kMlpMaxLayers];    // (c_i, c_{i+1}) row-major
  const float* b[kMlpMaxLayers];    // (c_{i+1})
  float* out;                       // (n, cL) (forward)
  float* dx;                        // (n, c0) or null (backward)
  float* parts;                     // gridDim.x partials of mlp_f32_parts floats (backward)
  long long n;
  int n_layers;
  int c[kMlpMaxLayers + 1];
  int act[kMlpMaxLayers];
};

__host__ __device__ inline long long mlp_f32_weights(const int* c, int n_layers) {
  long long n = 0;
  for (int i = 0; i < n_layers; ++i) n += (long long)c[i] * c[i + 1];
  return n;
}

__host__ __device__ inline int mlp_f32_biases(const int* c, int n_layers) {
  int n = 0;
  for (int i = 0; i < n_layers; ++i) n += c[i + 1];
  return n;
}

// dW_0 | ... | dW_{L-1} | db_0 | ... | db_{L-1}
__host__ __device__ inline long long mlp_f32_parts(const int* c, int n_layers) {
  return mlp_f32_weights(c, n_layers) + mlp_f32_biases(c, n_layers);
}

// The widest hidden layer (0 for a single layer).
__host__ __device__ inline int mlp_f32_hidden(const int* c, int n_layers) {
  int w = 0;
  for (int i = 1; i < n_layers; ++i) w = c[i] > w ? c[i] : w;
  return w;
}

// Forward: the weights, the biases, x and two hidden tiles (one for two
// layers, none for one).  Backward: the weights, the biases, the
// transposes, x, each hidden layer's tile and the cotangent's.  32 rows each.
inline size_t mlp_f32_smem(const int* c, int n_layers, int bwd) {
  const size_t r = kF32Rows;
  size_t n = smem_bytes(mlp_f32_weights(c, n_layers), 4) +
             smem_bytes(mlp_f32_biases(c, n_layers), 4);
  if (bwd) {
    n += smem_bytes(mlp_f32_weights(c, n_layers), 4) + smem_bytes(r * c[0], 4);
    for (int i = 1; i < n_layers; ++i) n += smem_bytes(r * c[i], 4);
    return n + smem_bytes(r * c[n_layers], 4);
  }
  const int hw = mlp_f32_hidden(c, n_layers);
  const int n_hidden = n_layers < 3 ? n_layers - 1 : 2;
  return n + smem_bytes(r * c[0], 4) + n_hidden * smem_bytes(r * hw, 4);
}

// mm32 with one column a lane for outputs up to 32 wide, two up to 64.
template <typename Epi, typename Init = Zero>
__device__ inline void mm_narrow(const float* A, int lda, int ak, int M, const float* B, int ldb,
                                 int N, int K, Epi epi, Init init = Init()) {
  if (N <= 32) {
    mm32<1>(A, lda, ak, M, B, ldb, N, K, epi, init);
  } else {
    mm32<2>(A, lda, ak, M, B, ldb, N, K, epi, init);
  }
}

// The weights (and, with wt, their transposes (c_{i+1}, c_i)) and the biases
// into shared memory, each layer after the one before; woff[i] / boff[i]
// are layer i's offsets.
__device__ inline void stage_params(const MlpF32& a, float* W, float* WT, float* B, int* woff,
                                    int* boff) {
  int wo = 0, bo = 0;
  for (int i = 0; i < a.n_layers; ++i) {
    const int ci = a.c[i], co = a.c[i + 1];
    woff[i] = wo;
    boff[i] = bo;
    for (int j = threadIdx.x; j < ci * co; j += blockDim.x) {
      const float v = a.w[i][j];
      W[wo + j] = v;
      if (WT != nullptr) WT[wo + (j % co) * ci + j / co] = v;
    }
    for (int j = threadIdx.x; j < co; j += blockDim.x) B[bo + j] = a.b[i][j];
    wo += ci * co;
    bo += co;
  }
}

__global__ void __launch_bounds__(kThreads, kMlpF32Blocks) mlp_fused_f32_kernel(MlpF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.n_layers, c0 = a.c[0], cl = a.c[L];
  SmemCarver carve{smem, 0};
  float* W = carve.take<float>(mlp_f32_weights(a.c, L));
  float* B = carve.take<float>(mlp_f32_biases(a.c, L));
  float* X = carve.take<float>(kF32Rows * c0);
  const int hw = mlp_f32_hidden(a.c, L);
  float* H[2] = {nullptr, nullptr};
  if (L > 1) H[0] = carve.take<float>(kF32Rows * hw);
  if (L > 2) H[1] = carve.take<float>(kF32Rows * hw);
  int woff[kMlpMaxLayers], boff[kMlpMaxLayers];
  stage_params(a, W, nullptr, B, woff, boff);
  const long long tiles = (a.n + kF32Rows - 1) / kF32Rows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kF32Rows;
    const int n = (int)min((long long)kF32Rows, a.n - row0);
    __syncthreads();  // the parameters staged; the last tile's readers are done with X
    load_tile(X, a.x + row0 * c0, n, c0);
    __syncthreads();
    const float* src = X;
    for (int i = 0; i < L; ++i) {
      const int ci = a.c[i], co = a.c[i + 1], act = a.act[i];
      const float* bias = B + boff[i];
      if (i == L - 1) {
        mm_narrow(src, ci, 1, kF32Rows, W + woff[i], co, co, ci, [&](int r, int c, float v) {
          if (r < n) a.out[(row0 + r) * cl + c] = mlp_act(act, v + bias[c]);
        });
      } else {
        float* dst = H[i % 2];
        mm_narrow(src, ci, 1, kF32Rows, W + woff[i], co, co, ci,
                  [&](int r, int c, float v) { dst[r * co + c] = mlp_act(act, v + bias[c]); });
        __syncthreads();
        src = dst;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMlpF32Blocks) mlp_fused_bwd_f32_kernel(MlpF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.n_layers, c0 = a.c[0], cl = a.c[L];
  SmemCarver carve{smem, 0};
  float* W = carve.take<float>(mlp_f32_weights(a.c, L));
  float* B = carve.take<float>(mlp_f32_biases(a.c, L));
  float* WT = carve.take<float>(mlp_f32_weights(a.c, L));
  float* H[kMlpMaxLayers];  // H[0] = x, H[i] = h_i (then its cotangent)
  for (int i = 0; i < L; ++i) H[i] = carve.take<float>(kF32Rows * a.c[i]);
  float* G = carve.take<float>(kF32Rows * cl);  // the output's cotangent, then gz
  int woff[kMlpMaxLayers], boff[kMlpMaxLayers];
  stage_params(a, W, WT, B, woff, boff);
  const long long n_parts = mlp_f32_parts(a.c, L);
  float* part = a.parts + blockIdx.x * n_parts;
  const long long db0 = mlp_f32_weights(a.c, L);
  zero_part(part, n_parts);
  const long long tiles = (a.n + kF32Rows - 1) / kF32Rows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kF32Rows;
    const int n = (int)min((long long)kF32Rows, a.n - row0);
    __syncthreads();  // the parameters and the partial's zeros; the last tile's readers
    load_tile(H[0], a.x + row0 * c0, n, c0);
    load_tile(G, a.g + row0 * cl, n, cl);
    __syncthreads();
    // the hidden layers recomputed
    for (int i = 0; i + 1 < L; ++i) {
      const int ci = a.c[i], co = a.c[i + 1], act = a.act[i];
      const float* bias = B + boff[i];
      float* dst = H[i + 1];
      mm_narrow(H[i], ci, 1, kF32Rows, W + woff[i], co, co, ci,
                [&](int r, int c, float v) { dst[r * co + c] = mlp_act(act, v + bias[c]); });
      __syncthreads();
    }
    if (a.act[L - 1] != 0) {  // the last layer's output recomputed for its gradient
      const int ci = a.c[L - 1], act = a.act[L - 1];
      const float* bias = B + boff[L - 1];
      mm_narrow(H[L - 1], ci, 1, kF32Rows, W + woff[L - 1], cl, cl, ci,
                [&](int r, int c, float v) {
                  G[r * cl + c] = mlp_act_grad(act, mlp_act(act, v + bias[c]), G[r * cl + c]);
                });
      __syncthreads();
    }
    const float* cur = G;  // gz of layer i, 32 x c_{i+1}
    for (int i = L - 1; i >= 0; --i) {
      const int ci = a.c[i], co = a.c[i + 1];
      add_col_sums(part + db0 + boff[i], cur, co);
      if (co <= 32) {
        add_outer<1>(part + woff[i], H[i], ci, cur, co);
      } else {
        add_outer<2>(part + woff[i], H[i], ci, cur, co);
      }
      if (i > 0) {
        __syncthreads();  // dW_i has read h_i
        const int act = a.act[i - 1];
        float* hi = H[i];
        mm_narrow(cur, co, 1, kF32Rows, WT + woff[i], ci, ci, co, [&](int r, int c, float v) {
          hi[r * ci + c] = mlp_act_grad(act, hi[r * ci + c], v);
        });
        __syncthreads();
        cur = hi;
      } else if (a.dx != nullptr) {
        mm_narrow(cur, co, 1, kF32Rows, WT, c0, c0, co, [&](int r, int c, float v) {
          if (r < n) a.dx[(row0 + r) * c0 + c] = v;
        });
      }
    }
  }
}

// Fill and check the kernels' arguments; false for what they do not compute.
inline bool mlp_f32_args(MlpF32& a, const void* const* w, const void* const* b, long long n,
                         int c0, int n_layers, const int* widths, const int* acts) {
  if (n < 0 || n_layers < 1 || n_layers > kMlpMaxLayers || c0 < 1 || c0 > kMlpMaxWidth)
    return false;
  a.n = n;
  a.n_layers = n_layers;
  a.c[0] = c0;
  for (int i = 0; i < kMlpMaxLayers; ++i) {
    a.w[i] = nullptr;
    a.b[i] = nullptr;
    a.act[i] = 0;
    a.c[i + 1] = 0;
  }
  for (int i = 0; i < n_layers; ++i) {
    if (widths[i] < 16 || widths[i] > kMlpMaxWidth || widths[i] % 16 || acts[i] < 0 ||
        acts[i] > 2 || w[i] == nullptr || b[i] == nullptr)
      return false;
    a.w[i] = static_cast<const float*>(w[i]);
    a.b[i] = static_cast<const float*>(b[i]);
    a.c[i + 1] = widths[i];
    a.act[i] = acts[i];
  }
  return true;
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of K10's f32 bodies for the chain c0 -> c1 ...
// (n_layers widths; bwd: the backward's carve): what ops/mlp_fused.py's
// mlp_f32_plan totals.
extern "C" long long wcmc_mlp_f32_smem(int c0, int c1, int c2, int c3, int c4, int n_layers,
                                       int bwd) {
  const int c[kMlpMaxLayers + 1] = {c0, c1, c2, c3, c4};
  if (n_layers < 1 || n_layers > kMlpMaxLayers) return -1;
  return (long long)mlp_f32_smem(c, n_layers, bwd);
}

// K10-fwd in f32: x (n, c0); w_i (c_i, c_{i+1}) row-major and b_i f32 (null
// beyond the last layer); out (n, cL) f32; all contiguous; widths multiples
// of 16 up to 64, c0 1 to 64; act_i 0 linear, 1 relu, 2 leaky relu.
// n_blocks: the grid (the plan's).
extern "C" int wcmc_mlp_fused_f32(const void* x, const void* w0, const void* w1, const void* w2,
                                  const void* w3, const void* b0, const void* b1, const void* b2,
                                  const void* b3, void* out, long long n, int c0, int n_layers,
                                  int c1, int c2, int c3, int c4, int a0, int a1, int a2, int a3,
                                  int n_blocks, int device, void* stream) {
  const void* w[kMlpMaxLayers] = {w0, w1, w2, w3};
  const void* b[kMlpMaxLayers] = {b0, b1, b2, b3};
  const int widths[kMlpMaxLayers] = {c1, c2, c3, c4};
  const int acts[kMlpMaxLayers] = {a0, a1, a2, a3};
  MlpF32 a{};
  if (!mlp_f32_args(a, w, b, n, c0, n_layers, widths, acts) || n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (n == 0) return cudaSuccess;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  return launch_f32(mlp_fused_f32_kernel, a, mlp_f32_smem(a.c, n_layers, 0), n_blocks, device,
                    static_cast<cudaStream_t>(stream));
}

// K10-bwd in f32: x, w_i, b_i as the forward's; g (n, cL) f32, the output's
// cotangent; dx (n, c0) f32 or null (not computed).  parts: n_blocks
// partials of dW_0 | ... | dW_{L-1} | db_0 | ... | db_{L-1} (scratch); out
// their sum in block order, f32.
extern "C" int wcmc_mlp_fused_bwd_f32(const void* x, const void* g, const void* w0,
                                      const void* w1, const void* w2, const void* w3,
                                      const void* b0, const void* b1, const void* b2,
                                      const void* b3, void* dx, void* parts, void* out,
                                      long long n, int c0, int n_layers, int c1, int c2, int c3,
                                      int c4, int a0, int a1, int a2, int a3, int n_blocks,
                                      int device, void* stream) {
  const void* w[kMlpMaxLayers] = {w0, w1, w2, w3};
  const void* b[kMlpMaxLayers] = {b0, b1, b2, b3};
  const int widths[kMlpMaxLayers] = {c1, c2, c3, c4};
  const int acts[kMlpMaxLayers] = {a0, a1, a2, a3};
  MlpF32 a{};
  if (!mlp_f32_args(a, w, b, n, c0, n_layers, widths, acts) || n < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  a.x = static_cast<const float*>(x);
  a.g = static_cast<const float*>(g);
  a.dx = static_cast<float*>(dx);
  a.parts = static_cast<float*>(parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_f32(mlp_fused_bwd_f32_kernel, a, mlp_f32_smem(a.c, n_layers, 1),
                               n_blocks, device, s);
  if (err != cudaSuccess) return err;
  return reduce_parts(a.parts, static_cast<float*>(out), n_blocks, mlp_f32_parts(a.c, n_layers),
                      s);
}
