// K10-fwd: the fused per-pixel MLP, a chain of 1x1 convolutions over rows.
//
//   h0 = x,  h[i + 1] = bf16(act_i(h[i] . W_i + b_i))   (f32 accumulation, f32 bias)
//   out = h[L]                                         (bf16)
//
// Replaces wcmc_tpu/ops/mlp_fused.py::_mlp_fwd_pallas (Pallas body
// _fwd_kernel): every layer accumulates in f32, adds its f32 bias, applies
// its activation (linear, relu or leaky relu, per layer) and rounds to
// bf16 before the next layer; only the last layer's output is written.
//
// What bounds it on the H100: memory.  At the LBMC shape (8 patches x 8
// spp x 128^2 px = 1,048,576 rows, 32 -> 32 -> 32 -> 32) it reads x and
// writes the output, 67 MB each, for ~6.4 GFLOP: ~0.040 ms of bytes
// against ~0.007 ms of bf16 tensor-core time.
//
// Design: the Pallas grid streams row tiles with the weights resident in
// VMEM.  Here persistent blocks (as many as fit per SM) walk over tiles of
// 128 rows, the weights (at most 4 layers of 64 x 64 bf16, 37 KB) are
// staged in shared memory once per block, and the hiddens never leave
// shared memory: they ping-pong between two tiles.  Rows are copied in and
// out 16 bytes a thread.  Each layer runs on the tensor cores through
// warp-level wmma (bf16 in, f32 accumulate) with the bias, activation and
// rounding in the store.  An input width that is not a multiple of 16 (27
// for LBMC without PathNet) comes with W0 zero-padded to k0 rows and the
// tile's extra columns zeroed, where Pallas padded rows instead.  No TMA,
// wgmma or pipelining yet: a tile's load, products and store run in turn.
#include "mlp.cuh"

namespace wcmc {

inline size_t mlp_fwd_smem(const MlpLayers& L) {
  size_t s = 0;
  for (int i = 0; i < L.n_layers; ++i)
    s += smem_bytes((size_t)L.dims[i] * pitch_bf16(L.dims[i + 1]), 2) +
         smem_bytes(L.dims[i + 1], 4);
  return s + smem_bytes((size_t)kMlpRows * pitch_bf16(L.dims[0]), 2) +
         2 * smem_bytes((size_t)kMlpRows * pitch_bf16(L.cmax), 2) +
         smem_bytes((size_t)kWarps * 256, 4);
}

__global__ void __launch_bounds__(kThreads)
    mlp_fused_kernel(const bf16* __restrict__ x, MlpLayers L, bf16* __restrict__ out,
                     long long n, int vec_in, int vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarver carve{smem, 0};
  bf16* s_w[kMlpMaxLayers];
  float* s_b[kMlpMaxLayers];
  for (int i = 0; i < L.n_layers; ++i) {
    s_w[i] = carve.take<bf16>((size_t)L.dims[i] * pitch_bf16(L.dims[i + 1]));
    s_b[i] = carve.take<float>(L.dims[i + 1]);
  }
  const int p_x = pitch_bf16(L.dims[0]), p_h = pitch_bf16(L.cmax);
  bf16* s_x = carve.take<bf16>((size_t)kMlpRows * p_x);
  bf16* s_h[2] = {carve.take<bf16>((size_t)kMlpRows * p_h),
                  carve.take<bf16>((size_t)kMlpRows * p_h)};
  float* s_stage = carve.take<float>((size_t)kWarps * 256);

  for (int i = 0; i < L.n_layers; ++i) {
    const int k = L.dims[i], c = L.dims[i + 1];
    load_bf16_tile(s_w[i], pitch_bf16(c), L.w[i], k, c, k, c);
    for (int j = threadIdx.x; j < c; j += blockDim.x) s_b[i][j] = L.b[i][j];
  }
  __syncthreads();

  const int c_out = L.dims[L.n_layers];
  const long long n_tiles = (n + kMlpRows - 1) / kMlpRows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kMlpRows;
    const int rows = (int)(n - row0 < kMlpRows ? n - row0 : kMlpRows);
    load_rows(s_x, p_x, x + row0 * L.c0, rows, L.c0, L.dims[0], vec_in);
    __syncthreads();
    const bf16* a = s_x;
    int lda = p_x;
    for (int i = 0; i < L.n_layers; ++i) {
      bf16* dst = s_h[i & 1];
      const int code = L.act[i];
      const float* bias = s_b[i];
      tile_mma(a, lda, s_w[i], pitch_bf16(L.dims[i + 1]), kMlpRows, L.dims[i + 1], L.dims[i],
               nullptr, 0, s_stage, [&](int r, int c, float v) {
                 dst[r * p_h + c] = __float2bfloat16(mlp_act(code, v + bias[c]));
               });
      __syncthreads();
      a = dst;
      lda = p_h;
    }
    store_rows(out + row0 * c_out, a, lda, rows, c_out, vec_out);
    __syncthreads();  // before the next tile's products overwrite the hiddens
  }
}

}  // namespace wcmc

using namespace wcmc;

// x (n, c0) bf16 contiguous; w0..w3 bf16 (dims[i], dims[i + 1]) row-major
// with W0 zero-padded to k0 = c0 rounded up to 16 rows, b0..b3 f32, null
// beyond n_layers; out (n, c_L) bf16 contiguous.  widths: c1..c_L
// (multiples of 16 up to 64); acts: 0 linear, 1 relu, 2 leaky relu.
// n_blocks: the most persistent blocks to launch.
extern "C" int wcmc_mlp_fused(const void* x, const void* w0, const void* w1, const void* w2,
                              const void* w3, const void* b0, const void* b1, const void* b2,
                              const void* b3, void* out, long long n, int c0, int n_layers,
                              int c1, int c2, int c3, int c4, int a0, int a1, int a2, int a3,
                              int n_blocks, int device, void* stream) {
  const void* w[kMlpMaxLayers] = {w0, w1, w2, w3};
  const void* b[kMlpMaxLayers] = {b0, b1, b2, b3};
  const int widths[kMlpMaxLayers] = {c1, c2, c3, c4};
  const int acts[kMlpMaxLayers] = {a0, a1, a2, a3};
  MlpLayers L;
  if (!mlp_layers(L, w, b, c0, n_layers, widths, acts) || n < 0 || n_blocks < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const size_t smem = mlp_fwd_smem(L);
  cudaError_t err = set_smem(mlp_fused_kernel, smem, device);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = mlp_grid(mlp_fused_kernel, smem, device, n_blocks, (n + kMlpRows - 1) / kMlpRows, &grid);
  if (err != cudaSuccess) return err;
  const int vec_in = L.c0 % 8 == 0 && aligned16(x);
  const int vec_out = aligned16(out);  // c_L is a multiple of 16
  mlp_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), L, static_cast<bf16*>(out), n, vec_in, vec_out);
  return cudaGetLastError();
}
