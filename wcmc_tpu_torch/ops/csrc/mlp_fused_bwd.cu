// K10-bwd: the gradients of the fused per-pixel MLP (K10-fwd).
//
//   h0 = x,  h[i + 1] = bf16(act_i(h[i] . W_i + b_i))          (recomputed)
//   gz[L-1] = act'(h[L], f32(bf16(g)))
//   gz[i]   = act'_i(h[i + 1], bf16(gz[i + 1]) . W_{i+1}^T)      (f32)
//   dW_i = h[i]^T . bf16(gz[i]),  db_i = sum_rows gz[i]           (f32, over all rows)
//   dx   = bf16(bf16(gz[0]) . W_0^T)                              (only when asked)
//
// act' is taken through the post-activation value: relu passes where
// h > 0, leaky relu where h >= 0 (0.01 elsewhere), linear everywhere.
// Replaces wcmc_tpu/ops/mlp_fused.py::_mlp_bwd_pallas (Pallas body
// _bwd_kernel) with the same rounding points: the cotangent arrives in
// bf16, the hiddens are recomputed in bf16, each layer's cotangent is
// rounded to bf16 before its products, and db comes from the unrounded one.
//
// What bounds it on the H100: memory.  At the LBMC training shape
// (1,048,576 rows, 32 -> 32 -> 32 -> 32, d(x) on, since the features
// carry the learned p-buffer) it reads x and g and writes dx, 201 MB, for
// ~19 GFLOP: ~0.060 ms of bytes against ~0.02 ms of tensor-core time.
//
// Design: the Pallas grid runs in order and adds every step's dW into one
// resident block.  CUDA blocks run in no order, so each persistent block
// adds its tiles' dW and db into its own f32 partials, kept in shared
// memory (at most 4 x 64 x 64 floats), writes them once at the end, and a
// second launch sums the partials in block order (common.cuh
// reduce_parts): deterministic, no float atomics.  A tile of 128 rows
// keeps x and every recomputed hidden in shared memory; the backward
// chain overwrites each hidden with its bf16 cotangent in place, and dx
// overwrites x.  Bias gradients go through per-fragment column sums in
// fixed slots, summed in order.  Weights are staged in shared memory once
// per block.  No TMA, wgmma or pipelining yet.
#include "mlp.cuh"

namespace wcmc {

__host__ __device__ inline long long mlp_bwd_parts(const MlpLayers& L) {
  long long n = 0;
  for (int i = 0; i < L.n_layers; ++i) n += (long long)L.dims[i] * L.dims[i + 1] + L.dims[i + 1];
  return n;
}

__host__ __device__ inline int mlp_dbpart_floats(const MlpLayers& L) {
  const int per_frag = (kMlpRows / 16) * L.cmax;
  return per_frag > kThreads ? per_frag : kThreads;
}

inline size_t mlp_bwd_smem(const MlpLayers& L) {
  size_t s = 0;
  for (int i = 0; i < L.n_layers; ++i)
    s += smem_bytes((size_t)L.dims[i] * pitch_bf16(L.dims[i + 1]), 2) +
         smem_bytes(L.dims[i + 1], 4) + smem_bytes((size_t)L.dims[i] * L.dims[i + 1], 4) +
         smem_bytes(L.dims[i + 1], 4);
  for (int i = 0; i <= L.n_layers; ++i)
    s += smem_bytes((size_t)kMlpRows * pitch_bf16(L.dims[i]), 2);
  return s + smem_bytes(mlp_dbpart_floats(L), 4) + smem_bytes((size_t)kWarps * 256, 4);
}

__global__ void __launch_bounds__(kThreads)
    mlp_fused_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, MlpLayers L,
                         bf16* __restrict__ dx, float* __restrict__ parts, long long n,
                         int vec_x, int vec_dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  using row = wmma::row_major;
  using col = wmma::col_major;
  const int nl = L.n_layers;
  SmemCarver carve{smem, 0};
  bf16* s_w[kMlpMaxLayers];
  float* s_b[kMlpMaxLayers];
  float* s_dw[kMlpMaxLayers];
  float* s_db[kMlpMaxLayers];
  bf16* s_h[kMlpMaxLayers + 1];
  for (int i = 0; i < nl; ++i) {
    s_w[i] = carve.take<bf16>((size_t)L.dims[i] * pitch_bf16(L.dims[i + 1]));
    s_b[i] = carve.take<float>(L.dims[i + 1]);
    s_dw[i] = carve.take<float>((size_t)L.dims[i] * L.dims[i + 1]);
    s_db[i] = carve.take<float>(L.dims[i + 1]);
  }
  for (int i = 0; i <= nl; ++i) s_h[i] = carve.take<bf16>((size_t)kMlpRows * pitch_bf16(L.dims[i]));
  float* s_dbpart = carve.take<float>(mlp_dbpart_floats(L));
  float* s_stage = carve.take<float>((size_t)kWarps * 256);

  for (int i = 0; i < nl; ++i) {
    const int k = L.dims[i], c = L.dims[i + 1];
    load_bf16_tile(s_w[i], pitch_bf16(c), L.w[i], k, c, k, c);
    for (int j = threadIdx.x; j < c; j += blockDim.x) s_b[i][j] = L.b[i][j], s_db[i][j] = 0.0f;
    for (int j = threadIdx.x; j < k * c; j += blockDim.x) s_dw[i][j] = 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c_out = L.dims[nl];
  const long long n_tiles = (n + kMlpRows - 1) / kMlpRows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kMlpRows;
    const int rows = (int)(n - row0 < kMlpRows ? n - row0 : kMlpRows);
    load_rows(s_h[0], pitch_bf16(L.dims[0]), x + row0 * L.c0, rows, L.c0, L.dims[0], vec_x);
    __syncthreads();
    // recompute the hiddens, rounded as the forward rounds
    for (int i = 0; i < nl; ++i) {
      bf16* dst = s_h[i + 1];
      const int p = pitch_bf16(L.dims[i + 1]), code = L.act[i];
      const float* bias = s_b[i];
      tile_mma(s_h[i], pitch_bf16(L.dims[i]), s_w[i], p, kMlpRows, L.dims[i + 1], L.dims[i],
               nullptr, 0, s_stage, [&](int r, int c, float v) {
                 dst[r * p + c] = __float2bfloat16(mlp_act(code, v + bias[c]));
               });
      __syncthreads();
    }
    // the output cotangent: gz = act'(h_L, g) over the tile, in place of
    // h_L, each thread a column of one group of rows; db in fixed order
    {
      bf16* h = s_h[nl];
      const int p = pitch_bf16(c_out), code = L.act[nl - 1];
      const int groups = kThreads / c_out, per = (kMlpRows + groups - 1) / groups;
      const int c = threadIdx.x % c_out, grp = threadIdx.x / c_out;
      if (grp < groups) {
        float sum = 0.0f;
        const bf16* gs = g + row0 * c_out + c;
        for (int r = grp * per; r < min(kMlpRows, (grp + 1) * per); ++r) {
          const float gv = r < rows ? __bfloat162float(gs[(size_t)r * c_out]) : 0.0f;
          const float gz = mlp_act_grad(code, __bfloat162float(h[r * p + c]), gv);
          h[r * p + c] = __float2bfloat16(gz);
          sum += gz;
        }
        s_dbpart[grp * c_out + c] = sum;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < c_out; j += blockDim.x) {
        float v = 0.0f;
        for (int q = 0; q < groups; ++q) v += s_dbpart[q * c_out + j];
        s_db[nl - 1][j] += v;
      }
    }
    for (int i = nl - 1; i >= 0; --i) {
      const int k = L.dims[i], c = L.dims[i + 1];
      const int p_in = pitch_bf16(k), p_out = pitch_bf16(c);
      // dW_i += h_i^T . bf16(gz_i), into this block's partial
      const int n_col = c / 16;
      for (int f = warp; f < (k / 16) * n_col; f += kWarps) {
        const int r0 = (f / n_col) * 16, c0 = (f % n_col) * 16;
        Acc acc;
        float* pd = s_dw[i] + r0 * c + c0;
        wmma::load_matrix_sync(acc, pd, c, wmma::mem_row_major);
        frag_mma<col, row>(acc, s_h[i], p_in, s_h[i + 1], p_out, r0, c0, kMlpRows);
        wmma::store_matrix_sync(pd, acc, c, wmma::mem_row_major);
      }
      __syncthreads();  // h_i is read (and the dbpart sums are taken); it is overwritten next
      if (i == 0 && dx == nullptr) break;
      // bf16(gz_i) . W_i^T: the next cotangent, in place of h_i; for i = 0,
      // d(x) in place of x
      const int code = i > 0 ? L.act[i - 1] : 0;
      const int n_colk = k / 16;
      for (int f = warp; f < (kMlpRows / 16) * n_colk; f += kWarps) {
        const int r0 = (f / n_colk) * 16, c0 = (f % n_colk) * 16;
        Acc acc;
        wmma::fill_fragment(acc, 0.0f);
        frag_mma<row, col>(acc, s_h[i + 1], p_out, s_w[i], p_out, r0, c0, c);
        float* st = stage_frag(acc, s_stage);
        for (int e = lane; e < 256; e += 32) {
          bf16* hp = s_h[i] + (r0 + e / 16) * p_in + c0 + e % 16;
          const float v = i > 0 ? mlp_act_grad(code, __bfloat162float(*hp), st[e]) : st[e];
          st[e] = v;
          *hp = __float2bfloat16(v);
        }
        __syncwarp();
        if (i > 0) {
          const float cs = stage_col_sum(st);
          if (lane < 16) s_dbpart[(r0 / 16) * k + c0 + lane] = cs;
        }
        __syncwarp();
      }
      __syncthreads();
      if (i > 0) {
        for (int j = threadIdx.x; j < k; j += blockDim.x) {
          float v = 0.0f;
          for (int rb = 0; rb < kMlpRows / 16; ++rb) v += s_dbpart[rb * k + j];
          s_db[i - 1][j] += v;
        }
      } else {
        store_rows(dx + row0 * L.c0, s_h[0], p_in, rows, L.c0, vec_dx);
      }
    }
    __syncthreads();  // before the next tile overwrites the tiles
  }
  float* part = parts + (size_t)blockIdx.x * mlp_bwd_parts(L);
  for (int i = 0; i < nl; ++i) {
    const int kc = L.dims[i] * L.dims[i + 1];
    for (int j = threadIdx.x; j < kc; j += blockDim.x) part[j] = s_dw[i][j];
    part += kc;
  }
  for (int i = 0; i < nl; ++i) {
    for (int j = threadIdx.x; j < L.dims[i + 1]; j += blockDim.x) part[j] = s_db[i][j];
    part += L.dims[i + 1];
  }
}

}  // namespace wcmc

using namespace wcmc;

// x (n, c0) bf16 and g (n, c_L) bf16, contiguous; w0..w3, b0..b3, widths
// and acts as for wcmc_mlp_fused; dx (n, c0) bf16 contiguous, or null for
// no d(x).  parts: n_blocks partials of mlp_bwd_parts floats (scratch);
// out: their sum, laid out as dW0 (k0, c1) | dW1 | ... | db0 | db1 | ...,
// f32, with k0 = c0 rounded up to 16 (dW0's extra rows are zero).
extern "C" int wcmc_mlp_fused_bwd(const void* x, const void* g, const void* w0, const void* w1,
                                  const void* w2, const void* w3, const void* b0, const void* b1,
                                  const void* b2, const void* b3, void* dx, void* parts,
                                  void* out, long long n, int c0, int n_layers, int c1, int c2,
                                  int c3, int c4, int a0, int a1, int a2, int a3, int n_blocks,
                                  int device, void* stream) {
  const void* w[kMlpMaxLayers] = {w0, w1, w2, w3};
  const void* b[kMlpMaxLayers] = {b0, b1, b2, b3};
  const int widths[kMlpMaxLayers] = {c1, c2, c3, c4};
  const int acts[kMlpMaxLayers] = {a0, a1, a2, a3};
  MlpLayers L;
  if (!mlp_layers(L, w, b, c0, n_layers, widths, acts) || n < 0 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const size_t smem = mlp_bwd_smem(L);
  cudaError_t err = set_smem(mlp_fused_bwd_kernel, smem, device);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = mlp_grid(mlp_fused_bwd_kernel, smem, device, n_blocks, (n + kMlpRows - 1) / kMlpRows,
                 &grid);
  if (err != cudaSuccess) return err;
  const int vec_x = L.c0 % 8 == 0 && aligned16(x);
  const int vec_dx = L.c0 % 8 == 0 && aligned16(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp_fused_bwd_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), L, static_cast<bf16*>(dx),
      static_cast<float*>(parts), n, vec_x, vec_dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(static_cast<const float*>(parts), static_cast<float*>(out), grid,
                      mlp_bwd_parts(L), s);
}
