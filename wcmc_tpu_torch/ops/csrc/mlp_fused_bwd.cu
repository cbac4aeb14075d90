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
// The Pallas grid runs in order and adds every step's dW into one
// resident block.  CUDA blocks run in no order, so each persistent block
// keeps its own f32 partials of dW and db, writes them once at the end,
// and a second launch sums the partials in block order (common.cuh
// reduce_parts): deterministic, no float atomics.  Two bodies:
//
// - The tiled body (mlp_fused_bwd_tiled_kernel) runs LayerNet's embedding
//   chain: three layers 32 wide, C0 from 1 to 32 (W0 zero-padded to 32
//   rows), any activation per layer, d(x) on or off.  A persistent block of
//   8 warps (one a SM: 203,136 bytes of shared memory); each warp walks its
//   own slabs of 64 rows (warp v of the launch takes slabs v, v + 8 grid,
//   ...) with no block barrier in the loop.  x and g land in a ring of 3
//   slabs a warp by 16-byte cp.async (a slab of x is one contiguous span of
//   128 C0 bytes; for C0 = 32 its pieces go straight into the tiles'
//   swizzled layout, other widths land flat and are unpacked in place).  A
//   slab runs in sub-tiles of 16 rows on mma.sync m16n8k16: the hiddens
//   and the cotangent chain stay in registers (each layer's rounded
//   accumulator is the next product's A fragment), the weights' B
//   fragments come from shared memory by ldmatrix (.trans for W, plain for
//   W^T) from one copy staged once a block, rounded there from the f32
//   parameters.  dW_i = h_i^T . bf16(gz_i)
//   contracts over rows, so its operands are the 8x8 blocks of h_i and
//   bf16(gz_i) transposed in registers (movmatrix; x^T by ldmatrix.trans of
//   the x tile); each warp keeps all three dW partials (96 f32 a thread)
//   and the db column sums of the unrounded gz (24) in registers, in row
//   order.  d(x) overwrites the sub-tile's x rows and leaves by 16-byte
//   stores under the next slab's products.  At the end each warp's partial
//   goes to its own ring, the block sums them in warp order (its one
//   barrier after the weights') and writes its partial.  The k16 steps and
//   rounding points are the wmma body's, so d(x) has its bits.
// - The wmma body (mlp_fused_bwd_kernel) keeps every other form: widths of
//   16, 48 or 64, other layer counts.  A tile of 128 rows keeps x and
//   every recomputed hidden in shared memory; the backward chain
//   overwrites each hidden with its bf16 cotangent in place, and dx
//   overwrites x; dW is added into the block's f32 partials in shared
//   memory each tile (at most 4 x 64 x 64 floats).  Bias gradients go
//   through per-fragment column sums in fixed slots, summed in order.
//   Weights are staged in shared memory once per block.  No pipelining.
#include "hopper.cuh"
#include "mlp.cuh"
#include "mlp_tiled.cuh"

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

// ---------------------------------------------------------------------------
// The tiled body: LayerNet's embedding chain, C0 <= 32 -> 32 -> 32 -> 32
// ---------------------------------------------------------------------------

// the slab tiles, their layout and the forward chain: mlp_tiled.cuh
constexpr int kTbWarps = 8;     // warps of a block, each walking its own slabs
constexpr int kTbStages = 3;    // slabs in flight a warp
constexpr int kTbParts = 3 * kTbW * kTbW + 3 * kTbW;  // dW0 | dW1 | dW2 | db0 | db1 | db2

// The block's shared memory, buffer by buffer in the order the kernel
// carves them (each a multiple of 128 bytes); ops/mlp_fused.py's
// mlp_bwd_plan lists the same.
struct MlpBwdTiledSmem {
  static constexpr int kW = kTbWTile;                    // a weight tile
  static constexpr int kBias = 3 * kTbW * 4;             // b0 | b1 | b2, f32
  static constexpr int kRing = kTbStages * 2 * kTbTile;  // a warp's ring: x tile | g tile a stage
  static size_t total() {
    return smem_bytes(3 * kW, 1) + smem_bytes(kBias, 1) + (size_t)kTbWarps * smem_bytes(kRing, 1);
  }
};
static_assert(kTbParts * 4 <= MlpBwdTiledSmem::kRing, "a warp's partial fits in its ring");

struct MlpBwdTiledArgs {
  const bf16* x;       // (n, c0)
  const bf16* g;       // (n, 32)
  const float* w[3];   // W0 (c0, 32), W1, W2 (32, 32) f32 row-major, rounded to bf16 here
  const float* b[3];   // 32 each
  bf16* dx;            // (n, c0) on 16 bytes, or null for no d(x)
  float* parts;        // kTbParts f32 a block
  long long n;
  int c0;
  int act[3];          // activation codes of mlp_act
  int vec_x, vec_g;    // x / g start on 16 bytes
};

// out = bf16(act(in . W + b)) as K10-fwd's tiled body computes it
// (tb_layer), W's B fragments loaded from its tile and the lane's bias
// columns from `bias` (f32, shared memory) for each call.
template <int kA>
__device__ __forceinline__ void tb_forward(const unsigned (&in)[2][4], unsigned u_w,
                                           const float* bias, int code, const TbLane& ln,
                                           int t4, unsigned (&out)[2][4]) {
  unsigned b[2][2][4];
  tb_weight_frags(u_w, ln, b);
  float2 bb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bb[j] = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t4);
  tb_layer<kA>(in, b, bb, code, out);
}

// acc = gzb . W^T, summed from zero in k16 steps in order; W^T's B
// fragments by ldmatrix of W's tile as it is stored.
__device__ __forceinline__ void tb_back(const unsigned (&gzb)[2][4], unsigned u_w,
                                        const TbLane& ln, float (&acc)[4][4]) {
  unsigned b[2][2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int p = 0; p < 2; ++p) ldmatrix_x4(b[k][p], u_w + ln.c(16 * p, 2 * k));
  tb_mma(gzb, b, acc);
}

// gz = act'(h, v), h the layer's rounded output and v f32 in the
// accumulator layout: db += gz unrounded (each column's rows in order, each
// add rounded as written), gzb = bf16(gz).
template <int kA>
__device__ __forceinline__ void tb_cotangent(const float (&v)[4][4], const unsigned (&h)[2][4],
                                             int code, float (&db)[4][2], unsigned (&gzb)[2][4]) {
  const int c = kA >= 0 ? kA : code;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned hp = h[j >> 1][2 * (j & 1) + r];
      const float z0 = mlp_act_grad(c, bf16_lo(hp), v[j][2 * r]);
      const float z1 = mlp_act_grad(c, bf16_hi(hp), v[j][2 * r + 1]);
      db[j][0] = __fadd_rn(db[j][0], z0);
      db[j][1] = __fadd_rn(db[j][1], z1);
      gzb[j >> 1][2 * (j & 1) + r] = pack_bf16(z0, z1);
    }
}

// The A fragments of h^T (its two m16 tiles: h's columns 0-15, 16-31;
// k16: the sub-tile's rows) from h's blocks, transposed in registers.
__device__ __forceinline__ void tb_transpose(const unsigned (&h)[2][4], unsigned (&at)[2][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    at[m][0] = movmatrix_trans(h[m][0]);
    at[m][1] = movmatrix_trans(h[m][2]);
    at[m][2] = movmatrix_trans(h[m][1]);
    at[m][3] = movmatrix_trans(h[m][3]);
  }
}

// dw (32 x 32 in the accumulator layout: m16 tile m of h's columns, n8
// tile j of gz's) += h^T . gzb over the sub-tile's 16 rows, one k16 step:
// gzb's blocks transposed in registers are the B fragments.
__device__ __forceinline__ void tb_dw(float (&dw)[2][4][4], const unsigned (&at)[2][4],
                                      const unsigned (&gzb)[2][4]) {
  unsigned bt[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) bt[j][r] = movmatrix_trans(gzb[j >> 1][2 * (j & 1) + r]);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(dw[m][j], at[m], bt[j][0], bt[j][1]);
}

// kA0..kA2: the layers' activation codes (-1: read from the arguments).
template <int kA0, int kA1, int kA2>
__global__ void __launch_bounds__(kTbWarps * 32, 1)
    mlp_fused_bwd_tiled_kernel(MlpBwdTiledArgs a) {
  using Sm = MlpBwdTiledSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarver carve{smem, 0};
  unsigned char* s_w = carve.take<unsigned char>(3 * Sm::kW);  // W0 | W1 | W2, swizzled
  float* s_b = carve.take<float>(3 * kTbW);
  unsigned char* s_ring = carve.take<unsigned char>((size_t)kTbWarps * Sm::kRing);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what MlpBwdTiledSmem sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  // the weights, rounded to bf16, and the biases, once a block
  tb_stage_weights(s_w, a.w, a.c0);
  for (int i = tid; i < 3 * kTbW; i += blockDim.x) s_b[i] = a.b[i / kTbW][i % kTbW];
  __syncthreads();

  const TbLane ln(lane);
  const unsigned u_w0 = smem_addr(s_w), u_w1 = u_w0 + Sm::kW, u_w2 = u_w1 + Sm::kW;
  // warp v of the launch walks slabs v, v + nv, ...
  const long long n_slabs = (a.n + kTbRows - 1) / kTbRows;
  const long long v = (long long)blockIdx.x * kTbWarps + warp, nv = (long long)gridDim.x * kTbWarps;
  const int n_mine = v < n_slabs ? (int)((n_slabs - v + nv - 1) / nv) : 0;
  unsigned char* const ring = s_ring + (size_t)warp * Sm::kRing;
  const bool flat_x = !(a.c0 == kTbW && a.vec_x), flat_g = !a.vec_g;
  auto row0_of = [&](int i) { return (v + (long long)i * nv) * kTbRows; };
  auto rows_of = [&](long long row0) { return (int)min((long long)kTbRows, a.n - row0); };
  auto stage = [&](int i) { return ring + (i % kTbStages) * 2 * kTbTile; };
  auto fetch = [&](int i) {
    const long long row0 = row0_of(i);
    const int rows = rows_of(row0);
    tb_land(stage(i), a.x + row0 * a.c0, rows, a.c0, a.vec_x, lane);
    tb_land(stage(i) + kTbTile, a.g + row0 * kTbW, rows, kTbW, a.vec_g, lane);
  };

  float dw[3][2][4][4], db[3][4][2];
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    zero_acc(dw[l][0]);
    zero_acc(dw[l][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) db[l][j][0] = db[l][j][1] = 0.0f;
  }

  for (int i = 0; i < kTbStages - 1; ++i) {
    if (i < n_mine) fetch(i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n_mine; ++i) {
    // the stage slab i + 2 lands in was emptied by slab i - 1
    if (i + kTbStages - 1 < n_mine) fetch(i + kTbStages - 1);
    cp_async_commit();
    cp_async_wait_group<kTbStages - 1>();
    __syncwarp();
    const long long row0 = row0_of(i);
    const int rows = rows_of(row0);
    unsigned char* const st = stage(i);
    if (flat_x) tb_unpack(st, rows, a.c0, lane);
    if (flat_g) tb_unpack(st + kTbTile, rows, kTbW, lane);
    const unsigned u_x = smem_addr(st), u_g = u_x + kTbTile;
#pragma unroll 1
    for (int q = 0; q < kTbRows; q += 16) {
      // the sub-tile's x and g fragments, then h1, h2, h3 recomputed in registers
      unsigned xa[2][4], gp[2][4], h1[2][4], h2[2][4], h3[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        ldmatrix_x4(xa[k], u_x + ln.r(q, 2 * k));
        ldmatrix_x4(gp[k], u_g + ln.r(q, 2 * k));
      }
      tb_forward<kA0>(xa, u_w0, s_b, a.act[0], ln, t4, h1);
      tb_forward<kA1>(h1, u_w1, s_b + kTbW, a.act[1], ln, t4, h2);
      tb_forward<kA2>(h2, u_w2, s_b + 2 * kTbW, a.act[2], ln, t4, h3);
      // gz2 = act2'(h3, g); dW2 += h2^T . bf16(gz2)
      unsigned gzb[2][4], at[2][4];
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[j][2 * r] = bf16_lo(gp[j >> 1][2 * (j & 1) + r]);
          acc[j][2 * r + 1] = bf16_hi(gp[j >> 1][2 * (j & 1) + r]);
        }
      tb_cotangent<kA2>(acc, h3, a.act[2], db[2], gzb);
      tb_transpose(h2, at);
      tb_dw(dw[2], at, gzb);
      // gz1 = act1'(h2, bf16(gz2) . W2^T); dW1 += h1^T . bf16(gz1)
      tb_back(gzb, u_w2, ln, acc);
      tb_cotangent<kA1>(acc, h2, a.act[1], db[1], gzb);
      tb_transpose(h1, at);
      tb_dw(dw[1], at, gzb);
      // gz0 = act0'(h1, bf16(gz1) . W1^T); dW0 += x^T . bf16(gz0), x^T's A
      // fragments by ldmatrix.trans of the x tile
      tb_back(gzb, u_w1, ln, acc);
      tb_cotangent<kA0>(acc, h1, a.act[0], db[0], gzb);
#pragma unroll
      for (int m = 0; m < 2; ++m) ldmatrix_x4_trans(at[m], u_x + ln.c(q, 2 * m));
      tb_dw(dw[0], at, gzb);
      if (a.dx != nullptr) {
        // d(x) = bf16(bf16(gz0) . W0^T), in place of the sub-tile's x rows
        tb_back(gzb, u_w0, ln, acc);
        __syncwarp();  // every lane has read those rows
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<unsigned*>(st + tb_off(q + g8 + 8 * r, j) + 4 * t4) =
                pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
    if (a.dx != nullptr) {
      __syncwarp();
      tb_store(a.dx + row0 * a.c0, st, rows, a.c0, true, lane);
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
  }

  // the warp's partial into its own ring (db summed over the 8 row lanes of
  // each column in a fixed order), then the block's: the warps' in warp order
  cp_async_wait_all();
  __syncwarp();
  float* const part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int l = 0; l < 3; ++l) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(part + l * kTbW * kTbW + (16 * m + g8 + 8 * r) * kTbW +
                                     8 * j + 2 * t4) =
              make_float2(dw[l][m][j][2 * r], dw[l][m][j][2 * r + 1]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = db[l][j][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g8 == 0) part[3 * kTbW * kTbW + l * kTbW + 8 * j + 2 * t4 + e] = s;
      }
  }
  __syncthreads();
  float* const out = a.parts + (size_t)blockIdx.x * kTbParts;
  for (int e = tid; e < kTbParts; e += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kTbWarps; ++w)
      s += reinterpret_cast<const float*>(s_ring + (size_t)w * Sm::kRing)[e];
    out[e] = s;
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

template <int kA0, int kA1, int kA2>
static cudaError_t launch_tiled(const MlpBwdTiledArgs& args, int grid, int device,
                                cudaStream_t stream) {
  auto* kernel = mlp_fused_bwd_tiled_kernel<kA0, kA1, kA2>;
  const size_t smem = MlpBwdTiledSmem::total();
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTbWarps * 32, smem, stream>>>(args);
  return cudaGetLastError();
}

// The tiled body (LayerNet's embedding chain): x (n, c0) bf16, 1 <= c0 <=
// 32; g (n, 32) bf16; w0 (c0, 32), w1, w2 (32, 32) f32 row-major (the
// parameters as they are), b0..b2 (32) f32; a0..a2 the activation codes; dx (n, c0) bf16
// on 16 bytes, or null for no d(x).  All contiguous.  grid: the persistent
// blocks to launch (ops/mlp_fused.py, MlpBwdPlan.grid); parts: grid
// partials of kTbParts floats (scratch); out: their sum in block order,
// dW0 (32, 32) | dW1 | dW2 | db0 | db1 | db2, f32 (dW0's rows past c0
// zero).
extern "C" int wcmc_mlp_fused_bwd_tiled(const void* x, const void* g, const void* w0,
                                        const void* w1, const void* w2, const void* b0,
                                        const void* b1, const void* b2, void* dx, void* parts,
                                        void* out, long long n, int c0, int a0, int a1, int a2,
                                        int grid, int device, void* stream) {
  if (c0 < 1 || c0 > kTbW || n < 0 || grid < 1 || a0 < 0 || a0 > 2 ||
      a1 < 0 || a1 > 2 || a2 < 0 || a2 > 2 || !w0 || !w1 || !w2 || !b0 || !b1 || !b2 ||
      (dx != nullptr && !aligned16(dx)))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  MlpBwdTiledArgs args{static_cast<const bf16*>(x),
                       static_cast<const bf16*>(g),
                       {static_cast<const float*>(w0), static_cast<const float*>(w1),
                        static_cast<const float*>(w2)},
                       {static_cast<const float*>(b0), static_cast<const float*>(b1),
                        static_cast<const float*>(b2)},
                       static_cast<bf16*>(dx),
                       static_cast<float*>(parts),
                       n,
                       c0,
                       {a0, a1, a2},
                       aligned16(x),
                       aligned16(g)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = a0 == 2 && a1 == 2 && a2 == 2  // LayerNet: leaky relu x 3
                              ? launch_tiled<2, 2, 2>(args, grid, device, s)
                              : launch_tiled<-1, -1, -1>(args, grid, device, s);
  if (err != cudaSuccess) return err;
  return reduce_parts(static_cast<const float*>(parts), static_cast<float*>(out), grid, kTbParts,
                      s);
}

// The dynamic shared memory, in bytes, that K10-bwd gives a block of the
// form: the tiled body's (tiled = 1) or the wmma body's; what
// ops/mlp_fused.py's mlp_bwd_plan totals.  -1 for a form the body does not
// take.
extern "C" long long wcmc_mlp_fused_bwd_smem(int c0, int n_layers, int c1, int c2, int c3, int c4,
                                             int tiled) {
  if (tiled) {
    return c0 >= 1 && c0 <= kTbW && n_layers == 3 && c1 == kTbW && c2 == kTbW && c3 == kTbW
               ? (long long)MlpBwdTiledSmem::total()
               : -1;
  }
  static const int any = 0;  // any non-null pointer: mlp_layers checks only the widths' pointers
  const void* w[kMlpMaxLayers] = {&any, &any, &any, &any};
  const int widths[kMlpMaxLayers] = {c1, c2, c3, c4};
  const int acts[kMlpMaxLayers] = {0, 0, 0, 0};
  MlpLayers L;
  if (!mlp_layers(L, w, w, c0, n_layers, widths, acts)) return -1;
  return (long long)mlp_bwd_smem(L);
}
