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
// The Pallas grid streams row tiles with the weights resident in VMEM.
// Two bodies; ops/mlp_fused.py's mlp_fwd_plan picks one:
//
// - The tiled body (mlp_fused_tiled_kernel) runs LayerNet's embedding
//   chain: three layers 32 wide, C0 from 1 to 32 (W0 zero-padded to 32
//   rows), any activation per layer; K10-bwd's tiled body (mlp_tiled.cuh)
//   without the backward.  A persistent block of 8 warps, one a SM; each
//   warp walks its own slabs of 64 rows (warp v of the launch takes slabs
//   v, v + 8 grid, ...) with no block barrier in the loop.  A slab of x is
//   one contiguous span (4 KB at C0 = 32); it lands by 16-byte cp.async in
//   the warp's ring of 4 slabs, straight into the swizzled layout ldmatrix
//   reads without bank conflicts for C0 = 32, flat and unpacked in place
//   otherwise.  The block stages the weights once, rounded to bf16 from the
//   f32 parameters; each warp then keeps every layer's B fragments (48
//   registers) and each thread its bias columns (24) for the whole walk.
//   A slab runs in sub-tiles of 16 rows on mma.sync m16n8k16 with the chain
//   in registers: each layer's f32 accumulator, plus bias, through the
//   activation and rounded to bf16, is packed straight into the next
//   layer's A fragment.  The last layer's bf16 rows overwrite the
//   sub-tile's x rows, and the slab leaves by 16-byte stores while the next
//   slab's copies are in flight.  The k16 steps and rounding points are the
//   wmma body's, so the output has its bits.
// - The wmma body (mlp_fused_kernel) keeps every other form (widths 16, 48
//   or 64, other layer counts): persistent blocks (as many as fit per SM)
//   walk over tiles of 128 rows, the weights (at most 4 layers of 64 x 64
//   bf16, 37 KB) are staged in shared memory once per block, and the
//   hiddens never leave shared memory: they ping-pong between two tiles.
//   Rows are copied in and out 16 bytes a thread.  Each layer runs on the
//   tensor cores through warp-level wmma (bf16 in, f32 accumulate) with the
//   bias, activation and rounding in the store.  An input width that is not
//   a multiple of 16 (27 for LBMC without PathNet) comes with W0
//   zero-padded to k0 rows and the tile's extra columns zeroed, where Pallas
//   padded rows instead.  A tile's load, products and store run in turn.
#include "mlp.cuh"
#include "mlp_tiled.cuh"

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

// ---------------------------------------------------------------------------
// The tiled body: LayerNet's embedding chain, C0 <= 32 -> 32 -> 32 -> 32
// ---------------------------------------------------------------------------

constexpr int kTfWarps = 8;    // warps of a block, each walking its own slabs
constexpr int kTfStages = 4;   // slabs in a warp's ring: three in flight while one computes

// The block's shared memory, buffer by buffer in the order the kernel
// carves them (each a multiple of 128 bytes); ops/mlp_fused.py's
// mlp_fwd_plan lists the same.
struct MlpFwdTiledSmem {
  static constexpr int kRing = kTfStages * kTbTile;  // a warp's ring of x slabs
  static size_t total() {
    return smem_bytes(3 * kTbWTile, 1) + (size_t)kTfWarps * smem_bytes(kRing, 1);
  }
};

struct MlpFwdTiledArgs {
  const bf16* x;       // (n, c0)
  const float* w[3];   // W0 (c0, 32), W1, W2 (32, 32) f32 row-major, rounded to bf16 here
  const float* b[3];   // 32 each
  bf16* out;           // (n, 32)
  long long n;
  int c0;
  int act[3];          // activation codes of mlp_act
  int vec_x, vec_out;  // x / out start on 16 bytes
};

// kA0..kA2: the layers' activation codes (-1: read from the arguments).
template <int kA0, int kA1, int kA2>
__global__ void __launch_bounds__(kTfWarps * 32, 1) mlp_fused_tiled_kernel(MlpFwdTiledArgs a) {
  using Sm = MlpFwdTiledSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarver carve{smem, 0};
  unsigned char* s_w = carve.take<unsigned char>(3 * kTbWTile);  // W0 | W1 | W2, swizzled
  unsigned char* s_ring = carve.take<unsigned char>((size_t)kTfWarps * Sm::kRing);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what MlpFwdTiledSmem sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  tb_stage_weights(s_w, a.w, a.c0);
  // the thread's bias columns 8 j + 2 t4 and + 1 of every layer
  float2 bias[3][4];
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bias[l][j] = make_float2(a.b[l][8 * j + 2 * t4], a.b[l][8 * j + 2 * t4 + 1]);
  __syncthreads();

  const TbLane ln(lane);
  // every layer's B fragments, once for the whole walk
  unsigned wf[3][2][2][4];
#pragma unroll
  for (int l = 0; l < 3; ++l) tb_weight_frags(smem_addr(s_w + l * kTbWTile), ln, wf[l]);

  // warp v of the launch walks slabs v, v + nv, ...
  const long long n_slabs = (a.n + kTbRows - 1) / kTbRows;
  const long long v = (long long)blockIdx.x * kTfWarps + warp, nv = (long long)gridDim.x * kTfWarps;
  const int n_mine = v < n_slabs ? (int)((n_slabs - v + nv - 1) / nv) : 0;
  unsigned char* const ring = s_ring + (size_t)warp * Sm::kRing;
  const bool flat_x = !(a.c0 == kTbW && a.vec_x);
  auto row0_of = [&](int i) { return (v + (long long)i * nv) * kTbRows; };
  auto rows_of = [&](long long row0) { return (int)min((long long)kTbRows, a.n - row0); };
  auto stage = [&](int i) { return ring + (i % kTfStages) * kTbTile; };
  auto fetch = [&](int i) {
    const long long row0 = row0_of(i);
    tb_land(stage(i), a.x + row0 * a.c0, rows_of(row0), a.c0, a.vec_x, lane);
  };

  for (int i = 0; i < kTfStages - 1; ++i) {
    if (i < n_mine) fetch(i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n_mine; ++i) {
    // the stage slab i + 3 lands in was emptied by slab i - 1's store
    if (i + kTfStages - 1 < n_mine) fetch(i + kTfStages - 1);
    cp_async_commit();
    cp_async_wait_group<kTfStages - 1>();
    __syncwarp();
    const long long row0 = row0_of(i);
    const int rows = rows_of(row0);
    unsigned char* const st = stage(i);
    if (flat_x) tb_unpack(st, rows, a.c0, lane);
    const unsigned u_x = smem_addr(st);
#pragma unroll 1
    for (int q = 0; q < kTbRows; q += 16) {
      unsigned xa[2][4], h1[2][4], h2[2][4], h3[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) ldmatrix_x4(xa[k], u_x + ln.r(q, 2 * k));
      tb_layer<kA0>(xa, wf[0], bias[0], a.act[0], h1);
      tb_layer<kA1>(h1, wf[1], bias[1], a.act[1], h2);
      tb_layer<kA2>(h2, wf[2], bias[2], a.act[2], h3);
      __syncwarp();  // every lane has read the sub-tile's x rows
      // the output rows in their place (an accumulator tile j is piece j)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<unsigned*>(st + tb_off(q + g8 + 8 * r, j) + 4 * t4) =
              h3[j >> 1][2 * (j & 1) + r];
    }
    __syncwarp();
    tb_store(a.out + row0 * kTbW, st, rows, kTbW, a.vec_out, lane);
    __syncwarp();  // every lane is done with the stage before it is refilled
  }
  cp_async_wait_all();
}

template <int kA0, int kA1, int kA2>
static cudaError_t launch_fwd_tiled(const MlpFwdTiledArgs& args, int grid, int device,
                                    cudaStream_t stream) {
  auto* kernel = mlp_fused_tiled_kernel<kA0, kA1, kA2>;
  const size_t smem = MlpFwdTiledSmem::total();
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTfWarps * 32, smem, stream>>>(args);
  return cudaGetLastError();
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

// The tiled body (LayerNet's embedding chain): x (n, c0) bf16, 1 <= c0 <=
// 32, contiguous; w0 (c0, 32), w1, w2 (32, 32) f32 row-major (the
// parameters as they are), b0..b2 (32) f32; a0..a2 the activation codes;
// out (n, 32) bf16 contiguous.  grid: the persistent blocks to launch
// (ops/mlp_fused.py, MlpFwdPlan.grid).
extern "C" int wcmc_mlp_fused_tiled(const void* x, const void* w0, const void* w1, const void* w2,
                                    const void* b0, const void* b1, const void* b2, void* out,
                                    long long n, int c0, int a0, int a1, int a2, int grid,
                                    int device, void* stream) {
  if (c0 < 1 || c0 > kTbW || n < 0 || grid < 1 || a0 < 0 || a0 > 2 || a1 < 0 || a1 > 2 ||
      a2 < 0 || a2 > 2 || !w0 || !w1 || !w2 || !b0 || !b1 || !b2)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  MlpFwdTiledArgs args{static_cast<const bf16*>(x),
                       {static_cast<const float*>(w0), static_cast<const float*>(w1),
                        static_cast<const float*>(w2)},
                       {static_cast<const float*>(b0), static_cast<const float*>(b1),
                        static_cast<const float*>(b2)},
                       static_cast<bf16*>(out),
                       n,
                       c0,
                       {a0, a1, a2},
                       aligned16(x),
                       aligned16(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a0 == 2 && a1 == 2 && a2 == 2  // LayerNet: leaky relu x 3
             ? launch_fwd_tiled<2, 2, 2>(args, grid, device, s)
             : launch_fwd_tiled<-1, -1, -1>(args, grid, device, s);
}

// The dynamic shared memory, in bytes, that K10-fwd gives a block of the
// form: the tiled body's (tiled = 1) or the wmma body's; what
// ops/mlp_fused.py's mlp_fwd_plan totals.  -1 for a form the body does not
// take.
extern "C" long long wcmc_mlp_fused_smem(int c0, int n_layers, int c1, int c2, int c3, int c4,
                                         int tiled) {
  if (tiled) {
    return c0 >= 1 && c0 <= kTbW && n_layers == 3 && c1 == kTbW && c2 == kTbW && c3 == kTbW
               ? (long long)MlpFwdTiledSmem::total()
               : -1;
  }
  static const int any = 0;  // any non-null pointer: mlp_layers checks only the widths' pointers
  const void* w[kMlpMaxLayers] = {&any, &any, &any, &any};
  const int widths[kMlpMaxLayers] = {c1, c2, c3, c4};
  const int acts[kMlpMaxLayers] = {0, 0, 0, 0};
  MlpLayers L;
  if (!mlp_layers(L, w, w, c0, n_layers, widths, acts)) return -1;
  return (long long)mlp_fwd_smem(L);
}
