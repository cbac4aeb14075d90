// K10-bwd in float32 on the tensor cores: the gradients of the fused
// per-pixel MLP at LayerNet's chain (C0 <= 32 -> 32 -> 32 -> 32, any
// activations, d(x) on or off), for f32 rows (TrainConfig.compute_dtype =
// "float32"), every product in split TF32 (tf32x3.cuh: lo . hi + hi . lo +
// hi . hi of the operands' tf32 halves, a partial a k8 step, about f32's
// accuracy):
//
//   h0 = x, h_{i+1} = a_i(h_i . W_i + b_i)          (recomputed; h3 only where a_2 is not linear)
//   g3 = a_2'(h3, g),  g_i = a_{i-1}'(h_i, g_{i+1} . W_i^T)   (each through its post-activation value)
//   dW_i = h_i^T . g_{i+1},  db_i = sum_rows g_{i+1},  d(x) = g1 . W0^T   (f32; d(x) where asked)
//
// The same function as ops/mlp_fused.py's _mlp_bwd_plain at f32.  Replaces
// wcmc_tpu/ops/mlp_fused.py::_mlp_bwd_pallas (pallas_call :224, body
// _bwd_kernel :96) on f32 rows, where every product is f32.  (The bf16
// forms are mlp_fused_bwd.cu; the first f32 body, SIMT, is mlp_f32.cu's
// mlp_fused_bwd_f32_kernel, kept as the card tests' reference and for every
// other form.)
//
// What bounds it on the H100: the bytes, barely.  Over LBMC's 1,048,576
// rows with d(x) it is 19.3 GFLOP: 0.117 ms in split TF32 (three tf32
// products an f32 one at 495 TFLOP/s), 0.288 ms at the CUDA cores' 67
// TFLOP/s; x, g and d(x) are 403 MB, 0.120 ms.
//
// Design: the bf16 tiled body's (mlp_fused_bwd.cu) in f32.
// - A persistent block of 8 warps, one an SM; each warp walks its own
//   slabs of 16 rows (warp v of the launch takes slabs v, v + 8 grid, ...)
//   with no block barrier in the walk.  A slab's x and g land in the warp's
//   ring of 3 slabs by cp.async (16 bytes a copy where C0 is a multiple of
//   4 and x 16-byte aligned, else 4; g likewise), rows at a pitch of 40
//   floats.  16-row slabs, not the bf16 body's 64: an f32 slab of x and g
//   is 5 KB, and 3 stages of 64 rows for 8 warps would not fit beside the
//   weights.
// - A slab is one m16 tile on mma.sync m16n8k8 (tf32).  The chain stays in
//   registers: an accumulator's n8 tile j is the next product's A fragment
//   of k8 step j, because the packed B operands (ops/pathnet_fused.py's
//   pack_b_tf32) take a k8 step's rows 2t and 2t + 1 where the fragment's k
//   is t and t + 4, which are the columns 2t and 2t + 1 that lane holds.
//   Each A value is split into its tf32 halves once a product, for all 4
//   n8 tiles.
// - dW_i = h_i^T . g_{i+1} contracts over the slab's rows, which a lane
//   holds by its row (g) where the product wants them by its k (t), so the
//   operands go through shared memory: h1 and h2 to the warp's own tiles,
//   each g_{i+1} over the slab's g tile in turn (its rows read by then),
//   and mm_rows_t reads them transposed (x^T straight from the x tile).
//   dW0, dW1 and dW2 stay in each warp's registers for its whole walk (32
//   floats a lane each), each k8 step's products into a partial from zero
//   added by one f32 add; db too, each lane summing its two rows of each
//   slab in order.
// - The weights' split B operands (W0, W1, W2, W2^T, W1^T, W0^T; 48 KB),
//   packed once per parameter value by the wrapper, are staged once a block
//   into shared memory and read 16 bytes a lane; the biases beside them.
// - d(x) is stored from the accumulators, 8 bytes a lane.
// - At the end each warp writes its partial over its ring, the block sums
//   its warps' in warp order and writes its partial once; reduce_parts
//   (common.cuh) sums the blocks' in block order, so two launches repeat
//   bit for bit.
// Shared memory (mlp_bwd_tc_smem): the weights, the biases, then 8 warps'
// rings (3 stages of an x and a g tile) and h1 and h2 tiles: 213376 bytes.
#include "hopper.cuh"
#include "mlp.cuh"
#include "tf32x3.cuh"

namespace wcmc {

constexpr int kMtW = 32;                       // every width; C0 padded to it
constexpr int kMtRows = 16;                    // rows of a slab: one m16 tile
constexpr int kMtWarps = 8;                    // warps of a block, each walking its own slabs
constexpr int kMtStages = 3;                   // slabs in flight a warp
constexpr int kMtPitch = 40;                   // floats a row of every tile
constexpr int kMtTile = kMtRows * kMtPitch;    // floats of a tile
constexpr int kMtMat = 2 * kMtW * kMtW;        // floats of a packed 32 x 32 matrix
constexpr int kMtParts = 3 * kMtW * kMtW + 3 * kMtW;  // dW0 | dW1 | dW2 | db0 | db1 | db2

// The block's shared memory in the kernel's carve order (each a multiple
// of 128 bytes): ops/mlp_fused.py's mlp_bwd_tc_plan lists the same.
struct MlpBwdTcSmem {
  static constexpr int kWeights = 6 * kMtMat * 4;
  static constexpr int kBias = 3 * kMtW * 4;
  static constexpr int kRing = kMtStages * 2 * kMtTile * 4;  // x tile | g tile a stage
  static constexpr int kHidden = 2 * kMtTile * 4;            // h1 | h2
  static constexpr size_t total() {
    return kWeights + kBias + (size_t)kMtWarps * (kRing + kHidden);
  }
};
static_assert(kMtParts * 4 <= MlpBwdTcSmem::kRing, "a warp's partial fits in its ring");

struct MlpBwdTcArgs {
  const float* x;     // (n, c0)
  const float* g;     // (n, 32)
  const float* wp;    // pack_mlp_tf32: W0 | W1 | W2 | W2^T | W1^T | W0^T as fragments
  const float* bias;  // b0 | b1 | b2
  float* dx;          // (n, c0) or null for no d(x)
  float* parts;       // kMtParts f32 a block
  long long n;
  int c0, xvec, gvec;
  int act[3];
};

// A 16 x 32 tile of a warp in the accumulator layout of mma.m16n8k8: v[j]
// holds (row g, cols 8 j + 2t, + 1) and (row g + 8, the same cols).
using Frags = float[4][4];

__device__ __forceinline__ void mt_load(Frags& v, const float* tile, int g, int t4) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 p = *reinterpret_cast<const float2*>(tile + (g + 8 * h) * kMtPitch + 8 * j + 2 * t4);
      v[j][2 * h] = p.x;
      v[j][2 * h + 1] = p.y;
    }
}

__device__ __forceinline__ void mt_store(float* tile, const Frags& v, int g, int t4) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (g + 8 * h) * kMtPitch + 8 * j + 2 * t4) =
          make_float2(v[j][2 * h], v[j][2 * h + 1]);
}

// out = a . W from zero, k8 step by k8 step (mma3): a's n8 tile ks is the A
// fragment of k8 step ks; W packed (pack_b_tf32) in shared memory.
__device__ __forceinline__ void mt_mm(Frags& out, const Frags& a, const float* w, int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[nt][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    FragA fa;
    fa.set(a[ks][0], a[ks][2], a[ks][1], a[ks][3]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint4 v = *reinterpret_cast<const uint4*>(w + ((nt * 4 + ks) * 32 + lane) * 4);
      FragB fb;
      fb.v[0] = v.x, fb.v[1] = v.y, fb.v[2] = v.z, fb.v[3] = v.w;
      mma3(out[nt], fa, fb);
    }
  }
}

// v = act(v + bias) in place
template <int kA>
__device__ __forceinline__ void mt_bias_act(Frags& v, const float* bias, int code, int t4) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[j][2 * h] = fixed_act<kA>(code, v[j][2 * h] + b.x);
      v[j][2 * h + 1] = fixed_act<kA>(code, v[j][2 * h + 1] + b.y);
    }
  }
}

// gz = act'(h, v) in place of v, h the layer's post-activation value;
// db += gz, the lane's row g, then its row g + 8
template <int kA>
__device__ __forceinline__ void mt_grad(Frags& v, const Frags& h, int code, float (&db)[4][2]) {
  const int c = kA >= 0 ? kA : code;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[j][2 * r + e] = mlp_act_grad(c, h[j][2 * r + e], v[j][2 * r + e]);
        db[j][e] += v[j][2 * r + e];
      }
}

// kA0..kA2: the layers' activation codes (-1: read from the arguments).
template <int kA0, int kA1, int kA2>
__global__ void __launch_bounds__(kMtWarps * 32, 1) mlp_fused_bwd_tf32_kernel(MlpBwdTcArgs a) {
  using Sm = MlpBwdTcSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarver carve{smem, 0};
  float* s_w = carve.take<float>(6 * kMtMat);
  float* s_b = carve.take<float>(3 * kMtW);
  float* s_ring = carve.take<float>((size_t)kMtWarps * Sm::kRing / 4);
  float* s_hid = carve.take<float>((size_t)kMtWarps * Sm::kHidden / 4);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  constexpr int oW1 = kMtMat, oW2 = 2 * kMtMat, oW2t = 3 * kMtMat, oW1t = 4 * kMtMat,
                oW0t = 5 * kMtMat;

  // the packed weights and the biases, once a block
  for (int i = tid; i < 6 * kMtMat / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(s_w)[i] = __ldg(reinterpret_cast<const uint4*>(a.wp) + i);
  for (int i = tid; i < 3 * kMtW; i += blockDim.x) s_b[i] = a.bias[i];
  __syncthreads();

  float* const ring = s_ring + (size_t)warp * Sm::kRing / 4;
  float* const H1 = s_hid + (size_t)warp * Sm::kHidden / 4;
  float* const H2 = H1 + kMtTile;
  const long long n_slabs = (a.n + kMtRows - 1) / kMtRows;
  const long long v = (long long)blockIdx.x * kMtWarps + warp, nv = (long long)gridDim.x * kMtWarps;
  const int n_mine = v < n_slabs ? (int)((n_slabs - v + nv - 1) / nv) : 0;
  auto row0_of = [&](int i) { return (v + (long long)i * nv) * kMtRows; };
  auto stage = [&](int i) { return ring + (i % kMtStages) * 2 * kMtTile; };
  // slab i's x (zero past c0) and g into its stage, rows past n zero
  auto fetch = [&](int i) {
    const long long row0 = row0_of(i);
    const int rows = (int)min((long long)kMtRows, a.n - row0);
    float* const X = stage(i);
    float* const G = X + kMtTile;
    if (a.xvec) {
      for (int k = lane; k < kMtRows * 8; k += 32) {
        const int r = k / 8, q = k % 8;
        const bool ok = r < rows && 4 * q < a.c0;
        cp_async16_zfill(smem_addr(X + r * kMtPitch + 4 * q),
                         ok ? a.x + (row0 + r) * a.c0 + 4 * q : a.x, ok ? 16 : 0);
      }
    } else {
      for (int k = lane; k < kMtRows * kMtW; k += 32) {
        const int r = k / kMtW, c = k % kMtW;
        const bool ok = r < rows && c < a.c0;
        cp_async4_zfill(smem_addr(X + r * kMtPitch + c), ok ? a.x + (row0 + r) * a.c0 + c : a.x,
                        ok ? 4 : 0);
      }
    }
    if (a.gvec) {
      for (int k = lane; k < kMtRows * 8; k += 32) {
        const int r = k / 8, q = k % 8;
        const bool ok = r < rows;
        cp_async16_zfill(smem_addr(G + r * kMtPitch + 4 * q),
                         ok ? a.g + (row0 + r) * kMtW + 4 * q : a.g, ok ? 16 : 0);
      }
    } else {
      for (int k = lane; k < kMtRows * kMtW; k += 32) {
        const int r = k / kMtW, c = k % kMtW;
        const bool ok = r < rows;
        cp_async4_zfill(smem_addr(G + r * kMtPitch + c), ok ? a.g + (row0 + r) * kMtW + c : a.g,
                        ok ? 4 : 0);
      }
    }
  };

  float dw[3][2][4][4], db[3][4][2];
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    zero_frags(dw[l]);
#pragma unroll
    for (int j = 0; j < 4; ++j) db[l][j][0] = db[l][j][1] = 0.0f;
  }

  for (int i = 0; i < kMtStages - 1; ++i) {
    if (i < n_mine) fetch(i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n_mine; ++i) {
    // the stage slab i + 2 lands in was emptied by slab i - 1
    if (i + kMtStages - 1 < n_mine) fetch(i + kMtStages - 1);
    cp_async_commit();
    cp_async_wait_group<kMtStages - 1>();
    __syncwarp();
    const long long row0 = row0_of(i);
    float* const X = stage(i);
    float* const G = X + kMtTile;

    // the chain recomputed: h1, h2 (to the warp's tiles), h3 where a2 is not linear
    Frags h, v;
    mt_load(v, X, g8, t4);
    mt_mm(h, v, s_w, lane);
    mt_bias_act<kA0>(h, s_b, a.act[0], t4);
    mt_store(H1, h, g8, t4);
    mt_mm(v, h, s_w + oW1, lane);
    mt_bias_act<kA1>(v, s_b + kMtW, a.act[1], t4);
    mt_store(H2, v, g8, t4);
    // g3 = a2'(h3, g)
    Frags gz;
    mt_load(gz, G, g8, t4);
    if (kA2 != 0 && (kA2 > 0 || a.act[2] != 0)) {
      mt_mm(h, v, s_w + oW2, lane);
      mt_bias_act<kA2>(h, s_b + 2 * kMtW, a.act[2], t4);
      mt_grad<kA2>(gz, h, a.act[2], db[2]);
    } else {
      mt_grad<0>(gz, h, 0, db[2]);
    }
    mt_store(G, gz, g8, t4);  // over g: each lane rewrites what it read
    __syncwarp();
    mm_rows_t<2, 4>(dw[2], H2, kMtPitch, 0, G, kMtPitch, 0, kMtRows / 8);  // dW2 += h2^T . g3
    // g2 = a1'(h2, g3 . W2^T)
    mt_mm(v, gz, s_w + oW2t, lane);
    mt_load(h, H2, g8, t4);
    mt_grad<kA1>(v, h, a.act[1], db[1]);
    __syncwarp();  // dW2 has read g3
    mt_store(G, v, g8, t4);
    __syncwarp();
    mm_rows_t<2, 4>(dw[1], H1, kMtPitch, 0, G, kMtPitch, 0, kMtRows / 8);  // dW1 += h1^T . g2
    // g1 = a0'(h1, g2 . W1^T)
    mt_mm(gz, v, s_w + oW1t, lane);
    mt_load(h, H1, g8, t4);
    mt_grad<kA0>(gz, h, a.act[0], db[0]);
    __syncwarp();  // dW1 has read g2
    mt_store(G, gz, g8, t4);
    __syncwarp();
    mm_rows_t<2, 4>(dw[0], X, kMtPitch, 0, G, kMtPitch, 0, kMtRows / 8);  // dW0 += x^T . g1
    if (a.dx != nullptr) {  // d(x) = g1 . W0^T, columns past c0 and rows past n dropped
      mt_mm(v, gz, s_w + oW0t, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long r = row0 + g8 + 8 * hh;
        if (r >= a.n) continue;
        float* d = a.dx + r * a.c0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * j + 2 * t4;
          if (a.c0 == kMtW) {
            *reinterpret_cast<float2*>(d + c) = make_float2(v[j][2 * hh], v[j][2 * hh + 1]);
          } else {
            if (c < a.c0) d[c] = v[j][2 * hh];
            if (c + 1 < a.c0) d[c + 1] = v[j][2 * hh + 1];
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the stage and the h tiles before they are refilled
  }

  // the warp's partial over its ring (db summed over the 8 row lanes of each
  // column in a fixed order), then the block's: the warps' in warp order
  cp_async_wait_all();
  __syncwarp();
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    each_frag(dw[l], 0, 0, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(ring + l * kMtW * kMtW + r * kMtW + c) = make_float2(v0, v1);
    });
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = db[l][j][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g8 == 0) ring[3 * kMtW * kMtW + l * kMtW + 8 * j + 2 * t4 + e] = s;
      }
  }
  __syncthreads();
  float* const out = a.parts + (size_t)blockIdx.x * kMtParts;
  for (int e = tid; e < kMtParts; e += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kMtWarps; ++w) s += s_ring[(size_t)w * Sm::kRing / 4 + e];
    out[e] = s;
  }
}

template <int kA0, int kA1, int kA2>
static cudaError_t launch_bwd_tc(const MlpBwdTcArgs& args, int grid, int device,
                                 cudaStream_t stream) {
  auto* kernel = mlp_fused_bwd_tf32_kernel<kA0, kA1, kA2>;
  const size_t smem = MlpBwdTcSmem::total();
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMtWarps * 32, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of K10-bwd's tensor-core f32 body for the chain
// c0 -> c1 -> c2 -> c3: what ops/mlp_fused.py's mlp_bwd_tc_plan totals; -1
// for a chain the body does not take.
extern "C" long long wcmc_mlp_fused_bwd_tf32_smem(int c0, int c1, int c2, int c3) {
  return c0 >= 1 && c0 <= kMtW && c1 == kMtW && c2 == kMtW && c3 == kMtW
             ? (long long)MlpBwdTcSmem::total()
             : -1;
}

// K10-bwd in f32 on the tensor cores, LayerNet's chain: x (n, c0) f32, 1 <=
// c0 <= 32; g (n, 32) f32; wp the weights packed by ops/mlp_fused.py's
// pack_mlp_tf32 (16-byte aligned), bias b0 | b1 | b2 (32 each) f32; a0..a2
// the activation codes; dx (n, c0) f32, 8-byte aligned, or null for no
// d(x).  All contiguous.  grid: the persistent blocks to launch
// (MlpBwdTcPlan.grid); parts: grid partials of kMtParts floats (scratch);
// out: their sum in block order, dW0 (32, 32) | dW1 | dW2 | db0 | db1 | db2,
// f32 (dW0's rows past c0 zero).
extern "C" int wcmc_mlp_fused_bwd_tf32(const void* x, const void* g, const void* wp,
                                       const void* bias, void* dx, void* parts, void* out,
                                       long long n, int c0, int a0, int a1, int a2, int grid,
                                       int device, void* stream) {
  if (c0 < 1 || c0 > kMtW || n < 1 || grid < 1 || a0 < 0 || a0 > 2 || a1 < 0 || a1 > 2 ||
      a2 < 0 || a2 > 2 || !aligned16(wp))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  MlpBwdTcArgs args{};
  args.x = static_cast<const float*>(x);
  args.g = static_cast<const float*>(g);
  args.wp = static_cast<const float*>(wp);
  args.bias = static_cast<const float*>(bias);
  args.dx = static_cast<float*>(dx);
  args.parts = static_cast<float*>(parts);
  args.n = n;
  args.c0 = c0;
  args.xvec = c0 % 4 == 0 && aligned16(x);
  args.gvec = aligned16(g);
  args.act[0] = a0, args.act[1] = a1, args.act[2] = a2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = a0 == 2 && a1 == 2 && a2 == 2  // LayerNet: leaky relu x 3
                              ? launch_bwd_tc<2, 2, 2>(args, grid, device, s)
                              : launch_bwd_tc<-1, -1, -1>(args, grid, device, s);
  if (err != cudaSuccess) return err;
  return reduce_parts(static_cast<const float*>(parts), static_cast<float*>(out), grid, kMtParts,
                      s);
}
