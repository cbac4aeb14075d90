// K4-fwd: the per-sample embedding MLP with its fused sample mean.
//
//   h_{i+1}        = bf16(act_i(h_i . W_i + b_i)),  h_0 = x[b, s, p, :],  i = 0, 1, 2
//   e[b, s, p, :]  = h_3,   mean[b, p, :] = sum_s f32(e[b, s, p, :]) / S
//
// with a per-layer activation (relu, leaky relu of slope 0.01, or linear;
// mlp_act of mlp.cuh, shared with K10): PathNet runs relu-relu-linear,
// the SBMC Multisteps embedding leaky x 3.  Those two chains are
// template instantiations with the activations fixed at compile time;
// any other chain runs a generic one that reads them at run time.  Replaces
// wcmc_tpu/ops/pathnet_fused.py::_embed_fwd_pallas (Pallas body
// _embed_fwd_kernel).  bf16 inputs and weights, f32 accumulation and f32
// biases, a bf16 rounding after every layer exactly where the TPU kernel
// rounds, and the mean taken over the rounded embedding.
//
// What bounds it on the H100: memory.  At the KPCN serving shape (8
// tiles x 8 spp x 128^2 px, 36 -> 128 -> 128 -> 128, the two PathNet
// branches merged) it moves ~411 MB (paths in, embedding and mean out)
// for ~78 GFLOP, about 190 flop/byte, under the bf16 tensor-core
// balance; at the SBMC shape (95 -> 128 -> 128 -> 128) ~535 MB for ~95
// GFLOP.
//
// Design: the Pallas grid carried the mean across a sequential S axis.
// GPU blocks run in no order, so here a block owns a tile of 64 pixels
// of one image and loops over S inside, keeping the f32 mean in shared
// memory and writing it once; no atomics.  Blocks are persistent (one
// per SM, walking over tiles) so the three weight matrices (~83 KB bf16
// for KPCN, ~96 KB for SBMC) are staged in shared memory once per block,
// not once per tile (~186 KB in all at the SBMC widths, of the 227 KB a
// block may take; the launch is refused above it).  The three layers run
// on the tensor cores through warp-level wmma (bf16 in, f32 accumulate);
// the hidden activations never leave shared memory.
// Loads are not pipelined and there is no TMA or wgmma yet.
#include "mlp.cuh"

namespace wcmc {

constexpr int kEmbedRows = 64;

struct EmbedDims {
  int c0, c1, c2, c3, k0;
  int act0, act1, act2;  // activation codes of mlp_act
};

inline size_t embed_smem(const EmbedDims& d) {
  return smem_bytes((size_t)d.k0 * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)d.c1 * pitch_bf16(d.c2), 2) +
         smem_bytes((size_t)d.c2 * pitch_bf16(d.c3), 2) +
         smem_bytes((size_t)kEmbedRows * pitch_bf16(d.k0), 2) +
         smem_bytes((size_t)kEmbedRows * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)kEmbedRows * pitch_bf16(d.c2), 2) +
         smem_bytes((size_t)kWarps * 256, 4) + smem_bytes((size_t)kEmbedRows * d.c3, 4) +
         smem_bytes(d.c1, 4) + smem_bytes(d.c2, 4) + smem_bytes(d.c3, 4);
}

// kA0..kA2: the layers' activation codes, fixed at compile time for the
// two chains the models run; -1 reads them from d at run time.
template <int kA0, int kA1, int kA2>
__global__ void __launch_bounds__(kThreads)
    pathnet_embed_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                         const float* __restrict__ b0, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, bf16* __restrict__ e,
                         float* __restrict__ mean, int B, int S, int HW, EmbedDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int p_w0 = pitch_bf16(d.c1), p_w1 = pitch_bf16(d.c2), p_w2 = pitch_bf16(d.c3);
  const int p_x = pitch_bf16(d.k0), p_h1 = pitch_bf16(d.c1), p_h2 = pitch_bf16(d.c2);
  SmemCarver carve{smem, 0};
  bf16* s_w0 = carve.take<bf16>((size_t)d.k0 * p_w0);
  bf16* s_w1 = carve.take<bf16>((size_t)d.c1 * p_w1);
  bf16* s_w2 = carve.take<bf16>((size_t)d.c2 * p_w2);
  bf16* s_x = carve.take<bf16>((size_t)kEmbedRows * p_x);
  bf16* s_h1 = carve.take<bf16>((size_t)kEmbedRows * p_h1);
  bf16* s_h2 = carve.take<bf16>((size_t)kEmbedRows * p_h2);
  float* s_stage = carve.take<float>((size_t)kWarps * 256);
  float* s_mean = carve.take<float>((size_t)kEmbedRows * d.c3);
  float* s_b0 = carve.take<float>(d.c1);
  float* s_b1 = carve.take<float>(d.c2);
  float* s_b2 = carve.take<float>(d.c3);

  // weights once per (persistent) block; W0's rows are zero-padded to k0
  load_bf16_tile(s_w0, p_w0, w0, d.c0, d.c1, d.k0, d.c1);
  load_bf16_tile(s_w1, p_w1, w1, d.c1, d.c2, d.c1, d.c2);
  load_bf16_tile(s_w2, p_w2, w2, d.c2, d.c3, d.c2, d.c3);
  for (int i = threadIdx.x; i < d.c1; i += blockDim.x) s_b0[i] = b0[i];
  for (int i = threadIdx.x; i < d.c2; i += blockDim.x) s_b1[i] = b1[i];
  for (int i = threadIdx.x; i < d.c3; i += blockDim.x) s_b2[i] = b2[i];
  __syncthreads();

  const int tiles_per_image = (HW + kEmbedRows - 1) / kEmbedRows;
  const int n_tiles = B * tiles_per_image;
  const float inv_s = 1.0f / (float)S;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_image;
    const int row0 = (t % tiles_per_image) * kEmbedRows;
    const int rows = min(kEmbedRows, HW - row0);
    for (int s = 0; s < S; ++s) {
      const size_t slab = ((size_t)b * S + s) * HW + row0;
      const bf16* xs = x + slab * d.c0;
      for (int i = threadIdx.x; i < kEmbedRows * d.k0; i += blockDim.x) {
        const int r = i / d.k0, c = i % d.k0;
        s_x[r * p_x + c] = (r < rows && c < d.c0) ? xs[(size_t)r * d.c0 + c] : zero;
      }
      __syncthreads();
      tile_mma(s_x, p_x, s_w0, p_w0, kEmbedRows, d.c1, d.k0, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 s_h1[r * p_h1 + c] = __float2bfloat16(fixed_act<kA0>(d.act0, v + s_b0[c]));
               });
      __syncthreads();
      tile_mma(s_h1, p_h1, s_w1, p_w1, kEmbedRows, d.c2, d.c1, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 s_h2[r * p_h2 + c] = __float2bfloat16(fixed_act<kA1>(d.act1, v + s_b1[c]));
               });
      __syncthreads();
      bf16* es = e + slab * d.c3;
      tile_mma(s_h2, p_h2, s_w2, p_w2, kEmbedRows, d.c3, d.c2, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 const bf16 h = __float2bfloat16(fixed_act<kA2>(d.act2, v + s_b2[c]));
                 if (r < rows) es[(size_t)r * d.c3 + c] = h;
                 const float contrib = __bfloat162float(h) * inv_s;
                 float* m = s_mean + r * d.c3 + c;
                 *m = (s == 0) ? contrib : *m + contrib;
               });
      __syncthreads();
    }
    float* ms = mean + ((size_t)b * HW + row0) * d.c3;
    for (int i = threadIdx.x; i < rows * d.c3; i += blockDim.x) ms[i] = s_mean[i];
    __syncthreads();
  }
}

}  // namespace wcmc

using namespace wcmc;

template <int kA0, int kA1, int kA2>
static cudaError_t launch_embed(const void* x, const void* w0, const void* b0, const void* w1,
                                const void* b1, const void* w2, const void* b2, void* e,
                                void* mean, int B, int S, int HW, const EmbedDims& d,
                                int n_blocks, int device, cudaStream_t stream) {
  const size_t smem = embed_smem(d);
  cudaError_t err = set_smem(pathnet_embed_kernel<kA0, kA1, kA2>, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kEmbedRows - 1) / kEmbedRows);
  if (n_tiles == 0) return cudaSuccess;
  const int grid = (int)(n_tiles < n_blocks ? n_tiles : n_blocks);
  pathnet_embed_kernel<kA0, kA1, kA2><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w0), static_cast<const float*>(b0),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(e), static_cast<float*>(mean), B, S, HW,
      d);
  return cudaGetLastError();
}

// x (B, S, HW, c0) bf16; w0 (c0, c1), w1 (c1, c2), w2 (c2, c3) bf16
// row-major; b0..b2 f32; e (B, S, HW, c3) bf16; mean (B, HW, c3) f32.
// All contiguous; c1, c2, c3 multiples of 16; act0..act2 the layers'
// activation codes (0 linear, 1 relu, 2 leaky relu).  n_blocks:
// persistent blocks to launch (the SM count).
extern "C" int wcmc_pathnet_embed(const void* x, const void* w0, const void* b0, const void* w1,
                                  const void* b1, const void* w2, const void* b2, void* e,
                                  void* mean, int B, int S, int HW, int c0, int c1, int c2, int c3,
                                  int act0, int act1, int act2, int n_blocks, int device,
                                  void* stream) {
  if (c0 < 1 || c1 % 16 || c2 % 16 || c3 % 16 || c1 < 16 || c2 < 16 || c3 < 16 || S < 1 ||
      n_blocks < 1 || act0 < 0 || act0 > 2 || act1 < 0 || act1 > 2 || act2 < 0 || act2 > 2)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const EmbedDims d{c0, c1, c2, c3, round_up(c0, 16), act0, act1, act2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act0 == 1 && act1 == 1 && act2 == 0)  // PathNet: relu, relu, linear
    return launch_embed<1, 1, 0>(x, w0, b0, w1, b1, w2, b2, e, mean, B, S, HW, d, n_blocks,
                                 device, s);
  if (act0 == 2 && act1 == 2 && act2 == 2)  // Multisteps: leaky relu x 3
    return launch_embed<2, 2, 2>(x, w0, b0, w1, b1, w2, b2, e, mean, B, S, HW, d, n_blocks,
                                 device, s);
  return launch_embed<-1, -1, -1>(x, w0, b0, w1, b1, w2, b2, e, mean, B, S, HW, d, n_blocks,
                                  device, s);
}
