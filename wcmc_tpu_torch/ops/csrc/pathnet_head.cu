// K5-fwd: PathNet head over [e | broadcast_S(ctx)] with the f32 sample
// moments.
//
//   h1             = bf16(relu(e[b, s, p] . W1e + ctx[b, p] . W1c + b1))
//   out[b, s, p]   = relu(h1 . W2 + b2)                     (f32, unrounded)
//   sum[b, p]      = sum_s out[b, s, p],  sumsq[b, p] = sum_s out[b, s, p]^2
//
// Replaces wcmc_tpu/ops/pathnet_fused.py::_head_fwd_pallas (Pallas body
// _head_fwd_kernel), with its `moments` and `cmajor` options.  The
// concat never exists: W1 is split at row Ce into the part that
// multiplies e and the part that multiplies the context.
//
// What bounds it on the H100: memory.  At the serving shape (8 tiles x
// 8 spp x 128^2 px, Ce = Cc = 128, 256 -> 256 -> 6, both PathNet
// branches merged) it reads the bf16 embedding (268 MB) and the bf16
// context (the UNet's output in the compute dtype, 34 MB) and writes the
// f32 output and moments, ~333 MB, for ~81 GFLOP.
//
// Design: the context is the same for every sample of a pixel, so a
// block computes ctx . W1c + b1 once per pixel tile (f32, in shared
// memory) and starts each sample's layer-1 accumulator from it; that
// drops ~40% of the head's flops, which the TPU kernel recomputed every
// grid step.  As in K4, a block owns a tile of 32 pixels of one image
// and loops over S inside, so the sum and sum of squares accumulate in
// shared memory and are written once (no atomics), and blocks are
// persistent so W1 (128 KB bf16) and W2 are staged once per block.
// Both layers run on the tensor cores through wmma (bf16 in, f32
// accumulate); W2's Cout <= 16 columns are zero-padded to one 16-wide
// fragment.  Loads are not pipelined and there is no TMA or wgmma yet.
#include "common.cuh"

namespace wcmc {

constexpr int kHeadRows = 32;
constexpr int kOutPad = 16;

struct HeadDims {
  int ce, cc, c1, cout;
};

inline size_t head_smem(const HeadDims& d) {
  const int hw = d.c1 > d.cc ? d.c1 : d.cc;  // s_h also holds the bf16 context tile
  return smem_bytes((size_t)d.ce * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)d.cc * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)d.c1 * pitch_bf16(kOutPad), 2) +
         smem_bytes((size_t)kHeadRows * pitch_f32(d.c1), 4) +
         smem_bytes((size_t)kHeadRows * pitch_bf16(d.ce), 2) +
         smem_bytes((size_t)kHeadRows * pitch_bf16(hw), 2) + smem_bytes((size_t)kWarps * 256, 4) +
         2 * smem_bytes((size_t)kHeadRows * kOutPad, 4) + smem_bytes(d.c1, 4) +
         smem_bytes(kOutPad, 4);
}

__global__ void __launch_bounds__(kThreads)
    pathnet_head_kernel(const bf16* __restrict__ e, const bf16* __restrict__ ctx,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2, const float* __restrict__ b2,
                        float* __restrict__ out, float* __restrict__ ssum,
                        float* __restrict__ ssq, int B, int S, int HW, HeadDims d, int cmajor) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hw = d.c1 > d.cc ? d.c1 : d.cc;
  const int p_w1 = pitch_bf16(d.c1), p_w2 = pitch_bf16(kOutPad), p_z = pitch_f32(d.c1);
  const int p_e = pitch_bf16(d.ce), p_h = pitch_bf16(hw);
  SmemCarver carve{smem, 0};
  bf16* s_w1e = carve.take<bf16>((size_t)d.ce * p_w1);
  bf16* s_w1c = carve.take<bf16>((size_t)d.cc * p_w1);
  bf16* s_w2 = carve.take<bf16>((size_t)d.c1 * p_w2);
  float* s_ctxz = carve.take<float>((size_t)kHeadRows * p_z);
  bf16* s_e = carve.take<bf16>((size_t)kHeadRows * p_e);
  bf16* s_h = carve.take<bf16>((size_t)kHeadRows * p_h);
  float* s_stage = carve.take<float>((size_t)kWarps * 256);
  float* s_sum = carve.take<float>((size_t)kHeadRows * kOutPad);
  float* s_sq = carve.take<float>((size_t)kHeadRows * kOutPad);
  float* s_b1 = carve.take<float>(d.c1);
  float* s_b2 = carve.take<float>(kOutPad);

  load_bf16_tile(s_w1e, p_w1, w1, d.ce, d.c1, d.ce, d.c1);
  load_bf16_tile(s_w1c, p_w1, w1 + (size_t)d.ce * d.c1, d.cc, d.c1, d.cc, d.c1);
  load_bf16_tile(s_w2, p_w2, w2, d.c1, d.cout, d.c1, kOutPad);
  for (int i = threadIdx.x; i < d.c1; i += blockDim.x) s_b1[i] = b1[i];
  for (int i = threadIdx.x; i < kOutPad; i += blockDim.x) s_b2[i] = i < d.cout ? b2[i] : 0.0f;
  __syncthreads();

  const int tiles_per_image = (HW + kHeadRows - 1) / kHeadRows;
  const int n_tiles = B * tiles_per_image;
  const bool moments = ssum != nullptr;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_image;
    const int row0 = (t % tiles_per_image) * kHeadRows;
    const int rows = min(kHeadRows, HW - row0);

    // shared context product: ctx . W1c + b1, once per pixel tile
    const bf16* cs = ctx + ((size_t)b * HW + row0) * d.cc;
    for (int i = threadIdx.x; i < kHeadRows * d.cc; i += blockDim.x) {
      const int r = i / d.cc, c = i % d.cc;
      s_h[r * p_h + c] = r < rows ? cs[(size_t)r * d.cc + c] : zero;
    }
    __syncthreads();
    tile_mma(s_h, p_h, s_w1c, p_w1, kHeadRows, d.c1, d.cc, nullptr, 0, s_stage,
             [&](int r, int c, float v) { s_ctxz[r * p_z + c] = v + s_b1[c]; });
    __syncthreads();

    for (int s = 0; s < S; ++s) {
      const size_t slab = ((size_t)b * S + s) * HW + row0;
      const bf16* es = e + slab * d.ce;
      for (int i = threadIdx.x; i < kHeadRows * d.ce; i += blockDim.x) {
        const int r = i / d.ce, c = i % d.ce;
        s_e[r * p_e + c] = r < rows ? es[(size_t)r * d.ce + c] : zero;
      }
      __syncthreads();
      tile_mma(s_e, p_e, s_w1e, p_w1, kHeadRows, d.c1, d.ce, s_ctxz, p_z, s_stage,
               [&](int r, int c, float v) { s_h[r * p_h + c] = __float2bfloat16(fmaxf(v, 0.0f)); });
      __syncthreads();
      tile_mma(s_h, p_h, s_w2, p_w2, kHeadRows, kOutPad, d.c1, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 if (c >= d.cout) return;
                 const float o = fmaxf(v + s_b2[c], 0.0f);
                 if (r < rows) {
                   const size_t idx = cmajor ? (((size_t)b * S + s) * d.cout + c) * HW + row0 + r
                                             : (slab + r) * d.cout + c;
                   out[idx] = o;
                 }
                 if (moments) {
                   float* ps = s_sum + r * kOutPad + c;
                   float* pq = s_sq + r * kOutPad + c;
                   *ps = (s == 0) ? o : *ps + o;
                   *pq = (s == 0) ? o * o : *pq + o * o;
                 }
               });
      __syncthreads();
    }
    if (moments) {
      const size_t base = ((size_t)b * HW + row0) * d.cout;
      for (int i = threadIdx.x; i < rows * d.cout; i += blockDim.x) {
        const int r = i / d.cout, c = i % d.cout;
        ssum[base + i] = s_sum[r * kOutPad + c];
        ssq[base + i] = s_sq[r * kOutPad + c];
      }
    }
    __syncthreads();
  }
}

}  // namespace wcmc

using namespace wcmc;

// e (B, S, HW, ce) bf16; ctx (B, HW, cc) bf16; w1 (ce + cc, c1) bf16 with
// the e rows first; b1 (c1) f32; w2 (c1, cout) bf16; b2 (cout) f32.
// out (B, S, HW, cout) f32, or (B, S, cout, HW) with cmajor; ssum/ssq
// (B, HW, cout) f32, or both null for no moments.  All contiguous; ce,
// cc, c1 multiples of 16; cout <= 16.  n_blocks: persistent blocks to
// launch (the SM count).
extern "C" int wcmc_pathnet_head(const void* e, const void* ctx, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, void* ssum, void* ssq,
                                 int B, int S, int HW, int ce, int cc, int c1, int cout, int cmajor,
                                 int n_blocks, int device, void* stream) {
  if (ce % 16 || cc % 16 || c1 % 16 || ce < 16 || cc < 16 || c1 < 16 || cout < 1 ||
      cout > kOutPad || S < 1 || n_blocks < 1 || ((ssum == nullptr) != (ssq == nullptr)))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const HeadDims d{ce, cc, c1, cout};
  const size_t smem = head_smem(d);
  cudaError_t err = set_smem(pathnet_head_kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kHeadRows - 1) / kHeadRows);
  if (n_tiles == 0) return cudaSuccess;
  const int grid = (int)(n_tiles < n_blocks ? n_tiles : n_blocks);
  pathnet_head_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(ctx), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), static_cast<float*>(ssum), static_cast<float*>(ssq), B, S, HW, d,
      cmajor);
  return cudaGetLastError();
}
