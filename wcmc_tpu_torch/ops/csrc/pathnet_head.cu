// K5-fwd: the per-sample head over [e | broadcast_S(ctx)] with the f32
// sample moments.
//
//   h1             = bf16(act1(e[b, s, p] . W1e + ctx[b, p] . W1c + b1))
//   o              = act2(h1 . W2 + b2)                       (f32)
//   out[b, s, p]   = o rounded to the output type (f32 or bf16)
//   sum[b, p]      = sum_s o,  sumsq[b, p] = sum_s o^2        (unrounded o)
//
// with per-layer activations (relu, leaky relu of slope 0.01, or linear;
// mlp_act of mlp.cuh): PathNet runs relu-relu with Cout <= 16 and an f32
// output, the SBMC Multisteps update chain leaky-leaky with Cout 128 and
// a bf16 output.  Those two forms are template instantiations with the
// activations and W2's width fixed at compile time; any other form runs
// a generic one that reads them at run time.  Replaces wcmc_tpu/ops/pathnet_fused.py::
// _head_fwd_pallas (Pallas body _head_fwd_kernel), with its `moments`,
// `out_dtype` and `cmajor` options; as there, the moments are summed
// from the unrounded f32 value.  The concat never exists: W1 is split at
// row Ce into the part that multiplies e and the part that multiplies
// the context.
//
// What bounds it on the H100: memory.  At the KPCN serving shape (8
// tiles x 8 spp x 128^2 px, Ce = Cc = 128, 256 -> 256 -> 6, both PathNet
// branches merged) it reads the bf16 embedding (268 MB) and the bf16
// context (the UNet's output in the compute dtype, 34 MB) and writes the
// f32 output and moments, ~333 MB, for ~81 GFLOP.  At the SBMC shape
// (256 -> 128 -> 128, bf16 output) it moves ~700 MB with the moments
// for ~86 GFLOP.
//
// Design: the context is the same for every sample of a pixel, so a
// block computes ctx . W1c + b1 once per pixel tile (f32, in shared
// memory) and starts each sample's layer-1 accumulator from it; that
// drops ~40% of the head's flops, which the TPU kernel recomputed every
// grid step.  As in K4, a block owns a tile of 32 pixels of one image
// and loops over S inside, so the sum and sum of squares accumulate in
// shared memory and are written once (no atomics), and blocks are
// persistent so W1 (up to 128 KB bf16) and W2 are staged once per
// block.  Both layers run on the tensor cores through wmma (bf16 in, f32
// accumulate); W2's Cout columns are zero-padded to a multiple of 16
// (one fragment for Cout <= 16).  At the SBMC widths the block takes
// ~177 KB of shared memory; the launch is refused above the card's 227
// KB.  Loads are not pipelined and there is no TMA or wgmma yet.
#include "mlp.cuh"

namespace wcmc {

constexpr int kHeadRows = 32;
constexpr int kHeadMaxOut = 128;

struct HeadDims {
  int ce, cc, c1, cout;
  int coutp;       // cout rounded up to 16: W2's staged columns
  int act1, act2;  // activation codes of mlp_act
};

inline size_t head_smem(const HeadDims& d) {
  const int hw = d.c1 > d.cc ? d.c1 : d.cc;  // s_h also holds the bf16 context tile
  return smem_bytes((size_t)d.ce * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)d.cc * pitch_bf16(d.c1), 2) +
         smem_bytes((size_t)d.c1 * pitch_bf16(d.coutp), 2) +
         smem_bytes((size_t)kHeadRows * pitch_f32(d.c1), 4) +
         smem_bytes((size_t)kHeadRows * pitch_bf16(d.ce), 2) +
         smem_bytes((size_t)kHeadRows * pitch_bf16(hw), 2) + smem_bytes((size_t)kWarps * 256, 4) +
         2 * smem_bytes((size_t)kHeadRows * d.coutp, 4) + smem_bytes(d.c1, 4) +
         smem_bytes(d.coutp, 4);
}

// kA1, kA2: the layers' activation codes and kCoutP: W2's staged width,
// fixed at compile time for the two forms the models run; -1 and 0 read
// them from d at run time.
template <typename TOut, int kA1, int kA2, int kCoutP>
__global__ void __launch_bounds__(kThreads)
    pathnet_head_kernel(const bf16* __restrict__ e, const bf16* __restrict__ ctx,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2, const float* __restrict__ b2,
                        TOut* __restrict__ out, float* __restrict__ ssum,
                        float* __restrict__ ssq, int B, int S, int HW, HeadDims d, int cmajor) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hw = d.c1 > d.cc ? d.c1 : d.cc;
  const int coutp = kCoutP > 0 ? kCoutP : d.coutp;
  const int p_w1 = pitch_bf16(d.c1), p_w2 = pitch_bf16(coutp), p_z = pitch_f32(d.c1);
  const int p_e = pitch_bf16(d.ce), p_h = pitch_bf16(hw);
  SmemCarver carve{smem, 0};
  bf16* s_w1e = carve.take<bf16>((size_t)d.ce * p_w1);
  bf16* s_w1c = carve.take<bf16>((size_t)d.cc * p_w1);
  bf16* s_w2 = carve.take<bf16>((size_t)d.c1 * p_w2);
  float* s_ctxz = carve.take<float>((size_t)kHeadRows * p_z);
  bf16* s_e = carve.take<bf16>((size_t)kHeadRows * p_e);
  bf16* s_h = carve.take<bf16>((size_t)kHeadRows * p_h);
  float* s_stage = carve.take<float>((size_t)kWarps * 256);
  float* s_sum = carve.take<float>((size_t)kHeadRows * coutp);
  float* s_sq = carve.take<float>((size_t)kHeadRows * coutp);
  float* s_b1 = carve.take<float>(d.c1);
  float* s_b2 = carve.take<float>(coutp);

  load_bf16_tile(s_w1e, p_w1, w1, d.ce, d.c1, d.ce, d.c1);
  load_bf16_tile(s_w1c, p_w1, w1 + (size_t)d.ce * d.c1, d.cc, d.c1, d.cc, d.c1);
  load_bf16_tile(s_w2, p_w2, w2, d.c1, d.cout, d.c1, coutp);
  for (int i = threadIdx.x; i < d.c1; i += blockDim.x) s_b1[i] = b1[i];
  for (int i = threadIdx.x; i < coutp; i += blockDim.x) s_b2[i] = i < d.cout ? b2[i] : 0.0f;
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
               [&](int r, int c, float v) {
                 s_h[r * p_h + c] = __float2bfloat16(fixed_act<kA1>(d.act1, v));
               });
      __syncthreads();
      tile_mma(s_h, p_h, s_w2, p_w2, kHeadRows, coutp, d.c1, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 if (c >= d.cout) return;
                 const float o = fixed_act<kA2>(d.act2, v + s_b2[c]);
                 if (r < rows) {
                   const size_t idx = cmajor ? (((size_t)b * S + s) * d.cout + c) * HW + row0 + r
                                             : (slab + r) * d.cout + c;
                   store_f32(out + idx, o);
                 }
                 if (moments) {
                   float* ps = s_sum + r * coutp + c;
                   float* pq = s_sq + r * coutp + c;
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
        ssum[base + i] = s_sum[r * coutp + c];
        ssq[base + i] = s_sq[r * coutp + c];
      }
    }
    __syncthreads();
  }
}

}  // namespace wcmc

using namespace wcmc;

template <typename TOut, int kA1, int kA2, int kCoutP>
static cudaError_t launch_head(const void* e, const void* ctx, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out, void* ssum, void* ssq,
                               int B, int S, int HW, const HeadDims& d, int cmajor, int n_blocks,
                               int device, cudaStream_t stream) {
  const size_t smem = head_smem(d);
  cudaError_t err = set_smem(pathnet_head_kernel<TOut, kA1, kA2, kCoutP>, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kHeadRows - 1) / kHeadRows);
  if (n_tiles == 0) return cudaSuccess;
  const int grid = (int)(n_tiles < n_blocks ? n_tiles : n_blocks);
  pathnet_head_kernel<TOut, kA1, kA2, kCoutP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(ctx), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<TOut*>(out), static_cast<float*>(ssum), static_cast<float*>(ssq), B, S, HW, d,
      cmajor);
  return cudaGetLastError();
}

// e (B, S, HW, ce) bf16; ctx (B, HW, cc) bf16; w1 (ce + cc, c1) bf16 with
// the e rows first; b1 (c1) f32; w2 (c1, cout) bf16; b2 (cout) f32.
// out (B, S, HW, cout), or (B, S, cout, HW) with cmajor, f32 or bf16
// (out_bf16 != 0); ssum/ssq (B, HW, cout) f32, or both null for no
// moments.  All contiguous; ce, cc, c1 multiples of 16; cout <= 16 or a
// multiple of 16 up to 128; act1, act2 the layers' activation codes (0
// linear, 1 relu, 2 leaky relu).  n_blocks: persistent blocks to launch
// (the SM count).
extern "C" int wcmc_pathnet_head(const void* e, const void* ctx, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, void* ssum, void* ssq,
                                 int B, int S, int HW, int ce, int cc, int c1, int cout, int act1,
                                 int act2, int out_bf16, int cmajor, int n_blocks, int device,
                                 void* stream) {
  if (ce % 16 || cc % 16 || c1 % 16 || ce < 16 || cc < 16 || c1 < 16 || cout < 1 ||
      cout > kHeadMaxOut || (cout > 16 && cout % 16) || S < 1 || n_blocks < 1 ||
      act1 < 0 || act1 > 2 || act2 < 0 || act2 > 2 || ((ssum == nullptr) != (ssq == nullptr)))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const HeadDims d{ce, cc, c1, cout, round_up(cout, 16), act1, act2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // PathNet: relu, relu, Cout <= 16, f32 output
  if (!out_bf16 && act1 == 1 && act2 == 1 && d.coutp == 16)
    return launch_head<float, 1, 1, 16>(e, ctx, w1, b1, w2, b2, out, ssum, ssq, B, S, HW, d,
                                        cmajor, n_blocks, device, s);
  // Multisteps' update chain: leaky relu x 2, Cout 128, bf16 output
  if (out_bf16 && act1 == 2 && act2 == 2 && d.coutp == 128)
    return launch_head<bf16, 2, 2, 128>(e, ctx, w1, b1, w2, b2, out, ssum, ssq, B, S, HW, d,
                                        cmajor, n_blocks, device, s);
  if (out_bf16)
    return launch_head<bf16, -1, -1, 0>(e, ctx, w1, b1, w2, b2, out, ssum, ssq, B, S, HW, d,
                                        cmajor, n_blocks, device, s);
  return launch_head<float, -1, -1, 0>(e, ctx, w1, b1, w2, b2, out, ssum, ssq, B, S, HW, d,
                                       cmajor, n_blocks, device, s);
}
