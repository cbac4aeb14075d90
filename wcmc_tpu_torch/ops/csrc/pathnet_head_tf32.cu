// K5-fwd in float32 on the tensor cores: the per-sample head over [e |
// broadcast_S(ctx)] with its sample moments, for f32 activations
// (TrainConfig.compute_dtype = "float32"), every product in split TF32
// (tf32x3.cuh: lo . hi + hi . lo + hi . hi of the operands' tf32 halves, a
// partial a k8 step, about f32's accuracy):
//
//   h1 = a1((e . W1e + ctx . W1c) + b1),  out = a2(h1 . W2 + b2)
//   moments: sum_s out and sum_s out^2 of the unrounded f32 out
//
// out written channel-major (B, S, Cout, HW) or channels-last, f32 or bf16.
// Replaces wcmc_tpu/ops/pathnet_fused.py::_head_fwd_pallas (pallas_call
// :494, body :299) on f32 e, where every product is f32.  (The bf16 forms
// are pathnet_head.cu; the first f32 body, SIMT, is pathnet_f32.cu's
// pathnet_head_f32_kernel, kept as the card tests' reference.)
//
// What bounds it on the H100: operations.  At KPCN's training shape (8
// images x 8 spp x 128^2 px, [128 | 128] -> 256 -> 6) the forward is (128 .
// 256 + 256 . 6) multiply-adds a row and 128 . 256 a pixel, 81 GFLOP: 1.2
// ms at the CUDA cores' 67 TFLOP/s, 0.49 ms in split TF32 (three tf32
// products an f32 one at 495 TFLOP/s); the bytes (e, ctx, out, f32) are
// ~0.2 ms.
//
// Design.  The five forms of K5-bwd's tensor-core body (Ce = Cc, C1, Cout
// padded to kOut): KPCN's (128, 256, 8) and the 64-wide PathNet's (64, 128,
// 8), each also with kOut 16, and Multisteps' update chain (128, 128, 128);
// narrower heads zero-padded by the wrapper; activations, the output's
// layout and dtype and the moments at run time.
// - Persistent blocks of 256 threads (one an SM; two where the 64-wide
//   forms' shared memory lets them) walk tiles of 16 pixels of one image; a
//   tile takes its samples in chunks of 4, so every product has 64 rows,
//   sample-major (row r: sample s0 + r / 16, pixel r % 16).  ctx . W1c is
//   computed once per tile (16 rows) and added to each of its samples' rows.
//   Rows past S or HW are zero-filled and never written.
// - Products on mma.sync m16n8k8 (tf32), the activations row-major in shared
//   memory (A K-major, as wgmma's tf32 A would want too), the weights W1e,
//   W1c and W2 from the pack K5-bwd reads (ops/pathnet_fused.py,
//   pack_head_tf32, made once per parameter value, so a train step's
//   backward finds its forward's), each lane's B fragments by 16-byte
//   read-only loads two k8 steps ahead (mm_rows_ldg; one step ahead the
//   weights' latency from L2 held the body back), h1's in tiles of all 64
//   rows by 32 columns where C1 is 256 (each weight fragment read once a
//   chunk), 32 by 32 where it is 128.  mma.sync and not
//   wgmma: Cout 6 is one n8 tile (wgmma's smallest M is 64 rows of a
//   warpgroup, and its N of 8 would leave the product one warpgroup's), and
//   the head's products are short (K 64-256) beside K5-bwd's.
// - The output product of a narrow head (kOut 8 or 16: N one or two n8
//   tiles, K = C1) is split over the 8 warps by k8 steps: each warp takes
//   C1 / 64 steps for all 64 rows, and the 8 partials are summed in warp
//   order by the thread that owns each output (a warp whose one n8 tile
//   walked all of K would leave its tensor core waiting on each step's
//   three products).  Multisteps' 128 columns take 8 tiles of 32 x 32.
// - The output is staged in shared memory and stored by consecutive threads
//   along its rows (channel-major: a sample's 16 pixels of a channel;
//   channels-last: its pixels' channels).  The moments stay in registers
//   for the tile's samples, each (pixel, channel) by one thread, summed in
//   sample order and written once a tile; the output with them is the
//   output without them, bit for bit.
// - Loads by cp.async: the next chunk's e (16 bytes a copy) into the second
//   of two buffers as a chunk starts, under its products, and with a tile's
//   last chunk the next tile's context (read only by ctx . W1c, done by
//   then).
// Shared memory (head_fwd_tc_smem): e twice, h1, the output (or the narrow
// head's 8 partials) at 64 rows, the context and ctx . W1c at 16: 179200
// bytes for KPCN (195584 with kOut 16), 156672 for Multisteps, 101376 for
// the 64-wide PathNet (two blocks an SM; 117760 with kOut 16, one).
#include "hopper.cuh"
#include "mlp.cuh"
#include "tf32x3.cuh"

namespace wcmc {

constexpr int kHfPix = 16, kHfSamp = 4, kHfRows = kHfPix * kHfSamp;

struct HeadFwdTc {
  const float* e;    // (B, S, HW, kCe)
  const float* ctx;  // (B, HW, kCe)
  const float* wp;   // pack_head_tf32: W1e | W1c | W2 | ... as fragments
  const float* b1;   // (kC1), zero past C1
  const float* b2;   // (kOut), zero past Cout
  void* out;         // (B, S, HW, cout) or (B, S, cout, HW) with cmajor, f32 or bf16
  float* ssum;       // (B, HW, cout) or null
  float* ssq;        // (B, HW, cout) or null
  int B, S, HW, cout, act1, act2, out_bf16, cmajor;
};

__host__ __device__ constexpr int hf_pitch(int c) { return c == 8 ? 8 : c + 8; }

__host__ __device__ constexpr size_t hf_r128(size_t floats) {
  return (4 * floats + 127) / 128 * 128;
}

// the output's staging: 64 rows of the output, or for a narrow head the 8
// warps' partials of them
__host__ __device__ constexpr size_t hf_out_floats(int kout) {
  return kout <= 16 ? (size_t)kWarps * kHfRows * kout : (size_t)kHfRows * hf_pitch(kout);
}

__host__ __device__ constexpr size_t head_fwd_tc_smem(int ce, int c1, int kout) {
  return 2 * hf_r128((size_t)kHfRows * hf_pitch(ce)) + hf_r128((size_t)kHfRows * hf_pitch(c1)) +
         hf_r128(hf_out_floats(kout)) + hf_r128((size_t)kHfPix * hf_pitch(ce)) +
         hf_r128((size_t)kHfPix * hf_pitch(c1));
}

template <int kCe, int kC1, int kOut>
__global__ void __launch_bounds__(kThreads, kCe == 64 ? 2 : 1) pathnet_head_tf32_kernel(HeadFwdTc a) {
  constexpr int pe = hf_pitch(kCe), ph = hf_pitch(kC1), po = hf_pitch(kOut);
  constexpr bool kNarrow = kOut <= 16;
  // packed weights: each K x N matrix 2 K N floats
  constexpr size_t oW1c = 2 * kCe * kC1, oW2 = 2 * oW1c;
  constexpr int NTz = kC1 / 64;                    // ctx . W1c: n8 tiles a warp
  constexpr int MTh = kC1 / 64;                    // h1: m16 tiles a warp
  constexpr int kAhead = 2;                        // weight fragments read ahead, in k8 steps
  constexpr int kStepsW = kC1 / 8 / kWarps;        // the narrow output product's k8 steps a warp
  constexpr int kMom = (kHfPix * kOut + kThreads - 1) / kThreads;
  static_assert(kC1 % 64 == 0 && (kNarrow || kOut % 32 == 0), "form");
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, tid = threadIdx.x;
  SmemCarver carve{smem, 0};
  float* E[2] = {carve.take<float>(kHfRows * pe), carve.take<float>(kHfRows * pe)};
  float* H = carve.take<float>(kHfRows * ph);
  float* O = carve.take<float>(hf_out_floats(kOut));  // the output, or the warps' partials
  float* CX = carve.take<float>(kHfPix * pe);
  float* ZC = carve.take<float>(kHfPix * ph);         // ctx . W1c
  const float* W = a.wp;
  const bool moments = a.ssum != nullptr;

  const int per_image = (a.HW + kHfPix - 1) / kHfPix, tiles = a.B * per_image;
  const int nch = (a.S + kHfSamp - 1) / kHfSamp;

  auto load_e = [&](float* Ed, int t, int s0) {
    const int b = t / per_image, p0 = t % per_image * kHfPix;
    constexpr int kQ = kCe / 4;
    for (int i = tid; i < kHfRows * kQ; i += kThreads) {
      const int r = i / kQ, q = i % kQ, s = s0 + r / kHfPix, p = p0 + r % kHfPix;
      const bool ok = s < a.S && p < a.HW;
      const float* src = ok ? a.e + (((size_t)b * a.S + s) * a.HW + p) * kCe + 4 * q : a.e;
      cp_async16_zfill(smem_addr(Ed + r * pe + 4 * q), src, ok ? 16 : 0);
    }
  };
  auto load_ctx = [&](int t) {
    const int b = t / per_image, p0 = t % per_image * kHfPix;
    constexpr int kQ = kCe / 4;
    for (int i = tid; i < kHfPix * kQ; i += kThreads) {
      const int p = i / kQ, q = i % kQ;
      const bool ok = p0 + p < a.HW;
      const float* src = ok ? a.ctx + ((size_t)b * a.HW + p0 + p) * kCe + 4 * q : a.ctx;
      cp_async16_zfill(smem_addr(CX + p * pe + 4 * q), src, ok ? 16 : 0);
    }
  };
  // the output value of row r, channel c, once the output product is done
  auto out_at = [&](int r, int c) {
    if constexpr (kNarrow) {
      float v = O[r * kOut + c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += O[(w * kHfRows + r) * kOut + c];
      return mlp_act(a.act2, v + a.b2[c]);
    } else {
      return O[r * po + c];
    }
  };

  int q = 0;  // chunks walked: E[q & 1] holds the current one
  if ((int)blockIdx.x < tiles) {
    load_e(E[0], blockIdx.x, 0);
    load_ctx(blockIdx.x);
    cp_async_commit();
  }
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / per_image, p0 = t % per_image * kHfPix;
    cp_async_wait_all();
    __syncthreads();  // the tile's context landed; the last tile's readers of ZC and O are done
    {  // ctx . W1c once per tile: warp w's NTz n8 tiles of C1
      float acc[1][NTz][4];
      zero_frags(acc);
      mm_rows_ldg<1, NTz, kAhead>(acc, CX, pe, kCe / 8, W + oW1c, kCe / 8, warp * NTz);
      each_frag(acc, 0, warp * NTz * 8, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(ZC + r * ph + c) = make_float2(v0, v1);
      });
    }
    float msum[kMom], msq[kMom];
#pragma unroll
    for (int k = 0; k < kMom; ++k) msum[k] = msq[k] = 0.0f;
    for (int ch = 0; ch < nch; ++ch, ++q) {
      const int s0 = ch * kHfSamp;
      const float* Ec = E[q & 1];
      cp_async_wait_all();
      __syncthreads();  // e landed; ctx . W1c written; the last chunk's readers done
      {  // the next chunk's e (and a next tile's context), under this chunk's products
        const int tn = ch + 1 < nch ? t : t + gridDim.x, sn = ch + 1 < nch ? s0 + kHfSamp : 0;
        if (tn < tiles) load_e(E[(q + 1) & 1], tn, sn);
        if (tn != t && tn < tiles) load_ctx(tn);
        cp_async_commit();
      }
      // h1 = a1((e . W1e + ctx . W1c) + b1), (16 MTh) x 32 tiles, one a warp
      {
        const int m0 = warp % (4 / MTh) * 16 * MTh, jn0 = warp / (4 / MTh) * 4;
        float acc[MTh][4][4];
        zero_frags(acc);
        mm_rows_ldg<MTh, 4, kAhead>(acc, Ec + m0 * pe, pe, kCe / 8, W, kCe / 8, jn0);
        each_frag(acc, m0, jn0 * 8, [&](int r, int c, float v0, float v1) {
          const float* zc = ZC + r % kHfPix * ph + c;
          *reinterpret_cast<float2*>(H + r * ph + c) =
              make_float2(mlp_act(a.act1, (v0 + zc[0]) + a.b1[c]),
                          mlp_act(a.act1, (v1 + zc[1]) + a.b1[c + 1]));
        });
      }
      __syncthreads();
      if constexpr (kNarrow) {
        // the warp's k8 steps of h1 . W2 for all 64 rows, into its partial
        float acc[4][kOut / 8][4];
        zero_frags(acc);
        const float* wo = W + oW2 + (size_t)warp * kStepsW * 128;  // the warp's first step
        mm_rows_ldg<4, kOut / 8, kAhead>(acc, H + warp * kStepsW * 8, ph, kStepsW, wo,
                                         kC1 / 8, 0);
        each_frag(acc, 0, 0, [&](int r, int c, float v0, float v1) {
          *reinterpret_cast<float2*>(O + (warp * kHfRows + r) * kOut + c) = make_float2(v0, v1);
        });
      } else {
        // out = a2(h1 . W2 + b2), 32 x 32 tiles
        for (int tt = warp; tt < 2 * kOut / 32; tt += kWarps) {
          const int m0 = tt % 2 * 32, jn0 = tt / 2 * 4;
          float acc[2][4][4];
          zero_frags(acc);
          mm_rows_ldg<2, 4, kAhead>(acc, H + m0 * ph, ph, kC1 / 8, W + oW2, kC1 / 8, jn0);
          each_frag(acc, m0, jn0 * 8, [&](int r, int c, float v0, float v1) {
            *reinterpret_cast<float2*>(O + r * po + c) =
                make_float2(mlp_act(a.act2, v0 + a.b2[c]), mlp_act(a.act2, v1 + a.b2[c + 1]));
          });
        }
      }
      __syncthreads();
      // the output: consecutive threads along its rows in either layout
      for (int i = tid; i < kHfRows * kOut; i += kThreads) {
        int r, c;
        if (a.cmajor) {  // (sample, channel, pixel)
          const int j = i / (kOut * kHfPix), rem = i % (kOut * kHfPix);
          c = rem / kHfPix, r = j * kHfPix + rem % kHfPix;
        } else {
          r = i / kOut, c = i % kOut;
        }
        const int s = s0 + r / kHfPix, p = p0 + r % kHfPix;
        if (s >= a.S || p >= a.HW || c >= a.cout) continue;
        const float v = out_at(r, c);
        const size_t at = a.cmajor ? (((size_t)b * a.S + s) * a.cout + c) * a.HW + p
                                   : (((size_t)b * a.S + s) * a.HW + p) * a.cout + c;
        if (a.out_bf16) {
          store_f32(static_cast<bf16*>(a.out) + at, v);
        } else {
          static_cast<float*>(a.out)[at] = v;
        }
      }
      if (moments) {  // in sample order, each (pixel, channel) by one thread
#pragma unroll
        for (int k = 0; k < kMom; ++k) {
          const int i = tid + k * kThreads;
          if (i < kHfPix * kOut) {
            const int p = i / kOut, c = i % kOut;
            for (int j = 0; j < kHfSamp && s0 + j < a.S; ++j) {
              const float v = out_at(j * kHfPix + p, c);
              msum[k] += v;
              msq[k] += v * v;
            }
          }
        }
      }
    }
    if (moments) {
#pragma unroll
      for (int k = 0; k < kMom; ++k) {
        const int i = tid + k * kThreads;
        if (i < kHfPix * kOut) {
          const int p = i / kOut, c = i % kOut;
          if (p0 + p < a.HW && c < a.cout) {
            const size_t at = ((size_t)b * a.HW + p0 + p) * a.cout + c;
            a.ssum[at] = msum[k];
            a.ssq[at] = msq[k];
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

template <int kCe, int kC1, int kOut>
static int launch_head_fwd_tc(const HeadFwdTc& a, int n_blocks, int device, cudaStream_t stream) {
  auto kernel = pathnet_head_tf32_kernel<kCe, kC1, kOut>;
  const size_t smem = head_fwd_tc_smem(kCe, kC1, kOut);
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of K5-fwd's tensor-core f32 body for the form
// (ce = cc, c1, kout): what ops/pathnet_fused.py's head_fwd_tc_plan totals.
extern "C" long long wcmc_pathnet_head_tf32_smem(int ce, int c1, int kout) {
  return (long long)head_fwd_tc_smem(ce, c1, kout);
}

// K5-fwd in f32 on the tensor cores: e (B, S, HW, ce) and ctx (B, HW, ce)
// f32, 16-byte aligned; wp the weights packed by ops/pathnet_fused.py's
// pack_head_tf32 for (ce, c1, kout), b1 (c1) and b2 (kout) f32 zero-padded;
// out (B, S, HW, cout), or (B, S, cout, HW) with cmajor, f32 or bf16
// (out_bf16); ssum and ssq (B, HW, cout) f32, both or neither null (the
// moments).  (ce, c1, kout) is (128, 256, 8), (128, 256, 16), (64, 128, 8),
// (64, 128, 16) or (128, 128, 128), cout <= kout.
extern "C" int wcmc_pathnet_head_tf32(const void* e, const void* ctx, const void* wp,
                                      const void* b1, const void* b2, void* out, void* ssum,
                                      void* ssq, int B, int S, int HW, int ce, int c1, int kout,
                                      int cout, int act1, int act2, int out_bf16, int cmajor,
                                      int n_blocks, int device, void* stream) {
  if (B < 1 || S < 1 || HW < 1 || n_blocks < 1 || cout < 1 || cout > kout || act1 < 0 ||
      act1 > 2 || act2 < 0 || act2 > 2 || (ssum == nullptr) != (ssq == nullptr) ||
      !aligned16(e) || !aligned16(ctx) || !aligned16(wp))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  HeadFwdTc a{};
  a.e = static_cast<const float*>(e);
  a.ctx = static_cast<const float*>(ctx);
  a.wp = static_cast<const float*>(wp);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.out = out;
  a.ssum = static_cast<float*>(ssum);
  a.ssq = static_cast<float*>(ssq);
  a.B = B, a.S = S, a.HW = HW, a.cout = cout, a.act1 = act1, a.act2 = act2;
  a.out_bf16 = out_bf16, a.cmajor = cmajor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ce == 128 && c1 == 256 && kout == 8) return launch_head_fwd_tc<128, 256, 8>(a, n_blocks, device, s);
  if (ce == 128 && c1 == 256 && kout == 16) return launch_head_fwd_tc<128, 256, 16>(a, n_blocks, device, s);
  if (ce == 64 && c1 == 128 && kout == 8) return launch_head_fwd_tc<64, 128, 8>(a, n_blocks, device, s);
  if (ce == 64 && c1 == 128 && kout == 16) return launch_head_fwd_tc<64, 128, 16>(a, n_blocks, device, s);
  if (ce == 128 && c1 == 128 && kout == 128) return launch_head_fwd_tc<128, 128, 128>(a, n_blocks, device, s);
  return cudaErrorInvalidValue;
}
