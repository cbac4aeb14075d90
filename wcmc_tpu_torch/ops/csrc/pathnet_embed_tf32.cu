// K4-fwd in float32 on the tensor cores: the PathNet embedding (three layers
// over per-sample rows) with its sample mean, for f32 activations
// (TrainConfig.compute_dtype = "float32"), every product in split TF32
// (tf32x3.cuh: lo . hi + hi . lo + hi . hi of the operands' tf32 halves, a
// partial a k8 step, about f32's accuracy):
//
//   h0 = x, h_{i+1} = a_i(h_i . W_i + b_i),  e = h3,  mean = (sum_s e) / S
//
// the mean summed in sample order from the unrounded f32 e and divided once,
// as the SIMT body sums it.  Replaces wcmc_tpu/ops/pathnet_fused.py::
// _embed_fwd_pallas (pallas_call :168, body :66) on f32 x, where every
// product is f32.  (The bf16 forms are pathnet_embed.cu; the first f32 body,
// SIMT, is pathnet_f32.cu's pathnet_embed_f32_kernel, kept as the card
// tests' reference and for the chains no form below holds.)
//
// What bounds it on the H100: operations.  At KPCN's training shape (8
// images x 8 spp x 128^2 px, 36 -> 128^3) the forward is 78 GFLOP: 1.17 ms
// at the CUDA cores' 67 TFLOP/s, 0.475 ms in split TF32 (three tf32
// products an f32 one at 495 TFLOP/s); the bytes (x, e and the mean, f32)
// are 0.23 ms.
//
// Design.  K4-bwd's three forms (pathnet_embed_bwd_tf32.cu), templated by
// (C0 padded to kC0, the hidden width kC): (40, 128) KPCN's dual PathNet,
// (40, 64) the 64-wide PathNet of LBMC and SBMC, (96, 128) Multisteps (95
// -> 128^3, leaky x 3); narrower chains zero-padded (a padded channel's
// weights and bias are zero, and every activation maps 0 to 0);
// activations and the output's width C3 at run time.
// - Persistent blocks of 256 threads walk tiles of 16 pixels of one image
//   (two blocks an SM for kC0 40, at 128 registers, faster than one: 2.01
//   against 2.35 ms at KPCN's shape; one for Multisteps' carve); a tile takes
//   its samples in chunks of 4, so every product has 64 rows, sample-major
//   (row r: sample s0 + r / 16, pixel r % 16).  Rows past S or HW are
//   zero-filled, computed, and neither stored nor summed.
// - Products on mma.sync m16n8k8 (tf32).  Each warp takes all 64 rows and
//   kC / 8 columns of every layer (4 m16 tiles by 1 or 2 n8 tiles), so each
//   lane holds the same two pixels' columns for all 4 samples of a chunk:
//   the mean's running sum stays in registers for the tile, summed in
//   sample order, with no barrier and no shared buffer.  The cost is that
//   every warp splits the whole A operand (x, h1, h2) into its tf32 halves,
//   8 times over a block, as K4-bwd's trial of 64-row tiles did for no
//   gain.  Here it buys the mean in registers and costs about a tenth of
//   the time (chip_parts.py k4f at KPCN's training shape on an H100: 1.83
//   ms without the split against 2.01 whole); the products set the rest,
//   about the same time a k8 step in every layer.
// - The activations row-major in shared memory at a pitch of 8 floats past
//   a multiple of 32 (the fragment loads of 8 rows fall on distinct banks);
//   the weights W0, W1 and W2 from the pack K4-bwd reads (ops/
//   pathnet_fused.py, pack_embed_tf32, made once per parameter value, so a
//   train step's backward finds its forward's), each lane's B fragments by
//   16-byte read-only loads two k8 steps ahead (mm_rows_ldg).
// - e is stored from the accumulators, 8 bytes a lane (a row's 8 columns
//   of an n8 tile by a quad of lanes: whole 32-byte sectors); the mean once
//   a tile.
// - Loads by cp.async: the next chunk's x (16 bytes a copy where C0 is a
//   multiple of 4 and x 16-byte aligned, else 4; the padding columns zero)
//   into the second of two x buffers as a chunk starts, under its
//   products.  Three block barriers a chunk.
// Shared memory (embed_fwd_tc_smem): x twice, h1, h2 at 64 rows: 90112
// bytes for (40, 128), 57344 for (40, 64), 122880 for (96, 128).
#include "hopper.cuh"
#include "mlp.cuh"
#include "tf32x3.cuh"

namespace wcmc {

constexpr int kEfPix = 16, kEfSamp = 4, kEfRows = kEfPix * kEfSamp;

struct EmbedFwdTc {
  const float* x;     // (B, S, HW, c0)
  const float* wp;    // pack_embed_tf32: W0 | W1 | W2 | ... as fragments
  const float* bias;  // b0 | b1 | b2, kC each, zero past the widths
  float* e;           // (B, S, HW, c3)
  float* mean;        // (B, HW, c3)
  int B, S, HW, c0, c3, xvec, act0, act1, act2;
};

// a row pitch of 8 floats past a multiple of 32 (as K4-bwd's et_pitch)
__host__ __device__ constexpr int ef_pitch(int c) { return c + (40 - c % 32) % 32; }

__host__ __device__ constexpr size_t ef_r128(size_t floats) {
  return (4 * floats + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t embed_fwd_tc_smem(int c0p, int c) {
  return 2 * ef_r128((size_t)kEfRows * ef_pitch(c0p)) + 2 * ef_r128((size_t)kEfRows * ef_pitch(c));
}

template <int kC0, int kC>
__global__ void __launch_bounds__(kThreads, kC0 == 40 ? 2 : 1)
    pathnet_embed_tf32_kernel(EmbedFwdTc a) {
  constexpr int px = ef_pitch(kC0), ph = ef_pitch(kC);
  // packed weights: each K x N matrix 2 K N floats
  constexpr size_t oW1 = 2 * kC0 * kC, oW2 = oW1 + 2 * kC * kC;
  constexpr int NT = kC / 64;   // n8 tiles a warp: kC / 8 columns over 8 warps
  constexpr int kAhead = 2;     // weight fragments read ahead, in k8 steps
  static_assert(kC0 % 8 == 0 && kC % 64 == 0, "form");
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int g = lane / 4, t4 = lane % 4;
  SmemCarver carve{smem, 0};
  float* X[2] = {carve.take<float>(kEfRows * px), carve.take<float>(kEfRows * px)};
  float* H1 = carve.take<float>(kEfRows * ph);
  float* H2 = carve.take<float>(kEfRows * ph);
  const float* W = a.wp;
  const float* b0 = a.bias;
  const float* b1 = a.bias + kC;
  const float* b2 = a.bias + 2 * kC;
  const int jn0 = warp * NT;  // the warp's first n8 tile

  const int per_image = (a.HW + kEfPix - 1) / kEfPix, tiles = a.B * per_image;
  const int nch = (a.S + kEfSamp - 1) / kEfSamp;

  // chunk (tile t, samples from s0): x into Xd, zero past c0 and on rows past S or HW
  auto load_x = [&](float* Xd, int t, int s0) {
    const int b = t / per_image, p0 = t % per_image * kEfPix;
    if (a.xvec) {
      constexpr int kQ = kC0 / 4;
      for (int i = tid; i < kEfRows * kQ; i += kThreads) {
        const int r = i / kQ, q = i % kQ, s = s0 + r / kEfPix, p = p0 + r % kEfPix;
        const bool ok = s < a.S && p < a.HW && 4 * q < a.c0;
        const float* src = ok ? a.x + (((size_t)b * a.S + s) * a.HW + p) * a.c0 + 4 * q : a.wp;
        cp_async16_zfill(smem_addr(Xd + r * px + 4 * q), src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kEfRows * kC0; i += kThreads) {
        const int r = i / kC0, c = i % kC0, s = s0 + r / kEfPix, p = p0 + r % kEfPix;
        const bool ok = s < a.S && p < a.HW && c < a.c0;
        const float* src = ok ? a.x + (((size_t)b * a.S + s) * a.HW + p) * a.c0 + c : a.x;
        cp_async4_zfill(smem_addr(Xd + r * px + c), src, ok ? 4 : 0);
      }
    }
  };
  // h_out = act(A . Wm + bias) for the warp's columns of all 64 rows, A at
  // pitch pa with k8s k8 steps
  auto hidden = [&](const float* A, int pa, int k8s, const float* Wm, const float* bias, int act,
                    float* Hd) {
    float acc[4][NT][4];
    zero_frags(acc);
    mm_rows_ldg<4, NT, kAhead>(acc, A, pa, k8s, Wm, k8s, jn0);
    each_frag(acc, 0, 8 * jn0, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(Hd + r * ph + c) =
          make_float2(mlp_act(act, v0 + bias[c]), mlp_act(act, v1 + bias[c + 1]));
    });
  };

  int q = 0;  // chunks walked: X[q & 1] holds the current one
  if ((int)blockIdx.x < tiles) {
    load_x(X[0], blockIdx.x, 0);
    cp_async_commit();
  }
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / per_image, p0 = t % per_image * kEfPix;
    // the lane's running sums over the samples: pixel g + 8 h, columns
    // 8 (jn0 + nt) + 2 t4 + i
    float msum[2][NT][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) msum[h][nt][0] = msum[h][nt][1] = 0.0f;
    for (int ch = 0; ch < nch; ++ch, ++q) {
      const int s0 = ch * kEfSamp;
      const float* Xc = X[q & 1];
      cp_async_wait_all();
      __syncthreads();  // x landed; the last chunk's readers of X, H1 and H2 done
      {  // the next chunk's x: this tile's next samples, or the next tile's first
        const int tn = ch + 1 < nch ? t : t + gridDim.x, sn = ch + 1 < nch ? s0 + kEfSamp : 0;
        if (tn < tiles) load_x(X[(q + 1) & 1], tn, sn);
        cp_async_commit();
      }
      hidden(Xc, px, kC0 / 8, W, b0, a.act0, H1);  // h1 = a0(x . W0 + b0)
      __syncthreads();
      hidden(H1, ph, kC / 8, W + oW1, b1, a.act1, H2);  // h2 = a1(h1 . W1 + b1)
      __syncthreads();
      // e = a2(h2 . W2 + b2): row 16 mt + g + 8 h is sample s0 + mt, pixel g + 8 h
      float acc[4][NT][4];
      zero_frags(acc);
      mm_rows_ldg<4, NT, kAhead>(acc, H2, ph, kC / 8, W + oW2, kC / 8, jn0);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int s = s0 + mt;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + g + 8 * h;
          if (s >= a.S || p >= a.HW) continue;
          float* er = a.e + (((size_t)b * a.S + s) * a.HW + p) * a.c3;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int c = 8 * (jn0 + nt) + 2 * t4;
            const float v0 = mlp_act(a.act2, acc[mt][nt][2 * h] + b2[c]);
            const float v1 = mlp_act(a.act2, acc[mt][nt][2 * h + 1] + b2[c + 1]);
            msum[h][nt][0] += v0;
            msum[h][nt][1] += v1;
            if (a.c3 == kC) {
              *reinterpret_cast<float2*>(er + c) = make_float2(v0, v1);
            } else {
              if (c < a.c3) er[c] = v0;
              if (c + 1 < a.c3) er[c + 1] = v1;
            }
          }
        }
      }
    }
    // the tile's mean, divided once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + g + 8 * h;
      if (p >= a.HW) continue;
      float* mr = a.mean + ((size_t)b * a.HW + p) * a.c3;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = 8 * (jn0 + nt) + 2 * t4;
        const float m0 = msum[h][nt][0] / (float)a.S, m1 = msum[h][nt][1] / (float)a.S;
        if (a.c3 == kC) {
          *reinterpret_cast<float2*>(mr + c) = make_float2(m0, m1);
        } else {
          if (c < a.c3) mr[c] = m0;
          if (c + 1 < a.c3) mr[c + 1] = m1;
        }
      }
    }
  }
  cp_async_wait_all();
}

template <int kC0, int kC>
static int launch_embed_fwd_tc(const EmbedFwdTc& a, int n_blocks, int device, cudaStream_t stream) {
  auto kernel = pathnet_embed_tf32_kernel<kC0, kC>;
  const size_t smem = embed_fwd_tc_smem(kC0, kC);
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of K4-fwd's tensor-core f32 body for the form
// (c0p, c): what ops/pathnet_fused.py's embed_fwd_tc_plan totals.
extern "C" long long wcmc_pathnet_embed_tf32_smem(int c0p, int c) {
  return (long long)embed_fwd_tc_smem(c0p, c);
}

// K4-fwd in f32 on the tensor cores: x (B, S, HW, c0) f32, c0 <= c0p; wp
// the weights packed by ops/pathnet_fused.py's pack_embed_tf32 for (c0p,
// c), 16-byte aligned, bias b0 | b1 | b2 (c each) f32 zero-padded; e (B, S,
// HW, c3) and mean (B, HW, c3) f32, c3 <= c, 8-byte aligned.  (c0p, c) is
// (40, 128), (40, 64) or (96, 128); act_i 0 linear, 1 relu, 2 leaky relu.
extern "C" int wcmc_pathnet_embed_tf32(const void* x, const void* wp, const void* bias, void* e,
                                       void* mean, int B, int S, int HW, int c0, int c3, int c0p,
                                       int c, int act0, int act1, int act2, int n_blocks,
                                       int device, void* stream) {
  if (B < 1 || S < 1 || HW < 1 || n_blocks < 1 || c0 < 1 || c0 > c0p || c3 < 1 || c3 > c ||
      act0 < 0 || act0 > 2 || act1 < 0 || act1 > 2 || act2 < 0 || act2 > 2 || !aligned16(wp))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  EmbedFwdTc a{};
  a.x = static_cast<const float*>(x);
  a.wp = static_cast<const float*>(wp);
  a.bias = static_cast<const float*>(bias);
  a.e = static_cast<float*>(e);
  a.mean = static_cast<float*>(mean);
  a.B = B, a.S = S, a.HW = HW, a.c0 = c0, a.c3 = c3;
  a.xvec = c0 % 4 == 0 && aligned16(x);
  a.act0 = act0, a.act1 = act1, a.act2 = act2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c0p == 40 && c == 128) return launch_embed_fwd_tc<40, 128>(a, n_blocks, device, s);
  if (c0p == 40 && c == 64) return launch_embed_fwd_tc<40, 64>(a, n_blocks, device, s);
  if (c0p == 96 && c == 128) return launch_embed_fwd_tc<96, 128>(a, n_blocks, device, s);
  return cudaErrorInvalidValue;
}
