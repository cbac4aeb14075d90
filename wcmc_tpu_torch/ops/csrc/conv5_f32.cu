// K6 in float32: a VALID K x K convolution with its bias and activation
// fused into the store, channels-last, for f32 input (the opt-in fused KPCN
// inference at TrainConfig.compute_dtype = "float32"):
//
//   y[b, i, j, n] = act(sum_{dy, dx, c} x[b, i + dy, j + dx, c] . w[dy, dx, c, n] + bias[n])
//
// every product and sum in f32, stored f32, as wcmc_tpu's _conv_xla and its
// Pallas kernel compute it on f32 input.  Replaces
// wcmc_tpu/ops/conv5.py::_conv_fwd_pallas on f32 input.  (The bf16 form is
// conv5.cu.)
//
// What bounds it on the H100: operations.  A 100 -> 100 layer of the KPCN
// chain does 2 . 25 . 100 . 100 = 500 k flops per output pixel for 800
// bytes moved; the chain's layers 1, 5 and 9 at 8 tiles of 128 px take
// 0.359, 0.697 and 2.229 ms at the 67 TFLOP/s f32 rate of the CUDA cores.
//
// Design: a direct SIMT convolution.  A block of 256 threads computes 8
// output rows x 16 columns x 64 output channels (one row a warp); the grid
// is (row and column tiles, channel chunks of 64, images).  Per chunk of 8
// input channels the block stages the input tile with its K - 1 halo,
// (8 + K - 1) x (16 + K - 1) pixels at a pitch of 9 floats (an odd pitch, so
// the four pixels a warp reads at once fall in four banks), and every tap's
// 8 x 64 weights (packed by the wrapper as [channel chunk of 64][input chunk
// of 8][tap][8 input channels][64 output channels], zero past Cin and Cout).
// A thread holds 4 pixels (columns c, c + 4, c + 8, c + 12 of its warp's
// row) x 8 output channels (4 q + {0..3} and 32 + 4 q + {0..3}) in
// registers, so each staged value feeds 8 or 4 fused multiply-adds.  Each
// output is one f32 fused multiply-add chain from zero in a fixed order
// (input chunk, tap, channel), then the bias, the activation and one store
// at the output's pixel pitch; channels between Cout and the pitch are
// written as zeros.  No atomics: the result repeats bit for bit.
#include "common.cuh"
#include "mlp.cuh"

namespace wcmc {

constexpr int kConvF32Rows = 8;    // output rows of a block, one a warp
constexpr int kConvF32Cols = 16;   // output columns of a block
constexpr int kConvF32Chunk = 8;   // input channels staged at once
constexpr int kConvF32Out = 64;    // output channels of a block
constexpr int kConvF32Pitch = kConvF32Chunk + 1;  // floats of a staged pixel

struct ConvF32 {
  const float* x;      // (b, h, w, cin) at strides (sb, sh, sw, 1)
  const float* wp;     // packed weights
  const float* bias;   // (cout)
  float* y;            // (b, ho, wo, ypitch)
  long long sb, sh, sw;
  int b, h, w, cin, cout, k, ho, wo, ypitch, n_chunks, act;
};

__host__ __device__ inline int conv_f32_tile_w(int k) { return kConvF32Cols + k - 1; }
__host__ __device__ inline int conv_f32_tile_h(int k) { return kConvF32Rows + k - 1; }

// The staged input tile, then the weights of one input chunk.
inline size_t conv_f32_smem(int k) {
  return smem_bytes((size_t)conv_f32_tile_h(k) * conv_f32_tile_w(k) * kConvF32Pitch, 4) +
         smem_bytes((size_t)k * k * kConvF32Chunk * kConvF32Out, 4);
}

__global__ void __launch_bounds__(kThreads, 3) conv5_f32_kernel(ConvF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = a.k, kk = k * k, tw = conv_f32_tile_w(k), th = conv_f32_tile_h(k);
  SmemCarver carve{smem, 0};
  float* XS = carve.take<float>((size_t)th * tw * kConvF32Pitch);
  float* WS = carve.take<float>((size_t)kk * kConvF32Chunk * kConvF32Out);
  const int tiles_w = (a.wo + kConvF32Cols - 1) / kConvF32Cols;
  const int oy0 = blockIdx.x / tiles_w * kConvF32Rows, ox0 = blockIdx.x % tiles_w * kConvF32Cols;
  const int n0 = blockIdx.y * kConvF32Out, img = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % 8, col = lane / 8;  // channels n0 + 4q + {0..3}, 32 + ...; columns col + 4i
  const float* xb = a.x + img * a.sb;
  const size_t w_chunk = (size_t)kk * kConvF32Chunk * kConvF32Out;
  const float* wsrc = a.wp + (size_t)blockIdx.y * a.n_chunks * w_chunk;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int ch = 0; ch < a.n_chunks; ++ch) {
    const int c0 = ch * kConvF32Chunk;
    __syncthreads();  // the last chunk's readers are done
    // the input tile: pixel p, channels c0 + 4 half + {0..3}; zero outside
    // the image and at or past Cin
    for (int i = threadIdx.x; i < th * tw * 2; i += blockDim.x) {
      const int p = i / 2, half = i % 2, cb = c0 + 4 * half;
      const int gy = oy0 + p / tw, gx = ox0 + p % tw;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (gy < a.h && gx < a.w && cb < a.cin) {
        const float* src = xb + gy * a.sh + gx * a.sw + cb;
        if (cb + 4 <= a.cin) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
        } else {
          for (int e = 0; cb + e < a.cin; ++e) v[e] = src[e];
        }
      }
      float* d = XS + p * kConvF32Pitch + 4 * half;
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = v[e];
    }
    const float4* wsrc4 = reinterpret_cast<const float4*>(wsrc + ch * w_chunk);
    for (int i = threadIdx.x; i < (int)(w_chunk / 4); i += blockDim.x)
      reinterpret_cast<float4*>(WS)[i] = wsrc4[i];
    __syncthreads();
    for (int dy = 0; dy < k; ++dy) {
      for (int dx = 0; dx < k; ++dx) {
        const float* xs = XS + ((warp + dy) * tw + col + dx) * kConvF32Pitch;
        const float* ws = WS + (dy * k + dx) * kConvF32Chunk * kConvF32Out + 4 * q;
#pragma unroll
        for (int c = 0; c < kConvF32Chunk; ++c) {
          float xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xs[4 * i * kConvF32Pitch + c];
          const float4 w0 = *reinterpret_cast<const float4*>(ws + c * kConvF32Out);
          const float4 w1 = *reinterpret_cast<const float4*>(ws + c * kConvF32Out + 32);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(xv[i], wv[j], acc[i][j]);
        }
      }
    }
  }
  const int oy = oy0 + warp;
  if (oy >= a.ho) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ox = ox0 + col + 4 * i;
    if (ox >= a.wo) continue;
    float* yp = a.y + (((long long)img * a.ho + oy) * a.wo + ox) * a.ypitch;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 4 * q + (j < 4 ? j : 28 + j);
      if (n < a.cout) {
        yp[n] = mlp_act(a.act, acc[i][j] + a.bias[n]);
      } else if (n < a.ypitch) {
        yp[n] = 0.0f;
      }
    }
  }
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of K6's f32 body for a K x K window: what
// ops/conv5.py's conv_f32_plan totals.
extern "C" long long wcmc_conv5_f32_smem(int k) { return (long long)conv_f32_smem(k); }

// K6 in f32: x (b, h, w, cin) f32 at strides (sb, sh, sw, 1), each a multiple
// of 4 and x 16-byte aligned (sw >= cin rounded up to 4); wp the weights
// packed by ops/conv5.py's pack_weights_f32 for cin_pad (Cin rounded up to
// whole chunks of 8), 16-byte aligned; bias (cout) f32; y (b, h - k + 1, w -
// k + 1, ypitch) f32, cout <= ypitch <= cout rounded up to 64; act 0 linear,
// 1 relu, 2 leaky relu.
extern "C" int wcmc_conv5_f32(const void* x, const void* wp, const void* bias, void* y, int b,
                              int h, int w, int cin, long long sb, long long sh, long long sw,
                              int cout, int ypitch, int k, int cin_pad, int act, int device,
                              void* stream) {
  ConvF32 a{};
  a.x = static_cast<const float*>(x);
  a.wp = static_cast<const float*>(wp);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<float*>(y);
  a.sb = sb, a.sh = sh, a.sw = sw;
  a.b = b, a.h = h, a.w = w, a.cin = cin, a.cout = cout, a.k = k;
  a.ho = h - k + 1, a.wo = w - k + 1, a.ypitch = ypitch, a.act = act;
  a.n_chunks = cin_pad / kConvF32Chunk;
  const int n_out = (cout + kConvF32Out - 1) / kConvF32Out;
  if (b < 1 || b > 65535 || k < 1 || a.ho < 1 || a.wo < 1 || cin < 1 || cout < 1 || act < 0 ||
      act > 2 || cin_pad % kConvF32Chunk || cin_pad < cin || cin_pad - kConvF32Chunk >= cin ||
      sb % 4 || sh % 4 || sw % 4 || sw < round_up(cin, 4) || ypitch < cout ||
      ypitch > n_out * kConvF32Out || !aligned16(x) || !aligned16(wp))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const size_t smem = conv_f32_smem(k);
  cudaError_t err = set_smem(conv5_f32_kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((a.ho + kConvF32Rows - 1) / kConvF32Rows) *
                          ((a.wo + kConvF32Cols - 1) / kConvF32Cols);
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)n_out, (unsigned)b);
  conv5_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
