// K6: a VALID K x K convolution with its bias and activation fused into
// the store, channels-last, in bf16 with f32 accumulation:
//
//   y[b, i, j, n] = bf16(act(sum_{dy, dx, c} x[b, i + dy, j + dx, c] . w[dy, dx, c, n] + bias[n]))
//
// rounded once, from f32, as wcmc_tpu's _conv_xla computes it.  Replaces
// wcmc_tpu/ops/conv5.py::_conv_fwd_pallas (Pallas body _conv_kernel), the
// opt-in fused KPCN inference (WCMC_FUSED_INFERENCE=1): two chains of nine
// 5 x 5 layers per batch, Cin -> 100 -> ... -> 100 -> 441.
//
// What bounds it on the H100.  Operations: a 100 -> 100 layer of the KPCN
// chain at 128-px tiles does 2 . 25 . 100 . 100 = 500 k flops per output
// pixel and moves 400 bytes for it (a bf16 pixel read and one written),
// some 1,250 flops a byte, far above the card's ~295; the whole chain of
// a branch is ~0.50 TFLOP for ~0.39 GB, ~0.51 ms at the bf16 dense peak.
//
// Design: an implicit GEMM, M = output pixels, N = Cout, the reduction
// over (dy, dx, Cin).  A block owns 16 output rows x 16 output columns x
// a slice of 112 output channels; each of its 16 warps owns two rows and
// half of the slice, i.e. 2 x 7 tiles of 16 x 8 f32 accumulators in
// registers (16 warps rather than 8 with twice the tiles: the SM has no
// room for a second block, and the latency of the operand loads wants
// the warps).  The block stages its input tile with the (K - 1)-pixel
// halo, (16 + K - 1)^2 pixels x a chunk of up to 128 input channels, in
// shared memory once per chunk, with channels past Cin and pixels past the
// image zero-filled there, not in device memory (with Cin even, by 4-byte
// cp.async copies that keep many loads in flight: a warp's plain loads
// pixel after pixel took a third of the kernel's time); and it streams
// the weights tap by tap: the (chunk x 112) slice of tap t + 1 is copied
// with cp.async into the second of two buffers while the warps multiply
// tap t, one barrier a tap.  For a tap (dy, dx), row r's A operand is 16
// consecutive pixels of staged row r + dy starting at column dx, a plain
// row-major matrix whose leading dimension is the pixel pitch, so no
// im2col copy is made.  Operands come from shared memory through ldmatrix
// (A as it is, B transposed from the row-major [Cin][Cout] slice), with
// pixel and weight rows padded by 16 bytes so that no two rows of a load
// share a bank group; the products are mma.sync m16n8k16 (bf16 in, f32
// accumulation).  The epilogue adds the f32 bias to the accumulators,
// applies the activation, rounds once and stores NHWC (channel pairs as
// one 4-byte store where Cout is even), with the ragged edges (rows,
// columns, Cout) masked.  No split of the reduction across blocks and no
// atomics: the result repeats bit for bit.  Offsets into device memory
// are 64-bit.  No TMA, wgmma or warp specialisation yet; one ~150 KB block
// per SM at K = 5 and 112 channels.
#include <algorithm>

#include "mlp.cuh"

namespace wcmc {

constexpr int kConvTH = 16;                   // output rows per block
constexpr int kConvTW = 16;                   // output columns per block (the M of a product)
constexpr int kConvWarps = 16;                // 8 row pairs x 2 halves of the channel slice
constexpr int kConvThreads = kConvWarps * 32;
constexpr int kConvRows = 2;                  // output rows per warp
constexpr int kConvNC = 112;                  // output channels per block
constexpr int kConvHalf = kConvNC / 2;        // output channels per warp
constexpr int kConvN8 = kConvHalf / 8;        // n8 accumulator tiles per row and warp
constexpr int kConvWPitch = kConvNC + 8;      // weight-slice row pitch (pitch_bf16)
constexpr int kConvMaxChunk = 128;            // most input channels staged at once

struct ConvDims {
  int b, h, w, cin, cout, k;  // input sizes and the kernel's side
  int ho, wo;                 // output sizes
  int cin_pad;                // weight rows per tap: Cin rounded up to 16
  int cout_pad;               // weight columns: Cout rounded up to kConvNC
  int chunk;                  // input channels per staged chunk (multiple of 16)
  int act;                    // 0 linear, 1 relu, 2 leaky relu (mlp_act)
};

// A staged pixel's pitch (elements): its chunk of channels plus 16 bytes,
// an odd number of 16-byte units, so the 8 rows an ldmatrix reads (8
// consecutive pixels) fall in 8 different bank groups.  The weight slice's
// rows (kConvWPitch) are padded the same way.
__host__ __device__ inline int conv_xpitch(int chunk) { return chunk + 8; }

inline size_t conv_smem(int k, int chunk) {
  const size_t pix = (size_t)(kConvTH + k - 1) * (kConvTW + k - 1);
  return smem_bytes(pix * conv_xpitch(chunk), 2) +
         2 * smem_bytes((size_t)chunk * kConvWPitch, 2) + smem_bytes(kConvNC, 4);
}

__device__ inline void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// 4 bytes, or (src_bytes 0) 4 zero bytes
__device__ inline void cp_async4_zfill(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Four 8x8 bf16 matrices from shared memory (each lane gives one row's
// address), as the A operand of mma.m16n8k16, or (trans) as the B operands
// of two n8 tiles from a row-major [k][n] tile.
__device__ inline void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline void ldmatrix_x2_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on the tensor cores: a 16x16 bf16 (row-major fragment), b
// 16x8 bf16 (two registers), c 16x8 f32.
__device__ inline void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __global__ void __launch_bounds__(kConvThreads)
    conv5_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ y, ConvDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_x = (d.wo + kConvTW - 1) / kConvTW;
  const int y0 = (blockIdx.x / tiles_x) * kConvTH, x0 = (blockIdx.x % tiles_x) * kConvTW;
  const int n0 = blockIdx.y * kConvNC, bi = blockIdx.z;
  const int win = kConvTW + d.k - 1, npix = (kConvTH + d.k - 1) * win;
  const int kk = d.k * d.k, xpitch = conv_xpitch(d.chunk);
  const int steps = (d.cin_pad + d.chunk - 1) / d.chunk * kk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp % 8) * kConvRows, nhalf = warp / 8;
  const bool active = y0 + row0 < d.ho;

  SmemCarver carve{smem, 0};
  bf16* sx = carve.take<bf16>((size_t)npix * xpitch);
  bf16* sw0 = carve.take<bf16>((size_t)d.chunk * kConvWPitch);
  bf16* sw1 = carve.take<bf16>((size_t)d.chunk * kConvWPitch);
  float* sb = carve.take<float>(kConvNC);
  // shared-window addresses, so every copy and fragment load is a shared one
  const unsigned sx_addr = static_cast<unsigned>(__cvta_generic_to_shared(sx));
  const unsigned sw_addr[2] = {static_cast<unsigned>(__cvta_generic_to_shared(sw0)),
                               static_cast<unsigned>(__cvta_generic_to_shared(sw1))};
  for (int i = threadIdx.x; i < kConvNC; i += kConvThreads)
    sb[i] = n0 + i < d.cout ? bias[n0 + i] : 0.0f;

  // step s: input chunk s / kk, tap s % kk; its weight slice is
  // (rows of the chunk) x kConvNC, 14 pieces of 16 bytes a row
  auto load_w = [&](int s, unsigned dst) {
    const int c0 = (s / kk) * d.chunk, rows = min(d.chunk, d.cin_pad - c0);
    const bf16* src = w + ((size_t)(s % kk) * d.cin_pad + c0) * d.cout_pad + n0;
    constexpr int kPieces = kConvNC * 2 / 16;
    for (int i = threadIdx.x; i < rows * kPieces; i += kConvThreads) {
      const int r = i / kPieces, p = i % kPieces;
      cp_async16(dst + (r * kConvWPitch + p * 8) * 2, src + (size_t)r * d.cout_pad + p * 8);
    }
    cp_async_commit();
  };
  // the input tile of chunk c0, a warp per pixel, lanes on its channels;
  // with Cin even, as channel pairs copied asynchronously (many in flight,
  // pixels past the image and channels past Cin zero-filled by the copy),
  // else element by element
  auto load_x = [&](int c0) {
    const int cw = min(d.chunk, d.cin_pad - c0);
    if (d.cin % 2 == 0) {
      for (int p = warp; p < npix; p += kConvWarps) {
        const int gy = y0 + p / win, gx = x0 + p % win;
        const bool in = gy < d.h && gx < d.w;
        const bf16* src = in ? x + (((size_t)bi * d.h + gy) * d.w + gx) * d.cin + c0 : x;
        const unsigned dst = sx_addr + 2 * p * xpitch;
        for (int c = 2 * lane; c < cw; c += 64) {
          const bool real = in && c0 + c < d.cin;
          cp_async4_zfill(dst + 2 * c, real ? src + c : x, real ? 4 : 0);
        }
      }
      cp_async_commit();
      return;
    }
    const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll 4
    for (int p = warp; p < npix; p += kConvWarps) {
      const int gy = y0 + p / win, gx = x0 + p % win;
      bf16* dst = sx + (size_t)p * xpitch;
      if (gy < d.h && gx < d.w) {
        const bf16* src = x + (((size_t)bi * d.h + gy) * d.w + gx) * d.cin + c0;
        const int real = min(cw, d.cin - c0);
        for (int c = lane; c < cw; c += 32) dst[c] = c < real ? src[c] : zero;
      } else {
        for (int c = lane; c < cw; c += 32) dst[c] = zero;
      }
    }
  };

  // the lane's row of each 8x8 matrix an ldmatrix.x4 reads: A's rows are
  // the 16 pixels (matrices 0 and 1) at channels +0 and +8 (2 and 3);
  // B's rows are the 16 k of the slice at channel columns +0 and +8
  const int frag_row = (lane % 8) + 8 * ((lane / 8) % 2), frag_col = 8 * (lane / 16);
  const int a_lane = (row0 * win + frag_row) * xpitch + frag_col;  // elements
  const int b_lane = frag_row * kConvWPitch + kConvHalf * nhalf + frag_col;

  float acc[kConvRows][kConvN8][4];
#pragma unroll
  for (int r = 0; r < kConvRows; ++r)
#pragma unroll
    for (int j = 0; j < kConvN8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][j][i] = 0.0f;

  load_w(0, sw_addr[0]);
  for (int s = 0; s < steps; ++s) {
    const int tap = s % kk, c0 = (s / kk) * d.chunk;
    if (tap == 0) {
      if (s > 0) __syncthreads();  // every warp is done with the last chunk's tile
      load_x(c0);
    }
    cp_async_wait_all();  // this step's weights (and the chunk's tile)
    __syncthreads();
    // the other buffer was last read in step s - 1, which every warp
    // finished before the barrier above: fill it for step s + 1 while
    // this step multiplies
    if (s + 1 < steps) load_w(s + 1, sw_addr[(s + 1) & 1]);
    if (!active) continue;
    const int dy = tap / d.k, dx = tap % d.k, cw = min(d.chunk, d.cin_pad - c0);
    const unsigned a_base = sx_addr + 2 * (a_lane + (dy * win + dx) * xpitch);
    const unsigned b_base = sw_addr[s & 1] + 2 * b_lane;
    // the 7th n8 tile by an x2 load: lanes 0-15 give its k rows 0-15
    const unsigned b_last =
        sw_addr[s & 1] + 2 * ((lane % 16) * kConvWPitch + kConvHalf * nhalf + 48);
    for (int k0 = 0; k0 < cw; k0 += 16) {
      unsigned a[kConvRows][4], b[4][4];
#pragma unroll
      for (int r = 0; r < kConvRows; ++r) ldmatrix_x4(a[r], a_base + 2 * (r * win * xpitch + k0));
#pragma unroll
      for (int jj = 0; jj < 3; ++jj)
        ldmatrix_x4_trans(b[jj], b_base + 2 * (k0 * kConvWPitch + 16 * jj));
      ldmatrix_x2_trans(b[3], b_last + 2 * k0 * kConvWPitch);
#pragma unroll
      for (int r = 0; r < kConvRows; ++r) {
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          mma_bf16(acc[r][2 * jj], a[r], b[jj][0], b[jj][1]);
          mma_bf16(acc[r][2 * jj + 1], a[r], b[jj][2], b[jj][3]);
        }
        mma_bf16(acc[r][6], a[r], b[3][0], b[3][1]);
      }
    }
  }

  // epilogue from the accumulators: lane holds pixels lane / 4 and
  // lane / 4 + 8 of its row at channels 2 (lane % 4) + {0, 1} of each n8 tile
  if (!active) return;
  const bool pairs = d.cout % 2 == 0;  // channel pairs are 4-byte aligned
#pragma unroll
  for (int r = 0; r < kConvRows; ++r) {
    const int oy = y0 + row0 + r;
    if (oy >= d.ho) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + lane / 4 + 8 * half;
      if (ox >= d.wo) continue;
      bf16* out = y + (((size_t)bi * d.ho + oy) * d.wo + ox) * d.cout;
#pragma unroll
      for (int j = 0; j < kConvN8; ++j) {
        const int c = kConvHalf * nhalf + j * 8 + 2 * (lane % 4), n = n0 + c;
        const float v0 = mlp_act(d.act, acc[r][j][2 * half] + sb[c]);
        const float v1 = mlp_act(d.act, acc[r][j][2 * half + 1] + sb[c + 1]);
        if (pairs && n + 1 < d.cout) {
          *reinterpret_cast<__nv_bfloat162*>(out + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < d.cout) out[n] = __float2bfloat16(v0);
          if (n + 1 < d.cout) out[n + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace wcmc

using namespace wcmc;

// x (b, h, w, cin) bf16 contiguous; wp (k, k, cin_pad, cout_pad) bf16,
// the weights zero-padded to cin_pad = cin rounded up to 16 rows and
// cout_pad (a multiple of the 112-channel block slice) columns; bias
// (cout) f32; y (b, h - k + 1, w - k + 1, cout) bf16 contiguous.  act: 0
// linear, 1 relu, 2 leaky relu.
extern "C" int wcmc_conv5(const void* x, const void* wp, const void* bias, void* y, int b, int h,
                          int w, int cin, int cout, int k, int cin_pad, int cout_pad, int act,
                          int device, void* stream) {
  ConvDims d{b, h, w, cin, cout, k, h - k + 1, w - k + 1, cin_pad, cout_pad, 0, act};
  if (b < 1 || b > 65535 || k < 1 || d.ho < 1 || d.wo < 1 || cin < 1 || cout < 1 ||
      cin_pad != round_up(cin, 16) || cout_pad != round_up(cout, kConvNC) || act < 0 ||
      act > 2 || cout_pad / kConvNC > 65535)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // the widest chunk of input channels whose tiles fit the block's shared memory
  d.chunk = std::min(cin_pad, kConvMaxChunk);
  while (d.chunk > 16 && conv_smem(k, d.chunk) > (size_t)limit) d.chunk -= 16;
  const size_t smem = conv_smem(k, d.chunk);
  err = set_smem(conv5_kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((d.ho + kConvTH - 1) / kConvTH) * ((d.wo + kConvTW - 1) / kConvTW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, cout_pad / kConvNC, b);
  conv5_kernel<<<grid, kConvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wp), static_cast<const float*>(bias),
      static_cast<bf16*>(y), d);
  return cudaGetLastError();
}
