// K6 in float32 on the tensor cores: a VALID K x K convolution with its
// bias and activation fused into the store, channels-last, for f32 input
// (the opt-in fused KPCN inference at TrainConfig.compute_dtype =
// "float32"):
//
//   y[b, i, j, n] = act(sum_{dy, dx, c} x[b, i + dy, j + dx, c] . w[dy, dx, c, n] + bias[n])
//
// in split TF32 (tf32x3.cuh): each f32 product taken as lo . hi + hi . lo +
// hi . hi on the tensor cores into one f32 accumulator, about f32's
// accuracy.  Replaces wcmc_tpu/ops/conv5.py::_conv_fwd_pallas (pallas_call
// :149, body _conv_kernel :82) on f32 input, as _conv_xla computes it there.
// (The bf16 form is conv5.cu; the first f32 body, a direct SIMT convolution,
// is conv5_f32.cu, kept as the card tests' reference.)
//
// What bounds it on the H100: operations.  A 100 -> 100 layer of the KPCN
// chain does 2 . 25 . 100 . 100 = 500 k flops per output pixel for 800
// bytes moved.  At the CUDA cores' 67 TFLOP/s f32 rate the chain's layers
// 1, 5 and 9 at 8 tiles of 128 px take 0.359, 0.697 and 2.229 ms, where
// cuDNN's f32 convolution already sits; in split TF32 the tensor cores do
// three tf32 products per f32 one, 3 . flops / 495 TFLOP/s: 0.145, 0.283
// and 0.905 ms (and 0.523 ms for layer 1 without paths at 256 px).
//
// Design: the implicit GEMM of the bf16 body (conv5.cu), M = output pixels,
// N = Cout, the reduction over (Cin, dy, dx).
// - A block owns 12 output rows (kWG = 3 warpgroups) x 16 columns and every
//   output channel, as passes of kN channels (kN = 104 for Cout <= 104, 112
//   above: Cout 441 is four passes); each warp one output row, its 16 pixels
//   the 16 rows of its warpgroup's m64 product.  A thread holds a pass's
//   running sums and a step's partials (kN / 2 f32 each): 170 registers a
//   thread at 384 threads, one block an SM.
// - Input: the (4 kWG + K - 1) x (16 + K - 1) pixels with the halo, a chunk
//   of Cin (all of the KPCN's 104 or 40 channels in one chunk), staged in
//   slabs of 8 channels by 16-byte cp.async at a pitch of the chunk rounded
//   to 8 mod 16 floats (an 8-byte load of 16 lanes then falls in 16 bank
//   pairs); each thread arrives on the slab's mbarrier once its copies have
//   landed, so the products of slab j run while slabs j + 1... still load.
//   The copies zero-fill channels past Cin and pixels past the image, and
//   need a pixel pitch in device memory that is a multiple of 4 floats (the
//   wrapper copies Cin 39 and 34 once to a pitch of 40; the chain's hidden
//   layers come at the pitch of 104 that this kernel writes).
// - Steps: (pass, chunk, slab of 8 channels, tap).  A step's A is the
//   warp's 16 pixels of staged row r + dy from column dx, one 8-byte load a
//   lane per 8 pixels (channels 2t and 2t + 1 of pixel g: the fragment's k t
//   and k t + 4, so the weights are packed with that order of k), split into
//   hi and lo in registers.  Its B, the tap's 8 input x kN output channels as
//   hi and lo, each K-major 8 x 4 core matrices (the only layout tf32 wgmma
//   reads), packed, split and cached once per parameter value by the wrapper
//   (ops/conv5.py, pack_weights_tf32), is one contiguous block brought in by
//   one cp.async.bulk into a ring of kStages buffers with full mbarriers; a
//   stage is refilled by the last warp that releases it.
// - Products: wgmma m64nNk8 (tf32, f32 accumulators, A from registers):
//   lo . hi (from zero), hi . lo, hi . hi per step into the step's partial,
//   committed and waited as one group, then added to the running sums by
//   f32 adds (tf32x3.cuh: the tensor cores' truncating accumulation stays
//   within one step's partial).
// - Epilogue: the f32 bias, the activation and one f32 store per output at
//   the output's pixel pitch (8-byte pairs where the pitch is even; channels
//   between Cout and the pitch written as zeros), ragged edges masked.
// No atomics on values and no split of the reduction: the result repeats
// bit for bit.  Offsets into device memory are 64-bit.
#include "hopper.cuh"
#include "mlp.cuh"
#include "tf32x3.cuh"

namespace wcmc {

constexpr int kTcTW = 16;          // output columns per block
constexpr int kTcWG = 3;           // warpgroups a block: 12 output rows
constexpr int kTcStages = 4;       // weight-ring buffers
constexpr int kTcMaxChunk = 256;   // most input channels staged at once
constexpr int kTcMaxSlabs = kTcMaxChunk / 8;

struct ConvTcDims {
  int b, h, w, cin, cout, k;  // input sizes and the kernel's side
  long long sb, sh, sw;       // x's strides (floats), channels contiguous
  int ho, wo;                 // output sizes
  int ypitch;                 // output pixel pitch (floats), >= cout
  int cin_pad;                // packed weight rows a tap: Cin in whole chunks
  int npass;                  // passes of kN output channels
  int chunk;                  // input channels staged at once (multiple of 8)
  int act;                    // 0 linear, 1 relu, 2 leaky relu (mlp_act)
};

// the staged pixel pitch: the chunk rounded up to 8 mod 16 floats
__host__ __device__ constexpr int conv_tc_xpitch(int chunk) {
  return chunk % 16 == 8 ? chunk : chunk + 8;
}

// The block's shared memory: the input tile, the weight ring, the bias of
// every pass, the ring's full barriers and release counts, the slabs'
// barriers.  ops/conv5.py's conv_tc_plan computes the same sum.
inline size_t conv_tc_smem(int k, int chunk, int n, int rows, int npass) {
  const size_t pix = (size_t)(rows + k - 1) * (kTcTW + k - 1);
  return smem_bytes(pix * conv_tc_xpitch(chunk), 4) + kTcStages * smem_bytes((size_t)n * 64, 1) +
         smem_bytes((size_t)npass * n, 4) + smem_bytes(kTcStages, 8) + smem_bytes(kTcStages, 4) +
         smem_bytes(kTcMaxSlabs, 8);
}

// d = a . B + (scale_d ? d : 0) on the tensor cores for the warpgroup: an
// m64n104k8 product, tf32 in, f32 accumulation; A (64 x 8) from registers
// (each warp's 16 rows in the layout of mma.m16n8k8's A fragment), B (8 x
// 104) K-major in shared memory through the descriptor.
__device__ inline void wgmma_tf32_n104(float (&d)[13][4], const unsigned (&a)[4], uint64_t desc,
                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d = a . B + (scale_d ? d : 0) on the tensor cores for the warpgroup: an
// m64n112k8 product, tf32 in, f32 accumulation; A (64 x 8) from registers
// (each warp's 16 rows in the layout of mma.m16n8k8's A fragment), B (8 x
// 112) K-major in shared memory through the descriptor.
__device__ inline void wgmma_tf32_n112(float (&d)[14][4], const unsigned (&a)[4], uint64_t desc,
                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int kN>
__device__ inline void wgmma_tf32(float (&d)[kN / 8][4], const unsigned (&a)[4], uint64_t desc,
                                  int scale_d) {
  if constexpr (kN == 104) {
    wgmma_tf32_n104(d, a, desc, scale_d);
  } else {
    wgmma_tf32_n112(d, a, desc, scale_d);
  }
}

// kN output channels per pass, kWG warpgroups (4 kWG output rows a block).
template <int kN, int kWG>
static __global__ void __launch_bounds__(kWG * 128, 1)
    conv5_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y, ConvTcDims d) {
  constexpr int kRows = 4 * kWG, kThreads = kWG * 128, kWarps = kThreads / 32;
  constexpr int kN8 = kN / 8;
  constexpr unsigned kStageBytes = kN * 64;  // hi and lo, 8 x kN f32 each
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_x = (d.wo + kTcTW - 1) / kTcTW;
  const int y0 = (blockIdx.x / tiles_x) * kRows, x0 = (blockIdx.x % tiles_x) * kTcTW;
  const int bi = blockIdx.z;
  const int win = kTcTW + d.k - 1, npix = (kRows + d.k - 1) * win;
  const int kk = d.k * d.k, nk8 = d.chunk / 8, nchunks = d.cin_pad / d.chunk;
  const int steps = d.npass * nchunks * nk8 * kk;
  const int xp = conv_tc_xpitch(d.chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  SmemCarver carve{smem, 0};
  float* sx = carve.take<float>((size_t)npix * xp);
  unsigned char* sw = carve.take<unsigned char>((size_t)kTcStages * kStageBytes);
  float* sb = carve.take<float>((size_t)d.npass * kN);
  unsigned long long* full = carve.take<unsigned long long>(kTcStages);
  int* released = carve.take<int>(kTcStages);
  unsigned long long* xbar = carve.take<unsigned long long>(kTcMaxSlabs);
  const unsigned sx_addr = smem_addr(sx), sw_addr = smem_addr(sw);
  const unsigned full0 = smem_addr(full), xbar0 = smem_addr(xbar);

  // step s's weights, one contiguous block of the packed tensor (steps in
  // the packed order), into stage s % kTcStages
  auto fetch = [&](int s) {
    const int st = s % kTcStages;
    mbar_expect_tx(full0 + 8 * st, kStageBytes);
    bulk_copy(sw_addr + st * kStageBytes, w + (size_t)s * (kN * 16), kStageBytes, full0 + 8 * st);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTcStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      released[i] = 0;
    }
    for (int j = 0; j < nk8; ++j) mbar_init(xbar0 + 8 * j, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kTcStages && s < steps; ++s) fetch(s);
  }
  for (int i = threadIdx.x; i < d.npass * kN; i += kThreads) sb[i] = i < d.cout ? bias[i] : 0.0f;
  __syncthreads();  // the barriers are initialised before any thread arrives on them

  // the input tile of channels [c0, c0 + chunk), slab by slab of 8
  // channels, 16 bytes a copy; each thread arrives on a slab's barrier once
  // its copies of that slab have landed
  const float* xb = x + (size_t)bi * d.sb;
  auto load_x = [&](int c0) {
    for (int j = 0; j < nk8; ++j) {
      for (int i = threadIdx.x; i < npix * 2; i += kThreads) {
        const int p = i / 2, c = c0 + 8 * j + 4 * (i % 2);
        const int gy = y0 + p / win, gx = x0 + p % win;
        const int bytes = gy < d.h && gx < d.w ? max(0, min(16, 4 * (d.cin - c))) : 0;
        const float* src = bytes ? xb + gy * d.sh + gx * d.sw + c : x;
        cp_async16_zfill(sx_addr + 4 * (p * xp + 8 * j + 4 * (i % 2)), src, bytes);
      }
      cp_async_mbar_arrive(xbar0 + 8 * j);
    }
  };

  // the lane's A values: pixel g (and g + 8) of the warp's row, channels
  // 2t and 2t + 1 of a slab
  const int g = lane / 4, t = lane % 4;
  const float* a_lane = sx + (size_t)(warp * win + g) * xp + 2 * t;

  float acc[kN8][4], part[kN8][4];
  zero_acc(part);
  int loads = 0;  // input tiles loaded so far: the slab barriers' phase
  for (int p = 0; p < d.npass; ++p) {
    zero_acc(acc);
    for (int c = 0; c < nchunks; ++c) {
      if (p == 0 || nchunks > 1) {
        if (p > 0 || c > 0) {
          __syncthreads();  // every warp is done with the last tile
          ++loads;
        }
        load_x(c * d.chunk);
      }
      for (int j = 0; j < nk8; ++j) {
        mbar_wait(xbar0 + 8 * j, loads & 1);
        for (int tap = 0; tap < kk; ++tap) {
          const int s = ((p * nchunks + c) * nk8 + j) * kk + tap, st = s % kTcStages;
          const int dy = tap / d.k, dx = tap % d.k;
          const float* ap = a_lane + (size_t)(dy * win + dx) * xp + 8 * j;
          const float2 v0 = *reinterpret_cast<const float2*>(ap);
          const float2 v1 = *reinterpret_cast<const float2*>(ap + 8 * xp);
          unsigned hi[4], lo[4];
          split_tf32(v0.x, hi[0], lo[0]);
          split_tf32(v1.x, hi[1], lo[1]);
          split_tf32(v0.y, hi[2], lo[2]);
          split_tf32(v1.y, hi[3], lo[3]);
          mbar_wait(full0 + 8 * st, (s / kTcStages) & 1);
          const unsigned b = sw_addr + st * kStageBytes;
          const uint64_t b_hi = smem_desc(b, 128, 256), b_lo = smem_desc(b + kN * 32, 128, 256);
          fence_acc(part);
          wgmma_fence();
          wgmma_tf32<kN>(part, lo, b_hi, 0);   // the step's own partial, from zero
          wgmma_tf32<kN>(part, hi, b_lo, 1);
          wgmma_tf32<kN>(part, hi, b_hi, 1);
          wgmma_commit();
          wgmma_wait_all();
          fence_acc(part);
#pragma unroll
          for (int jn = 0; jn < kN8; ++jn)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[jn][i] += part[jn][i];
          // this warp is done with the stage; the last warp to say so
          // refills it with step s + kTcStages
          __syncwarp();
          if (lane == 0 &&
              atomicAdd(released + st, 1) == (s / kTcStages + 1) * kWarps - 1 &&
              s + kTcStages < steps)
            fetch(s + kTcStages);
          __syncwarp();
        }
      }
    }

    // epilogue from the accumulators: lane holds pixels g and g + 8 of its
    // row at channels 2t + {0, 1} of each n8 tile
    const int oy = y0 + warp;
    if (oy >= d.ho) continue;
    const bool pairs = d.ypitch % 2 == 0;  // channel pairs are 8-byte aligned
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (ox >= d.wo) continue;
      float* out = y + (((size_t)bi * d.ho + oy) * d.wo + ox) * d.ypitch;
#pragma unroll
      for (int jn = 0; jn < kN8; ++jn) {
        const int n = p * kN + jn * 8 + 2 * t;
        if (n >= d.ypitch) continue;
        const float v0 = n < d.cout ? mlp_act(d.act, acc[jn][2 * half] + sb[n]) : 0.0f;
        const float v1 =
            n + 1 < d.cout ? mlp_act(d.act, acc[jn][2 * half + 1] + sb[n + 1]) : 0.0f;
        if (pairs) {
          *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
        } else {
          out[n] = v0;
          if (n + 1 < d.ypitch) out[n + 1] = v1;
        }
      }
    }
  }
}

template <int kN, int kWG>
static int launch_conv5_tf32(const float* x, const float* wp, const float* bias, float* y,
                             ConvTcDims d, int device, cudaStream_t stream) {
  constexpr int kRows = 4 * kWG;
  const size_t smem = conv_tc_smem(d.k, d.chunk, kN, kRows, d.npass);
  cudaError_t err = set_smem(conv5_tf32_kernel<kN, kWG>, smem, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((d.ho + kRows - 1) / kRows) * ((d.wo + kTcTW - 1) / kTcTW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, d.b);
  conv5_tf32_kernel<kN, kWG><<<grid, kWG * 128, smem, stream>>>(x, wp, bias, y, d);
  return cudaGetLastError();
}

}  // namespace wcmc

using namespace wcmc;

// The dynamic shared memory of K6's tensor-core f32 body for a K x K window,
// a chunk of `chunk` input channels, passes of n (104 or 112) channels:
// what ops/conv5.py's conv_tc_plan totals.
extern "C" long long wcmc_conv5_tf32_smem(int k, int chunk, int n, int npass) {
  return (long long)conv_tc_smem(k, chunk, n, 4 * kTcWG, npass);
}

// x (b, h, w, cin) f32 with strides (sb, sh, sw, 1), each a multiple of 4
// floats, and 16-byte aligned; wp the weights packed by ops/conv5.py's
// pack_weights_tf32 (npass passes of n channels, cin_pad rows a tap, a
// multiple of the chunk, split into tf32 hi and lo); bias (cout) f32; y (b,
// h - k + 1, w - k + 1, ypitch) f32 contiguous, channels [cout, ypitch)
// written as zeros.  n is 104 or 112; chunk (8 to 256, a multiple of 8) the
// input channels staged at once.  act: 0 linear, 1 relu, 2 leaky relu.
extern "C" int wcmc_conv5_tf32(const void* x, const void* wp, const void* bias, void* y, int b,
                               int h, int w, int cin, long long sb, long long sh, long long sw,
                               int cout, int ypitch, int k, int n, int cin_pad, int chunk,
                               int act, int device, void* stream) {
  ConvTcDims d{b, h, w, cin, cout, k, sb, sh, sw, h - k + 1, w - k + 1, ypitch, cin_pad, 0, chunk,
               act};
  if (b < 1 || b > 65535 || k < 1 || d.ho < 1 || d.wo < 1 || cin < 1 || cout < 1 ||
      (n != 104 && n != 112) || act < 0 || act > 2 || chunk < 8 || chunk % 8 ||
      chunk > kTcMaxChunk || cin_pad < cin || cin_pad % chunk || cin_pad - chunk >= cin ||
      sb % 4 || sh % 4 || sw % 4 || sw < cin || !aligned16(x) || !aligned16(wp))
    return cudaErrorInvalidValue;
  d.npass = (cout + n - 1) / n;
  if (ypitch < cout || ypitch > d.npass * n) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const auto xs = static_cast<const float*>(x);
  const auto ws = static_cast<const float*>(wp);
  const auto bs = static_cast<const float*>(bias);
  const auto ys = static_cast<float*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  return n == 104 ? launch_conv5_tf32<104, kTcWG>(xs, ws, bs, ys, d, device, st)
                  : launch_conv5_tf32<112, kTcWG>(xs, ws, bs, ys, d, device, st);
}
