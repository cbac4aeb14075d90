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
// over (dy, dx, Cin).  A block owns an output tile of 4 . kWG rows x 16
// columns and every output channel: it runs Cout as passes of kN channels
// (kN = 104 with kWG = 4 for Cout <= 104, kN = 224 with kWG = 2 above:
// Cout 441 is two passes) over one staged input tile, so the tile is
// loaded once per chunk of input channels, not once per channel slice.
// Each warp owns one output row: 16 pixels x kN channels of f32
// accumulators in registers (kN / 2 a thread).  Those registers cap a
// block at 256 (kN 104) or 128 (kN 224) output pixels, so each weight
// byte streamed from L2 serves that many flops: at the tensor cores'
// peak the blocks would draw ~3.9 or ~7.7 TB/s of weights from L2: the
// likely limit of this design (inferred from that arithmetic, not
// profiled).
//
// Input tile: the (4 kWG + K - 1) x (16 + K - 1) pixels with the halo,
// a chunk of up to 128 input channels, copied by 16-byte cp.async into
// shared memory at a pitch of chunk + 8 elements (an odd number of
// 16-byte units, so the 8 rows of an ldmatrix fall in 8 bank groups).
// The copies need a pixel pitch in device memory that is a multiple of 8
// channels: the wrapper gives K6 either such a tensor as it is (the fused
// chain carries its hidden activations at a pitch of 104 channels, which
// K6 itself writes, pad channels zero) or one padded copy (Cin 39 and 34
// -> 40).  A padded pitch in device memory was chosen over staging rows
// flat and re-laying them out in shared memory: it costs one small copy
// at the chain's first layer and nothing after, where a re-layout costs
// a second pass through shared memory and a barrier on every tile.  The
// copy itself zero-fills what it does not read (channels past Cin in the
// last 16 bytes, pixels past the image), so the pad channels' contents in
// device memory never matter.
//
// Weights: packed once by the wrapper (ops/conv5.py, pack_weights) into
// the order the kernel streams, [pass][tap][k16 step][n8 group][k half]
// [8 n][8 k]: 8 x 8 core matrices of 128 contiguous bytes, K-major, the
// layout a wgmma reads B from through a descriptor (no swizzle), so one
// step's slice (a tap's chunk of input channels x kN) is one contiguous
// block, brought in by a single cp.async.bulk (no tensor map) into a ring
// of kStages buffers, each with a full mbarrier that the copy completes:
// no block-wide barrier per tap.  A stage is refilled by the last warp
// that releases it (a count in shared memory), so no warp waits on the
// refill and no producer warp costs registers (a wgmma block's register
// budget is counted in whole warpgroups).  Chunks are templated by their
// depth, so every step issues a fixed run of wgmmas (a product under a
// branch is serialized by ptxas); the wrapper pads Cin to whole chunks.
//
// Products: wgmma m64nNk16 (N = kN, bf16 in, f32 accumulation), one
// warpgroup's 4 output rows x 16 columns as the 64 rows of M: each warp
// supplies its row's 16 pixels as A from registers, the ldmatrix
// fragments of mma.m16n8k16 (for a tap (dy, dx), row r's A operand is 16
// consecutive pixels of staged row r + dy starting at column dx: no
// im2col copy), and B comes from the ring, read once per warpgroup.  A
// step loads its A fragments, fences, issues one wgmma per k16 step,
// commits and waits, then frees the stage.  The epilogue adds the f32
// bias, applies the activation, rounds once and stores NHWC at the
// output's pixel pitch (channel pairs as one 4-byte store where the pitch
// is even; channels between Cout and the pitch written as zeros), with the
// ragged edges masked.  No split of the reduction across blocks and no
// atomics on values (the one atomic, a shared count, only picks the warp
// that refills a stage): the result repeats bit for bit.  Offsets into
// device memory are 64-bit.
#include "hopper.cuh"
#include "mlp.cuh"

namespace wcmc {

constexpr int kConvTW = 16;         // output columns per block (a warp's 16 rows of M)
constexpr int kConvStages = 3;      // weight-ring buffers
constexpr int kConvMaxChunk = 128;  // most input channels staged at once

struct ConvDims {
  int b, h, w, cin, cout, k;  // input sizes and the kernel's side
  long long sb, sh, sw;       // x's strides (elements), channels contiguous
  int ho, wo;                 // output sizes
  int ypitch;                 // output pixel pitch (elements), >= cout
  int cin_pad;                // packed weight rows per tap: Cin in whole chunks
  int npass;                  // passes of kN output channels
  int chunk;                  // input channels per staged chunk (multiple of 16)
  int act;                    // 0 linear, 1 relu, 2 leaky relu (mlp_act)
};

__host__ __device__ constexpr int conv_xpitch(int chunk) { return chunk + 8; }

// The block's shared memory: the input tile, the weight ring, the bias
// of every pass, the ring's full barriers and its release counts.
// ops/conv5.py's kernel_plan computes the same sum to choose the chunk.
inline size_t conv_smem(int k, int chunk, int n, int rows, int npass) {
  const size_t pix = (size_t)(rows + k - 1) * (kConvTW + k - 1);
  return smem_bytes(pix * conv_xpitch(chunk), 2) +
         kConvStages * smem_bytes((size_t)chunk * n, 2) + smem_bytes((size_t)npass * n, 4) +
         smem_bytes(kConvStages, 8) + smem_bytes(kConvStages, 4);
}

// A wgmma descriptor of a K-major B operand without swizzle in shared
// memory: 8 x 8 core matrices of 128 contiguous bytes, the two k halves
// of an n8 group 128 bytes apart (leading byte offset), successive n8
// groups 256 bytes apart (stride byte offset).
__device__ inline uint64_t wgmma_desc(unsigned addr) { return smem_desc(addr, 128, 256); }

// d += a . B on the tensor cores for the warpgroup: an m64n104k16 product,
// A (64 x 16 bf16) from registers as four ldmatrix fragments a warp, B
// (16 x 104 bf16) from shared memory through the descriptor, f32 d.
__device__ inline void wgmma_n104(float (&d)[13][4], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a . B on the tensor cores for the warpgroup: an m64n224k16 product,
// A (64 x 16 bf16) from registers as four ldmatrix fragments a warp, B
// (16 x 224 bf16) from shared memory through the descriptor, f32 d.
__device__ inline void wgmma_n224(float (&d)[28][4], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 0;\n}\n"
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
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int kN>
__device__ inline void wgmma_bf16(float (&d)[kN / 8][4], const unsigned (&a)[4], uint64_t desc) {
  if constexpr (kN == 104) {
    wgmma_n104(d, a, desc);
  } else {
    wgmma_n224(d, a, desc);
  }
}

// kN output channels per pass, kWG warpgroups (4 kWG output rows per
// block), chunks of 16 kNK input channels.
template <int kN, int kWG, int kNK>
static __global__ void __launch_bounds__(kWG * 128, 1)
    conv5_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ y, ConvDims d) {
  constexpr int kRows = 4 * kWG, kThreads = kWG * 128, kWarps = kThreads / 32;
  constexpr int kN8 = kN / 8, kChunk = 16 * kNK;
  constexpr unsigned kStageBytes = kChunk * kN * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles_x = (d.wo + kConvTW - 1) / kConvTW;
  const int y0 = (blockIdx.x / tiles_x) * kRows, x0 = (blockIdx.x % tiles_x) * kConvTW;
  const int bi = blockIdx.z;
  const int win = kConvTW + d.k - 1, npix = (kRows + d.k - 1) * win;
  const int kk = d.k * d.k, nchunks = d.cin_pad / kChunk, steps = d.npass * nchunks * kk;
  constexpr int kXPitch = conv_xpitch(kChunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  SmemCarver carve{smem, 0};
  bf16* sx = carve.take<bf16>((size_t)npix * kXPitch);
  bf16* sw = carve.take<bf16>((size_t)kConvStages * kChunk * kN);
  float* sb = carve.take<float>((size_t)d.npass * kN);
  unsigned long long* full = carve.take<unsigned long long>(kConvStages);
  int* released = carve.take<int>(kConvStages);
  // shared-window addresses, so every copy and fragment load is a shared one
  const unsigned sx_addr = static_cast<unsigned>(__cvta_generic_to_shared(sx));
  const unsigned sw_addr = static_cast<unsigned>(__cvta_generic_to_shared(sw));
  const unsigned full0 = static_cast<unsigned>(__cvta_generic_to_shared(full));

  // step s: pass s / (nchunks kk), chunk (s / kk) % nchunks, tap s % kk;
  // its weights, one contiguous block of the packed tensor, into stage
  // s % kStages, counted against that stage's full barrier
  auto fetch = [&](int s) {
    const int st = s % kConvStages, t = s % kk, c = (s / kk) % nchunks, p = s / (kk * nchunks);
    const bf16* src = w + ((size_t)(p * kk + t) * d.cin_pad + c * kChunk) * kN;
    mbar_expect_tx(full0 + 8 * st, kStageBytes);
    bulk_copy(sw_addr + st * kStageBytes, src, kStageBytes, full0 + 8 * st);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kConvStages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kConvStages && s < steps; ++s) fetch(s);
  }
  for (int i = threadIdx.x; i < d.npass * kN; i += kThreads) sb[i] = i < d.cout ? bias[i] : 0.0f;

  // the input tile of channels [c0, c0 + kChunk), 16 bytes a copy;
  // channels past Cin and pixels past the image are zero-filled by the copy
  const bf16* xb = x + (size_t)bi * d.sb;
  auto load_x = [&](int c0) {
    constexpr int kPieces = kChunk / 8;
    for (int i = threadIdx.x; i < npix * kPieces; i += kThreads) {
      const int p = i / kPieces, q = i % kPieces, c = c0 + 8 * q;
      const int gy = y0 + p / win, gx = x0 + p % win;
      const int bytes = gy < d.h && gx < d.w ? max(0, min(16, 2 * (d.cin - c))) : 0;
      const bf16* src = bytes ? xb + gy * d.sh + gx * d.sw + c : x;
      cp_async16_zfill(sx_addr + 2 * (p * kXPitch + 8 * q), src, bytes);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  };

  // the lane's row of each 8x8 matrix an ldmatrix.x4 reads for A: the 16
  // pixels (matrices 0 and 1) at channels +0 and +8 (2 and 3)
  const int frag_row = (lane % 8) + 8 * ((lane / 8) % 2), frag_col = 8 * (lane / 16);
  const unsigned a_lane = sx_addr + 2 * ((warp * win + frag_row) * kXPitch + frag_col);

  float acc[kN8][4];
  for (int p = 0; p < d.npass; ++p) {
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    for (int c = 0; c < nchunks; ++c) {
      if (p == 0 || nchunks > 1) {
        if (p > 0 || c > 0) __syncthreads();  // every warp is done with the last tile
        load_x(c * kChunk);
      }
      for (int t = 0; t < kk; ++t) {
        const int s = (p * nchunks + c) * kk + t, st = s % kConvStages;
        const int dy = t / d.k, dx = t % d.k;
        // the warp's A fragments of every k16 step of the chunk, then, once
        // the step's weights have landed, its products as one group
        const unsigned a_base = a_lane + 2 * (dy * win + dx) * kXPitch;
        unsigned a[kNK][4];
#pragma unroll
        for (int ks = 0; ks < kNK; ++ks) ldmatrix_x4(a[ks], a_base + 32 * ks);
        mbar_wait(full0 + 8 * st, (s / kConvStages) & 1);
        const uint64_t desc = wgmma_desc(sw_addr + st * kStageBytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kNK; ++ks)
          wgmma_bf16<kN>(acc, a[ks], desc + (uint64_t)(ks * kN * 2));
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
        // this warp is done with the stage; the last warp to say so refills
        // it with step s + kStages (the count only grows: round s / kStages
        // ends at (round + 1) kWarps)
        __syncwarp();
        if (lane == 0 &&
            atomicAdd(released + st, 1) == (s / kConvStages + 1) * kWarps - 1 &&
            s + kConvStages < steps)
          fetch(s + kConvStages);
        __syncwarp();
      }
    }

    // epilogue from the accumulators: lane holds pixels lane / 4 and
    // lane / 4 + 8 of its row at channels 2 (lane % 4) + {0, 1} of each n8 tile
    const int oy = y0 + warp;
    if (oy >= d.ho) continue;
    const bool pairs = d.ypitch % 2 == 0;  // channel pairs are 4-byte aligned
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + lane / 4 + 8 * half;
      if (ox >= d.wo) continue;
      bf16* out = y + (((size_t)bi * d.ho + oy) * d.wo + ox) * d.ypitch;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        const int c = j * 8 + 2 * (lane % 4), n = p * kN + c;
        if (n >= d.ypitch) continue;
        const float v0 = n < d.cout ? mlp_act(d.act, acc[j][2 * half] + sb[n]) : 0.0f;
        const float v1 = n + 1 < d.cout ? mlp_act(d.act, acc[j][2 * half + 1] + sb[n + 1]) : 0.0f;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          out[n] = __float2bfloat16(v0);
          if (n + 1 < d.ypitch) out[n + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int kN, int kWG, int kNK>
static int launch_conv5(const bf16* x, const bf16* wp, const float* bias, bf16* y, ConvDims d,
                        int device, cudaStream_t stream) {
  constexpr int kRows = 4 * kWG;
  const size_t smem = conv_smem(d.k, d.chunk, kN, kRows, d.npass);
  cudaError_t err = set_smem(conv5_kernel<kN, kWG, kNK>, smem, device);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((d.ho + kRows - 1) / kRows) * ((d.wo + kConvTW - 1) / kConvTW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, d.b);
  conv5_kernel<kN, kWG, kNK><<<grid, kWG * 128, smem, stream>>>(x, wp, bias, y, d);
  return cudaGetLastError();
}

// one instantiation per pass width and chunk depth (16 to 128 channels)
template <int kN, int kWG>
static int dispatch_conv5(const bf16* x, const bf16* wp, const float* bias, bf16* y, ConvDims d,
                          int device, cudaStream_t stream) {
  switch (d.chunk / 16) {
    case 1: return launch_conv5<kN, kWG, 1>(x, wp, bias, y, d, device, stream);
    case 2: return launch_conv5<kN, kWG, 2>(x, wp, bias, y, d, device, stream);
    case 3: return launch_conv5<kN, kWG, 3>(x, wp, bias, y, d, device, stream);
    case 4: return launch_conv5<kN, kWG, 4>(x, wp, bias, y, d, device, stream);
    case 5: return launch_conv5<kN, kWG, 5>(x, wp, bias, y, d, device, stream);
    case 6: return launch_conv5<kN, kWG, 6>(x, wp, bias, y, d, device, stream);
    case 7: return launch_conv5<kN, kWG, 7>(x, wp, bias, y, d, device, stream);
    case 8: return launch_conv5<kN, kWG, 8>(x, wp, bias, y, d, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wcmc

using namespace wcmc;

// x (b, h, w, cin) bf16 with strides (sb, sh, sw, 1), each a multiple of
// 8 elements, and 16-byte aligned; wp the packed weights of ops/conv5.py
// (pack_weights: npass passes of n channels, cin_pad rows a tap, a
// multiple of the chunk); bias (cout) f32; y (b, h - k + 1, w - k + 1,
// ypitch) bf16 contiguous, channels [cout, ypitch) written as zeros.  n
// is 104 or 224; chunk (16 to 128, a multiple of 16) the input channels
// staged at once.  act: 0 linear, 1 relu, 2 leaky relu.
extern "C" int wcmc_conv5(const void* x, const void* wp, const void* bias, void* y, int b, int h,
                          int w, int cin, long long sb, long long sh, long long sw, int cout,
                          int ypitch, int k, int n, int cin_pad, int chunk, int act, int device,
                          void* stream) {
  ConvDims d{b, h, w, cin, cout, k, sb, sh, sw, h - k + 1, w - k + 1, ypitch, cin_pad, 0, chunk,
             act};
  if (b < 1 || b > 65535 || k < 1 || d.ho < 1 || d.wo < 1 || cin < 1 || cout < 1 ||
      (n != 104 && n != 224) || act < 0 || act > 2 || chunk < 16 || chunk % 16 ||
      chunk > kConvMaxChunk || cin_pad < cin || cin_pad % chunk || cin_pad - chunk >= cin ||
      sb % 8 || sh % 8 || sw % 8 || sw < cin || (reinterpret_cast<uintptr_t>(x) & 15u) ||
      (reinterpret_cast<uintptr_t>(wp) & 15u))
    return cudaErrorInvalidValue;
  d.npass = (cout + n - 1) / n;
  if (ypitch < cout || ypitch > d.npass * n) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const auto xs = static_cast<const bf16*>(x);
  const auto ws = static_cast<const bf16*>(wp);
  const auto bs = static_cast<const float*>(bias);
  const auto ys = static_cast<bf16*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  return n == 104 ? dispatch_conv5<104, 4>(xs, ws, bs, ys, d, device, st)
                  : dispatch_conv5<224, 2>(xs, ws, bs, ys, d, device, st);
}
