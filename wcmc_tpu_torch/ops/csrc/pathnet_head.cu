// K5-fwd: the per-sample head over [e | broadcast_S(ctx)] with the f32
// sample moments.
//
//   h1             = bf16(act1(e[b, s, p] . W1e + ctx[b, p] . W1c + b1))
//   o              = act2(h1 . W2 + b2)                       (f32)
//   out[b, s, p]   = o rounded to the output type (f32 or bf16)
//   sum[b, p]      = sum_s o,  sumsq[b, p] = sum_s o^2        (unrounded o)
//
// with per-layer activations (relu, leaky relu of slope 0.01, or linear;
// mlp_act of mlp.cuh).  Replaces wcmc_tpu/ops/pathnet_fused.py:457
// _head_fwd_pallas (pallas_call :494, body _head_fwd_kernel), with its
// `moments`, `out_dtype` and `cmajor` options; as there, the moments are
// summed from the unrounded f32 value.  The concat never exists: W1 is
// split at row Ce into the part that multiplies e and the part that
// multiplies the context, and since the context is the same for every
// sample of a pixel, ctx . W1c + b1 is computed once per pixel tile and
// starts each sample's layer-1 accumulator (the TPU kernel recomputed it
// every grid step).
//
// What bounds it on the H100 (bytes over 3.35 TB/s, flops over the 989
// TFLOP/s bf16 dense peak), at the path shapes of 8 images x 8 spp x 128^2
// px, in the three forms the models run:
// - Multisteps' update chain ([128 | 128] -> 128 -> 128, leaky relu x 2,
//   bf16 out, channels-last; SBMC serving and training, with moments in
//   steps 0 and 1): e (268 MB) and the context (34 MB) in, the output (268
//   MB) and the f32 moments (134 MB) out: 705 MB, 0.210 ms (570 MB, 0.170
//   ms without moments), against 73 GFLOP, 0.074 ms.  Bytes.
// - KPCN's head, both branches merged ([128 | 128] -> 256 -> 6, relu x 2,
//   f32 out with moments; channels-last serving, channel-major training):
//   268 + 34 MB in, 25 + 6 MB out: 334 MB, 0.0996 ms, against 81 GFLOP,
//   0.081 ms.  Bytes, the flops close behind.
// - The 64-wide PathNet head (LBMC's and SBMC's, [64 | 64] -> 128 -> 3, relu
//   x 2, f32 out, channels-last, no moments): 134 + 17 MB in, 13 MB out:
//   164 MB, 0.049 ms, against 20 GFLOP.  Bytes.
// Without weight gradients the kernel is a pure stream, so the design
// keeps copies in flight while the tensor cores work:
// - The tiled kernel (pathnet_head_tiled_kernel) runs those three forms.
//   Persistent blocks of two warpgroups; each warpgroup walks its own
//   (image, 64-pixel tile) units, so one's epilogues run under the other's
//   products, and takes a unit's samples in order, one sample a product
//   (64 rows, a wgmma's m64): a thread owns the same (pixel, column)
//   elements for every sample, and the moments add up in its registers in
//   sample order, with no shuffle, barrier or atomic; two launches repeat
//   bit for bit.
// - The weights are the pack K5-bwd reads (ops/pathnet_fused.py,
//   pack_head_weights; one pack per parameter value, shared by a train
//   step's forward and backward): blocked W1e and W2 bulk-copied into
//   shared memory once per block (the 64-wide form's Ce = 64 rows are the
//   first half of the pack's zero-padded 128), W1c's mma.m16n8k16 B
//   fragments read from device memory once per unit.
// - The context tile and then the unit's e tiles stream through a ring of
//   blocked tiles per warpgroup (2 stages; 4 in the 64-wide form), by
//   16-byte cp.async (8 threads a core matrix, so a warp reads 64
//   contiguous bytes of each of 8 rows) with an mbarrier a stage; pixels
//   past HW are zero-filled.  A tile is refilled with the item kStages
//   ahead as soon as every warp has read it.
// - ctx . W1c + b1 once per unit on mma.sync, in the accumulator layout of
//   the warpgroup's wgmma: PathNet keeps it in registers, Multisteps
//   (whose 128 moment registers leave no room) in shared f32, each thread
//   its own 64 values.  Layer 1 starts from it: wgmma m64n128k16 (C1 256 in
//   two halves), e and W1e from shared memory through descriptors; h1 is
//   rounded in registers and stored blocked; layer 2 on wgmma (m64n128,
//   or m64n16 for PathNet's Cout <= 16 zero-padded to 16).
// - Epilogues in registers: bias, activation, moments; the output staged
//   in shared memory (Multisteps' bf16 rows padded over h1, PathNet's f32
//   as [pixel][channel] or [channel][pixel]) and stored 16 bytes a thread
//   where the destination lines up (a Multisteps row is 256 contiguous
//   bytes, a PathNet tile one run of 64 Cout floats, or Cout runs of 64
//   pixels channel-major); moments once per unit.  Barriers are named
//   per warpgroup: 2 a sample for PathNet, 4 for Multisteps (whose output
//   staging shares h1's buffer).
// - Shared memory (FwdSmem, head_fwd_plan): 231,552 bytes for Multisteps,
//   230,016 for KPCN's form, 144,000 for the 64-wide one, of the 232,448 a
//   block may opt into: one block per SM.
// - The wmma body (pathnet_head_kernel) keeps every other form: run-time
//   activations, other widths, Multisteps with an f32 or channel-major
//   output.  A block owns 32 pixels and loops over S, weights staged once
//   per block, products on wmma 16 x 16 fragments through shared memory;
//   loads are not pipelined.
#include "hopper.cuh"
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

// The wmma body, for the forms the tiled kernel below does not take; the
// activations and W2's staged width are read from d at run time.
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
    pathnet_head_kernel(const bf16* __restrict__ e, const bf16* __restrict__ ctx,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2, const float* __restrict__ b2,
                        TOut* __restrict__ out, float* __restrict__ ssum,
                        float* __restrict__ ssq, int B, int S, int HW, HeadDims d, int cmajor) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hw = d.c1 > d.cc ? d.c1 : d.cc;
  const int coutp = d.coutp;
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
                 s_h[r * p_h + c] = __float2bfloat16(mlp_act(d.act1, v));
               });
      __syncthreads();
      tile_mma(s_h, p_h, s_w2, p_w2, kHeadRows, coutp, d.c1, nullptr, 0, s_stage,
               [&](int r, int c, float v) {
                 if (c >= d.cout) return;
                 const float o = mlp_act(d.act2, v + s_b2[c]);
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

// ---------------------------------------------------------------------------
// The tiled forms: Multisteps' update chain, KPCN's head, the 64-wide head
// ---------------------------------------------------------------------------

constexpr int kFPix = 64;              // pixels of one image per unit; one sample a product (m64)
constexpr int kFThreads = 256;         // two warpgroups, each walking its own units
constexpr int kFPackCe = 128;          // W1e's rows in the pack (Ce zero-padded to 128)
constexpr int kFOutPitch = kFPix + 4;  // a channel's staged row of a channel-major output

// The block's shared memory, buffer by buffer in the order the kernel
// carves them (each a multiple of 128 bytes); ops/pathnet_fused.py's
// head_fwd_plan lists the same.  kCe: Ce = Cc; kOut: W2's staged width
// (128: Multisteps, ctx . W1c + b1 in shared memory and the bf16 output
// staged over h1; 16: PathNet, ctx . W1c + b1 in registers, the f32
// output and the moments staged in buffers of their own).  The ring, zc,
// h, the output and moment stages: one each per warpgroup.
template <int kCe, int kC1, int kOut, int kStages>
struct FwdSmem {
  static constexpr bool kWide = kOut == 128;
  static constexpr int kTile = kFPix * kCe * 2;  // an e or context tile, bf16, blocked
  static constexpr int kW1e = kCe * kC1 * 2, kW2 = kC1 * kOut * 2;
  static constexpr int kRing = kStages * kTile;
  static constexpr int kZc = kWide ? kFPix * kC1 * 4 : 0;
  static constexpr int kH = cmax(kFPix * kC1 * 2, kWide ? kFPix * (kOut + 8) * 2 : 0);
  static constexpr int kOst = kWide ? 0 : kOut * kFOutPitch * 4;
  static constexpr int kMst = kWide ? 0 : 2 * kFPix * kOut * 4;
  static constexpr int kBars = (1 + 2 * kStages) * 8;
  static size_t total() {
    return smem_bytes(kW1e, 1) + smem_bytes(kW2, 1) + smem_bytes(2 * kRing, 1) +
           smem_bytes(2 * kZc, 1) + smem_bytes(2 * kH, 1) + smem_bytes(2 * kOst, 1) +
           smem_bytes(2 * kMst, 1) + smem_bytes(kBars, 1);
  }
};

struct FwdArgs {
  const bf16* e;      // (B, S, HW, Ce)
  const bf16* ctx;    // (B, HW, Ce)
  const bf16* w;      // pack_head_weights: blocked W1e | blocked W2 | W1c's fragments | ...
  const float* bias;  // b1 (C1) | b2 (kOut)
  void* out;          // (B, S, HW, cout), or (B, S, cout, HW) with cmajor (PathNet)
  float* ssum;        // (B, HW, cout), or null for no moments
  float* ssq;
  int B, S, HW, cout, cmajor;
};

// kCe = Cc, kC1: the layer widths; kOut: W2's staged width; kA: both
// layers' activation code; kStages: the ring's stages; TOut: the output's
// type; kMom: moments on (1), off (0) or as a null ssum says (-1).
template <int kCe, int kC1, int kOut, int kA, int kStages, typename TOut, int kMom>
__global__ void __launch_bounds__(kFThreads, 1) pathnet_head_tiled_kernel(FwdArgs a) {
  using Sm = FwdSmem<kCe, kC1, kOut, kStages>;
  constexpr bool kWide = Sm::kWide;
  constexpr int kTile = Sm::kTile;
  constexpr int kRGe = kCe / 8 * 128;   // bytes between 8-row groups of an e or context tile
  constexpr int kRGh = kC1 / 8 * 128;   // ... of h1 and of W1e
  constexpr int kRGo = kOut / 8 * 128;  // ... of W2
  constexpr int kN1 = kC1 / 8;          // n8 tiles of a C1-wide row
  constexpr int kHPitch = kOut + 8;     // a staged bf16 output row (Multisteps), 272 bytes
  static_assert((kCe == 64 || kCe == 128) && kC1 % 128 == 0 && (kOut == 16 || kOut == 128),
                "the tiled forms");
  static_assert(!kWide || kC1 == 128, "Multisteps' form is 128 wide");
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarver carve{smem, 0};
  unsigned char* s_w1e = carve.take<unsigned char>(Sm::kW1e);
  unsigned char* s_w2 = carve.take<unsigned char>(Sm::kW2);
  unsigned char* s_ring = carve.take<unsigned char>(2 * Sm::kRing);
  float* s_zc = carve.take<float>(2 * Sm::kZc / 4);
  unsigned char* s_h = carve.take<unsigned char>(2 * Sm::kH);
  float* s_ost = carve.take<float>(2 * Sm::kOst / 4);
  float* s_mst = carve.take<float>(2 * Sm::kMst / 4);
  unsigned long long* s_bars = carve.take<unsigned long long>(1 + 2 * kStages);
  if (carve.offset != dynamic_smem_size()) __trap();  // the carve is what FwdSmem::total() sums

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  const int S = a.S, HW = a.HW, cout = a.cout;
  const int per_image = (HW + kFPix - 1) / kFPix, n_units = a.B * per_image;
  // warpgroup wg of block x is walker 2 x + wg of 2 gridDim.x: units vb,
  // vb + nvb, ...; a unit's items are its context tile, then its S e tiles
  const int vb = 2 * (int)blockIdx.x + wg, nvb = 2 * (int)gridDim.x;
  const int n_mine = vb < n_units ? (n_units - vb + nvb - 1) / nvb : 0;
  const int n_items = n_mine * (S + 1);
  const bool moments = kMom > 0 || (kMom < 0 && a.ssum != nullptr);

  const unsigned u_w1e = smem_addr(s_w1e), u_w2 = smem_addr(s_w2);
  const unsigned u_ring = smem_addr(s_ring) + wg * Sm::kRing;
  unsigned char* const h_buf = s_h + wg * Sm::kH;
  const unsigned u_h = smem_addr(h_buf);
  // mbarriers: 0 the weights, then each warpgroup's ring stages
  const unsigned bar_w = smem_addr(s_bars), bar_r = bar_w + 8 * (1 + kStages * wg);
  const int named = 1 + wg;  // the warpgroup's named barrier
  if (tid == 0) {
    mbar_init(bar_w, 1);
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(bar_w + 8 * (1 + i), 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_mine == 0) return;  // only the second warpgroup of the last block can lack a unit
  if (tid == 0) {
    mbar_expect_tx(bar_w, Sm::kW1e + Sm::kW2);
    bulk_copy(u_w1e, a.w, Sm::kW1e, bar_w);
    bulk_copy(u_w2, a.w + kFPackCe * kC1, Sm::kW2, bar_w);
  }

  auto unit_of = [&](int u, int& b, int& p0, int& npx) {
    const int t = vb + u * nvb;
    b = t / per_image;
    p0 = (t % per_image) * kFPix;
    npx = min(kFPix, HW - p0);
  };
  // Item c of the walk into ring stage c % kStages, by the warpgroup's
  // threads, 16 bytes a cp.async: 8 threads take one 16-byte piece of 8
  // rows (a core matrix), so a warp reads 64 contiguous bytes of each of 8
  // rows; rows past HW are zero-filled.  Each thread then arrives on the
  // stage's mbarrier once its copies have landed.
  constexpr int kP = kCe / 8, kRGPass = 16 / kP;  // pieces a row, row groups a pass
  const int f_r8 = wt % 8, f_pc = (wt / 8) % kP, f_rg = wt / (8 * kP);
  auto fetch = [&](int c) {
    int b, p0, npx;
    const int j = c % (S + 1);
    unit_of(c / (S + 1), b, p0, npx);
    const bf16* src = j == 0 ? a.ctx + ((size_t)b * HW + p0) * kCe
                             : a.e + (((size_t)b * S + j - 1) * HW + p0) * kCe;
    const int st = c % kStages;
    const unsigned dst = u_ring + st * kTile + f_pc * 128 + f_r8 * 16;
#pragma unroll
    for (int m = 0; m < 8 / kRGPass; ++m) {
      const int rg = m * kRGPass + f_rg, row = 8 * rg + f_r8;
      const bool ok = row < npx;
      cp_async16_zfill(dst + rg * kRGe, ok ? src + (size_t)row * kCe + 8 * f_pc : src,
                       ok ? 16 : 0);
    }
    cp_async_mbar_arrive(bar_r + 8 * st);
  };
  // `runs` runs of n floats from shared src + r src_step to device dst + r
  // dst_step, by the warpgroup's threads, 16 bytes a store where dst lines up
  auto copy_runs = [&](float* dst, size_t dst_step, const float* src, int src_step, int runs,
                       int n) {
    const int n4 = aligned16(dst) && dst_step % 4 == 0 ? n / 4 : 0, rest = n - 4 * n4;
    for (int i = wt; i < runs * n4; i += 128) {
      const int r = i / n4, k = i % n4;
      reinterpret_cast<float4*>(dst + r * dst_step)[k] =
          reinterpret_cast<const float4*>(src + r * src_step)[k];
    }
    for (int i = wt; i < runs * rest; i += 128) {
      const int r = i / rest, k = 4 * n4 + i % rest;
      dst[r * dst_step + k] = src[r * src_step + k];
    }
  };
  // z = ctx . W1c for the warp's 16 pixels of a context tile and all C1
  // columns, on mma.sync: A from the blocked tile through ldmatrix, W1c's
  // B fragments from device memory (frag_order of the pack, 8 bytes a lane
  // a load).  z's layout is the warp's part of a wgmma accumulator.
  const uint2* const w1c_f =
      reinterpret_cast<const uint2*>(a.w + kFPackCe * kC1 + kC1 * kOut) + lane;
  auto ctx_product = [&](float (&z)[kN1][4], unsigned tile) {
    const int i = lane >> 3;
    const unsigned a0 = tile + (2 * warp + (i & 1)) * kRGe + (i >> 1) * 128 + (lane & 7) * 16;
    zero_acc(z);
#pragma unroll 1
    for (int ks = 0; ks < kCe / 16; ++ks) {
      unsigned af[4];
      ldmatrix_x4(af, a0 + ks * 256);
#pragma unroll
      for (int j0 = 0; j0 < kN1; j0 += 8) {
        uint2 bf[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bf[j] = __ldg(w1c_f + (ks * kN1 + j0 + j) * 32);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(z[j0 + j], af, bf[j].x, bf[j].y);
      }
    }
  };

  for (int c = 0; c < kStages && c < n_items; ++c) fetch(c);
  mbar_wait(bar_w, 0);

  float zc[kWide ? 1 : kN1][4];  // PathNet: ctx . W1c + b1 of the warp's rows, for a unit
  float acc[16][4];              // a 128-column layer's accumulators
  float ms[kWide ? 16 : 2][4], mq[kWide ? 16 : 2][4];  // the moments, summed in sample order
  // Multisteps: ctx . W1c + b1 in shared memory, each thread its own 16 float4s
  float4* const zc_lane = reinterpret_cast<float4*>(s_zc + wg * (Sm::kZc / 4)) + wt;
  // the lane's accumulator elements (n8 tile j, row half h): rows r_lane +
  // 8 h of the unit's tile, columns 8 j + 2 t4 and + 1; in the blocked h1
  // at h_lane + h kRGh + 128 j bytes
  const int r_lane = 16 * warp + g8;
  char* const h_lane = reinterpret_cast<char*>(h_buf) + 2 * warp * kRGh + g8 * 16 + 4 * t4;
  float* const ost = s_ost + wg * (Sm::kOst / 4);
  float* const mst = s_mst + wg * (Sm::kMst / 4);

  for (int u = 0; u < n_mine; ++u) {
    int b, p0, npx;
    unit_of(u, b, p0, npx);
    int c = u * (S + 1);
    mbar_wait(bar_r + 8 * (c % kStages), (c / kStages) & 1);
    if constexpr (kWide) {
      ctx_product(acc, u_ring + (c % kStages) * kTile);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + 8 * j + 2 * t4));
        zc_lane[128 * j] =
            make_float4(acc[j][0] + bb.x, acc[j][1] + bb.y, acc[j][2] + bb.x, acc[j][3] + bb.y);
      }
    } else {
      ctx_product(zc, u_ring + (c % kStages) * kTile);
#pragma unroll
      for (int j = 0; j < kN1; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + 8 * j + 2 * t4));
        zc[j][0] += bb.x, zc[j][1] += bb.y, zc[j][2] += bb.x, zc[j][3] += bb.y;
      }
    }
    named_sync(named, 128);  // every warp has read the context tile: refill its stage
    if (c + kStages < n_items) fetch(c + kStages);
    zero_acc(ms);
    zero_acc(mq);

    for (int s = 0; s < S; ++s) {
      ++c;
      const int st = c % kStages;
      mbar_wait(bar_r + 8 * st, (c / kStages) & 1);
      fence_proxy_async();  // e came by cp.async; the wgmmas read it through the async proxy
      // layer 1, a 128-column half at a time: ctx . W1c + b1 + e . W1e
#pragma unroll
      for (int hf = 0; hf < kC1 / 128; ++hf) {
        if constexpr (kWide) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float4 z = zc_lane[128 * j];
            acc[j][0] = z.x, acc[j][1] = z.y, acc[j][2] = z.z, acc[j][3] = z.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = zc[16 * hf + j][i];
        }
        fence_acc(acc);
        wgmma_fence();
        mm<16, kCe / 16, false, kRGe, true, kRGh>(acc, u_ring + st * kTile,
                                                  u_w1e + 16 * hf * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
        // Multisteps' h buffer holds the last sample's staged output until
        // every warp has stored its rows
        if constexpr (kWide) named_sync(named, 128);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(h_lane + h * kRGh + (16 * hf + j) * 128) =
                __floats2bfloat162_rn(mlp_act(kA, acc[j][2 * h]), mlp_act(kA, acc[j][2 * h + 1]));
      }
      fence_proxy_async();     // h1 is read by a wgmma next
      named_sync(named, 128);  // h1 is whole, and every warp's product has read the e tile
      if (c + kStages < n_items) fetch(c + kStages);
      const size_t row0 = ((size_t)b * S + s) * HW + p0;  // the tile's first row of the output

      if constexpr (kWide) {
        // o = act(h1 . W2 + b2), 128 columns, staged as padded bf16 rows
        // over h1 once every warp's product has read it, then out 16 bytes
        // a store (16 threads a 256-byte row)
        zero_acc(acc);
        fence_acc(acc);
        wgmma_fence();
        mm<16, kC1 / 16, false, kRGh, true, kRGo>(acc, u_h, u_w2);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
        named_sync(named, 128);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * t4;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + kC1 + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = mlp_act(kA, acc[j][2 * h] + bb.x);
            const float v1 = mlp_act(kA, acc[j][2 * h + 1] + bb.y);
            if constexpr (kMom > 0) {
              ms[j][2 * h] += v0, ms[j][2 * h + 1] += v1;
              mq[j][2 * h] += v0 * v0, mq[j][2 * h + 1] += v1 * v1;
            }
            *reinterpret_cast<__nv_bfloat162*>(h_buf + ((r_lane + 8 * h) * kHPitch + col) * 2) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
        named_sync(named, 128);
        const int pr = wt / 16, pc = wt % 16;
        TOut* const to = static_cast<TOut*>(a.out) + row0 * kOut + 8 * pc;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int r = pr + 8 * m;
          if (r < npx)
            *reinterpret_cast<uint4*>(to + (size_t)r * kOut) =
                *reinterpret_cast<const uint4*>(h_buf + (r * kHPitch + 8 * pc) * 2);
        }
      } else {
        // o = act(h1 . W2 + b2), Cout <= 16 columns, staged in f32 as
        // [pixel][channel] (one run of npx Cout floats) or, channel-major,
        // [channel][pixel] (Cout runs of npx floats)
        float o[2][4];
        zero_acc(o);
        fence_acc(o);
        wgmma_fence();
        mm<2, kC1 / 16, false, kRGh, true, kRGo>(o, u_h, u_w2);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(o);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * j + 2 * t4;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + kC1 + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r_lane + 8 * h;
            const float v[2] = {mlp_act(kA, o[j][2 * h] + bb.x), mlp_act(kA, o[j][2 * h + 1] + bb.y)};
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              ms[j][2 * h + k] += v[k];
              mq[j][2 * h + k] += v[k] * v[k];
              if (col + k < cout)
                ost[a.cmajor ? (col + k) * kFOutPitch + row : row * cout + col + k] = v[k];
            }
          }
        }
        named_sync(named, 128);
        float* const to = static_cast<float*>(a.out);
        if (a.cmajor)
          copy_runs(to + ((size_t)b * S + s) * cout * HW + p0, HW, ost, kFOutPitch, cout, npx);
        else
          copy_runs(to + row0 * cout, 0, ost, 0, 1, npx * cout);
      }
    }

    // the unit's moments, once
    if constexpr (kWide) {
      if constexpr (kMom > 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r_lane + 8 * h;
            if (row < npx) {
              const size_t at = ((size_t)b * HW + p0 + row) * kOut + 8 * j + 2 * t4;
              *reinterpret_cast<float2*>(a.ssum + at) = make_float2(ms[j][2 * h], ms[j][2 * h + 1]);
              *reinterpret_cast<float2*>(a.ssq + at) = make_float2(mq[j][2 * h], mq[j][2 * h + 1]);
            }
          }
      }
    } else if (moments) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int row = r_lane + 8 * h, col = 8 * j + 2 * t4 + k;
            if (col < cout) {
              mst[row * cout + col] = ms[j][2 * h + k];
              mst[kFPix * kOut + row * cout + col] = mq[j][2 * h + k];
            }
          }
      named_sync(named, 128);
      const size_t at = ((size_t)b * HW + p0) * cout;
      copy_runs(a.ssum + at, 0, mst, 0, 1, npx * cout);
      copy_runs(a.ssq + at, 0, mst + kFPix * kOut, 0, 1, npx * cout);
    }
  }
}

}  // namespace wcmc

using namespace wcmc;

template <typename TOut>
static cudaError_t launch_head(const void* e, const void* ctx, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out, void* ssum, void* ssq,
                               int B, int S, int HW, const HeadDims& d, int cmajor, int n_blocks,
                               int device, cudaStream_t stream) {
  const size_t smem = head_smem(d);
  cudaError_t err = set_smem(pathnet_head_kernel<TOut>, smem, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)B * ((HW + kHeadRows - 1) / kHeadRows);
  if (n_tiles == 0) return cudaSuccess;
  const int grid = (int)(n_tiles < n_blocks ? n_tiles : n_blocks);
  pathnet_head_kernel<TOut><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(ctx), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<TOut*>(out), static_cast<float*>(ssum), static_cast<float*>(ssq), B, S, HW, d,
      cmajor);
  return cudaGetLastError();
}

template <int kCe, int kC1, int kOut, int kA, int kStages, typename TOut, int kMom>
static cudaError_t launch_tiled(const FwdArgs& args, int n_blocks, int device,
                                cudaStream_t stream) {
  const size_t smem = FwdSmem<kCe, kC1, kOut, kStages>::total();
  auto* kernel = pathnet_head_tiled_kernel<kCe, kC1, kOut, kA, kStages, TOut, kMom>;
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  const long long units = (long long)args.B * ((args.HW + kFPix - 1) / kFPix);
  if (units == 0) return cudaSuccess;
  const long long blocks = (units + 1) / 2;  // two warpgroups a block, a unit each at least
  const int grid = (int)(blocks < n_blocks ? blocks : n_blocks);
  kernel<<<grid, kFThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// The tiled form of a head (1 Multisteps' update chain, 2 KPCN's merged
// PathNet head, 3 the 64-wide PathNet head), or 0 for the wmma body.
static int tiled_form(int ce, int cc, int c1, int cout, int act1, int act2, int out_bf16,
                      int cmajor) {
  if (act1 == 2 && act2 == 2 && ce == 128 && cc == 128 && c1 == 128 && cout == 128 &&
      out_bf16 && !cmajor)
    return 1;
  if (act1 == 1 && act2 == 1 && cout <= 16 && !out_bf16) {
    if (ce == 128 && cc == 128 && c1 == 256) return 2;
    if (ce == 64 && cc == 64 && c1 == 128) return 3;
  }
  return 0;
}

// The dynamic shared memory, in bytes, that K5-fwd gives a block of the
// form: what ops/pathnet_fused.py's head_fwd_plan totals.
extern "C" long long wcmc_pathnet_head_smem(int ce, int cc, int c1, int cout, int act1, int act2,
                                            int out_bf16, int cmajor) {
  switch (tiled_form(ce, cc, c1, cout, act1, act2, out_bf16, cmajor)) {
    case 1: return (long long)FwdSmem<128, 128, 128, 2>::total();
    case 2: return (long long)FwdSmem<128, 256, 16, 2>::total();
    case 3: return (long long)FwdSmem<64, 128, 16, 4>::total();
    default: return (long long)head_smem(HeadDims{ce, cc, c1, cout, round_up(cout, 16), act1, act2});
  }
}

// The tiled forms (tiled_form): e (B, S, HW, ce) bf16; ctx (B, HW, cc)
// bf16; wpack, bpack: the head's parameters as ops/pathnet_fused.py's
// pack_head_weights lays them out; out (B, S, HW, cout), or (B, S, cout,
// HW) with cmajor, bf16 for Multisteps and f32 for PathNet; ssum, ssq (B,
// HW, cout) f32, or both null for no moments.  All contiguous, every
// pointer 16-byte aligned.  n_blocks: the most persistent blocks to
// launch (the SM count).
extern "C" int wcmc_pathnet_head_tiled(const void* e, const void* ctx, const void* wpack,
                                       const void* bpack, void* out, void* ssum, void* ssq,
                                       int B, int S, int HW, int ce, int cc, int c1, int cout,
                                       int act1, int act2, int out_bf16, int cmajor,
                                       int n_blocks, int device, void* stream) {
  const int form = tiled_form(ce, cc, c1, cout, act1, act2, out_bf16, cmajor);
  if (form == 0 || S < 1 || n_blocks < 1 || cout < 1 || ((ssum == nullptr) != (ssq == nullptr)))
    return cudaErrorInvalidValue;
  for (const void* p : {e, ctx, wpack, bpack, static_cast<const void*>(out)})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  if (ssum != nullptr && (!aligned16(ssum) || !aligned16(ssq))) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs args{static_cast<const bf16*>(e), static_cast<const bf16*>(ctx),
                     static_cast<const bf16*>(wpack), static_cast<const float*>(bpack), out,
                     static_cast<float*>(ssum), static_cast<float*>(ssq), B, S, HW, cout,
                     cmajor};
  if (form == 1)
    return ssum != nullptr ? launch_tiled<128, 128, 128, 2, 2, bf16, 1>(args, n_blocks, device, s)
                           : launch_tiled<128, 128, 128, 2, 2, bf16, 0>(args, n_blocks, device, s);
  if (form == 2) return launch_tiled<128, 256, 16, 1, 2, float, -1>(args, n_blocks, device, s);
  return launch_tiled<64, 128, 16, 1, 4, float, -1>(args, n_blocks, device, s);
}

// The wmma body: e (B, S, HW, ce) bf16; ctx (B, HW, cc) bf16; w1 (ce + cc,
// c1) bf16 with the e rows first; b1 (c1) f32; w2 (c1, cout) bf16; b2
// (cout) f32.  out (B, S, HW, cout), or (B, S, cout, HW) with cmajor, f32
// or bf16 (out_bf16 != 0); ssum/ssq (B, HW, cout) f32, or both null for no
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
  if (out_bf16)
    return launch_head<bf16>(e, ctx, w1, b1, w2, b2, out, ssum, ssq, B, S, HW, d, cmajor,
                             n_blocks, device, s);
  return launch_head<float>(e, ctx, w1, b1, w2, b2, out, ssum, ssq, B, S, HW, d, cmajor,
                            n_blocks, device, s);
}
