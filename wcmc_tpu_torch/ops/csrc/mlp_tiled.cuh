// The pieces K10's tiled bodies share (LayerNet's embedding chain: three
// layers 32 wide, C0 from 1 to 32 with W0 zero-padded to 32 rows): the
// swizzled 64-row slab tiles each warp walks, their ldmatrix lanes, the
// chain's layer on mma.sync m16n8k16 with the hiddens in registers, and the
// slab copies between device and shared memory.  K10-fwd
// (mlp_fused.cu::mlp_fused_tiled_kernel) runs the chain; K10-bwd
// (mlp_fused_bwd.cu::mlp_fused_bwd_tiled_kernel) recomputes it with the same
// k16 steps and rounding points, then runs its backward.
#pragma once

#include "hopper.cuh"
#include "mlp.cuh"

namespace wcmc {

constexpr int kTbW = 32;                        // every width of the tiled form; C0 padded to it
constexpr int kTbRows = 64;                     // rows of a slab, walked by one warp
constexpr int kTbTile = kTbRows * kTbW * 2;     // a slab's tile, bf16
constexpr int kTbWTile = kTbW * kTbW * 2;       // a weight tile, bf16

// Byte offset of 16-byte piece p of row r of a 32-wide bf16 tile: rows of
// 64 bytes, piece p stored at p ^ ((r >> 1) & 3), so that the 8 rows an
// ldmatrix phase reads (from a multiple of 8 on) hit all 32 banks.
__device__ __forceinline__ int tb_off(int r, int p) { return r * 64 + ((p ^ ((r >> 1) & 3)) << 4); }

// The lane's row and piece in the four 8x8 matrices of an ldmatrix.x4 over
// rows r0.. and pieces p0.. of a tile (r0 a multiple of 8): r() takes the
// matrices (r0, p0), (r0 + 8, p0), (r0, p0 + 1), (r0 + 8, p0 + 1), c() takes
// (r0, p0), (r0, p0 + 1), (r0 + 8, p0), (r0 + 8, p0 + 1).
struct TbLane {
  int rr, pr, rc, pc;
  __device__ explicit TbLane(int lane)
      : rr((lane & 7) + 8 * ((lane >> 3) & 1)), pr(lane >> 4),
        rc((lane & 7) + 8 * (lane >> 4)), pc((lane >> 3) & 1) {}
  __device__ int r(int r0, int p0) const { return tb_off(r0 + rr, p0 + pr); }
  __device__ int c(int r0, int p0) const { return tb_off(r0 + rc, p0 + pc); }
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float bf16_lo(unsigned p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(unsigned p) { return __uint_as_float(p & 0xffff0000u); }

// A 16 x 32 bf16 matrix of a sub-tile is held as unsigned m[2][4]: the A
// fragments of its two k16 steps (mma.m16n8k16), m[k][0..3] its 8x8 blocks
// (rows 0-7, columns 16 k..), (8-15, 16 k..), (0-7, 16 k + 8..), (8-15,
// 16 k + 8..).  An accumulator's n8 tile j, row half h rounds to the
// block m[j / 2][2 (j % 2) + h].

// acc = a . B, each n8 tile summed from zero in k16 steps in order; b: B's
// fragments, b[k][p] those of k16 step k and n8 tiles 2 p, 2 p + 1, all
// loaded before the first product.
__device__ __forceinline__ void tb_mma(const unsigned (&a)[2][4], const unsigned (&b)[2][2][4],
                                       float (&acc)[4][4]) {
  zero_acc(acc);
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      mma_bf16(acc[2 * p], a[k], b[k][p][0], b[k][p][1]);
      mma_bf16(acc[2 * p + 1], a[k], b[k][p][2], b[k][p][3]);
    }
}

// W's B fragments for both k16 steps and all four n8 tiles (b[k][p]: k16
// step k, n8 tiles 2 p and 2 p + 1), by ldmatrix.trans of its tile.
__device__ __forceinline__ void tb_weight_frags(unsigned u_w, const TbLane& ln,
                                                unsigned (&b)[2][2][4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int p = 0; p < 2; ++p) ldmatrix_x4_trans(b[k][p], u_w + ln.r(16 * k, 2 * p));
}

// out = bf16(act(in . W + b)): each n8 tile summed from zero in k16 steps
// in order, the f32 bias added after, as the wmma bodies sum; b: W's B
// fragments (tb_weight_frags), bias[j]: the lane's bias columns 8 j + 2 t4
// and + 1.
template <int kA>
__device__ __forceinline__ void tb_layer(const unsigned (&in)[2][4], const unsigned (&b)[2][2][4],
                                         const float2 (&bias)[4], int code,
                                         unsigned (&out)[2][4]) {
  float acc[4][4];
  tb_mma(in, b, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      out[j >> 1][2 * (j & 1) + h] = pack_bf16(fixed_act<kA>(code, acc[j][2 * h] + bias[j].x),
                                               fixed_act<kA>(code, acc[j][2 * h + 1] + bias[j].y));
}

// The three weight tiles into their swizzled layout at s_w, one after the
// other, rounded to bf16 from the f32 parameters (as the wmma bodies' caller
// rounds them), W0's rows past c0 zero; by all threads of the block.
__device__ inline void tb_stage_weights(unsigned char* s_w, const float* const (&w)[3], int c0) {
  for (int i = threadIdx.x; i < 3 * kTbW * kTbW; i += blockDim.x) {
    const int l = i / (kTbW * kTbW), r = i / kTbW % kTbW, col = i % kTbW;
    const float v = l > 0 || r < c0 ? w[l][r * kTbW + col] : 0.0f;
    *reinterpret_cast<bf16*>(s_w + l * kTbWTile + tb_off(r, col >> 3) + 2 * (col & 7)) =
        __float2bfloat16(v);
  }
}

// Rows [0, rows) of a (., c) bf16 row-major matrix (src: the slab's first
// row) into a stage tile, by the warp: with c = 32 and src on 16 bytes, by
// 16-byte cp.asyncs straight into the swizzled layout (rows past `rows`
// zero-filled); otherwise the span as it lies, flat from the tile's start,
// 16 bytes a cp.async where src starts on 16 bytes (the last piece
// zero-filled past the span) and 2 bytes a load where it does not, for
// tb_unpack once it has landed.
__device__ inline void tb_land(unsigned char* tile, const bf16* src, int rows, int c, bool vec,
                               int lane) {
  const unsigned u = smem_addr(tile);
  if (vec && c == kTbW) {
#pragma unroll
    for (int k = 0; k < kTbRows * 4 / 32; ++k) {
      const int i = lane + 32 * k, r = i >> 2, p = i & 3;
      cp_async16_zfill(u + tb_off(r, p), r < rows ? src + r * kTbW + 8 * p : src,
                       r < rows ? 16 : 0);
    }
  } else if (vec) {
    const int bytes = 2 * rows * c;
    for (int i = lane; 16 * i < bytes; i += 32)
      cp_async16_zfill(u + 16 * i, reinterpret_cast<const char*>(src) + 16 * i,
                       min(16, bytes - 16 * i));
  } else {
    bf16* d = reinterpret_cast<bf16*>(tile);
    for (int i = lane; i < rows * c; i += 32) d[i] = src[i];
  }
}

// The flat span of `rows` rows of c values at the tile's start, moved in
// place into the swizzled layout (columns past c and rows past `rows`
// zero), by the warp: groups of 8 rows from the last, each read whole
// before it is written, so that a group's writes (bytes 512 q on) never
// reach the span of the groups still to be read (below byte 16 c q).
__device__ inline void tb_unpack(unsigned char* tile, int rows, int c, int lane) {
  const unsigned short* f = reinterpret_cast<const unsigned short*>(tile);
  for (int q = kTbRows / 8 - 1; q >= 0; --q) {
    unsigned short v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * q + i;
      v[i] = r < rows && lane < c ? f[r * c + lane] : (unsigned short)0;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<unsigned short*>(tile + tb_off(8 * q + i, lane >> 3) + 2 * (lane & 7)) =
          v[i];
    __syncwarp();
  }
}

// Rows [0, rows) of a swizzled tile (c <= 32 columns) to dst, the slab's
// first row of a (., c) row-major output, by the warp: with vec (dst on 16
// bytes) in 16-byte stores, whole rows for c = 32, else the flat span in
// pieces gathered from the tile (a partial last piece by 2-byte stores);
// without, 2 bytes a store.
__device__ inline void tb_store(bf16* dst, const unsigned char* tile, int rows, int c, bool vec,
                                int lane) {
  if (vec && c == kTbW) {
    for (int i = lane; i < rows * 4; i += 32) {
      const int r = i >> 2, p = i & 3;
      reinterpret_cast<uint4*>(dst + r * kTbW)[p] =
          *reinterpret_cast<const uint4*>(tile + tb_off(r, p));
    }
    return;
  }
  auto at = [&](int e) -> unsigned {
    const int r = e / c, col = e % c;
    return *reinterpret_cast<const unsigned short*>(tile + tb_off(r, col >> 3) + 2 * (col & 7));
  };
  const int len = rows * c, full = vec ? len / 8 : 0;
  for (int i = lane; i < full; i += 32) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = at(8 * i + 2 * k) | at(8 * i + 2 * k + 1) << 16;
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int e = 8 * full + lane; e < len; e += 32)
    reinterpret_cast<unsigned short*>(dst)[e] = (unsigned short)at(e);
}

}  // namespace wcmc
