// Split TF32 ("3xTF32") on the tensor cores, shared by the f32 bodies that
// run their products there (conv5_tf32.cu, pathnet_head_bwd_tf32.cu,
// pathnet_head_tf32.cu, pathnet_embed_bwd_tf32.cu), and the mma.sync
// fragment helpers of the three PathNet bodies.
//
// An f32 value a is split into hi = tf32(a) and lo = tf32(a - hi), each
// rounded to nearest with ties away from zero (cvt.rna.tf32.f32); a - hi is
// exact in f32, and |lo| <= 2^-11 |a|.  A product a . b is then taken as
// lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, the three on the tensor cores in
// that order (the two small terms first, so they are not lost under the
// large one), and only lo_a . lo_b (~2^-22 |a b|) is dropped: about f32's
// accuracy at a third of the tensor cores' TF32 rate, 165 TFLOP/s on an H100
// against the CUDA cores' 67.  The tensor cores add into their f32
// accumulator with truncation, up to an ulp of the accumulator a product and
// always toward zero: K6's products summed into one running accumulator
// over its K of 2,600 read 1.8e-5 from an f64 convolution on an H100 in
// relative L2, 36x cuDNN's f32 error (chip_parts.py k6).  So every product
// (K6's, and each of K5-bwd's, its weight gradients summed over a block's
// whole walk the longest) takes each k8 step's three products into a
// partial from zero, added to the running sum by one f32 add (round to
// nearest): the truncation is then of the small partial, once a step (K6:
// 3.4e-7 from f64).  A tf32 value is an f32 bit pattern whose low 13 bits
// are zero; the weights are split once by the wrapper (ops/_tf32.py, the
// same rounding on the bits), the activations here as they are loaded.
#pragma once

#include "common.cuh"

namespace wcmc {

// tf32(a): a rounded to 10 explicit mantissa bits, nearest, ties away from
// zero, as an f32 bit pattern (low 13 bits zero)
__device__ inline unsigned tf32_rna(float a) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r & 0xffffe000u;
}

// hi = tf32(a), lo = tf32(a - hi)
__device__ inline void split_tf32(float a, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a . b for one warp: mma.m16n8k8, tf32 in, f32 accumulation.  A
// fragment: a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3
// (row g + 8, k t + 4); B fragment: b0 (k t, col g), b1 (k t + 4, col g);
// accumulator: d0, d1 (row g, cols 2t, 2t + 1), d2, d3 (row g + 8, the
// same cols); g = lane / 4, t = lane % 4.
__device__ inline void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split: hi and lo of each of its four values.
struct FragA {
  unsigned hi[4], lo[4];
  __device__ inline void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

// A B fragment split: hi of b0, b1, then lo of b0, b1 (the order the
// packed weights hold them in, 16 bytes a lane).
struct FragB {
  unsigned v[4];
  __device__ inline void set(float b0, float b1) {
    split_tf32(b0, v[0], v[2]);
    split_tf32(b1, v[1], v[3]);
  }
};

// d = a . b for one warp, the same product from a zero accumulator
__device__ inline void mma_tf32_zero(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                     unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// d += a . b in split TF32: the k8 step's partial lo . hi + hi . lo + hi .
// hi on the tensor cores from zero, then one f32 add into d.
__device__ inline void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  float t[4];
  mma_tf32_zero(t, a.lo, b.v[0], b.v[1]);
  mma_tf32(t, a.hi, b.v[2], b.v[3]);
  mma_tf32(t, a.hi, b.v[0], b.v[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// acc[mt][nt] += A[16 mt + (g, g + 8)][k] . W[k][8 (jn0 + nt) + g] over k8s
// k8 steps for the warp: A row-major in shared memory at pitch pa from the
// warp's first row, W packed in fragment order (wk8 k8 steps an n8 tile;
// ops/pathnet_fused.py's pack_b_tf32).  Each lane reads its B fragments by
// 16-byte read-only loads (L1, L2) kAhead k8 steps ahead of their products,
// so no cp.async group of the caller is waited on here.
template <int MT, int NT, int kAhead = 1>
__device__ inline void mm_rows_ldg(float (&acc)[MT][NT][4], const float* A, int pa, int k8s,
                                   const float* __restrict__ W, int wk8, int jn0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint4* wp = reinterpret_cast<const uint4*>(W) + (size_t)jn0 * wk8 * 32 + lane;
  uint4 next[kAhead][NT];
#pragma unroll
  for (int i = 0; i < kAhead; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      next[i][nt] = __ldg(wp + ((size_t)nt * wk8 + (i < k8s ? i : k8s - 1)) * 32);
  for (int ks = 0; ks < k8s; ++ks) {
    FragB b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b[nt].v[0] = next[0][nt].x, b[nt].v[1] = next[0][nt].y;
      b[nt].v[2] = next[0][nt].z, b[nt].v[3] = next[0][nt].w;
#pragma unroll
      for (int i = 0; i + 1 < kAhead; ++i) next[i][nt] = next[i + 1][nt];
    }
    if (ks + kAhead < k8s) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        next[kAhead - 1][nt] = __ldg(wp + ((size_t)nt * wk8 + ks + kAhead) * 32);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* ap = A + (16 * mt + g) * pa + 8 * ks + 2 * t;
      const float2 v0 = *reinterpret_cast<const float2*>(ap);
      const float2 v1 = *reinterpret_cast<const float2*>(ap + 8 * pa);
      FragA a;
      a.set(v0.x, v1.x, v0.y, v1.y);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma3(acc[mt][nt], a, b[nt]);
    }
  }
}

// acc[mt][nt] += sum_r A[r][m0 + 16 mt + (g, g + 8)] . B[r][n0 + 8 nt + g]
// over 8 k8s rows for the warp (a weight gradient): A and B row-major in
// shared memory at pitches pa and pb, read as A^T and B.
template <int MT, int NT>
__device__ inline void mm_rows_t(float (&acc)[MT][NT][4], const float* A, int pa, int m0,
                                 const float* B, int pb, int n0, int k8s) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int ks = 0; ks < k8s; ++ks) {
    FragB b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* bp = B + (8 * ks + t) * pb + n0 + 8 * nt + g;
      b[nt].set(bp[0], bp[4 * pb]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* ap = A + (8 * ks + t) * pa + m0 + 16 * mt + g;
      FragA a;
      a.set(ap[0], ap[8], ap[4 * pa], ap[4 * pa + 8]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma3(acc[mt][nt], a, b[nt]);
    }
  }
}

template <int MT, int NT>
__device__ inline void zero_frags(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
}

// f(row, col, value) for each accumulator of the warp's MT x NT tiles, rows
// from m0, columns from n0: (row g, cols 2t, 2t + 1), then row g + 8
template <int MT, int NT, typename F>
__device__ inline void each_frag(float (&acc)[MT][NT][4], int m0, int n0, F f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(m0 + 16 * mt + g + 8 * h, n0 + 8 * nt + 2 * t, acc[mt][nt][2 * h],
          acc[mt][nt][2 * h + 1]);
}

// acc from the row-major matrix p (ld floats a row) at the positions
// each_frag hands them out
template <int MT, int NT>
__device__ inline void load_frags(float (&acc)[MT][NT][4], int m0, int n0, const float* p,
                                  int ld) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            p + (size_t)(m0 + 16 * mt + g + 8 * h) * ld + n0 + 8 * nt + 2 * t);
        acc[mt][nt][2 * h] = v.x;
        acc[mt][nt][2 * h + 1] = v.y;
      }
}

}  // namespace wcmc
