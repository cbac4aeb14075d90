// Hopper (sm_90a) building blocks shared by the hand-written kernels:
// 16- and 4-byte cp.async copies, mbarriers, 1-D bulk copies from device to
// shared memory and back (no tensor map), ldmatrix, movmatrix, mma.sync, wgmma
// descriptors, fences and products (m64 n16 / n48 / n64 / n128 with both
// operands in shared memory; m64 n64 / n128 with A from registers), named
// barriers.
// Addresses in shared memory are shared-window (32-bit) addresses.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace wcmc {

// the shared-window address of a pointer into shared memory
__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory the block was launched with, in bytes
__device__ inline unsigned dynamic_smem_size() {
  unsigned r;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(r));
  return r;
}

// 16 bytes, of which the first src_bytes are read and the rest zero-filled
__device__ inline void cp_async16_zfill(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes, of which the first src_bytes (0 or 4) are read and the rest zero-filled
__device__ inline void cp_async4_zfill(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// until at most N of the thread's cp.async groups are pending
template <int N>
__device__ inline void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an arrive on the mbarrier once the thread's earlier cp.asyncs have
// completed, counted as one of its expected arrivals
__device__ inline void cp_async_mbar_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// an arrive on the mbarrier (release: the thread's earlier writes to shared
// memory are seen by the threads that wait on the phase)
__device__ inline void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ inline void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ inline void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ inline void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, counted against the mbarrier's transaction count
__device__ inline void bulk_copy(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from shared to
// device memory, in the thread's current bulk group; the writes to shared
// memory it reads must be ordered before it by fence_proxy_async
__device__ inline void bulk_store(void* dst, unsigned src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ inline void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// until at most N of the thread's bulk groups still read their shared memory
template <int N>
__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until at most N of the thread's bulk groups are pending
template <int N>
__device__ inline void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory (each lane gives one row's
// address): a warp's 16 x 16 slice of the A operand of a wgmma, in the
// layout of mma.m16n8k16's A fragment.
__device__ inline void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same with each 8x8 matrix transposed: a lane then holds element
// (2 (lane % 4) + {0, 1}, lane / 4) of its matrix.
__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// An 8x8 bf16 matrix held by the warp in the layout of an ldmatrix result
// (lane: row lane / 4, columns 2 (lane % 4) and + 1, one 32-bit register),
// transposed in registers: the lane then holds its transpose's elements.
__device__ inline unsigned movmatrix_trans(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

template <bool kTrans>
__device__ inline void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  if constexpr (kTrans) {
    ldmatrix_x4_trans(r, addr);
  } else {
    ldmatrix_x4(r, addr);
  }
}

// d += a . b for one warp: mma.m16n8k16, bf16 in, f32 accumulation; a the
// four registers of the A fragment, b0 / b1 the B fragment's k halves.
__device__ inline void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// orders this thread's generic writes to shared memory before later
// accesses of the async proxy (bulk copies, wgmma operand reads)
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor of a wgmma operand without swizzle:
// 8 x 8 core matrices of 128 contiguous bytes, lbo bytes apart along K and
// sbo bytes apart along M or N (given in bytes, stored in 16-byte units).
__device__ inline uint64_t smem_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
template <int kN8>
__device__ inline void fence_acc(float (&d)[kN8][4]) {
#pragma unroll
  for (int j = 0; j < kN8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

template <int kN8>
__device__ inline void zero_acc(float (&acc)[kN8][4]) {
#pragma unroll
  for (int j = 0; j < kN8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
}

// d += A . B for the warpgroup: wgmma m64n64k16, bf16 in, f32 accumulation,
// A and B from shared memory through descriptors; kTA / kTB: the operand
// is stored M- / N-major (transposed), else K-major.
template <int kTA, int kTB>
__device__ inline void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

// d += A . B for the warpgroup: wgmma m64n128k16, bf16 in, f32 accumulation,
// A and B from shared memory through descriptors; kTA / kTB: the operand
// is stored M- / N-major (transposed), else K-major.
template <int kTA, int kTB>
__device__ inline void wgmma_ss_n128(float (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

// a barrier of `threads` threads (a multiple of 32) on named barrier `id`
__device__ inline void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d += A . B for the warpgroup: wgmma m64n48k16, as wgmma_ss_n64, into
// the first 6 n8 tiles of d.
template <int kTA, int kTB, int kN8>
__device__ inline void wgmma_ss_n48(float (&d)[kN8][4], uint64_t a, uint64_t b) {
  static_assert(kN8 >= 6, "m64n48 needs 6 n8 tiles of accumulators");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

// d += A . B for the warpgroup: wgmma m64n16k16, as wgmma_ss_n64, into
// 2 n8 tiles of d.
template <int kTA, int kTB>
__device__ inline void wgmma_ss_n16(float (&d)[2][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(a), "l"(b), "r"(1), "n"(kTA), "n"(kTB));
}

// acc (kN8 n8 tiles) += A . B over kK16 k16 steps, for this warpgroup's
// 64 rows, on wgmma: A and B blocked bf16 tiles (8 x 8 core matrices) in
// shared memory, kARG / kBRG bytes between their 8-row groups, a and b
// the addresses of the warpgroup's first row of A and first column of B
// at k = 0.  kTA: A is stored transposed ([k][m], read with its rows
// along K), else [m][k]; kTB: B is stored [k][n], else [n][k].  The
// caller brackets a group of products with wgmma_fence / commit / wait.
template <int kN8, int kK16, bool kTA, int kARG, bool kTB, int kBRG, int kAcc>
__device__ inline void mm(float (&acc)[kAcc][4], unsigned a, unsigned b) {
  const uint64_t da = kTA ? smem_desc(a, kARG, 128) : smem_desc(a, 128, kARG);
  const uint64_t db = kTB ? smem_desc(b, kBRG, 128) : smem_desc(b, 128, kBRG);
  constexpr int kAStep = kTA ? 2 * kARG : 256, kBStep = kTB ? 2 * kBRG : 256;
#pragma unroll
  for (int ks = 0; ks < kK16; ++ks) {
    const uint64_t sa = da + (uint64_t)((ks * kAStep) >> 4);
    const uint64_t sb = db + (uint64_t)((ks * kBStep) >> 4);
    if constexpr (kN8 == 2) {
      static_assert(kAcc == 2, "m64n16 into 2 n8 tiles");
      wgmma_ss_n16<kTA, kTB>(acc, sa, sb);
    } else if constexpr (kN8 == 6) {
      wgmma_ss_n48<kTA, kTB>(acc, sa, sb);
    } else if constexpr (kN8 == 8) {
      wgmma_ss_n64<kTA, kTB>(acc, sa, sb);
    } else {
      static_assert(kN8 == 16 && kAcc == 16, "m64 n16, n48, n64 or n128");
      wgmma_ss_n128<kTA, kTB>(acc, sa, sb);
    }
  }
}

// Keeps the compiler from reusing the registers of A fragments that an
// asynchronous product still reads.
template <int kK16>
__device__ inline void fence_frag(unsigned (&a)[kK16][4]) {
#pragma unroll
  for (int k = 0; k < kK16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d += A . B for the warpgroup: wgmma m64n64k16, bf16 in, f32 accumulation,
// A from registers (the warp's 16 rows in the layout of mma.m16n8k16's A
// fragment, which is that of a wgmma accumulator's k16 slice: two n8
// tiles of a layer's output, rounded to bf16 pairs, are the next layer's
// A), B from shared memory through a descriptor; kTB: B is stored
// N-major (transposed), else K-major.
template <int kTB>
__device__ inline void wgmma_rs_n64(float (&d)[8][4], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTB));
}

// d += A . B for the warpgroup: wgmma m64n128k16, A from registers, as
// wgmma_rs_n64.
template <int kTB>
__device__ inline void wgmma_rs_n128(float (&d)[16][4], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTB));
}

// acc (kN8 = 8 or 16 n8 tiles) += A . B over kK16 k16 steps on wgmma, A
// the warpgroup's 64 rows as kK16 register fragments, B a blocked bf16
// matrix stored [k][n] in shared memory (8 x 8 core matrices, kBRG bytes
// between its 8-row groups along K), b the address of its first column
// at k = 0.  The caller brackets the products with wgmma_fence / commit /
// wait and keeps a live (fence_frag) until the wait.
template <int kN8, int kK16, int kBRG>
__device__ inline void mm_rs(float (&acc)[kN8][4], const unsigned (&a)[kK16][4], unsigned b) {
  const uint64_t db = smem_desc(b, kBRG, 128);
#pragma unroll
  for (int ks = 0; ks < kK16; ++ks) {
    const uint64_t sb = db + (uint64_t)((ks * 2 * kBRG) >> 4);
    if constexpr (kN8 == 8) {
      wgmma_rs_n64<1>(acc, a[ks], sb);
    } else {
      static_assert(kN8 == 16, "m64 n64 or n128");
      wgmma_rs_n128<1>(acc, a[ks], sb);
    }
  }
}

}  // namespace wcmc
