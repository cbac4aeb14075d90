// Hopper (sm_90a) building blocks shared by the hand-written kernels:
// 16-byte cp.async copies, mbarriers, 1-D bulk copies from device to
// shared memory (no tensor map), ldmatrix, mma.sync, wgmma descriptors
// and fences.
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

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// an arrive on the mbarrier once the thread's earlier cp.asyncs have
// completed, counted as one of its expected arrivals
__device__ inline void cp_async_mbar_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
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

}  // namespace wcmc
