// int8 tensor-core helpers shared by K3 (match.cu), K4 (coarse.cu) and K5
// (fine.cu), sm_90a: cp.async copies, ldmatrix, the mma.sync m16n8k32
// s8 -> s32 product, and packed bits spread into +-1 or 0/1 bytes.

#pragma once

#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

// 8 bytes from global to shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The low 4 bits of x -> 4 bytes, bit i to byte i: +1 where set, -1 where
// clear (a query's side). The multiply spreads bit i to bit 8i (the shifted
// copies do not overlap); each clear byte's 0x01 times 0xFE is 0xFE, which
// OR 0x01 makes 0xFF, with no carry between bytes.
__device__ __forceinline__ unsigned pm1_nibble(unsigned x) {
  const unsigned s = ((x & 0xFu) * 0x00204081u) & 0x01010101u;
  return 0x01010101u | ((s ^ 0x01010101u) * 0xFEu);
}

// Bits 0-3 of x -> 4 bytes, bit i to byte i as 0 or 1 (a track's side).
__device__ __forceinline__ unsigned bits01_nibble(unsigned x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

}  // namespace
