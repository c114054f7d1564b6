// Hopper warpgroup-MMA helpers shared by K1 (frontend.cu), K2
// (fingerprint.cu) and K4's packed body (coarse.cu), sm_90a: shared-memory
// descriptors of no-swizzle K-major operands, the wgmma fences and groups, the
// m64n128k16 bf16 product, the m64n96k32 s8 product, and the split of float32
// values into three bf16 parts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

// Shared-memory writes of this thread (st.shared, cp.async) made visible to
// the tensor cores' reads (the async proxy); a barrier then orders them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a no-swizzle K-major operand starting at p (16-byte aligned):
// the next core matrix (8 rows x 16 bytes, 128 contiguous bytes) along K is
// lbo bytes on, along the rows sbo bytes on.
__device__ __forceinline__ unsigned long long wgmma_desc(const void* p, unsigned lbo,
                                                         unsigned sbo) {
  return (unsigned long long)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((unsigned long long)(lbo >> 4) << 16) | ((unsigned long long)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of d across an asynchronous
// wgmma's issue or wait.
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 f32, the warpgroup's fragment) = A (64 x 16) * B (16 x 128)
// (+ d when accumulate), both bf16 operands read from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], unsigned long long da,
                                                 unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 96 s32, the warpgroup's fragment) = A (64 x 32) * B (32 x 96) (+ d
// when accumulate), both s8 operands K-major in shared memory. Thread l of
// warp w holds rows 16 w + l / 4 (+ 8) and columns 8 n + 2 (l % 4) (+ 1):
// d[4 n + 2 h + e] is row 16 w + 8 h + l / 4, column 8 n + 2 (l % 4) + e.
__device__ __forceinline__ void wgmma_m64n96k32_s8(int (&d)[48], unsigned long long da,
                                                   unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Two floats -> their (h, m, l) bf16 parts, each pair packed low element
// first: h = bf16(x), m = bf16(x - h), l = bf16(x - h - m), each rounded to
// nearest even; the differences are exact in float32.
__device__ __forceinline__ void split3(float2 x, unsigned& h, unsigned& m, unsigned& l) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x.x), h1 = __float2bfloat16_rn(x.y);
  const float r0 = x.x - __bfloat162float(h0), r1 = x.y - __bfloat162float(h1);
  const __nv_bfloat16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(r0 - __bfloat162float(m0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(r1 - __bfloat162float(m1));
  h = (unsigned)__bfloat16_as_ushort(h0) | ((unsigned)__bfloat16_as_ushort(h1) << 16);
  m = (unsigned)__bfloat16_as_ushort(m0) | ((unsigned)__bfloat16_as_ushort(m1) << 16);
  l = (unsigned)__bfloat16_as_ushort(l0) | ((unsigned)__bfloat16_as_ushort(l1) << 16);
}

}  // namespace
