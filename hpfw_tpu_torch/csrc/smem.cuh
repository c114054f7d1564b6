// The shared-memory address of a generic pointer, for the PTX of the kernels'
// helper headers (mma_s8.cuh, wgmma.cuh), which a source may include together.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

}  // namespace
