// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), shared by the rings of K1 (k1_sweep.cuh)
// and K2 (quant_candidates.cu). A copy of fewer than 16 source bytes
// zero-fills the rest, so a row or column past the edge of a matrix stages
// as zeros.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
