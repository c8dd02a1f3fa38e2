// Asynchronous global -> shared copies (cp.async, sm_80+), shared by the
// kernels that stage time chunks of row-major signals in shared memory.
#pragma once

#include <cuda_runtime.h>

namespace xm {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// As cp_async4, but reads only the first `src_bytes` (0, 2 or 4) bytes
// of src and writes zeros for the rest.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 16 bytes global -> shared through L2 only (cp.async.cg); dst and src
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are
// still in flight; its own completed copies are then visible to it.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace xm
