// Asynchronous global -> shared copies (cp.async, sm_80+), and the bulk
// copies of the Tensor Memory Accelerator (sm_90) with their mbarriers,
// shared by the kernels that stage time chunks of row-major signals in
// shared memory.
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

// Bulk copies by the Tensor Memory Accelerator (sm_90): one thread moves
// a contiguous run of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) without a register or an instruction per element. A load
// completes on an mbarrier in shared memory, whose phase ends when its
// arrivals and the bytes it expects have all come in.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// Makes mbarrier inits visible to the async proxy (the bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more of this phase's loads.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The box of a 2-D tensor map (a CUtensorMap kernel parameter) at
// element coordinates (x inner, y outer) into shared memory, completing
// on `bar`; elements outside the tensor read as zero.
__device__ __forceinline__ void tensor_load_2d(void* dst, const void* map,
                                               int x, int y,
                                               unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// The box at (x, y) of a 2-D tensor map from shared memory, in this
// thread's current bulk group; elements outside the tensor are dropped.
__device__ __forceinline__ void tensor_store_2d(const void* map, int x, int y,
                                                const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}],"
      " [%3];\n" ::"l"(map),
      "r"(x), "r"(y), "r"(smem_addr(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's bulk groups are still
// reading their shared-memory sources.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// Wait until this thread's bulk stores have all completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later bulk copies
// (the async proxy) read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace xm
