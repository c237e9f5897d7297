// Hopper's bulk-copy engine (TMA) and shared-memory barriers (mbarrier),
// used by K2's and K4's ring bodies (fused_update.cu, cache_combine.cu).
//
//   mbar_init / fence_mbarrier_init   one thread sets a barrier's arrival
//                                     count; the fence publishes it
//   mbar_arrive                       one arrival on the current phase
//   mbar_arrive_warp                  one arrival for a whole warp, once
//                                     all its lanes are done (__syncwarp)
//   mbar_arrive_expect_tx             one arrival that also expects `bytes`
//                                     of bulk copies to complete on it
//   mbar_wait                         spin until the phase of parity
//                                     `parity` has completed (try_wait)
//   bulk_load                         cp.async.bulk global -> shared of
//                                     `bytes`, completing on a barrier
//   bulk_store                        cp.async.bulk shared -> global of
//                                     `bytes`, tracked by bulk groups
//   bulk_commit / bulk_wait_read<N>   close a bulk group / wait until at
//                                     most N groups still read shared
//                                     memory
//   bulk_wait<N>                      ... until at most N groups have not
//                                     finished writing
//   fence_proxy_async                 order this thread's view of shared
//                                     memory (generic writes it observed)
//                                     before its next bulk copy
//
// A phase completes when its pending arrivals reach zero and every byte it
// expects has landed; the barrier then moves to the next phase, whose
// parity is flipped.  Bulk copies need 16-byte aligned addresses on both
// sides and a size that is a multiple of 16.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}
