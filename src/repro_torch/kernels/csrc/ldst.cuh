// Row-copy loads and stores with cache hints (K1's copy units).
//
// The combine reads source rows that later rows of the same call read
// again (hub rows many times) and writes an output that no kernel of the
// call reads back.  Its output is larger than the 50 MB L2, so with the
// default policy the write-allocated output lines evict source rows before
// their next use.  The loads here keep source lines in L2 (an evict_last
// policy from createpolicy, no L1 allocation: a row is read once a warp)
// and the stores stream past it (st.global.cs: evict-first lines).
//
// One overload per copy unit of common.cuh's with_unit (16, 8, 4, 2, 1
// bytes); the copies move bits, whatever the element type.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// An L2 policy that gives every line it touches evict_last priority.
__device__ __forceinline__ uint64_t l2_evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint4 load_reused(const uint4* p,
                                             uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 "
      "{%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint2 load_reused(const uint2* p,
                                             uint64_t policy) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.u32 {%0, %1}, [%2], "
      "%3;"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ unsigned load_reused(const unsigned* p,
                                                uint64_t policy) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

// the 2- and 1-byte units travel in 32-bit registers (PTX widens a narrow
// load and narrows a store): 16-bit registers cost ptxas a spill here
__device__ __forceinline__ unsigned short load_reused(
    const unsigned short* p, uint64_t policy) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u16 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return static_cast<unsigned short>(v);
}

__device__ __forceinline__ unsigned char load_reused(const unsigned char* p,
                                                     uint64_t policy) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u8 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return static_cast<unsigned char>(v);
}

__device__ __forceinline__ void store_streaming(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void store_streaming(uint2* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};"
               :: "l"(p), "r"(v.x), "r"(v.y)
               : "memory");
}

__device__ __forceinline__ void store_streaming(unsigned* p, unsigned v) {
  asm volatile("st.global.cs.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void store_streaming(unsigned short* p,
                                                unsigned short v) {
  asm volatile("st.global.cs.u16 [%0], %1;"
               :: "l"(p), "r"(static_cast<unsigned>(v))
               : "memory");
}

__device__ __forceinline__ void store_streaming(unsigned char* p,
                                                unsigned char v) {
  asm volatile("st.global.cs.u8 [%0], %1;"
               :: "l"(p), "r"(static_cast<unsigned>(v))
               : "memory");
}
