// Hopper's bulk-copy engine (TMA) and shared-memory barriers (mbarrier),
// used by K2's and K4's ring bodies (fused_update.cu, cache_combine.cu) and
// K8's bf16 bodies (flash_attention.cu, flash_attention_bwd.cu).
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
//                                     before its next bulk copy or wgmma
//   tma_load_4d                       cp.async.bulk.tensor: one box of a
//                                     4-D tensor map at coordinates
//                                     (c0 innermost .. c3) into shared
//                                     memory, in the map's swizzle,
//                                     elements outside the tensor zero;
//                                     completes the box's whole bytes on a
//                                     barrier
//   tma_load_5d                       the same over a 5-D tensor map
//   encode_tensor_map_4d / _5d (host) cuTensorMapEncodeTiled for a bf16
//                                     4-D / 5-D tensor, taken from the driver
//                                     through the runtime's entry-point
//                                     query (CUDA 12.5 on), so no library
//                                     links -lcuda
//
// A phase completes when its pending arrivals reach zero and every byte it
// expects has landed; the barrier then moves to the next phase, whose
// parity is flipped.  Bulk copies need 16-byte aligned addresses on both
// sides and a size that is a multiple of 16.
#pragma once

#include <cuda.h>
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

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global."
      "mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global."
      "mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_addr(bar))
      : "memory");
}

// A bf16 tensor of dims[0] (innermost, contiguous) x dims[1..R-1] with byte
// strides strides[0..R-2] of dims 1..R-1, read in boxes of box[0..R-1]
// elements with `swizzle_bytes` (32, 64 or 128) swizzle; elements outside
// the tensor read as zero.  Returns cudaErrorInvalidValue where the driver
// refuses the map (alignment, strides, box) or has no such entry point.
template <int R>
static inline cudaError_t encode_tensor_map(CUtensorMap* map,
                                            const void* base,
                                            const uint64_t (&dims)[R],
                                            const uint64_t (&strides)[R - 1],
                                            const uint32_t (&box)[R],
                                            int swizzle_bytes) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return cudaErrorInvalidValue;
  cuuint64_t dim[R], stride[R - 1];
  cuuint32_t boxes[R], unit[R];
  for (int i = 0; i < R; ++i) {
    dim[i] = dims[i];
    boxes[i] = box[i];
    unit[i] = 1;
    if (i + 1 < R) stride[i] = strides[i];
  }
  const CUtensorMapSwizzle swizzle =
      swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(base), dim,
      stride, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

static inline cudaError_t encode_tensor_map_4d(CUtensorMap* map,
                                               const void* base,
                                               const uint64_t (&dims)[4],
                                               const uint64_t (&strides)[3],
                                               const uint32_t (&box)[4],
                                               int swizzle_bytes) {
  return encode_tensor_map<4>(map, base, dims, strides, box, swizzle_bytes);
}

static inline cudaError_t encode_tensor_map_5d(CUtensorMap* map,
                                               const void* base,
                                               const uint64_t (&dims)[5],
                                               const uint64_t (&strides)[4],
                                               const uint32_t (&box)[5],
                                               int swizzle_bytes) {
  return encode_tensor_map<5>(map, base, dims, strides, box, swizzle_bytes);
}
