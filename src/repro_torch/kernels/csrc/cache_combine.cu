// K1: the cache combine (the paper's Feature Duplicator, run on the device).
//
// Replaces the TPU kernel repro/kernels/gather_scatter_mm.py:
// cache_combine_tiled_kernel_call (body _cache_combine_tiled_kernel) and its
// host schedule repro/kernels/ops.py:_assemble_tiled.
//
//   out[i] = cache[slots[i]]        if slots[i] >= 0
//            miss[miss_index[i]]    otherwise
//
// What bounds it on Hopper: bytes.  Every output row is written once
// (N * F * elem bytes) and each referenced source row is read (hub rows many
// times, mostly from L2); there is no arithmetic.  The TPU design sorted
// positions by source rank and expanded a 4W-row VMEM window through a
// one-hot MXU product.  Here a 4x128x128 f32 window would not fit one SM's
// shared memory, and the one-hot product is exact only for finite values, so
// the design is a direct row gather instead: one warp per output row reads
// its two table entries itself and copies the row with the widest vector
// unit (16, 8, 4, 2 or 1 bytes) that divides the row and every base
// pointer.  The copy is bitwise, so the result is bit-equal to the plain
// version for any dtype; the f32 and bf16 entry points differ only in the
// element size.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
combine_rows_kernel(const V* __restrict__ cache, const V* __restrict__ miss,
                    const int32_t* __restrict__ slots,
                    const int32_t* __restrict__ miss_index,
                    V* __restrict__ out, int64_t n, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int32_t s = slots[row];  // one address per warp: a broadcast load
  const V* src = (s >= 0 && cache != nullptr)
                     ? cache + static_cast<int64_t>(s) * units
                     : miss + static_cast<int64_t>(miss_index[row]) * units;
  V* dst = out + row * units;
  for (int64_t u = lane; u < units; u += 32) dst[u] = __ldg(src + u);
}

template <typename V>
cudaError_t launch(const void* cache, const void* miss, const int32_t* slots,
                   const int32_t* miss_index, void* out, int64_t n,
                   int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t blocks = ceil_div(n, kWarpsPerBlock);
  combine_rows_kernel<V><<<static_cast<unsigned>(blocks),
                           kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const V*>(cache), static_cast<const V*>(miss), slots,
      miss_index, static_cast<V*>(out), n, units);
  return cudaGetLastError();
}

int combine(const void* cache, const void* miss, const int32_t* slots,
            const int32_t* miss_index, void* out, int64_t n, int64_t row_bytes,
            void* stream) {
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = as_stream(stream);
  cudaError_t err;
  switch (copy_unit(row_bytes, out, cache, miss)) {
    case 16:
      err = launch<uint4>(cache, miss, slots, miss_index, out, n, row_bytes,
                          st);
      break;
    case 8:
      err = launch<uint2>(cache, miss, slots, miss_index, out, n, row_bytes,
                          st);
      break;
    case 4:
      err = launch<unsigned int>(cache, miss, slots, miss_index, out, n,
                                 row_bytes, st);
      break;
    case 2:
      err = launch<unsigned short>(cache, miss, slots, miss_index, out, n,
                                   row_bytes, st);
      break;
    default:
      err = launch<unsigned char>(cache, miss, slots, miss_index, out, n,
                                  row_bytes, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// cache may be null (the cache-less dedup path: every slot is -1); miss may
// be null only when every slot is >= 0.  slots / miss_index: int32 [n].
REPRO_API int cache_combine_f32(const void* cache, const void* miss,
                                const int32_t* slots,
                                const int32_t* miss_index, void* out,
                                int64_t n, int64_t f, void* stream) {
  return combine(cache, miss, slots, miss_index, out, n, f * 4, stream);
}

REPRO_API int cache_combine_bf16(const void* cache, const void* miss,
                                 const int32_t* slots,
                                 const int32_t* miss_index, void* out,
                                 int64_t n, int64_t f, void* stream) {
  return combine(cache, miss, slots, miss_index, out, n, f * 2, stream);
}

REPRO_API const char* cache_combine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
