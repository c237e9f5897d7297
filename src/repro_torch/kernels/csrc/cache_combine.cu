// K1, K4 and K7: the cache combine (the paper's Feature Duplicator, run on
// the device), single-buffered, multi-buffered and the legacy baseline.
//
//   out[i] = cache[slots[i]]        if slots[i] >= 0
//            miss[miss_index[i]]    otherwise
//
// K1 replaces the TPU kernel repro/kernels/gather_scatter_mm.py:
// cache_combine_tiled_kernel_call (body _cache_combine_tiled_kernel) and its
// host schedule repro/kernels/ops.py:_assemble_tiled.
//
// What bounds all three on Hopper: bytes.  Every output row is written once
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
//
// K4 replaces cache_combine_pipelined_kernel_call (body
// _cache_combine_pipelined_kernel), the TPU combine that keeps `depth` (2..4)
// windows in VMEM and starts each window's DMA `depth` tiles ahead.  Its
// function is K1's; its window and one-hot product are dropped for K1's
// reasons.  What it keeps is the copy ring: a persistent grid of at most four
// blocks per SM walks 8-row output blocks, one warp per output row.  Each
// warp reads its row's two table entries and cp.asyncs the source row (from
// the cache or the miss block) into ring slot k % depth; one commit group per
// output block, empty past the end, so `__pipeline_wait_prior(depth - 1)`
// always means "block k has landed".  The block then writes its 8 rows to
// `out`, which are contiguous there, as one coalesced copy, while the gathers
// of the next depth - 1 blocks are in flight.  The ring needs depth * 8 * row
// bytes of shared memory (12.8 KB at depth 4 for 100 f32 features); the
// wrapper refuses a ring over 227 KB and the launcher opts in above 48 KB.
// cp.async copies 4, 8 or 16 bytes, so units below 4 bytes (odd bf16 rows)
// are staged with plain loads.  Bit-equal to K1 at every depth.
//
// K7 replaces cache_combine_kernel_call (body _cache_combine_kernel), the
// legacy one-row-per-grid-step combine with the (sel, row) tables:
//
//   out[i] = cache[row[i]]   if sel[i] == 0
//            miss[row[i]]    otherwise
//
// It lies on no path of the trainer (the reference keeps it as a parity
// baseline) and is K1's warp-per-row copy with the other table contract.
#include "common.cuh"

#include <cuda_pipeline.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // K1, K7: output rows per block
constexpr int kRowBlock = 8;       // K4: output rows per staged block
constexpr int kMaxBlocksPerSm = 4;

template <typename V>
__device__ __forceinline__ const V* source_row(
    const V* cache, const V* miss, const int32_t* slots,
    const int32_t* miss_index, int64_t row, int64_t units) {
  const int32_t s = slots[row];  // one address per warp: a broadcast load
  return (s >= 0 && cache != nullptr)
             ? cache + static_cast<int64_t>(s) * units
             : miss + static_cast<int64_t>(miss_index[row]) * units;
}

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
  const V* src = source_row(cache, miss, slots, miss_index, row, units);
  V* dst = out + row * units;
  for (int64_t u = lane; u < units; u += 32) dst[u] = __ldg(src + u);
}

template <typename V, int kDepth>
__global__ void __launch_bounds__(kRowBlock * 32)
combine_rows_pipelined_kernel(const V* __restrict__ cache,
                              const V* __restrict__ miss,
                              const int32_t* __restrict__ slots,
                              const int32_t* __restrict__ miss_index,
                              V* __restrict__ out, int64_t n,
                              int64_t n_blocks, int64_t units) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  V* ring = reinterpret_cast<V*>(ring_bytes);
  const int64_t block_units = kRowBlock * units;  // one output block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this block's output blocks: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int64_t first = blockIdx.x;
  const int64_t stride = gridDim.x;
  const int64_t n_mine =
      first < n_blocks ? (n_blocks - 1 - first) / stride + 1 : 0;

  auto stage = [&](int64_t k) {  // my k-th block's rows -> ring slot k % depth
    const int64_t row = (first + k * stride) * kRowBlock + warp;
    if (row >= n) return;  // the ragged last block
    const V* src = source_row(cache, miss, slots, miss_index, row, units);
    V* dst = ring + (k % kDepth) * block_units + warp * units;
    for (int64_t u = lane; u < units; u += 32) {
      if constexpr (sizeof(V) >= 4) {
        __pipeline_memcpy_async(dst + u, src + u, sizeof(V));
      } else {
        dst[u] = __ldg(src + u);
      }
    }
  };

  for (int k = 0; k < kDepth; ++k) {
    if (k < n_mine) stage(k);
    __pipeline_commit();
  }
  for (int64_t k = 0; k < n_mine; ++k) {
    __pipeline_wait_prior(kDepth - 1);
    __syncthreads();  // every warp's copies of block k are visible
    const int64_t row0 = (first + k * stride) * kRowBlock;
    const int64_t rows = n - row0 < kRowBlock ? n - row0 : kRowBlock;
    const V* src = ring + (k % kDepth) * block_units;
    V* dst = out + row0 * units;  // the block's rows are contiguous in out
    for (int64_t u = threadIdx.x; u < rows * units; u += blockDim.x)
      dst[u] = src[u];
    __syncthreads();  // slot k % depth is free again
    if (k + kDepth < n_mine) stage(k + kDepth);
    __pipeline_commit();
  }
}

template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
combine_legacy_kernel(const V* __restrict__ cache, const V* __restrict__ miss,
                      const int32_t* __restrict__ sel,
                      const int32_t* __restrict__ row_of,
                      V* __restrict__ out, int64_t n, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const V* src = (sel[i] == 0 ? cache : miss) +
                 static_cast<int64_t>(row_of[i]) * units;
  V* dst = out + i * units;
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

template <typename V, int kDepth>
cudaError_t launch_pipelined(const void* cache, const void* miss,
                             const int32_t* slots, const int32_t* miss_index,
                             void* out, int64_t n, int64_t row_bytes,
                             cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t n_blocks = ceil_div(n, kRowBlock);
  const int64_t smem = kDepth * kRowBlock * row_bytes;
  auto kernel = combine_rows_pipelined_kernel<V, kDepth>;
  cudaError_t err;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int64_t grid = 0;
  err = persistent_grid(n_blocks, kMaxBlocksPerSm, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), kRowBlock * 32,
           static_cast<size_t>(smem), stream>>>(
      static_cast<const V*>(cache), static_cast<const V*>(miss), slots,
      miss_index, static_cast<V*>(out), n, n_blocks, units);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_legacy(const void* cache, const void* miss,
                          const int32_t* sel, const int32_t* row_of,
                          void* out, int64_t n, int64_t row_bytes,
                          cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t blocks = ceil_div(n, kWarpsPerBlock);
  combine_legacy_kernel<V><<<static_cast<unsigned>(blocks),
                             kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const V*>(cache), static_cast<const V*>(miss), sel, row_of,
      static_cast<V*>(out), n, units);
  return cudaGetLastError();
}

int combine(const void* cache, const void* miss, const int32_t* slots,
            const int32_t* miss_index, void* out, int64_t n, int64_t row_bytes,
            void* stream) {
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = as_stream(stream);
  return static_cast<int>(
      with_unit(copy_unit(row_bytes, out, cache, miss), [&](auto unit) {
        return launch<decltype(unit)>(cache, miss, slots, miss_index, out, n,
                                      row_bytes, st);
      }));
}

int combine_pipelined(const void* cache, const void* miss,
                      const int32_t* slots, const int32_t* miss_index,
                      void* out, int64_t n, int64_t row_bytes, int depth,
                      void* stream) {
  // depth 1 is K1's work: the wrapper launches K1 there
  if (depth < 2 || depth > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = as_stream(stream);
  return static_cast<int>(
      with_unit(copy_unit(row_bytes, out, cache, miss), [&](auto unit) {
        using V = decltype(unit);
        switch (depth) {
          case 2:
            return launch_pipelined<V, 2>(cache, miss, slots, miss_index, out,
                                          n, row_bytes, st);
          case 3:
            return launch_pipelined<V, 3>(cache, miss, slots, miss_index, out,
                                          n, row_bytes, st);
          default:
            return launch_pipelined<V, 4>(cache, miss, slots, miss_index, out,
                                          n, row_bytes, st);
        }
      }));
}

int combine_legacy(const void* cache, const void* miss, const int32_t* sel,
                   const int32_t* row_of, void* out, int64_t n,
                   int64_t row_bytes, void* stream) {
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = as_stream(stream);
  return static_cast<int>(
      with_unit(copy_unit(row_bytes, out, cache, miss), [&](auto unit) {
        return launch_legacy<decltype(unit)>(cache, miss, sel, row_of, out, n,
                                             row_bytes, st);
      }));
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

// K4: the same contract as K1, through a ring of `depth` (2..4) blocks.
REPRO_API int cache_combine_pipelined_f32(const void* cache, const void* miss,
                                          const int32_t* slots,
                                          const int32_t* miss_index,
                                          void* out, int64_t n, int64_t f,
                                          int depth, void* stream) {
  return combine_pipelined(cache, miss, slots, miss_index, out, n, f * 4,
                           depth, stream);
}

REPRO_API int cache_combine_pipelined_bf16(const void* cache,
                                           const void* miss,
                                           const int32_t* slots,
                                           const int32_t* miss_index,
                                           void* out, int64_t n, int64_t f,
                                           int depth, void* stream) {
  return combine_pipelined(cache, miss, slots, miss_index, out, n, f * 2,
                           depth, stream);
}

// K7: cache [K, f], miss [M, f] (both non-null); sel / row int32 [n].
REPRO_API int cache_combine_legacy_f32(const void* cache, const void* miss,
                                       const int32_t* sel,
                                       const int32_t* row, void* out,
                                       int64_t n, int64_t f, void* stream) {
  return combine_legacy(cache, miss, sel, row, out, n, f * 4, stream);
}

REPRO_API int cache_combine_legacy_bf16(const void* cache, const void* miss,
                                        const int32_t* sel,
                                        const int32_t* row, void* out,
                                        int64_t n, int64_t f, void* stream) {
  return combine_legacy(cache, miss, sel, row, out, n, f * 2, stream);
}

REPRO_API const char* cache_combine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
