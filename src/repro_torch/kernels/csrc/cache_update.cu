// K5 and K6: the refresh scatter of the dynamic hot-feature cache.
//
//   out[slots[i]] = rows[i]        for i < m   (out starts as a copy of the
//                                               cache block; slots unique)
//
// K5 replaces the TPU kernel repro/kernels/gather_scatter_mm.py:
// cache_update_kernel_call (body _cache_update_kernel); K6 replaces
// cache_update_pipelined_kernel_call (body _cache_update_pipelined_kernel).
//
// What bounds it on Hopper: bytes.  Each admitted row is read once and
// written once (plus one int32 slot), about 804 bytes a row for 100 f32
// features, and there is no arithmetic.  On the TPU the sequential grid
// gave last-writer-wins for a slot named twice; GPU blocks run in no
// order, so the wrapper (kernels/ops.py: update_cache_rows) dedupes
// keep-last on the host first and both kernels take unique slots.  Both
// copy bits, in the widest unit (16, 8, 4, 2 or 1 bytes) that divides the
// row and every base pointer, so the result is bit-equal for any dtype.
//
// K5 is one warp per admitted row: it reads the row and writes it to its
// slot directly.
//
// K6 keeps the TPU design's shape: rows move as 8-row blocks (one warp per
// row of a block) through a ring of `depth` (1..4) shared-memory slots.  A
// persistent grid of at most four blocks per SM walks the row blocks; each
// block stages its block k+depth with cp.async (the cuda_pipeline.h
// primitives) while it writes block k's rows to their slots, so reads of
// later rows are in flight during the scattered writes.  The rows arrive
// padded to a multiple of 8; a pad row is staged but never written.  The
// ring needs depth * 8 * row bytes of shared memory (12.8 KB at depth 4 for
// 100 f32 features); the wrapper refuses a ring over 227 KB.  Units below
// 4 bytes (odd bf16 rows) are staged with plain loads: cp.async copies 4,
// 8 or 16 bytes.
#include "common.cuh"

#include <cuda_pipeline.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // K5: rows per block
constexpr int kRowBlock = 8;       // K6: rows per staged block, a warp each
constexpr int kMaxBlocksPerSm = 4;

template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter_rows_kernel(V* __restrict__ out, const V* __restrict__ rows,
                    const int32_t* __restrict__ slots, int64_t m,
                    int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;
  const V* src = rows + i * units;
  V* dst = out + static_cast<int64_t>(slots[i]) * units;  // a broadcast load
  for (int64_t u = lane; u < units; u += 32) dst[u] = __ldg(src + u);
}

template <typename V, int kDepth>
__global__ void __launch_bounds__(kRowBlock * 32)
scatter_rows_pipelined_kernel(V* __restrict__ out, const V* __restrict__ rows,
                              const int32_t* __restrict__ slots, int64_t m,
                              int64_t n_blocks, int64_t units) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  V* ring = reinterpret_cast<V*>(ring_bytes);
  const int64_t block_units = kRowBlock * units;  // one row block, contiguous
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this block's row blocks: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int64_t first = blockIdx.x;
  const int64_t stride = gridDim.x;
  const int64_t n_mine =
      first < n_blocks ? (n_blocks - 1 - first) / stride + 1 : 0;

  auto stage = [&](int64_t k) {  // my k-th row block -> ring slot k % depth
    const V* src = rows + (first + k * stride) * block_units;
    V* dst = ring + (k % kDepth) * block_units;
    for (int64_t u = threadIdx.x; u < block_units; u += blockDim.x) {
      if constexpr (sizeof(V) >= 4) {
        __pipeline_memcpy_async(dst + u, src + u, sizeof(V));
      } else {
        dst[u] = src[u];
      }
    }
  };

  // one commit group per row block (empty past the end), so that after
  // `depth + k` commits, waiting for all but the newest depth-1 groups
  // means block k has landed
  for (int k = 0; k < kDepth; ++k) {
    if (k < n_mine) stage(k);
    __pipeline_commit();
  }
  for (int64_t k = 0; k < n_mine; ++k) {
    __pipeline_wait_prior(kDepth - 1);
    __syncthreads();  // every thread's copies of block k are visible
    const int64_t row = (first + k * stride) * kRowBlock + warp;
    if (row < m) {  // pad rows are never written
      const V* src = ring + (k % kDepth) * block_units + warp * units;
      V* dst = out + static_cast<int64_t>(slots[row]) * units;
      for (int64_t u = lane; u < units; u += 32) dst[u] = src[u];
    }
    __syncthreads();  // slot k % depth is free again
    if (k + kDepth < n_mine) stage(k + kDepth);
    __pipeline_commit();
  }
}

template <typename V>
cudaError_t launch(void* out, const void* rows, const int32_t* slots,
                   int64_t m, int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t blocks = ceil_div(m, kWarpsPerBlock);
  scatter_rows_kernel<V><<<static_cast<unsigned>(blocks),
                           kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<V*>(out), static_cast<const V*>(rows), slots, m, units);
  return cudaGetLastError();
}

template <typename V, int kDepth>
cudaError_t launch_pipelined(void* out, const void* rows,
                             const int32_t* slots, int64_t m, int64_t mp,
                             int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t n_blocks = mp / kRowBlock;
  const int64_t smem = kDepth * kRowBlock * row_bytes;
  auto kernel = scatter_rows_pipelined_kernel<V, kDepth>;
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
      static_cast<V*>(out), static_cast<const V*>(rows), slots, m, n_blocks,
      units);
  return cudaGetLastError();
}

int scatter(void* out, const void* rows, const int32_t* slots, int64_t m,
            int64_t row_bytes, void* stream) {
  if (m <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = as_stream(stream);
  return static_cast<int>(
      with_unit(copy_unit(row_bytes, out, rows), [&](auto unit) {
        return launch<decltype(unit)>(out, rows, slots, m, row_bytes, st);
      }));
}

int scatter_pipelined(void* out, const void* rows, const int32_t* slots,
                      int64_t m, int64_t mp, int64_t row_bytes, int depth,
                      void* stream) {
  if (depth < 1 || depth > 4 || mp % kRowBlock != 0 || mp < m)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = as_stream(stream);
  return static_cast<int>(
      with_unit(copy_unit(row_bytes, out, rows), [&](auto unit) {
        using V = decltype(unit);
        switch (depth) {
          case 1:
            return launch_pipelined<V, 1>(out, rows, slots, m, mp, row_bytes,
                                          st);
          case 2:
            return launch_pipelined<V, 2>(out, rows, slots, m, mp, row_bytes,
                                          st);
          case 3:
            return launch_pipelined<V, 3>(out, rows, slots, m, mp, row_bytes,
                                          st);
          default:
            return launch_pipelined<V, 4>(out, rows, slots, m, mp, row_bytes,
                                          st);
        }
      }));
}

}  // namespace

// out: [K, f] (a copy of the cache block, written in place); rows: [m, f];
// slots: int32 [m], unique, each in [0, K).
REPRO_API int cache_update_f32(void* out, const void* rows,
                               const int32_t* slots, int64_t m, int64_t f,
                               void* stream) {
  return scatter(out, rows, slots, m, f * 4, stream);
}

REPRO_API int cache_update_bf16(void* out, const void* rows,
                                const int32_t* slots, int64_t m, int64_t f,
                                void* stream) {
  return scatter(out, rows, slots, m, f * 2, stream);
}

// As above with rows padded to mp (a multiple of 8) rows; depth in 1..4.
REPRO_API int cache_update_pipelined_f32(void* out, const void* rows,
                                         const int32_t* slots, int64_t m,
                                         int64_t mp, int64_t f, int depth,
                                         void* stream) {
  return scatter_pipelined(out, rows, slots, m, mp, f * 4, depth, stream);
}

REPRO_API int cache_update_pipelined_bf16(void* out, const void* rows,
                                          const int32_t* slots, int64_t m,
                                          int64_t mp, int64_t f, int depth,
                                          void* stream) {
  return scatter_pipelined(out, rows, slots, m, mp, f * 2, depth, stream);
}

REPRO_API const char* cache_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
