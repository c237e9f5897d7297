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
// the design is a direct row gather instead, in the widest copy unit (16,
// 8, 4, 2 or 1 bytes) that divides the row and every base pointer.  The
// copy is bitwise, so the result is bit-equal to the plain version for any
// dtype; the f32 and bf16 entry points differ only in the element size.
//
// K1 moves rows through registers, and what held its first design (a warp
// per row) under half its bound was latency and idle lanes, not the bytes:
// a row waited on its slot, then on its miss index (a dependent load), then
// on its row, with a few rows a warp in flight, and a 25-unit f32 row of
// width 100 left 7 of 32 lanes idle.  So a warp now takes a group of 32
// output rows.  Lane r loads row r's slot and miss index together (two
// coalesced loads, one latency) and forms its source address, which
// __shfl_sync hands to the lane that copies each unit.  The group's
// 32 * units copy units are one contiguous run of `out`, dealt over the
// 32 lanes, so no lane idles, and each lane keeps kCopyDepth independent
// loads in flight: a unit's store frees its register for the load
// kCopyDepth units on.  The output (80.5 MB on the main path) outgrows the
// 50 MB L2 while the distinct source rows (about 30 MB, each read 2.65
// times on average) fit, so the loads keep source lines in L2 (evict_last,
// no L1 allocation) and the stores stream (evict-first): ldst.cuh.  One
// group a warp; whole warps leave the loop together, so every lane reaches
// every shuffle, and the ragged last group masks its missing rows.  On an
// H100 this moves its bound's bytes at about 90 % of the rate the card
// copies a contiguous tensor of the output's size (PERF.md).
//
// K4 replaces cache_combine_pipelined_kernel_call (body
// _cache_combine_pipelined_kernel), the TPU combine that keeps `depth` (2..4)
// windows in VMEM and starts each window's DMA `depth` tiles ahead.  Its
// function is K1's; its window and one-hot product are dropped for K1's
// reasons.  What it keeps is the copy ring, here Hopper's bulk-copy engine
// (tma.cuh) feeding a ring of `depth` stages of 32 output rows, each stage
// with a full and an empty mbarrier.  A persistent grid (as many CTAs an SM
// as the ring leaves room for) walks the stages blockIdx.x, +gridDim.x, ...
// Each CTA is two warps.  In the loader warp, lane r loads row r's two
// table entries together, as K1 does, and issues one cp.async.bulk of its
// source row, from the cache or the miss block, into the stage, completing
// on the stage's full barrier.  One storer thread waits for the stage and
// writes its rows, which are contiguous in `out`, with one cp.async.bulk
// store; once the store of the stage before has read shared memory it
// releases that stage's empty barrier.  No thread moves a row through
// registers and no __syncthreads sits in the loop.  This bulk route needs
// rows of a multiple of 16 bytes and 16-byte aligned bases (the main
// path's 400-B f32 rows).  Other rows take the cp.async route: one warp
// per output row of 8-row blocks cp.asyncs its source row into ring slot
// k % depth; one commit group per block, empty past the end, so
// `__pipeline_wait_prior(depth - 1)` always means "block k has landed",
// and the block then writes its 8 rows as one coalesced copy.  cp.async
// copies 4, 8 or 16 bytes, so units below 4 bytes (odd bf16 rows) are
// staged with plain loads.  The wrapper refuses a ring over 227 KB.
// Bit-equal to K1 at every depth.
//
// K7 replaces cache_combine_kernel_call (body _cache_combine_kernel), the
// legacy one-row-per-grid-step combine with the (sel, row) tables:
//
//   out[i] = cache[row[i]]   if sel[i] == 0
//            miss[row[i]]    otherwise
//
// It lies on no path of the trainer (the reference keeps it as a parity
// baseline) and is a warp-per-row copy with the other table contract.
#include "common.cuh"
#include "ldst.cuh"
#include "tma.cuh"

#include <cuda_pipeline.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // K7: output rows per block
constexpr int kGroupRows = 32;     // K1: output rows per warp, a lane each
constexpr int kGroupWarps = 8;     // K1: warps per block
constexpr int kCopyDepth = 8;      // K1: copy units a lane has in flight
constexpr int kRowBlock = 8;       // K4 cp.async route: rows per block
constexpr int kMaxBlocksPerSm = 4;
constexpr int kStageRows = 32;     // K4 bulk route: rows per stage, a lane each
constexpr int kBulkThreads = 64;   // a loader warp and a storer warp
constexpr int64_t kMaxRing = 232448;  // shared memory a block may use

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
__global__ void __launch_bounds__(kGroupWarps * 32)
combine_rows_kernel(const V* __restrict__ cache, const V* __restrict__ miss,
                    const int32_t* __restrict__ slots,
                    const int32_t* __restrict__ miss_index,
                    V* __restrict__ out, int64_t n, int64_t n_groups,
                    int units) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kGroupWarps;
  const uint64_t keep = l2_evict_last_policy();
  // unit e of a group lies in its row e / units at column e % units; a
  // lane's next unit (e + 32) is row_step rows and col_step columns on
  const int row_step = 32 / units;
  const int col_step = 32 % units;
  // the loop bound is the warp's, so whole warps leave together and every
  // lane reaches every shuffle
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kGroupWarps +
                   (threadIdx.x >> 5);
       g < n_groups; g += warps) {
    const int64_t row0 = g * kGroupRows;
    const int rows =
        n - row0 < kGroupRows ? static_cast<int>(n - row0) : kGroupRows;
    // lane r reads row r's two table entries, both loads in flight at
    // once; the ragged last group masks its missing rows
    unsigned long long src = 0;
    if (lane < rows) {
      const int32_t s = slots[row0 + lane];
      const int32_t m = miss_index[row0 + lane];
      src = reinterpret_cast<unsigned long long>(
          (s >= 0 && cache != nullptr)
              ? cache + static_cast<int64_t>(s) * units
              : miss + static_cast<int64_t>(m) * units);
    }
    // the group's rows are contiguous in out: its rows * units units are
    // one run, dealt over the 32 lanes.  A lane keeps a window of
    // kCopyDepth loads in flight: once unit e is stored, the load of unit
    // e + 32 * kCopyDepth takes its register.
    V* dst = out + row0 * units;
    const int total = rows * units;
    int r = lane / units;
    int c = lane % units;
    auto fetch = [&](V& slot, int e) {
      const V* row = reinterpret_cast<const V*>(
          __shfl_sync(0xffffffffu, src, r & 31));
      if (e < total) slot = load_reused(row + c, keep);
      r += row_step;
      c += col_step;
      if (c >= units) {
        c -= units;
        ++r;
      }
    };
    V buf[kCopyDepth];
#pragma unroll
    for (int j = 0; j < kCopyDepth; ++j) fetch(buf[j], j * 32 + lane);
    for (int e0 = 0; e0 < total; e0 += 32 * kCopyDepth) {
#pragma unroll
      for (int j = 0; j < kCopyDepth; ++j) {
        const int e = e0 + j * 32 + lane;
        if (e < total) store_streaming(dst + e, buf[j]);
        fetch(buf[j], e + 32 * kCopyDepth);
      }
    }
  }
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

__global__ void __launch_bounds__(kBulkThreads)
combine_rows_bulk_kernel(const unsigned char* __restrict__ cache,
                         const unsigned char* __restrict__ miss,
                         const int32_t* __restrict__ slots,
                         const int32_t* __restrict__ miss_index,
                         unsigned char* __restrict__ out, int64_t n,
                         int64_t n_stages, int64_t row_bytes, int depth) {
  extern __shared__ __align__(128) unsigned char ring[];
  const int64_t stage_bytes = kStageRows * row_bytes;  // a multiple of 16
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + depth * stage_bytes);
  uint64_t* empty = full + depth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(&full[s], 1);    // lane 0's expect_tx arrival
      mbar_init(&empty[s], 1);   // the storer's release
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  const int64_t n_mine = blockIdx.x < n_stages
                             ? (n_stages - 1 - blockIdx.x) / gridDim.x + 1
                             : 0;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x < 32) {  // the loader warp: lane r gathers row r
    for (int64_t k = 0; k < n_mine; ++k) {
      const int s = static_cast<int>(k % depth);
      if (k >= depth) mbar_wait(&empty[s], ((k / depth) - 1) & 1);
      const int64_t row0 = (blockIdx.x + k * gridDim.x) * kStageRows;
      const int64_t rows = n - row0 < kStageRows ? n - row0 : kStageRows;
      // the tx count may run below zero until this arrival: the phase
      // completes only once lane 0 has arrived and every byte has landed
      if (lane == 0)
        mbar_arrive_expect_tx(&full[s],
                              static_cast<uint32_t>(rows * row_bytes));
      if (lane < rows) {
        const int64_t row = row0 + lane;
        const int32_t slot = slots[row];  // both entries in flight at once
        const int32_t mi = miss_index[row];
        const unsigned char* src =
            (slot >= 0 && cache != nullptr)
                ? cache + static_cast<int64_t>(slot) * row_bytes
                : miss + static_cast<int64_t>(mi) * row_bytes;
        bulk_load(ring + s * stage_bytes + lane * row_bytes, src,
                  static_cast<uint32_t>(row_bytes), &full[s]);
      }
    }
  } else if (threadIdx.x == 32) {  // the storer
    for (int64_t k = 0; k < n_mine; ++k) {
      const int s = static_cast<int>(k % depth);
      mbar_wait(&full[s], (k / depth) & 1);
      const int64_t row0 = (blockIdx.x + k * gridDim.x) * kStageRows;
      const int64_t rows = n - row0 < kStageRows ? n - row0 : kStageRows;
      bulk_store(out + row0 * row_bytes, ring + s * stage_bytes,
                 static_cast<uint32_t>(rows * row_bytes));
      bulk_commit();
      // the previous stage's store has read shared memory: release it
      bulk_wait_read<1>();
      if (k > 0) mbar_arrive(&empty[(k - 1) % depth]);
    }
    bulk_wait<0>();  // every store has written out
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
  if (units > INT32_MAX / kGroupRows) return cudaErrorInvalidValue;
  const int64_t groups = ceil_div(n, kGroupRows);
  const int64_t blocks = ceil_div(groups, kGroupWarps);  // a group a warp
  combine_rows_kernel<V><<<static_cast<unsigned>(blocks), kGroupWarps * 32,
                           0, stream>>>(
      static_cast<const V*>(cache), static_cast<const V*>(miss), slots,
      miss_index, static_cast<V*>(out), n, groups, static_cast<int>(units));
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

cudaError_t launch_bulk(const void* cache, const void* miss,
                        const int32_t* slots, const int32_t* miss_index,
                        void* out, int64_t n, int64_t row_bytes, int depth,
                        cudaStream_t stream) {
  const int64_t smem = depth * (kStageRows * row_bytes + 16);
  cudaError_t err = cudaFuncSetAttribute(
      combine_rows_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, combine_rows_bulk_kernel, kBulkThreads,
      static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  const int64_t n_stages = ceil_div(n, kStageRows);
  int64_t grid = 0;
  err = persistent_grid(n_stages, per_sm > 0 ? per_sm : 1, &grid);
  if (err != cudaSuccess) return err;
  combine_rows_bulk_kernel<<<static_cast<unsigned>(grid), kBulkThreads,
                             static_cast<size_t>(smem), stream>>>(
      static_cast<const unsigned char*>(cache),
      static_cast<const unsigned char*>(miss), slots, miss_index,
      static_cast<unsigned char*>(out), n, n_stages, row_bytes, depth);
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
  const int64_t unit_bytes = copy_unit(row_bytes, out, cache, miss);
  if (unit_bytes == 16 && depth * (kStageRows * row_bytes + 16) <= kMaxRing)
    return static_cast<int>(launch_bulk(cache, miss, slots, miss_index, out,
                                        n, row_bytes, depth, st));
  return static_cast<int>(
      with_unit(unit_bytes, [&](auto unit) {
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
