// K2: the fused aggregate + update GNN layer (the paper's Section IV-C
// datapath: the aggregated tile feeds the update directly and is never
// written to device memory).
//
// Replaces the TPU kernel repro/kernels/gather_scatter_mm.py:
// fused_update_kernel_call (body _fused_kernel), wrapped by
// repro/kernels/ops.py:fused_gnn_update and called from
// repro/graph/models.py:_fused_layer.
//
//   out = (self_scale ⊙ x_self) @ w_self
//       + (sum_{j<fanout} w_edge ⊙ x_nbr) @ w_agg + bias          (f32)
//
// SAGE passes W[:F] / W[F:] as w_self / w_agg; GCN passes W twice.
//
// What bounds it on Hopper: at the paper's widths both sides are close.
// Layer 1 (F=100, O=256, fanout 10) reads ~119 MB and does ~1.9 GFLOP:
// ~35 us of HBM traffic against ~28 us of fp32 FMA at the card's
// non-tensor peak.  Layer 2 (F=256, O=47, fanout 25, D=704) reads 19 MB
// for 34 MFLOP: bytes alone.  So x_nbr is read in ONE pass (one block owns
// up to 256 output columns, so no column tile re-reads the neighbours), the
// reads keep enough bytes in flight, and the aggregate never leaves shared
// memory.  Plain fp32 FMAs: no TF32, no tensor cores.
//
// The ring route.  A persistent grid, one block an SM, walks tiles of T_D
// = 8*RM destination rows (RM a product warp) and every output column
// (O <= T_O = 32*CO).  A tile's neighbours are one contiguous slab of
// x_nbr and its self rows one slab of x_self, and a KT-row slice of w_self
// or w_agg is contiguous too, so every input moves by cp.async.bulk into
// rings of mbarrier-guarded stages (tma.cuh), and the block's warps
// specialise:
//   - the x producer (one thread) copies a tile's self rows into one of
//     two tile buffers and streams its neighbour slab in ~16 KB chunks of
//     whole rows through a 3-stage ring;
//   - four aggregating warps reduce each chunk into the buffer's aggregate
//     tile (a thread owns (row, 4 columns) items: fanout 16-byte reads from
//     shared memory, the edge weights staged in shared memory) and scale
//     the self tile by self_scale;
//   - the W producer (one thread) streams the KT-row slices of w_self then
//     w_agg through a ring of up to 32 slots;
//   - eight product warps accumulate self @ w_self + agg @ w_agg in
//     registers, RM rows x CO columns a thread (a float4 of A for four k
//     steps, one broadcast; 32 consecutive W values a step), and store.
// With two tile buffers, tile i + 1 is aggregated while tile i's product
// runs, and the W ring runs ahead of both; each consumer releases a stage
// with one mbarrier arrival a warp.  It runs where F % 4 == 0, O <= 256 and
// x_self, x_nbr, w_self, w_agg are 16-byte aligned (both layers of the main
// path) and the plan fits shared memory.
//
// The plain-load route, for every other shape (F = 7, F = 33, O > 256,
// unaligned views), one block a T_D x T_O tile: it walks F in KT-wide
// slices, builds each slice of the weighted aggregate and of the scaled
// self rows in shared memory with plain loads, stages the matching w_self /
// w_agg slices and accumulates both products the same way.  Ragged D, F
// and O are masked on both routes; the inputs are not padded.
#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: warp = row group, lane = column
constexpr int KT = 16;         // F slice per shared-memory stage

template <int RM, int CO>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const float* __restrict__ xs, const float* __restrict__ xn,
                    const float* __restrict__ we, const float* __restrict__ ss,
                    const float* __restrict__ ws, const float* __restrict__ wa,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int64_t D, int64_t F, int64_t O, int fanout) {
  constexpr int TD = 8 * RM;
  constexpr int TO = 32 * CO;
  // k-major A tiles (+1 pad against bank conflicts on the transposed store)
  __shared__ float a_self[KT][TD + 1];
  __shared__ float a_agg[KT][TD + 1];
  __shared__ float b_self[KT][TO];
  __shared__ float b_agg[KT][TO];

  const int tid = threadIdx.x;
  const int ty = tid >> 5;  // warp: rows ty*RM .. ty*RM+RM-1 of the tile
  const int tx = tid & 31;  // lane: columns tx + 32*c
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * TD;
  const int64_t o0 = static_cast<int64_t>(blockIdx.y) * TO;

  float acc[RM][CO];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.0f;

  for (int64_t f0 = 0; f0 < F; f0 += KT) {
    __syncthreads();  // the previous slice's tiles are consumed
    // scaled self rows and the weighted neighbour aggregate, f32
    for (int e = tid; e < TD * KT; e += kThreads) {
      const int r = e / KT;
      const int k = e - r * KT;
      const int64_t d = d0 + r;
      const int64_t f = f0 + k;
      float vs = 0.0f, va = 0.0f;
      if (d < D && f < F) {
        vs = __ldg(xs + d * F + f) * __ldg(ss + d);
        const int64_t e0 = d * fanout;
        for (int j = 0; j < fanout; ++j)
          va += __ldg(we + e0 + j) * __ldg(xn + (e0 + j) * F + f);
      }
      a_self[k][r] = vs;
      a_agg[k][r] = va;
    }
    // the matching w_self / w_agg slices
    for (int e = tid; e < KT * TO; e += kThreads) {
      const int k = e / TO;
      const int c = e - k * TO;
      const int64_t f = f0 + k;
      const int64_t o = o0 + c;
      const bool ok = f < F && o < O;
      b_self[k][c] = ok ? __ldg(ws + f * O + o) : 0.0f;
      b_agg[k][c] = ok ? __ldg(wa + f * O + o) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      float as[RM], ag[RM], bs[CO], ba[CO];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        as[i] = a_self[k][ty * RM + i];
        ag[i] = a_agg[k][ty * RM + i];
      }
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        bs[c] = b_self[k][tx + 32 * c];
        ba[c] = b_agg[k][tx + 32 * c];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CO; ++c)
          acc[i][c] += as[i] * bs[c] + ag[i] * ba[c];
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t d = d0 + ty * RM + i;
    if (d >= D) continue;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int64_t o = o0 + tx + 32 * c;
      if (o < O)
        out[d * O + o] = acc[i][c] + (bias != nullptr ? __ldg(bias + o) : 0.0f);
    }
  }
}

// ---------------------------------------------------------------- ring route

constexpr int kGemmWarps = 8;                    // the product's warps
constexpr int kAggThreads = 128;                 // four aggregating warps
constexpr int kXWarp = kGemmWarps + kAggThreads / 32;  // the x producer
constexpr int kWWarp = kXWarp + 1;               // the W producer's warp
constexpr int kRingThreads = (kWWarp + 1) * 32;  // 448
constexpr int kGemmThreads = kGemmWarps * 32;
constexpr int64_t kChunkTarget = 16 * 1024;      // bytes a chunk aims at
constexpr int kStages = 3;                       // chunks in flight
constexpr int kMaxSlots = 32;                    // W slices held at once
constexpr int64_t kMaxSmem = 232448;             // shared memory of a block

// The ring route's shared memory (one block an SM): the chunk ring, the
// W-slice ring, two buffers of the self and aggregate tiles [T_D][F], two
// of the tiles' edge weights and self scales, then the barriers.
struct RingPlan {
  int64_t chunk_rows, slots, smem;
};

template <int RM, int CO>
RingPlan ring_plan(int64_t F, int fanout) {
  constexpr int64_t TD = kGemmWarps * RM, TO = 32 * CO;
  RingPlan p{};
  const int64_t slab_bytes = fanout * F * 4;
  p.chunk_rows = kChunkTarget / slab_bytes;
  if (p.chunk_rows < 1) p.chunk_rows = 1;
  if (p.chunk_rows > TD) p.chunk_rows = TD;
  const int64_t fixed = kStages * p.chunk_rows * slab_bytes +
                        4 * TD * F * 4 +
                        ceil_div(2 * (TD * fanout + TD) * 4, 16) * 16 +
                        (2 * kStages + 7) * 8;
  const int64_t slot_bytes = KT * TO * 4;
  p.slots = (kMaxSmem - fixed) / (slot_bytes + 16);
  const int64_t n_slices = 2 * ceil_div(F, KT);
  if (p.slots > n_slices) p.slots = n_slices;
  if (p.slots > kMaxSlots) p.slots = kMaxSlots;
  p.smem = p.slots < 2 ? 0 : fixed + p.slots * (slot_bytes + 16);
  return p;
}

template <int RM, int CO>
__global__ void __launch_bounds__(kRingThreads, 1)
fused_update_ring_kernel(const float* __restrict__ xs,
                         const float* __restrict__ xn,
                         const float* __restrict__ we,
                         const float* __restrict__ ss,
                         const float* __restrict__ ws,
                         const float* __restrict__ wa,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int64_t D, int64_t F,
                         int64_t O, int fanout, int64_t chunk_rows,
                         int slots, int64_t n_tiles) {
  constexpr int TD = kGemmWarps * RM;
  constexpr int TO = 32 * CO;
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t slab = fanout * F;  // elements of one row's neighbours
  const int64_t chunk_bytes = chunk_rows * slab * 4;
  const int64_t tile = TD * F;      // elements of one self / agg tile
  unsigned char* chunks = smem;
  float* w_ring = reinterpret_cast<float*>(smem + kStages * chunk_bytes);
  float* a_self = w_ring + slots * (KT * TO);  // [2][TD][F]
  float* a_agg = a_self + 2 * tile;            // [2][TD][F]
  float* e_tile = a_agg + 2 * tile;            // [2][TD * fanout]
  float* s_tile = e_tile + 2 * TD * fanout;    // [2][TD]
  uint64_t* c_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(e_tile) +
      (2 * (TD * fanout + TD) * 4 + 15) / 16 * 16);
  uint64_t* c_empty = c_full + kStages;
  uint64_t* self_full = c_empty + kStages;  // [2]: x_self rows landed
  uint64_t* a_full = self_full + 2;         // [2]: both tiles ready
  uint64_t* a_empty = a_full + 2;           // [2]: the product is done
  uint64_t* agg_sync = a_empty + 2;         // the aggregators' own barrier
  uint64_t* w_full = agg_sync + 1;          // [slots]
  uint64_t* w_empty = w_full + slots;       // [slots]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {  // releases below are one arrival a warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&c_full[s], 1);
      mbar_init(&c_empty[s], kAggThreads / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&self_full[b], 1);
      mbar_init(&a_full[b], kAggThreads / 32);
      mbar_init(&a_empty[b], kGemmWarps);
    }
    mbar_init(agg_sync, kAggThreads / 32);
    for (int s = 0; s < slots; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], kGemmWarps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  // this block's tiles: blockIdx.x, +gridDim.x, ...; tile i uses buffer
  // i & 1, whose (i >> 1)-th phase it is
  const int64_t n_mine =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t per_side = (F + KT - 1) / KT;
  const int64_t n_slices = 2 * per_side;

  if (warp == kXWarp) {  // self rows and neighbour chunks, in tile order
    if (lane != 0) return;
    int64_t g = 0;  // chunks issued so far
    for (int64_t i = 0; i < n_mine; ++i) {
      const int64_t d0 = (blockIdx.x + i * gridDim.x) * TD;
      const int64_t rows = D - d0 < TD ? D - d0 : TD;
      const int b = static_cast<int>(i & 1);
      if (i >= 2) {
        mbar_wait(&a_empty[b], ((i >> 1) - 1) & 1);
        fence_proxy_async();  // after the generic writes to this buffer
      }
      mbar_arrive_expect_tx(&self_full[b],
                            static_cast<uint32_t>(rows * F * 4));
      bulk_load(a_self + b * tile, xs + d0 * F,
                static_cast<uint32_t>(rows * F * 4), &self_full[b]);
      for (int64_t r0 = 0; r0 < rows; r0 += chunk_rows, ++g) {
        const int s = static_cast<int>(g % kStages);
        if (g >= kStages) mbar_wait(&c_empty[s], ((g / kStages) - 1) & 1);
        const int64_t cr = rows - r0 < chunk_rows ? rows - r0 : chunk_rows;
        const uint32_t bytes = static_cast<uint32_t>(cr * slab * 4);
        mbar_arrive_expect_tx(&c_full[s], bytes);
        bulk_load(chunks + s * chunk_bytes, xn + (d0 + r0) * slab, bytes,
                  &c_full[s]);
      }
    }
    return;
  }

  if (warp == kWWarp) {  // W slices: w_self's rows, then w_agg's, per tile
    if (lane != 0) return;
    for (int64_t gs = 0; gs < n_mine * n_slices; ++gs) {
      const int64_t t = gs % n_slices;
      const int s = static_cast<int>(gs % slots);
      if (gs >= slots) mbar_wait(&w_empty[s], ((gs / slots) - 1) & 1);
      const float* w = t < per_side ? ws : wa;
      const int64_t f0 = (t < per_side ? t : t - per_side) * KT;
      const int64_t kr = F - f0 < KT ? F - f0 : KT;
      const uint32_t bytes = static_cast<uint32_t>(kr * O * 4);
      mbar_arrive_expect_tx(&w_full[s], bytes);
      bulk_load(w_ring + s * (KT * TO), w + f0 * O, bytes, &w_full[s]);
    }
    return;
  }

  if (warp >= kGemmWarps) {  // the aggregators
    const int at = threadIdx.x - kGemmThreads;
    const int64_t nvec = F / 4;
    int64_t g = 0;
    uint32_t sync_phase = 0;
    for (int64_t i = 0; i < n_mine; ++i) {
      const int64_t d0 = (blockIdx.x + i * gridDim.x) * TD;
      const int64_t rows = D - d0 < TD ? D - d0 : TD;
      const int b = static_cast<int>(i & 1);
      // no wait for buffer b: tile i's rows arrive only once the product
      // has freed it (the x producer waits for that), and the edge weights
      // are the aggregators' own, last read in tile i - 2, which agg_sync
      // closed before tile i - 1
      float* et = e_tile + b * (TD * fanout);
      float* st = s_tile + b * TD;
      for (int64_t e = at; e < rows * fanout; e += kAggThreads)
        et[e] = __ldg(we + d0 * fanout + e);
      for (int64_t e = at; e < rows; e += kAggThreads)
        st[e] = __ldg(ss + d0 + e);
      mbar_arrive_warp(agg_sync);  // every aggregator's weights are in
      mbar_wait(agg_sync, sync_phase);  // place
      sync_phase ^= 1;
      float* ag = a_agg + b * tile;
      for (int64_t r0 = 0; r0 < rows; r0 += chunk_rows, ++g) {
        const int s = static_cast<int>(g % kStages);
        mbar_wait(&c_full[s], (g / kStages) & 1);
        const int64_t cr = rows - r0 < chunk_rows ? rows - r0 : chunk_rows;
        const float* chunk = reinterpret_cast<const float*>(
            chunks + s * chunk_bytes);
        for (int64_t item = at; item < cr * nvec; item += kAggThreads) {
          const int64_t r = item / nvec;
          const int64_t col = (item - r * nvec) * 4;
          const float* xr = chunk + r * slab + col;
          const float* wr = et + (r0 + r) * fanout;
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 5
          for (int j = 0; j < fanout; ++j) {
            const float wj = wr[j];
            const float4 v = *reinterpret_cast<const float4*>(xr + j * F);
            acc.x += wj * v.x;
            acc.y += wj * v.y;
            acc.z += wj * v.z;
            acc.w += wj * v.w;
          }
          *reinterpret_cast<float4*>(ag + (r0 + r) * F + col) = acc;
        }
        mbar_arrive_warp(&c_empty[s]);
      }
      mbar_wait(&self_full[b], (i >> 1) & 1);
      float* sf = a_self + b * tile;
      for (int64_t item = at; item < rows * nvec; item += kAggThreads) {
        const int64_t r = item / nvec;
        float4* p = reinterpret_cast<float4*>(sf + r * F +
                                              (item - r * nvec) * 4);
        const float sc = st[r];
        const float4 v = *p;
        *p = make_float4(v.x * sc, v.y * sc, v.z * sc, v.w * sc);
      }
      mbar_arrive_warp(&a_full[b]);
    }
    return;
  }

  // the product warps: self @ w_self + agg @ w_agg, RM rows x CO columns a
  // thread, its rows' A values four k at a time, one W value a column
  // (a W slice keeps w's row stride O <= T_O; columns past O are masked)
  const int ty = warp;
  const int tx = lane;
  int64_t gs = 0;
  for (int64_t i = 0; i < n_mine; ++i) {
    const int64_t d0 = (blockIdx.x + i * gridDim.x) * TD;
    const int b = static_cast<int>(i & 1);
    mbar_wait(&a_full[b], (i >> 1) & 1);
    float acc[RM][CO];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[r][c] = 0.0f;
    for (int64_t t = 0; t < n_slices; ++t, ++gs) {
      const int s = static_cast<int>(gs % slots);
      mbar_wait(&w_full[s], (gs / slots) & 1);
      const int64_t f0 = (t < per_side ? t : t - per_side) * KT;
      const int64_t kr = F - f0 < KT ? F - f0 : KT;  // a multiple of 4
      const float* a = (t < per_side ? a_self : a_agg) + b * tile + f0;
      const float* w = w_ring + s * (KT * TO);
#pragma unroll
      for (int k = 0; k < KT; k += 4) {
        if (k >= kr) break;
        float4 av[RM];
#pragma unroll
        for (int r = 0; r < RM; ++r)
          av[r] = *reinterpret_cast<const float4*>(a + (ty * RM + r) * F + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[CO];
#pragma unroll
          for (int c = 0; c < CO; ++c) bv[c] = w[(k + kk) * O + tx + 32 * c];
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float ar = kk == 0 ? av[r].x : kk == 1 ? av[r].y
                           : kk == 2 ? av[r].z : av[r].w;
#pragma unroll
            for (int c = 0; c < CO; ++c) acc[r][c] += ar * bv[c];
          }
        }
      }
      mbar_arrive_warp(&w_empty[s]);
    }
    mbar_arrive_warp(&a_empty[b]);  // both tiles of buffer b are free
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int64_t d = d0 + ty * RM + r;
      if (d >= D) continue;
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const int64_t o = tx + 32 * c;
        if (o < O)
          out[d * O + o] =
              acc[r][c] + (bias != nullptr ? __ldg(bias + o) : 0.0f);
      }
    }
  }
}

template <int RM, int CO>
cudaError_t launch(const float* xs, const float* xn, const float* we,
                   const float* ss, const float* ws, const float* wa,
                   const float* bias, float* out, int64_t D, int64_t F,
                   int64_t O, int fanout, cudaStream_t st) {
  const RingPlan p = ring_plan<RM, CO>(F, fanout);
  // the ring route: whole rows of x bulk-copied, and one block spanning
  // every output column, so a slice of w is contiguous rows
  if (F % 4 == 0 && O <= 32 * CO && p.smem > 0 && aligned_to(xs, 16) &&
      aligned_to(xn, 16) && aligned_to(ws, 16) && aligned_to(wa, 16)) {
    auto kernel = fused_update_ring_kernel<RM, CO>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
    const int64_t n_tiles = ceil_div(D, kGemmWarps * RM);
    int64_t grid = 0;
    err = persistent_grid(n_tiles, 1, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(grid), kRingThreads,
             static_cast<size_t>(p.smem), st>>>(
        xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, p.chunk_rows,
        static_cast<int>(p.slots), n_tiles);
  } else {
    const dim3 grid(static_cast<unsigned>(ceil_div(D, 8 * RM)),
                    static_cast<unsigned>(ceil_div(O, 32 * CO)));
    fused_update_kernel<RM, CO><<<grid, kThreads, 0, st>>>(
        xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout);
  }
  return cudaGetLastError();
}

template <int RM>
cudaError_t launch_rows(int co, const float* xs, const float* xn,
                        const float* we, const float* ss, const float* ws,
                        const float* wa, const float* bias, float* out,
                        int64_t D, int64_t F, int64_t O, int fanout,
                        cudaStream_t st) {
  switch (co) {
    case 1: return launch<RM, 1>(xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st);
    case 2: return launch<RM, 2>(xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st);
    case 4: return launch<RM, 4>(xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st);
    default: return launch<RM, 8>(xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st);
  }
}

}  // namespace

// x_self: [D, F]; x_nbr: [D*fanout, F]; w_edge: [D*fanout]; self_scale: [D];
// w_self / w_agg: [F, O]; bias: [O] or null -> out: [D, O].  All f32,
// contiguous.
REPRO_API int fused_update_f32(const float* xs, const float* xn,
                               const float* we, const float* ss,
                               const float* ws, const float* wa,
                               const float* bias, float* out, int64_t D,
                               int64_t F, int64_t O, int fanout,
                               void* stream) {
  if (D <= 0 || O <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = as_stream(stream);
  // column groups per thread: the smallest power of two covering O, at
  // most 8 (a 256-column tile), so x_nbr is read once for O <= 256
  int co = 1;
  while (co < 8 && 32 * co < O) co *= 2;
  const int64_t col_tiles = ceil_div(O, 32 * co);
  // tall tiles when there are enough of them to fill the card (2 per SM)
  if (ceil_div(D, 32) * col_tiles >= 264)
    return static_cast<int>(launch_rows<4>(co, xs, xn, we, ss, ws, wa, bias,
                                           out, D, F, O, fanout, st));
  return static_cast<int>(launch_rows<1>(co, xs, xn, we, ss, ws, wa, bias,
                                         out, D, F, O, fanout, st));
}

REPRO_API const char* fused_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
