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
// Layer 1 (F=100, O=256, fanout 10) reads ~118 MB and does ~2.7 GFLOP:
// ~35 us of HBM traffic against ~40 us of fp32 FMA at the card's
// non-tensor peak, so the design keeps x_nbr to ONE pass (one block owns up
// to 256 output columns, so no column tile re-reads the neighbours) and
// keeps the aggregate in shared memory.  Each block owns a T_D x T_O output
// tile (T_D = 8*RM rows, T_O = 32*CO columns) and walks F in KT-wide
// slices: it builds the slice of the weighted neighbour aggregate and of the
// scaled self rows in shared memory, stages the matching w_self / w_agg
// slices, and accumulates both products into per-thread f32 registers
// (RM rows x CO columns per thread; a warp reads one broadcast A value and
// 32 consecutive W values per step).  Plain fp32 FMAs: no TF32, no tensor
// cores (a later PR may move the products to wgmma).  Ragged D, F and O
// are masked; the inputs are not padded.
#include "common.cuh"

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

template <int RM, int CO>
void launch(const float* xs, const float* xn, const float* we,
            const float* ss, const float* ws, const float* wa,
            const float* bias, float* out, int64_t D, int64_t F, int64_t O,
            int fanout, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(ceil_div(D, 8 * RM)),
                  static_cast<unsigned>(ceil_div(O, 32 * CO)));
  fused_update_kernel<RM, CO><<<grid, kThreads, 0, st>>>(
      xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout);
}

template <int RM>
void launch_rows(int co, const float* xs, const float* xn, const float* we,
                 const float* ss, const float* ws, const float* wa,
                 const float* bias, float* out, int64_t D, int64_t F,
                 int64_t O, int fanout, cudaStream_t st) {
  switch (co) {
    case 1: launch<RM, 1>(xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st); break;
    case 2: launch<RM, 2>(xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st); break;
    case 4: launch<RM, 4>(xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st); break;
    default: launch<RM, 8>(xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st); break;
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
  if (ceil_div(D, 32) * col_tiles >= 264) {
    launch_rows<4>(co, xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st);
  } else {
    launch_rows<1>(co, xs, xn, we, ss, ws, wa, bias, out, D, F, O, fanout, st);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_API const char* fused_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
