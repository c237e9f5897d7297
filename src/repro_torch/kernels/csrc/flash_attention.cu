// K8: causal grouped-query flash attention, forward (the LM's prefill).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_call (body _flash_kernel), wrapped by
// repro/kernels/ops.py:flash_attention and reached through
// repro/models/layers.py:attention(impl="flash").
//
//   q [B, S, Hkv, G, D], k/v [B, S, Hkv, D] -> o [B, S, Hkv, G, D]
//   o[b,i,h,g] = sum_{j <= i} softmax_j(q[b,i,h,g] . k[b,j,h] / sqrt(D))
//                * v[b,j,h]
//
// computed in f32 (scores, running max m, running sum l, accumulator acc)
// and rounded once to the input dtype: acc / max(l, 1e-30).  Masked scores
// are -1e30, as in the reference.
//
// What bounds it on Hopper: operations.  At the serving slice's prefill
// (llama3.2-1b: B 4, S 4096, Hkv 8, G 4, D 64, bf16) one launch does
// 2*B*Hq*D*S^2 = 2.75e11 causal FLOPs against 168 MB of q, k, v and o:
// 0.278 ms at the 989 TFLOP/s of bf16 tensor cores, 0.050 ms of bytes.
//
// Why the tiling differs from the TPU's.  The TPU grid step held a head's
// whole [S, D] K/V stream in VMEM and walked it in 512-key tiles for one
// (b, h, g, 512-row q block).  An SM has 227 KB of shared memory and runs
// blocks in parallel, so here a CTA owns a block of q rows of one (b, kv
// head): rows are (position, head) pairs with the head fastest, so the G
// query heads of each position sit in one CTA and share every K/V tile it
// stages (for any G: with G = 3 a CTA may start mid-position).  The tile
// loop stops at the last 64-key tile that touches the CTA's last position
// (causal).  D is a template parameter (16, 32, 64, 112, 128; 112 is
// zamba2-7b's 3584 / 32).  Two bodies:
//
// bf16 (the serving path): FlashAttention-2's structure on tensor cores.
//   128 threads = 4 warps; a warp owns 32 q rows (two m16 tiles) for
//   D <= 64 and 16 at D = 112 and 128, so a CTA holds Br = 128 or 64 rows
//   and the O and S accumulators fit in registers.  Every ldmatrix.x4
//   covers one k16 step of d (Q's A-fragments, K's B-fragments of two n8
//   key tiles) or two n8 output tiles (V's), so D needs only be a multiple
//   of 16: at D = 112 there are 7 k16 steps (an odd count is fine) and 7
//   pairs of output tiles.  The Q tile is copied once with
//   cp.async into shared memory (bf16, rows padded by 16 B so the 8 row
//   addresses of each ldmatrix hit distinct banks) and moved into
//   registers as mma A-fragments (ldmatrix.x4) for the whole KV loop.  K
//   and V stream through a two-stage ring of bf16 [64][D] tiles filled by
//   cp.async (zero fill past S): tile t+1's copies are in flight while
//   tile t's products run, with one barrier per tile.  S = Q K^T is
//   mma.m16n8k16 (bf16 in, f32 accumulate) with K's B-fragments by
//   ldmatrix.x4 from the row-major [key][d] tile; the online softmax runs
//   on the accumulator fragments (row max and sum over the 4 lanes of a
//   quad, exp2f with scale * log2(e) folded into one FMA, m and l in f32;
//   the causal mask only in tiles that cross the CTA's first position,
//   which covers the zero-filled keys past S); P is rounded to bf16 pairs
//   in registers and is directly the A operand of O += P V (two n8 score
//   tiles form one k16 A tile), V's B-fragments by ldmatrix.x4.trans from
//   the same row-major tile.  P never touches shared memory; l sums the
//   f32 p.  CTAs launch heaviest first (the q block is
//   n_blocks - 1 - blockIdx.x).  The epilogue divides by max(l, 1e-30),
//   rounds once to bf16, stages the warp's rows in its part of the Q tile
//   and writes 16-byte stores.
//
// f32 (tests and the card check, held to 2e-5, so exact f32 and no TF32):
//   256 threads form a 16 x 16 grid over 64 q rows: thread (ty, tx) owns
//   rows 4ty..4ty+3, the scores of keys tx + 16k of the tile, and output
//   columns [tx * D/16, (tx+1) * D/16) (7 at D = 112, read as scalars: the
//   16 threads of a row hit distinct banks for any odd D/16).  K and V are
//   f32 tiles in shared memory (rows padded to D + 4 floats: conflict-free
//   float4 reads of Q K^T's d steps).  Per
//   tile: S = Q K^T with fp32 FMAs, scale and mask, the row max and sum
//   over the 16 threads of a row (shuffles), P written transposed to
//   shared memory, then acc = alpha * acc + P V.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kKeys = 64;  // keys per K/V tile (both bodies)

// ------------------------------------------------------------ f32 body

constexpr int kThreads = 256;
constexpr int kRows = 64;        // q rows (position x head) per CTA
constexpr int kPld = kRows + 4;  // row stride of the transposed P tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// max / sum over the 16 threads that share a row (one half of a warp)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         static_cast<size_t>(kRows * (D + 4) + 2 * kKeys * (D + 4) +
                             kKeys * kPld);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int64_t s, int64_t hkv, int64_t g, int64_t pos0,
                 float scale) {
  constexpr int kLd = D + 4;      // padded row stride of the q/k/v tiles
  constexpr int kVec = D / 4;     // float4 units in a row
  constexpr int kCols = D / 16;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kRows][kLd]
  float* ks = qs + kRows * kLd;                // [kKeys][kLd]
  float* vs = ks + kKeys * kLd;                // [kKeys][kLd]
  float* ps = vs + kKeys * kLd;                // [kKeys][kPld]: P^T

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t n_rows = s * g;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t kv_stride = hkv * D;  // between two positions of k / v
  const float* kb = k + (b * s * hkv + h) * D;
  const float* vb = v + (b * s * hkv + h) * D;
  // q/o row r = i * g + gi of (b, h) starts at ((b*s + i)*hkv + h)*g*D + gi*D
  auto row_offset = [&](int64_t r) {
    const int64_t i = r / g;
    return ((b * s + i) * hkv + h) * g * D + (r - i * g) * D;
  };

  for (int u = tid; u < kRows * kVec; u += kThreads) {
    const int row = u / kVec, c = (u - row * kVec) * 4;
    const int64_t r = r0 + row;
    store4(qs + row * kLd + c, r < n_rows ? load4(q + row_offset(r) + c)
                                          : make_float4(0.f, 0.f, 0.f, 0.f));
  }

  int64_t q_pos[4];
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    q_pos[rr] = pos0 + (r0 + 4 * ty + rr) / g;
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[rr][c] = 0.f;
  }
  const int64_t last_row_pos = (r0 + kRows - 1) / g;
  const int64_t last = last_row_pos < s - 1 ? last_row_pos : s - 1;
  const int64_t n_tiles = last / kKeys + 1;

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t j0 = t * kKeys;
    __syncthreads();  // q staged; the last tile's readers are done
    for (int u = tid; u < kKeys * kVec; u += kThreads) {
      const int key = u / kVec, c = (u - key * kVec) * 4;
      const int64_t j = j0 + key;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (j < s) {
        kx = load4(kb + j * kv_stride + c);
        vx = load4(vb + j * kv_stride + c);
      }
      store4(ks + key * kLd + c, kx);
      store4(vs + key * kLd + c, vx);
    }
    __syncthreads();

    // S = Q K^T: rows 4ty..4ty+3, keys tx + 16kk
    float sc[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sc[rr][kk] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kx[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        qa[rr] = *reinterpret_cast<const float4*>(qs + (4 * ty + rr) * kLd + d);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        kx[kk] = *reinterpret_cast<const float4*>(ks + (tx + 16 * kk) * kLd + d);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float a = sc[rr][kk];
          a = fmaf(qa[rr].x, kx[kk].x, a);
          a = fmaf(qa[rr].y, kx[kk].y, a);
          a = fmaf(qa[rr].z, kx[kk].z, a);
          a = fmaf(qa[rr].w, kx[kk].w, a);
          sc[rr][kk] = a;
        }
    }

    // scale, causal mask, online softmax (each row over its 16 threads)
    float alpha[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float mx = kNeg;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int64_t kv_pos = pos0 + j0 + tx + 16 * kk;
        const float x = kv_pos <= q_pos[rr] ? sc[rr][kk] * scale : kNeg;
        sc[rr][kk] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[rr], row_max(mx));
      alpha[rr] = expf(m[rr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float p = expf(sc[rr][kk] - m_new);
        sc[rr][kk] = p;
        sum += p;
      }
      l[rr] = l[rr] * alpha[rr] + row_sum(sum);
      m[rr] = m_new;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      store4(ps + (tx + 16 * kk) * kPld + 4 * ty,
             make_float4(sc[0][kk], sc[1][kk], sc[2][kk], sc[3][kk]));
    __syncthreads();

    // acc = alpha * acc + P V: rows 4ty..4ty+3, columns tx*kCols..
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[rr][c] *= alpha[rr];
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(ps + key * kPld +
                                                        4 * ty);
      const float* vrow = vs + key * kLd + tx * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vrow[c];
        acc[0][c] = fmaf(p.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int64_t r = r0 + 4 * ty + rr;
    if (r >= n_rows) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    float* out = o + row_offset(r) + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[c] = acc[rr][c] / denom;
  }
}

// ----------------------------------------------------------- bf16 body

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;

// m16 tiles a warp owns: two for D <= 64, one at D = 128 (registers)
template <int D>
__host__ __device__ constexpr int tc_mtiles() { return D <= 64 ? 2 : 1; }

template <int D>
__host__ __device__ constexpr int tc_rows() {
  return 16 * kTcWarps * tc_mtiles<D>();
}

// Q tile [Br][D + 8] and a two-stage ring of K and V tiles [64][D + 8]
template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) *
         static_cast<size_t>((tc_rows<D>() + 2 * 2 * kKeys) * (D + 8));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int64_t s, int64_t hkv, int64_t g, float scale_log2) {
  constexpr int MT = tc_mtiles<D>();     // m16 tiles per warp
  constexpr int kBr = tc_rows<D>();      // q rows per CTA
  constexpr int kLd = D + 8;             // padded row (bf16): +16 bytes
  constexpr int kChunks = D / 8;         // 16-byte chunks in a row
  constexpr int KD = D / 16;             // k16 steps of Q K^T over d
  constexpr int NS = kKeys / 8;          // n8 score tiles of a key tile
  constexpr int NO = D / 8;              // n8 output tiles
  static_assert(D % 16 == 0, "whole k16 steps and n8 output-tile pairs");
  static_assert(kKeys * kChunks % kTcThreads == 0 &&
                kBr * kChunks % kTcThreads == 0 &&
                16 * MT * kChunks % 32 == 0, "whole copy rounds");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kBr][kLd]
  bf16* ring = qs + kBr * kLd;               // [2][K, V][kKeys][kLd]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad_row = lane >> 2, quad_col = 2 * (lane & 3);
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t n_rows = s * g;
  // heaviest first: the last q block (the most keys) launches first
  const int64_t r0 =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBr;
  const int64_t kv_stride = hkv * D;
  const bf16* kb = k + (b * s * hkv + h) * D;
  const bf16* vb = v + (b * s * hkv + h) * D;
  auto row_offset = [&](int64_t r) {
    const int64_t i = r / g;
    return ((b * s + i) * hkv + h) * g * D + (r - i * g) * D;
  };
  auto load_kv = [&](int64_t t, int stage) {
    bf16* ks = ring + stage * 2 * kKeys * kLd;
    bf16* vs = ks + kKeys * kLd;
#pragma unroll
    for (int it = 0; it < kKeys * kChunks / kTcThreads; ++it) {
      const int u = tid + it * kTcThreads;
      const int key = u / kChunks, c = (u - key * kChunks) * 8;
      const int64_t j = t * kKeys + key;
      const int64_t off = j < s ? j * kv_stride + c : 0;
      cp_async_16(ks + key * kLd + c, kb + off, j < s);
      cp_async_16(vs + key * kLd + c, vb + off, j < s);
    }
  };

#pragma unroll
  for (int it = 0; it < kBr * kChunks / kTcThreads; ++it) {
    const int u = tid + it * kTcThreads;
    const int row = u / kChunks, c = (u - row * kChunks) * 8;
    const int64_t r = r0 + row;
    cp_async_16(qs + row * kLd + c, q + (r < n_rows ? row_offset(r) : 0) + c,
                r < n_rows);
  }
  load_kv(0, 0);
  cp_async_commit();

  // this thread's rows: warp * 16 * MT + mt * 16 + quad_row + 8 * half
  const int warp_row = warp * 16 * MT;
  int64_t q_pos[MT][2];
  float m[MT][2], l[MT][2], acc[MT][NO][4];
  uint32_t qf[MT][KD][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      q_pos[mt][hf] = (r0 + warp_row + mt * 16 + quad_row + 8 * hf) / g;
      m[mt][hf] = kNeg;
      l[mt][hf] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
  const int64_t first_pos = r0 / g;
  const int64_t last_row_pos = (r0 + kBr - 1) / g;
  const int64_t last = last_row_pos < s - 1 ? last_row_pos : s - 1;
  const int64_t n_tiles = last / kKeys + 1;

  for (int64_t t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    // tile t (and at t = 0 the Q tile) landed for every thread; every
    // warp is done with tile t - 1, so its stage takes tile t + 1
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const int row = warp_row + mt * 16 + (lane & 7) +
                          ((lane >> 3) & 1) * 8;
          ldmatrix_x4(qf[mt][kd], qs + row * kLd + kd * 16 + (lane >> 4) * 8);
        }
    }
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    const bf16* ks = ring + (t & 1) * 2 * kKeys * kLd;
    const bf16* vs = ks + kKeys * kLd;
    const int64_t j0 = t * kKeys;

    // S = Q K^T on the tensor cores: per k16 step, one ldmatrix.x4 gives
    // the B-fragments of two n8 key tiles
    float sc[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(kf, ks + key * kLd + kd * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(sc[mt][2 * np], qf[mt][kd], kf[0], kf[1]);
          mma_bf16_16816(sc[mt][2 * np + 1], qf[mt][kd], kf[2], kf[3]);
        }
      }

    // the causal mask (which also covers the zero-filled keys past S, all
    // after every row's position) only where the tile crosses a row's
    // position; the offset pos0 shifts q and k alike, so it cancels
    if (j0 + kKeys - 1 > first_pos) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t j = j0 + nt * 8 + quad_col + (e & 1);
            if (j > q_pos[mt][e >> 1]) sc[mt][nt][e] = kNeg;
          }
    }

    // online softmax on the accumulator fragments: a row lives in the 4
    // lanes of a quad; m in raw score units, exp2 of (x - m) * scale*log2e
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = m[mt][hf];
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
          mx = fmaxf(mx, fmaxf(sc[mt][nt][2 * hf], sc[mt][nt][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f((m[mt][hf] - mx) * scale_log2);
        const float shift = mx * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            const float p = exp2f(fmaf(sc[mt][nt][e], scale_log2, -shift));
            sc[mt][nt][e] = p;
            sum += p;
          }
        l[mt][hf] = l[mt][hf] * alpha + sum;  // this lane's part of the row
        m[mt][hf] = mx;
#pragma unroll
        for (int nt = 0; nt < NO; ++nt) {
          acc[mt][nt][2 * hf] *= alpha;
          acc[mt][nt][2 * hf + 1] *= alpha;
        }
      }

    // O += P V: the score tiles 2kk and 2kk+1 are the A-fragment of key
    // step kk; one ldmatrix.x4.trans gives V's B-fragments of two n8
    // output tiles
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16x2(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16x2(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16x2(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16x2(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vf[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vf, vs + key * kLd + dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(acc[mt][2 * dp], pa[mt], vf[0], vf[1]);
          mma_bf16_16816(acc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
  }

  // epilogue: l over the quad, acc / max(l, 1e-30) rounded once to bf16,
  // staged in this warp's own rows of the Q tile (read only by this warp,
  // at t = 0), then 16-byte stores of whole rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float denom = fmaxf(lt, 1e-30f);
      bf16* row = qs + (warp_row + mt * 16 + quad_row + 8 * hf) * kLd;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        *reinterpret_cast<uint32_t*>(row + nt * 8 + quad_col) =
            pack_bf16x2(acc[mt][nt][2 * hf] / denom,
                        acc[mt][nt][2 * hf + 1] / denom);
    }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * MT * kChunks / 32; ++it) {
    const int u = lane + 32 * it;
    const int row = u / kChunks, c = (u - row * kChunks) * 8;
    const int64_t r = r0 + warp_row + row;
    if (r < n_rows)
      *reinterpret_cast<uint4*>(o + row_offset(r) + c) =
          *reinterpret_cast<const uint4*>(qs + (warp_row + row) * kLd + c);
  }
}

// ------------------------------------------------------------- launchers

constexpr double kLog2e = 1.4426950408889634;

// 1 / sqrt(D) rounded from double, as the reference's 1.0 / d ** 0.5
template <int D>
double inv_sqrt_d() { return 1.0 / sqrt(static_cast<double>(D)); }

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int64_t b, int64_t s, int64_t hkv, int64_t g,
                       int64_t pos0, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(ceil_div(s * g, kRows)),
                  static_cast<unsigned>(hkv), static_cast<unsigned>(b));
  flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, hkv, g, pos0,
      static_cast<float>(inv_sqrt_d<D>()));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int64_t b, int64_t s, int64_t hkv, int64_t g,
                        cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(ceil_div(s * g, tc_rows<D>())),
                  static_cast<unsigned>(hkv), static_cast<unsigned>(b));
  flash_fwd_bf16_kernel<D><<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), s, hkv, g,
      static_cast<float>(inv_sqrt_d<D>() * kLog2e));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(bool is_bf16, const void* q, const void* k,
                     const void* v, void* o, int64_t b, int64_t s,
                     int64_t hkv, int64_t g, int64_t pos0, cudaStream_t st) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, b, s, hkv, g, st)
                 : launch_f32<D>(q, k, v, o, b, s, hkv, g, pos0, st);
}

int launch(bool is_bf16, const void* q, const void* k, const void* v,
           void* o, int64_t b, int64_t s, int64_t hkv, int64_t g, int d,
           int64_t pos0, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || g <= 0)
    return static_cast<int>(cudaSuccess);
  // both bodies move 16-byte units (float4; cp.async and uint4 for bf16)
  if (!aligned_to(q, 16) || !aligned_to(k, 16) || !aligned_to(v, 16) ||
      !aligned_to(o, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  switch (d) {
    case 16:
      return static_cast<int>(
          launch_d<16>(is_bf16, q, k, v, o, b, s, hkv, g, pos0, st));
    case 32:
      return static_cast<int>(
          launch_d<32>(is_bf16, q, k, v, o, b, s, hkv, g, pos0, st));
    case 64:
      return static_cast<int>(
          launch_d<64>(is_bf16, q, k, v, o, b, s, hkv, g, pos0, st));
    case 112:
      return static_cast<int>(
          launch_d<112>(is_bf16, q, k, v, o, b, s, hkv, g, pos0, st));
    case 128:
      return static_cast<int>(
          launch_d<128>(is_bf16, q, k, v, o, b, s, hkv, g, pos0, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [b, s, hkv, g, d]; k, v: [b, s, hkv, d]; o: like q.  d in {16, 32, 64,
// 112, 128}; contiguous, every base pointer 16-byte aligned.
REPRO_API int flash_attention_f32(const void* q, const void* k, const void* v,
                                  void* o, int64_t b, int64_t s, int64_t hkv,
                                  int64_t g, int d, int64_t pos0,
                                  void* stream) {
  return launch(false, q, k, v, o, b, s, hkv, g, d, pos0, stream);
}

REPRO_API int flash_attention_bf16(const void* q, const void* k,
                                   const void* v, void* o, int64_t b,
                                   int64_t s, int64_t hkv, int64_t g, int d,
                                   int64_t pos0, void* stream) {
  return launch(true, q, k, v, o, b, s, hkv, g, d, pos0, stream);
}

REPRO_API const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
