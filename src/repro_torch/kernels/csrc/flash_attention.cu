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
// loop stops at the last key tile that touches the CTA's last position
// (causal).  D is a template parameter (16, 32, 64, 112, 128; 112 is
// zamba2-7b's 3584 / 32).  Two bodies:
//
// bf16 (the serving path): Hopper's warp-specialised design.  384 threads
//   = three warpgroups, one CTA an SM (__launch_bounds__(384, 1)).  The
//   work items (128-row q blocks of one batch and kv head) run head by
//   head (the CTAs in flight share a few heads' K and V in L2) and within
//   a head heaviest first (the q blocks with the most keys), one CTA an
//   item; a CTA given several items (a persistent grid, measured and not
//   kept) runs its ring on from one to the next:
//   * a producer warpgroup, lowered to 24 registers a thread by
//     setmaxnreg, in which one thread keeps K and V flowing: TMA tensor
//     loads (cp.async.bulk.tensor, 4-D maps over (D, Hkv, S, B), boxes of
//     (Cw, 1, 128, 1)) into a ring of 3 stages, each a 128-key K tile and
//     V tile.  A stage's "full" mbarrier is armed with its bytes
//     (arrive.expect_tx) and completes when they land; its "empty" one
//     completes when all 8 consumer warps have arrived, and only then is
//     the stage refilled.  Keys past S read as zeros (TMA's out-of-bounds
//     fill), so no tile reads batch b + 1;
//   * two consumer warpgroups, raised to 240 registers, each owning 64 q
//     rows (wgmma's M), so Br = 128 at every D.  Each stages its Q rows
//     once with 16-byte loads into the swizzled layout TMA would give (the
//     rows are not one stride apart when G does not divide 128).  Per key
//     tile t it issues S_t = Q K_t^T (wgmma m64n128k16, both operands
//     K-major in shared memory, D / 16 k16 steps: 7 at D 112) and then
//     O += P_{t-1} V_{t-1} (wgmma m64n{Dp}k16, P from registers, V's
//     [key][d] tile read MN-major by the transpose bit), each its own
//     group; waits for S_t alone and runs the online softmax while P V
//     runs (the overlap within a warpgroup): the causal mask only on tiles
//     that cross the consumer's first position, row max and sum over the
//     4 lanes of a quad, 2^x as one MUFU.EX2 (ex2.approx.ftz) with scale
//     * log2(e) folded into one FMA, m and l in f32; then waits for P V,
//     frees tile t-1's stage (one arrival a warp), rescales O and rounds
//     P_t to bf16 pairs in registers, which are directly the next
//     product's A operand.  The two consumers take turns to issue (named
//     barriers 3 and 4, the ping-pong), so one's products run while the
//     other's softmax does.
//   Tiles are stored as regions of Cw = min(Dp, 64) columns in W = 2 Cw
//   byte swizzle (32 B at D 16, 64 B at D 32, 128 B from D 64 on), the
//   layout both TMA and wgmma's descriptors name.  At D 112 the padded
//   head dim Dp is 128: P V runs N = 128 over TMA's zero columns 112..127
//   (14 % more MMA work for zamba2-7b) and the store drops them.  The
//   epilogue multiplies by one reciprocal of max(l, 1e-30) a row, rounds
//   once to bf16, stages the consumer's rows in its part of the Q tile and
//   writes 16-byte stores.  Given an lse pointer (the training forward,
//   flash_attention_bf16_lse) it also writes each row's log-sum-exp of the
//   scaled scores, m scale + ln(l) in f32, for the backward
//   (flash_attention_bwd.cu): 4 bytes a row beside the output's 2 D.  The primitives are csrc/wgmma.cuh's and
//   csrc/tma.cuh's; scripts/k8_variants.py times the body with each of
//   these choices taken out.
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
#include "tma.cuh"
#include "wgmma.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kKeys = 64;  // keys per K/V tile of the f32 body

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

constexpr int kWg = 128;               // threads of a warpgroup
constexpr int kWsThreads = 3 * kWg;    // producer + two consumers
constexpr int kWsRows = 128;           // q rows a CTA: 64 a consumer
constexpr int kBc = 128;               // keys a K/V tile
constexpr int kConsumerWarps = 8;      // arrivals that free a stage
constexpr int kProducerRegs = 24;      // setmaxnreg: 24 * 128 + 240 * 256
constexpr int kConsumerRegs = 240;     //   = 64,512 of the SM's 65,536

// The layout of one head dim's tiles.  A row of Dp bf16 (D 112 padded to
// 128: TMA fills columns 112..127 with zeros) is stored as Nc regions of Cw
// columns, each region a [rows][Cw] tile in W-byte swizzle (W = 2 Cw: 32 B
// at D 16, 64 B at D 32, 128 B from D 64 on).
template <int D>
struct Ws {
  static constexpr int kDp = D == 112 ? 128 : D;
  static constexpr int kCw = kDp < 64 ? kDp : 64;
  static constexpr int kW = 2 * kCw;
  static constexpr int kNc = kDp / kCw;
  static constexpr int kStages = 3;
  static constexpr uint32_t kQBytes = kWsRows * kDp * 2;
  static constexpr uint32_t kTileBytes = kBc * kDp * 2;  // a K or V tile
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  // + 1024 to align the tiles to a swizzle span, + the full/empty barriers
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(D % 16 == 0 && kDp % kCw == 0, "whole k16 steps");
};

// the W-byte swizzle of a byte offset from a tile region's start (a
// multiple of 8 W): its 16-byte chunk index XOR its row within the span
template <int W>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (W / 16 - 1)) << 4);
}

// One work item: a 128-row q block of one (batch, kv head).
struct WsItem {
  int64_t b, h, r0;
  int n_tiles;
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const bf16* __restrict__ q, bf16* __restrict__ o,
                       float* __restrict__ lse, int64_t nb, int64_t s,
                       int64_t hkv, int64_t g, float scale_log2) {
  using L = Ws<D>;
  constexpr int kDp = L::kDp, kCw = L::kCw, kW = L::kW, KS = L::kStages;
  constexpr int kQRegion = kWsRows * kW;   // bytes of a Q region
  constexpr int kKRegion = kBc * kW;       // bytes of a K or V region
  constexpr int kRowChunks = kDp / 8;      // 16-byte chunks of a padded row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + L::kQBytes;   // [KS][K, V][Nc][kBc][Cw]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + KS * L::kStageBytes);
  uint64_t* empty = full + KS;

  const int tid = threadIdx.x;
  const int64_t n_rows = s * g;
  const int64_t n_blocks = (n_rows + kWsRows - 1) / kWsRows;
  const int64_t n_items = n_blocks * hkv * nb;
  // CTA c takes items c, c + gridDim.x, ... (one, as launched).  Items run
  // head by head, so the CTAs in flight share a few heads' K and V in L2,
  // and each head's q blocks heaviest first: item w is q block n_blocks -
  // 1 - w % n_blocks (the most keys) of head w / n_blocks.
  auto item = [&](int64_t w) {
    WsItem x;
    const int64_t hb = w / n_blocks;
    x.h = hb % hkv;
    x.b = hb / hkv;
    x.r0 = (n_blocks - 1 - w % n_blocks) * kWsRows;
    const int64_t last_row_pos = (x.r0 + kWsRows - 1) / g;
    const int64_t last = last_row_pos < s - 1 ? last_row_pos : s - 1;
    x.n_tiles = static_cast<int>(last / kBc + 1);
    return x;
  };

  if (tid == 0) {
    for (int i = 0; i < KS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (tid < kWg) {
    // producer warpgroup: one thread keeps the ring's TMA loads in flight,
    // across items (`it` counts the CTA's tiles: the ring's position)
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      int it = 0;
      for (int64_t w = blockIdx.x; w < n_items; w += gridDim.x) {
        const WsItem x = item(w);
        for (int t = 0; t < x.n_tiles; ++t, ++it) {
          const int stage = it % KS;
          if (it >= KS) mbar_wait(&empty[stage], ((it / KS) - 1) & 1);
          unsigned char* ks = ring + stage * L::kStageBytes;
          unsigned char* vs = ks + L::kTileBytes;
          mbar_arrive_expect_tx(&full[stage], L::kStageBytes);
#pragma unroll
          for (int c = 0; c < L::kNc; ++c) {
            tma_load_4d(ks + c * kKRegion, &kmap, c * kCw,
                        static_cast<int>(x.h), t * kBc,
                        static_cast<int>(x.b), &full[stage]);
            tma_load_4d(vs + c * kKRegion, &vmap, c * kCw,
                        static_cast<int>(x.h), t * kBc,
                        static_cast<int>(x.b), &full[stage]);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wc owns rows 64 wc .. 64 wc + 63 of each item
  setmaxnreg_inc<kConsumerRegs>();
  const int wc = tid / kWg - 1;
  const int t_wg = tid % kWg, warp = t_wg >> 5, lane = tid & 31;
  const int row_base = 64 * wc;
  // this thread's rows: 16 warp + lane / 4 (+ 8) of the consumer's 64
  const int quad_row = lane >> 2, quad_col = 2 * (lane & 3);
  // where the byte `cb` of a padded row `row` lies in the swizzled Q tile
  auto q_at = [&](int row, int cb) {
    return qs + swz<kW>((cb / kW) * kQRegion + row * kW + cb % kW);
  };

  // descriptors: Q and K K-major, V MN-major (its regions LBO apart)
  const uint64_t q_desc = smem_desc(qs + row_base * kW, 16, 8 * kW, kW);
  auto k_step = [&](int kd) {   // the k16 step's offset (16-byte units)
    return static_cast<uint64_t>(((kd * 16) / kCw) * kKRegion +
                                 ((kd * 16) % kCw) * 2) >> 4;
  };
  auto q_step = [&](int kd) {
    return static_cast<uint64_t>(((kd * 16) / kCw) * kQRegion +
                                 ((kd * 16) % kCw) * 2) >> 4;
  };

  int64_t q_pos[2];
  float m[2], l[2], acc[kDp / 2];
  float sc[kBc / 2];
  uint32_t pa[kBc / 16][4];
  float alpha[2];

  // the products of one step, each closed as its own group: S = Q K^T of
  // tile t (D / 16 k16 steps, both operands K-major) and O += P V of the
  // tile before (P from registers, V's [key][d] tile read MN-major, 16
  // keys a step)
  auto issue_qk = [&](int stage) {
    const uint64_t k_desc =
        smem_desc(ring + stage * L::kStageBytes, 16, 8 * kW, kW);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss<kBc>(sc, q_desc + q_step(kd), k_desc + k_step(kd), kd > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int stage) {
    const uint64_t v_desc = smem_desc(
        ring + stage * L::kStageBytes + L::kTileBytes, kKRegion, 8 * kW, kW);
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk)
      wgmma_rs<kDp>(acc, pa[kk],
                    v_desc + (static_cast<uint64_t>(16 * kk * kW) >> 4), 1);
    wgmma_commit();
  };

  // The online softmax of tile t on its scores in sc (rows live in the 4
  // lanes of a quad; m in raw score units, exp2 of (x - m) * scale*log2e),
  // leaving p in sc and each row's rescale factor in alpha.  The causal
  // mask (which also covers the zero-filled keys past S, all after every
  // row's position; the offset pos0 shifts q and k alike, so it cancels)
  // is compiled only into the steps of tiles that cross a row's position.
  auto softmax = [&](int t, auto masked) {
    if constexpr (decltype(masked)::value) {
      const int64_t j0 = static_cast<int64_t>(t) * kBc;
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t key = j0 + 8 * j + quad_col + (i & 1);
          if (key > q_pos[i >> 1]) sc[4 * j + i] = kNeg;
        }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[hf] = exp2_ftz((m[hf] - mx) * scale_log2);
      const float shift = mx * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          const float p = exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -shift));
          sc[4 * j + e] = p;
          sum += p;
        }
      l[hf] = l[hf] * alpha[hf] + sum;   // this lane's part of the row
      m[hf] = mx;
    }
  };
  // O rescaled to the new row maxima, then P rounded to bf16 pairs: score
  // blocks 2kk and 2kk+1 form key step kk's A fragment
  auto rescale_and_pack = [&] {
#pragma unroll
    for (int j = 0; j < kDp / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] *= alpha[i >> 1];
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // the ring, seen from a consumer: tile i of the CTA (its ring position)
  // has landed / this warp is done with it
  auto wait_full = [&](int i) { mbar_wait(&full[i % KS], (i / KS) & 1); };
  auto free_stage = [&](int i) { mbar_arrive_warp(&empty[i % KS]); };
  // the ping-pong: a consumer issues its products only on its turn (named
  // barrier 3 + wc) and then hands the turn to the other, so one's
  // products run while the other's softmax does
  auto take_turn = [&] { named_bar_sync(3 + wc, 2 * kWg); };
  auto pass_turn = [&] { named_bar_arrive(4 - wc, 2 * kWg); };

  // Per tile t >= 1: wait for its stage; on this consumer's turn issue
  // S_t = Q K_t^T and then O += P_{t-1} V_{t-1}; wait for S_t alone and
  // run the softmax while P V still runs (the overlap within a
  // warpgroup); then wait for P V, free tile t-1's stage, rescale O and
  // pack P_t.  No branch lies between two products: the compiler would
  // serialise them (ptxas C7520).  Both consumers need every tile of the
  // CTA: a tile starts at a position whose first row is a multiple of 128,
  // so the CTA's last tile starts at or before its first row's position.
  auto step = [&](int t, int it, auto masked) {   // it: the ring position
    const int stage = it % KS, prev = (it - 1) % KS;
    wait_full(it);
    take_turn();
    wgmma_fence();
    issue_qk(stage);
    issue_pv(prev);
    pass_turn();
    wgmma_wait<1>();
    wgmma_fence_acc(sc);
    softmax(t, masked);
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    free_stage(it - 1);
    rescale_and_pack();
  };

  // consumer 1 hands consumer 0 the first turn, and consumer 0 takes, at
  // the very end, the turn consumer 1 hands over after its last tile
  if (wc == 1) named_bar_arrive(3, 2 * kWg);
  int it = 0;   // the CTA's tiles consumed so far: the ring's position
  for (int64_t w = blockIdx.x; w < n_items; w += gridDim.x) {
    const WsItem x = item(w);
    auto row_offset = [&](int64_t r) {
      const int64_t i = r / g;
      return ((x.b * s + i) * hkv + x.h) * g * D + (r - i * g) * D;
    };
    // Q: 16-byte loads into the layout TMA would give (rows of one item
    // are not one stride apart when G does not divide 128); zeros past the
    // last row and in the padding columns
    for (int u = t_wg; u < 64 * kRowChunks; u += kWg) {
      const int row = u / kRowChunks, c = u - row * kRowChunks;
      const int64_t r = x.r0 + row_base + row;
      uint4 v = {0u, 0u, 0u, 0u};
      if (r < n_rows && c * 8 < D)
        v = *reinterpret_cast<const uint4*>(q + row_offset(r) + c * 8);
      *reinterpret_cast<uint4*>(q_at(row_base + row, 16 * c)) = v;
    }
    fence_proxy_async();   // the generic writes, before wgmma reads them
    named_bar_sync(1 + wc, kWg);

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      q_pos[hf] = (x.r0 + row_base + 16 * warp + quad_row + 8 * hf) / g;
      m[hf] = kNeg;
      l[hf] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.f;
    // tile 0, then the tiles before the first that crosses a row's
    // position (unmasked), then the rest (masked), then the last tile's
    // P V
    const int64_t first_pos = (x.r0 + row_base) / g;
    const int64_t t_mask64 = (first_pos + 1) / kBc;
    const int t_mask =
        static_cast<int>(t_mask64 < x.n_tiles ? t_mask64 : x.n_tiles);
    wait_full(it);
    take_turn();
    wgmma_fence();
    issue_qk(it % KS);
    pass_turn();
    wgmma_wait<0>();
    wgmma_fence_acc(sc);
    softmax(0, std::true_type{});
    rescale_and_pack();
    int t = 1;
    for (; t < t_mask; ++t) step(t, it + t, std::false_type{});
    for (; t < x.n_tiles; ++t) step(t, it + t, std::true_type{});
    it += x.n_tiles;
    wgmma_fence();
    issue_pv((it - 1) % KS);
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    free_stage(it - 1);

    // epilogue: l over the quad, acc / max(l, 1e-30) (as one reciprocal
    // a row) rounded once to bf16, staged in this consumer's own rows of
    // the Q tile (its products are done: every thread of the warpgroup has
    // passed its last wait), then 16-byte stores of whole rows; the Q tile
    // is free again once every thread has read its rows back
    named_bar_sync(1 + wc, kWg);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int row = row_base + 16 * warp + quad_row + 8 * hf;
      // the row's log-sum-exp of the scaled scores, for the backward
      if (lse != nullptr && (lane & 3) == 0 && x.r0 + row < n_rows)
        lse[(x.b * hkv + x.h) * n_rows + x.r0 + row] =
            (m[hf] * scale_log2 + log2f(lt)) * kLn2;
#pragma unroll
      for (int j = 0; j < kDp / 8; ++j)
        *reinterpret_cast<uint32_t*>(q_at(row, 2 * (8 * j + quad_col))) =
            pack_bf16x2(acc[4 * j + 2 * hf] * inv,
                        acc[4 * j + 2 * hf + 1] * inv);
    }
    named_bar_sync(1 + wc, kWg);
    for (int u = t_wg; u < 64 * (D / 8); u += kWg) {
      const int row = u / (D / 8), c = u - row * (D / 8);
      const int64_t r = x.r0 + row_base + row;
      if (r < n_rows)
        *reinterpret_cast<uint4*>(o + row_offset(r) + c * 8) =
            *reinterpret_cast<const uint4*>(q_at(row_base + row, 16 * c));
    }
    named_bar_sync(1 + wc, kWg);
  }
  if (wc == 0) named_bar_sync(3, 2 * kWg);
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
                        float* lse, int64_t b, int64_t s, int64_t hkv,
                        int64_t g, cudaStream_t st) {
  using L = Ws<D>;
  // k and v as 4-D tensors (D, Hkv, S, B), innermost first, read in boxes
  // of (Cw, 1, kBc, 1): keys past S (and so batch b + 1) read as zeros
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(hkv),
                            static_cast<uint64_t>(s),
                            static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {static_cast<uint64_t>(D) * 2,
                               static_cast<uint64_t>(hkv * D) * 2,
                               static_cast<uint64_t>(s * hkv * D) * 2};
  const uint32_t box[4] = {L::kCw, 1, kBc, 1};
  CUtensorMap kmap, vmap;
  cudaError_t err = encode_tensor_map_4d(&kmap, k, dims, strides, box, L::kW);
  if (err != cudaSuccess) return err;
  err = encode_tensor_map_4d(&vmap, v, dims, strides, box, L::kW);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  // one CTA an item: the hardware hands a free SM the next item, which
  // balanced the causal items better than a persistent grid of one CTA an
  // SM walking a fixed share (scripts/k8_variants.py, "persistent")
  const int64_t grid = ceil_div(s * g, kWsRows) * hkv * b;
  flash_fwd_wgmma_kernel<D><<<static_cast<unsigned>(grid), kWsThreads,
                              L::kSmem, st>>>(
      kmap, vmap, static_cast<const bf16*>(q), static_cast<bf16*>(o), lse, b,
      s, hkv, g, static_cast<float>(inv_sqrt_d<D>() * kLog2e));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(bool is_bf16, const void* q, const void* k,
                     const void* v, void* o, float* lse, int64_t b,
                     int64_t s, int64_t hkv, int64_t g, int64_t pos0,
                     cudaStream_t st) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, lse, b, s, hkv, g, st)
                 : launch_f32<D>(q, k, v, o, b, s, hkv, g, pos0, st);
}

int launch(bool is_bf16, const void* q, const void* k, const void* v,
           void* o, float* lse, int64_t b, int64_t s, int64_t hkv, int64_t g,
           int d, int64_t pos0, void* stream) {
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
          launch_d<16>(is_bf16, q, k, v, o, lse, b, s, hkv, g, pos0, st));
    case 32:
      return static_cast<int>(
          launch_d<32>(is_bf16, q, k, v, o, lse, b, s, hkv, g, pos0, st));
    case 64:
      return static_cast<int>(
          launch_d<64>(is_bf16, q, k, v, o, lse, b, s, hkv, g, pos0, st));
    case 112:
      return static_cast<int>(
          launch_d<112>(is_bf16, q, k, v, o, lse, b, s, hkv, g, pos0, st));
    case 128:
      return static_cast<int>(
          launch_d<128>(is_bf16, q, k, v, o, lse, b, s, hkv, g, pos0, st));
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
  return launch(false, q, k, v, o, nullptr, b, s, hkv, g, d, pos0, stream);
}

REPRO_API int flash_attention_bf16(const void* q, const void* k,
                                   const void* v, void* o, int64_t b,
                                   int64_t s, int64_t hkv, int64_t g, int d,
                                   int64_t pos0, void* stream) {
  return launch(true, q, k, v, o, nullptr, b, s, hkv, g, d, pos0, stream);
}

// The bf16 body that also writes each row's log-sum-exp of the scaled
// scores, lse [b, hkv, s, g] f32 (natural log), which the backward
// (flash_attention_bwd.cu) reads.
REPRO_API int flash_attention_bf16_lse(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int64_t b, int64_t s, int64_t hkv,
                                       int64_t g, int d, void* stream) {
  if (!aligned_to(lse, 4)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(true, q, k, v, o, static_cast<float*>(lse), b, s, hkv, g, d,
                0, stream);
}

// Dynamic shared bytes a CTA of the bf16 body takes at head dim d (0 for
// a head dim it is not built for).
REPRO_API int64_t flash_attention_bf16_smem_bytes(int d) {
  switch (d) {
    case 16: return static_cast<int64_t>(Ws<16>::kSmem);
    case 32: return static_cast<int64_t>(Ws<32>::kSmem);
    case 64: return static_cast<int64_t>(Ws<64>::kSmem);
    case 112: return static_cast<int64_t>(Ws<112>::kSmem);
    case 128: return static_cast<int64_t>(Ws<128>::kSmem);
    default: return 0;
  }
}

REPRO_API const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
