// K8's gradient: the causal grouped-query flash-attention VJP, bf16 on
// Hopper's tensor cores.
//
// Replaces no TPU kernel: the reference differentiates its Pallas forward
// with a jnp recompute VJP (repro/kernels/ops.py:_flash_vjp_bwd), which the
// port's plain version kernels/ref.py:flash_attention_vjp repeats in f32
// torch ops.  On the card that plain version ran the VJP's five products on
// CUDA cores in f32 and its softmax algebra as elementwise kernels over
// [q_block, S] f32 temporaries: about half of an LM training step.  This
// file computes the same cotangents from bf16 q, k, v, the forward's bf16
// output o, the output cotangent dO and the forward's per-row log-sum-exp
// (flash_attention_bf16_lse):
//
//   P  = exp(q . k / sqrt(D) - lse)          (causal: key <= position)
//   dV = P^T dO       dP = dO V^T       Di = rowsum(dO o o)
//   dS = P o (dP - Di)
//   dQ = dS K / sqrt(D)                  dK = dS^T Q / sqrt(D)
//
// with S, P's exponent, lse, Di and every sum in f32; P and dS are rounded
// to bf16 only as tensor-core operands, and dq, dk, dv once at the end.
//
// What bounds it on Hopper: operations.  Five products over the causal half
// of S x S: at musicgen-medium's training shape (B 8, S 1536, 24 heads of
// 64, G 1) 1.45e11 FLOPs a layer, 0.147 ms at the 989 TFLOP/s of bf16
// tensor cores, against ~110 MB of q, k, v, o, dO, dq, dk and dv (0.033 ms)
// and dQ's f32 partial sums (below).
//
// Three kernels, one entry point (flash_attention_bwd_bf16):
//
// 1. flash_bwd_pre_kernel: per q tile row, Di = rowsum(dO o o) in f32 and
//    lse * log2(e), into [B, Hkv, T, 64] (a 256-byte block a tile, so the
//    main kernel bulk-loads it); rows past a tile's positions or past S
//    get Di = 0 and lse = +inf, so their P is exactly 0.  It also zeroes
//    the f32 dQ accumulator [B, Hkv, S * G, Dp].
// 2. flash_bwd_wgmma_kernel: one CTA owns 128 keys of one (batch, kv
//    head), the grid ordered head by head and within a head heaviest first
//    (the first key blocks see the most q tiles).  384 threads = three
//    warpgroups, one CTA an SM:
//    * a producer warpgroup (24 registers a thread) in which one thread
//      loads the CTA's K and V tiles once (TMA, 4-D maps as the forward's)
//      and streams the q tiles that can see them, from the tile holding the
//      block's first key to the last: each a stage of a 2-stage ring with
//      the tile's Q and dO (TMA 5-D maps over (D, G, Hkv, S, B), boxes of
//      64 / G whole positions of G heads: the rows are (position, head)
//      pairs, head fastest, as in the forward, so the G query heads of a
//      position share the CTA's K and V) and its lse and Di blocks (bulk
//      copies).  Positions past S read as zeros;
//    * two consumer warpgroups (240 registers), each owning 64 of the keys
//      (wgmma's M).  Per tile: S^T = K Q^T and dP^T = V dO^T (SS, both
//      K-major, N = 64 rows), P^T = 2^(S^T scale log2(e) - lse) with the
//      causal mask on the tiles that cross the block's keys, dS^T = P^T o
//      (dP^T - Di); dV += P^T dO and dK += dS^T Q (RS: P^T and dS^T rounded
//      to bf16 pairs in registers, the accumulator layout being the A
//      fragment's; Q and dO read MN-major); dS^T stored as bf16 into a
//      shared [128 keys][64 rows] block (128-byte swizzle), then dQ = dS K
//      (SS, both operands MN-major): at Dp >= 64 each consumer takes half of
//      dQ's columns over all 128 keys (a barrier of both consumers a tile
//      between the stores and the product; the block double-buffered, so
//      that one suffices), below that each its own 64 keys (a barrier of
//      the consumer's own warps).
//      dQ's f32 tile is added to the accumulator with vector atomics
//      (atomicAdd of float2, sm_90): the CTAs of a head add into the same
//      rows in no fixed order, so dq's bits vary from run to run in the
//      last place of an f32 sum before its one rounding to bf16.  No check
//      of the card asks for bit-equal runs of a bf16 VJP; a deterministic
//      order would need a second pass over the keys.
//    dK and dV stay in registers over all tiles and are written once.
//    Head dims are regions of Cw = min(Dp, 32) columns in 2 Cw byte
//    swizzle, so that a half of dQ's columns starts a region; D 112 is
//    padded to Dp 128 by TMA's zero columns, as in the forward.  No branch
//    lies between two products of a tile (ptxas C7520).
// 3. flash_bwd_dq_kernel: dq = bf16(acc / sqrt(D)) in q's layout.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

#include <math.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWg = 128;               // threads of a warpgroup
constexpr int kThreads = 3 * kWg;      // producer + two consumers
constexpr int kBk = 128;               // keys a CTA: 64 a consumer
constexpr int kBq = 64;                // q rows a tile
constexpr int kConsumerWarps = 8;      // arrivals that free a stage
constexpr int kProducerRegs = 24;      // setmaxnreg: 24 * 128 + 240 * 256
constexpr int kConsumerRegs = 240;     //   = 64,512 of the SM's 65,536
constexpr int kDsW = 128;              // dS rows: 64 bf16, 128-byte swizzle
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Bw {
  static constexpr int kDp = D == 112 ? 128 : D;
  static constexpr int kCw = kDp < 32 ? kDp : 32;
  static constexpr int kW = 2 * kCw;
  static constexpr int kNc = kDp / kCw;
  static constexpr int kStages = 2;
  // dQ's product: each consumer half the columns over all keys, or (at
  // Dp 16, 32) all columns over its own keys
  static constexpr bool kSplitDq = kDp >= 64;
  static constexpr int kDqN = kSplitDq ? kDp / 2 : kDp;
  static constexpr int kDqKeys = kSplitDq ? kBk : kBk / 2;
  static constexpr uint32_t kKBytes = kBk * kDp * 2;     // a K or V tile
  static constexpr uint32_t kQBytes = kBq * kDp * 2;     // a Q or dO tile
  static constexpr uint32_t kStatBytes = kBq * 4;        // lse or Di
  static constexpr uint32_t kStageBytes = 2 * kQBytes + 2 * kStatBytes;
  static constexpr uint32_t kDsBytes = kBk * kDsW;
  // + 1024 to align the tiles to a swizzle span, + the barriers
  static constexpr size_t kSmem = 1024 + 2 * kKBytes + 2 * kDsBytes +
                                  kStages * kStageBytes +
                                  (2 * kStages + 1) * 8;
  static_assert(D % 16 == 0 && kDp % kCw == 0, "whole k16 steps");
  static_assert(kQBytes % 512 == 0, "stages start a 64-byte swizzle span");
};

// the W-byte swizzle of a byte offset from a tile region's start (a
// multiple of 8 W): its 16-byte chunk index XOR its row within the span
template <int W>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (W / 16 - 1)) << 4);
}

// ----------------------------------------------------------- preprocess

// One thread a q tile row (b, h, t, rr): position t * P + rr / G, head
// rr % G.  Then the dQ accumulator zeroed (n4 float4 units).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_pre_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ lse2,
                     float* __restrict__ di, float4* __restrict__ dq_acc,
                     int64_t n_tile_rows, int64_t s, int64_t hkv, int64_t g,
                     int p_pos, int n_tiles, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  for (int64_t u = first; u < n_tile_rows; u += stride) {
    const int rr = static_cast<int>(u % kBq);
    const int64_t t = (u / kBq) % n_tiles;
    const int64_t hb = u / (static_cast<int64_t>(kBq) * n_tiles);
    const int64_t h = hb % hkv, b = hb / hkv;
    const int64_t i = t * p_pos + rr / g, gi = rr % g;
    float sum = 0.f, l2 = INFINITY;
    if (rr < p_pos * g && i < s) {
      const int64_t off = (((b * s + i) * hkv + h) * g + gi) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(o + off + 8 * c);
        const uint4 y = *reinterpret_cast<const uint4*>(dout + off + 8 * c);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum = fmaf(__low2float(xp[e]), __low2float(yp[e]), sum);
          sum = fmaf(__high2float(xp[e]), __high2float(yp[e]), sum);
        }
      }
      l2 = lse[hb * s * g + i * g + gi] * kLog2e;
    }
    di[u] = sum;
    lse2[u] = l2;
  }
  for (int64_t u = first; u < n4; u += stride)
    dq_acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------- main

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const float* __restrict__ lse2,
                       const float* __restrict__ di,
                       float* __restrict__ dq_acc, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int64_t s, int64_t hkv,
                       int64_t g, int p_pos, int n_tiles_total,
                       float scale_log2, float scale) {
  using L = Bw<D>;
  constexpr int kDp = L::kDp, kCw = L::kCw, kW = L::kW, KS = L::kStages;
  constexpr int kKRegion = kBk * kW;    // bytes of a K or V region
  constexpr int kQRegion = kBq * kW;    // bytes of a Q or dO region
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ks =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + L::kKBytes;
  unsigned char* dss = vs + L::kKBytes;       // [2][kBk][kBq] bf16
  unsigned char* ring = dss + 2 * L::kDsBytes; // [KS][Q, dO, lse, Di]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + KS * L::kStageBytes);
  uint64_t* empty = full + KS;
  uint64_t* kv_full = empty + KS;

  const int tid = threadIdx.x;
  const int64_t n_kb = (s + kBk - 1) / kBk;
  const int64_t hb = blockIdx.x / n_kb;
  const int64_t h = hb % hkv, b = hb / hkv;
  const int64_t j0 = (blockIdx.x % n_kb) * kBk;
  const int64_t n_rows = s * g;
  const int rows_tile = p_pos * static_cast<int>(g);
  // the q tiles that can see the block's keys: from the one holding its
  // first key on; those before t_open hold a position before its last key
  // (the causal mask), the rest see every key of the block
  const int t_first = static_cast<int>(j0 / p_pos);
  const int n_tiles = n_tiles_total - t_first;
  const int64_t t_open = (j0 + kBk - 1 + p_pos - 1) / p_pos;
  const int n_masked = static_cast<int>(
      (t_open < n_tiles_total ? t_open : n_tiles_total) - t_first);

  // the ring zeroed once: a tile of 64 / G positions fills P G < 64 rows
  // when G does not divide 64, and the rest must be zeros, not stale bits
  for (int u = tid; u < static_cast<int>(KS * L::kStageBytes / 16);
       u += kThreads)
    reinterpret_cast<uint4*>(ring)[u] = uint4{0u, 0u, 0u, 0u};
  fence_proxy_async();
  if (tid == 0) {
    for (int i = 0; i < KS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_init(kv_full, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  if (tid < kWg) {
    // producer warpgroup: one thread loads K and V, then keeps the ring's
    // q tiles in flight
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKBytes);
#pragma unroll
      for (int c = 0; c < L::kNc; ++c) {
        tma_load_4d(ks + c * kKRegion, &kmap, c * kCw, static_cast<int>(h),
                    static_cast<int>(j0), static_cast<int>(b), kv_full);
        tma_load_4d(vs + c * kKRegion, &vmap, c * kCw, static_cast<int>(h),
                    static_cast<int>(j0), static_cast<int>(b), kv_full);
      }
      const uint32_t tile_bytes =
          2u * L::kNc * kW * static_cast<uint32_t>(rows_tile) +
          2u * L::kStatBytes;
      for (int n = 0; n < n_tiles; ++n) {
        const int stage = n % KS;
        if (n >= KS) mbar_wait(&empty[stage], ((n / KS) - 1) & 1);
        unsigned char* qs = ring + stage * L::kStageBytes;
        unsigned char* dos = qs + L::kQBytes;
        float* st = reinterpret_cast<float*>(dos + L::kQBytes);
        const int t = t_first + n;
        mbar_arrive_expect_tx(&full[stage], tile_bytes);
#pragma unroll
        for (int c = 0; c < L::kNc; ++c) {
          tma_load_5d(qs + c * kQRegion, &qmap, c * kCw, 0,
                      static_cast<int>(h), t * p_pos, static_cast<int>(b),
                      &full[stage]);
          tma_load_5d(dos + c * kQRegion, &domap, c * kCw, 0,
                      static_cast<int>(h), t * p_pos, static_cast<int>(b),
                      &full[stage]);
        }
        const int64_t st_off = (hb * n_tiles_total + t) * kBq;
        bulk_load(st, lse2 + st_off, L::kStatBytes, &full[stage]);
        bulk_load(st + kBq, di + st_off, L::kStatBytes, &full[stage]);
      }
    }
    return;
  }

  // consumer warpgroup wc owns keys j0 + 64 wc .. j0 + 64 wc + 63
  setmaxnreg_inc<kConsumerRegs>();
  const int wc = tid / kWg - 1;
  const int t_wg = tid % kWg, warp = t_wg >> 5, lane = tid & 31;
  const int kc0 = 64 * wc;
  // accumulator layout (m64nNk16): this thread's rows 16 warp + lane / 4
  // (+ 8) and column pairs 8 j + 2 (lane % 4) (+ 1)
  const int quad_row = lane >> 2, quad_col = 2 * (lane & 3);

  float dv_acc[kDp / 2], dk_acc[kDp / 2];
  float st_acc[kBq / 2], dp_acc[kBq / 2];   // S^T, then P^T; dP^T, then dS^T
  float dq[L::kDqN / 2];
  uint32_t pa[kBq / 16][4], da[kBq / 16][4];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  // descriptors.  This consumer's K and V rows as A (K-major); a tile's Q
  // and dO as B, K-major for S^T and dP^T, MN-major for dV and dK (their
  // regions LBO apart); dS and K both MN-major for dQ
  const uint64_t k_desc = smem_desc(ks + kc0 * kW, 16, 8 * kW, kW);
  const uint64_t v_desc = smem_desc(vs + kc0 * kW, 16, 8 * kW, kW);
  auto d_step = [&](int kd, int region) {   // k16 step kd over the head dim
    return static_cast<uint64_t>(((kd * 16) / kCw) * region +
                                 ((kd * 16) % kCw) * 2) >> 4;
  };
  const int dq_n0 = L::kSplitDq ? wc * L::kDqN : 0;      // dQ's columns
  const int dq_k0 = L::kSplitDq ? 0 : kc0;               // and keys
  const uint64_t kq_desc = smem_desc(
      ks + (dq_n0 / kCw) * kKRegion + dq_k0 * kW, kKRegion, 8 * kW, kW);

  auto issue_s_dp = [&](int stage) {
    unsigned char* qs = ring + stage * L::kStageBytes;
    const uint64_t q_desc = smem_desc(qs, 16, 8 * kW, kW);
    const uint64_t do_desc = smem_desc(qs + L::kQBytes, 16, 8 * kW, kW);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss<kBq>(st_acc, k_desc + d_step(kd, kKRegion),
                    q_desc + d_step(kd, kQRegion), kd > 0);
    wgmma_commit();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_ss<kBq>(dp_acc, v_desc + d_step(kd, kKRegion),
                    do_desc + d_step(kd, kQRegion), kd > 0);
    wgmma_commit();
  };
  auto issue_dv_dk = [&](int stage) {
    unsigned char* qs = ring + stage * L::kStageBytes;
    const uint64_t q_mn = smem_desc(qs, kQRegion, 8 * kW, kW);
    const uint64_t do_mn = smem_desc(qs + L::kQBytes, kQRegion, 8 * kW, kW);
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
      wgmma_rs<kDp>(dv_acc, pa[kk],
                    do_mn + (static_cast<uint64_t>(16 * kk * kW) >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
      wgmma_rs<kDp>(dk_acc, da[kk],
                    q_mn + (static_cast<uint64_t>(16 * kk * kW) >> 4), 1);
    wgmma_commit();
  };
  auto issue_dq = [&](int buf) {
    const uint64_t ds_desc = smem_desc(dss + buf * L::kDsBytes + dq_k0 * kDsW,
                                       L::kDsBytes, 8 * kDsW, kDsW);
#pragma unroll
    for (int kk = 0; kk < L::kDqKeys / 16; ++kk)
      wgmma_ss_mn<L::kDqN>(
          dq, ds_desc + (static_cast<uint64_t>(16 * kk * kDsW) >> 4),
          kq_desc + (static_cast<uint64_t>(16 * kk * kW) >> 4), kk > 0);
    wgmma_commit();
  };

  // P^T in place of S^T: 2^(s scale log2(e) - lse), 0 where the key lies
  // after the row's position (compiled only into the tiles that cross the
  // block's keys; rows past the tile's positions or S have lse = +inf)
  auto probs = [&](int t, const float* st, auto masked) {
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j +
                                                         quad_col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2_ftz(fmaf(st_acc[4 * j + i], scale_log2,
                                -((i & 1) ? l2.y : l2.x)));
        if constexpr (decltype(masked)::value) {
          const int64_t key = j0 + kc0 + 16 * warp + quad_row + 8 * (i >> 1);
          const int rr = 8 * j + quad_col + (i & 1);
          const int64_t pos = static_cast<int64_t>(t) * p_pos +
                              rr / static_cast<int>(g);
          if (key > pos) p = 0.f;
        }
        st_acc[4 * j + i] = p;
      }
    }
  };
  // dS^T in place of dP^T: P^T o (dP^T - Di)
  auto dscores = [&](const float* st) {
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(st + kBq + 8 * j +
                                                         quad_col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp_acc[4 * j + i] =
            st_acc[4 * j + i] * (dp_acc[4 * j + i] - ((i & 1) ? d2.y : d2.x));
    }
  };
  // an accumulator's 16-column blocks rounded to bf16 pairs: A fragments
  auto pack = [&](const float (&x)[kBq / 2], uint32_t (&f)[kBq / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk) {
      f[kk][0] = pack_bf16x2(x[8 * kk], x[8 * kk + 1]);
      f[kk][1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
      f[kk][2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
      f[kk][3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
    }
  };
  // dS^T's bf16 pairs into this consumer's 64 key rows of the dS block
  auto store_ds = [&](int buf) {
    unsigned char* base = dss + buf * L::kDsBytes;
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = kc0 + 16 * warp + quad_row + 8 * hf;
        const uint32_t off = key * kDsW + 2 * (8 * j + quad_col);
        *reinterpret_cast<uint32_t*>(base + swz<kDsW>(off)) =
            pack_bf16x2(dp_acc[4 * j + 2 * hf], dp_acc[4 * j + 2 * hf + 1]);
      }
  };
  // this consumer's dQ block added to the f32 accumulator, rows t P G + rr
  auto add_dq = [&](int t) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = 16 * warp + quad_row + 8 * hf;
      const int64_t r = static_cast<int64_t>(t) * rows_tile + rr;
      if (rr < rows_tile && r < n_rows) {
        float* dst = dq_acc + (hb * n_rows + r) * kDp + dq_n0 + quad_col;
#pragma unroll
        for (int j = 0; j < L::kDqN / 8; ++j)
          atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                    make_float2(dq[4 * j + 2 * hf], dq[4 * j + 2 * hf + 1]));
      }
    }
  };

  // One q tile (ring position n): S^T and dP^T (two groups); P^T while dP^T
  // runs; dS^T; dV and dK (one group); dS^T to shared memory, the rows dQ
  // reads in place (named barrier 1 over both consumers, or 2 + wc over
  // this one's), dQ; then the stage is free and dQ goes out.
  auto step = [&](int n, auto masked) {
    const int stage = n % KS, buf = n & 1, t = t_first + n;
    const float* st = reinterpret_cast<const float*>(
        ring + stage * L::kStageBytes + 2 * L::kQBytes);
    mbar_wait(&full[stage], (n / KS) & 1);
    wgmma_fence();
    issue_s_dp(stage);
    wgmma_wait<1>();
    wgmma_fence_acc(st_acc);
    probs(t, st, masked);
    pack(st_acc, pa);
    wgmma_wait<0>();
    wgmma_fence_acc(dp_acc);
    dscores(st);
    pack(dp_acc, da);
    wgmma_fence();
    issue_dv_dk(stage);
    store_ds(buf);
    fence_proxy_async();   // the generic writes, before wgmma reads them
    if constexpr (L::kSplitDq)
      named_bar_sync(1, 2 * kWg);        // both consumers' halves
    else
      named_bar_sync(2 + wc, kWg);       // this consumer's rows
    wgmma_fence();
    issue_dq(buf);
    wgmma_wait<0>();
    wgmma_fence_acc(dv_acc);
    wgmma_fence_acc(dk_acc);
    wgmma_fence_acc(dq);
    mbar_arrive_warp(&empty[stage]);
    add_dq(t);
  };

  mbar_wait(kv_full, 0);
  int n = 0;
  for (; n < n_masked; ++n) step(n, std::true_type{});
  for (; n < n_tiles; ++n) step(n, std::false_type{});

  // dK (scaled) and dV: this thread's two key rows, column pairs
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t key = j0 + kc0 + 16 * warp + quad_row + 8 * hf;
    if (key >= s) continue;
    const int64_t off = ((b * s + key) * hkv + h) * D;
#pragma unroll
    for (int j = 0; j < kDp / 8; ++j) {
      const int d = 8 * j + quad_col;
      if (d >= D) continue;
      *reinterpret_cast<uint32_t*>(dv + off + d) =
          pack_bf16x2(dv_acc[4 * j + 2 * hf], dv_acc[4 * j + 2 * hf + 1]);
      *reinterpret_cast<uint32_t*>(dk + off + d) =
          pack_bf16x2(dk_acc[4 * j + 2 * hf] * scale,
                      dk_acc[4 * j + 2 * hf + 1] * scale);
    }
  }
}

// ------------------------------------------------------------ epilogue

// dq[b, i, h, gi, :] = bf16(acc[b, h, i G + gi, :D] * scale), 8 a thread
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                    int64_t n_chunks, int64_t s, int64_t hkv, int64_t g,
                    float scale) {
  constexpr int kDp = Bw<D>::kDp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       u < n_chunks; u += stride) {
    const int64_t c = u % (D / 8), row = u / (D / 8);
    const int64_t gi = row % g, r2 = row / g;
    const int64_t h = r2 % hkv, r3 = r2 / hkv;
    const int64_t i = r3 % s, b = r3 / s;
    const float* src =
        dq_acc + ((b * hkv + h) * s * g + i * g + gi) * kDp + 8 * c;
    const float4 x = *reinterpret_cast<const float4*>(src);
    const float4 y = *reinterpret_cast<const float4*>(src + 4);
    uint4 out;
    out.x = pack_bf16x2(x.x * scale, x.y * scale);
    out.y = pack_bf16x2(x.z * scale, x.w * scale);
    out.z = pack_bf16x2(y.x * scale, y.y * scale);
    out.w = pack_bf16x2(y.z * scale, y.w * scale);
    *reinterpret_cast<uint4*>(dq + row * D + 8 * c) = out;
  }
}

// ------------------------------------------------------------- launcher

// 1 / sqrt(D) rounded from double, as the reference's 1.0 / d ** 0.5
template <int D>
double inv_sqrt_d() { return 1.0 / sqrt(static_cast<double>(D)); }

// positions a q tile, and q tiles a head
int64_t tile_positions(int64_t g) { return kBq / g; }
int64_t n_tiles_of(int64_t s, int64_t g) {
  return ceil_div(s, tile_positions(g));
}

int64_t grid_stride_blocks(int64_t work) {
  const int64_t blocks = ceil_div(work, 256);
  return blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dq, void* dk, void* dv, float* scratch, int64_t b,
                   int64_t s, int64_t hkv, int64_t g, cudaStream_t st) {
  using L = Bw<D>;
  const int p_pos = static_cast<int>(tile_positions(g));
  const int n_tiles = static_cast<int>(n_tiles_of(s, g));
  const int64_t n_tile_rows = b * hkv * n_tiles * kBq;
  const int64_t acc_floats = b * hkv * s * g * L::kDp;
  float* dq_acc = scratch;
  float* lse2 = scratch + acc_floats;
  float* di = lse2 + n_tile_rows;
  const float scale = static_cast<float>(inv_sqrt_d<D>());
  const float scale_log2 =
      static_cast<float>(inv_sqrt_d<D>() * 1.4426950408889634);

  const unsigned pre_grid = static_cast<unsigned>(grid_stride_blocks(
      n_tile_rows > acc_floats / 4 ? n_tile_rows : acc_floats / 4));
  flash_bwd_pre_kernel<D><<<pre_grid, 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), lse2, di,
      reinterpret_cast<float4*>(dq_acc), n_tile_rows, s, hkv, g, p_pos,
      n_tiles, acc_floats / 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // k, v as (D, Hkv, S, B) in boxes of (Cw, 1, 128, 1); q, dO as (D, G,
  // Hkv, S, B) in boxes of (Cw, G, 1, P, 1): P whole positions of G heads
  const uint64_t kdims[4] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(hkv),
                             static_cast<uint64_t>(s),
                             static_cast<uint64_t>(b)};
  const uint64_t kstrides[3] = {static_cast<uint64_t>(D) * 2,
                                static_cast<uint64_t>(hkv * D) * 2,
                                static_cast<uint64_t>(s * hkv * D) * 2};
  const uint32_t kbox[4] = {L::kCw, 1, kBk, 1};
  const uint64_t qdims[5] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(g),
                             static_cast<uint64_t>(hkv),
                             static_cast<uint64_t>(s),
                             static_cast<uint64_t>(b)};
  const uint64_t qstrides[4] = {static_cast<uint64_t>(D) * 2,
                                static_cast<uint64_t>(g * D) * 2,
                                static_cast<uint64_t>(hkv * g * D) * 2,
                                static_cast<uint64_t>(s * hkv * g * D) * 2};
  const uint32_t qbox[5] = {L::kCw, static_cast<uint32_t>(g), 1,
                            static_cast<uint32_t>(p_pos), 1};
  CUtensorMap kmap, vmap, qmap, domap;
  err = encode_tensor_map_4d(&kmap, k, kdims, kstrides, kbox, L::kW);
  if (err == cudaSuccess)
    err = encode_tensor_map_4d(&vmap, v, kdims, kstrides, kbox, L::kW);
  if (err == cudaSuccess)
    err = encode_tensor_map_5d(&qmap, q, qdims, qstrides, qbox, L::kW);
  if (err == cudaSuccess)
    err = encode_tensor_map_5d(&domap, dout, qdims, qstrides, qbox, L::kW);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const int64_t grid = ceil_div(s, kBk) * hkv * b;
  flash_bwd_wgmma_kernel<D><<<static_cast<unsigned>(grid), kThreads,
                              L::kSmem, st>>>(
      kmap, vmap, qmap, domap, lse2, di, dq_acc, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, hkv, g, p_pos, n_tiles, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n_chunks = b * s * hkv * g * (D / 8);
  const unsigned dq_grid =
      static_cast<unsigned>(grid_stride_blocks(n_chunks));
  flash_bwd_dq_kernel<D><<<dq_grid, 256, 0, st>>>(
      dq_acc, static_cast<bf16*>(dq), n_chunks, s, hkv, g, scale);
  return cudaGetLastError();
}

}  // namespace

// f32 scratch the backward needs at a shape: the dQ accumulator [b, hkv,
// s g, Dp] and the per-tile lse and Di blocks [b, hkv, T, 64] each; 0 for a
// head dim or group the kernel is not built for.
REPRO_API int64_t flash_attention_bwd_scratch_floats(int64_t b, int64_t s,
                                                     int64_t hkv, int64_t g,
                                                     int d) {
  if (g < 1 || g > kBq || (d != 16 && d != 32 && d != 64 && d != 112 &&
                           d != 128))
    return 0;
  const int64_t dp = d == 112 ? 128 : d;
  return b * hkv * s * g * dp + 2 * b * hkv * n_tiles_of(s, g) * kBq;
}

// q, o, dout, dq: [b, s, hkv, g, d] bf16; k, v, dk, dv: [b, s, hkv, d]
// bf16; lse [b, hkv, s, g] f32 from flash_attention_bf16_lse; scratch of
// flash_attention_bwd_scratch_floats f32.  Contiguous; q, k, v, o, dout, dq
// and scratch 16-byte aligned, dk and dv 4-byte.  d in {16, 32, 64, 112,
// 128}, 1 <= g <= 64.
REPRO_API int flash_attention_bwd_bf16(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* dq, void* dk, void* dv,
                                       void* scratch, int64_t b, int64_t s,
                                       int64_t hkv, int64_t g, int d,
                                       void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0) return static_cast<int>(cudaSuccess);
  if (g < 1 || g > kBq) return static_cast<int>(cudaErrorInvalidValue);
  const void* a16[] = {q, k, v, o, dout, dq, scratch};
  for (const void* p : a16)
    if (!aligned_to(p, 16)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned_to(dk, 4) || !aligned_to(dv, 4) || !aligned_to(lse, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  float* sc = static_cast<float*>(scratch);
  switch (d) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, o, dout, lse, dq, dk, dv,
                                         sc, b, s, hkv, g, st));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, o, dout, lse, dq, dk, dv,
                                         sc, b, s, hkv, g, st));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, dout, lse, dq, dk, dv,
                                         sc, b, s, hkv, g, st));
    case 112:
      return static_cast<int>(launch<112>(q, k, v, o, dout, lse, dq, dk, dv,
                                          sc, b, s, hkv, g, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, dout, lse, dq, dk, dv,
                                          sc, b, s, hkv, g, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared bytes a CTA of the main kernel takes at head dim d (0 for
// a head dim it is not built for).
REPRO_API int64_t flash_attention_bwd_smem_bytes(int d) {
  switch (d) {
    case 16: return static_cast<int64_t>(Bw<16>::kSmem);
    case 32: return static_cast<int64_t>(Bw<32>::kSmem);
    case 64: return static_cast<int64_t>(Bw<64>::kSmem);
    case 112: return static_cast<int64_t>(Bw<112>::kSmem);
    case 128: return static_cast<int64_t>(Bw<128>::kSmem);
    default: return 0;
  }
}

REPRO_API const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
