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
// This first version multiplies with fp32 FMAs (67 TFLOP/s, so >= 4.1 ms);
// mma/wgmma and TMA are later work.
//
// Why the tiling differs from the TPU's.  The TPU grid step held a head's
// whole [S, D] K/V stream in VMEM and walked it in 512-key tiles for one
// (b, h, g, 512-row q block).  An SM has 227 KB of shared memory and runs
// blocks in parallel, so here a CTA owns 64 q rows of one (b, kv head):
// rows are (position, head) pairs with the head fastest, so the G query
// heads of each position sit in one CTA and share every K/V tile it
// stages.  K and V stream through shared memory in 64-key tiles (f32,
// rows padded to D + 4 floats so the float4 reads of 8 neighbouring rows
// hit distinct banks).  256 threads form a 16 x 16 grid: thread (ty, tx)
// owns rows 4ty..4ty+3, the scores of keys tx + 16k of the tile, and
// output columns [tx * D/16, (tx+1) * D/16).  Per tile: S = Q K^T (4 x 4
// scores a thread), scale and mask, the row max and sum over the 16
// threads of a row (shuffles), P written transposed to shared memory, then
// acc = alpha * acc + P V.  The tile loop stops at the last tile that
// touches the CTA's last position (causal).  D is a template parameter
// (16, 32, 64, 128).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // q rows (position x head) per CTA
constexpr int kKeys = 64;        // keys per K/V tile
constexpr int kPld = kRows + 4;  // row stride of the transposed P tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t s,
                 int64_t hkv, int64_t g, int64_t pos0, float scale) {
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
  const T* kb = k + (b * s * hkv + h) * D;
  const T* vb = v + (b * s * hkv + h) * D;
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
    T* out = o + row_offset(r) + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[c] = from_f32<T>(acc[rr][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int64_t b, int64_t s, int64_t hkv, int64_t g,
                     int64_t pos0, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // 1 / sqrt(D) rounded from double, as the reference's 1.0 / d ** 0.5
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(static_cast<unsigned>(ceil_div(s * g, kRows)),
                  static_cast<unsigned>(hkv), static_cast<unsigned>(b));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, hkv, g, pos0, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t s, int64_t hkv, int64_t g, int d, int64_t pos0,
           void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || g <= 0)
    return static_cast<int>(cudaSuccess);
  const int64_t align = 4 * static_cast<int64_t>(sizeof(T));
  if (!aligned_to(q, align) || !aligned_to(k, align) ||
      !aligned_to(v, align) || !aligned_to(o, align))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  switch (d) {
    case 16:
      return static_cast<int>(launch_d<T, 16>(q, k, v, o, b, s, hkv, g, pos0, st));
    case 32:
      return static_cast<int>(launch_d<T, 32>(q, k, v, o, b, s, hkv, g, pos0, st));
    case 64:
      return static_cast<int>(launch_d<T, 64>(q, k, v, o, b, s, hkv, g, pos0, st));
    case 128:
      return static_cast<int>(launch_d<T, 128>(q, k, v, o, b, s, hkv, g, pos0, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [b, s, hkv, g, d]; k, v: [b, s, hkv, d]; o: like q.  d in {16, 32, 64,
// 128}; contiguous, 16-byte (f32) or 8-byte (bf16) aligned.
REPRO_API int flash_attention_f32(const void* q, const void* k, const void* v,
                                  void* o, int64_t b, int64_t s, int64_t hkv,
                                  int64_t g, int d, int64_t pos0,
                                  void* stream) {
  return launch<float>(q, k, v, o, b, s, hkv, g, d, pos0, stream);
}

REPRO_API int flash_attention_bf16(const void* q, const void* k,
                                   const void* v, void* o, int64_t b,
                                   int64_t s, int64_t hkv, int64_t g, int d,
                                   int64_t pos0, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, s, hkv, g, d, pos0, stream);
}

REPRO_API const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
