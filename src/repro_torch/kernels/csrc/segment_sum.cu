// K3: regular-layout weighted segment sum (the paper's scatter-gather
// aggregation stage, agg_impl="pallas"/"kernel").
//
// Replaces the TPU kernel repro/kernels/gather_scatter_mm.py:
// segment_sum_kernel_call (body _segsum_kernel), wrapped by
// repro/kernels/ops.py:segment_weighted_sum_regular.
//
//   out[d, f] = sum_{j < fanout} w[d*fanout + j] * x[d*fanout + j, f]
//
// accumulated in f32 and cast back to x's dtype (round to nearest even).
//
// What bounds it on Hopper: bytes.  x is read once (D*fanout*F elements) and
// out written once, with fanout multiply-adds per output element.  The TPU
// kernel DMA'd (T_D*fanout, T_F) tiles into VMEM; here each thread owns one
// (d, vector of VEC columns) output, walks the d's fanout rows with vector
// loads (16 bytes for f32, 8 bytes for bf16 when F and the pointers allow)
// and keeps its sum in registers.  Neighbouring threads own neighbouring
// column vectors of the same rows, so every load of a warp is coalesced
// along F; the edge weight is one broadcast load per (d, j).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) p[i] = from_f32<T>(v[i]);
}

template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p,
                                                   const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int64_t d, int64_t f, int fanout) {
  const int64_t nvec = f / VEC;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= d * nvec) return;
  const int64_t row = idx / nvec;
  const int64_t col = (idx - row * nvec) * VEC;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  const int64_t e0 = row * fanout;
  for (int j = 0; j < fanout; ++j) {
    const float wj = to_f32(w[e0 + j]);
    float v[VEC];
    load_vec<VEC>(x + (e0 + j) * f + col, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += wj * v[i];
  }
  store_vec<T, VEC>(out + row * f + col, acc);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int64_t d, int64_t f,
           int fanout, void* stream) {
  if (d <= 0 || f <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = as_stream(stream);
  const int64_t vec_bytes = 4 * static_cast<int64_t>(sizeof(T));
  const bool vec4 = f % 4 == 0 && aligned_to(x, vec_bytes) &&
                    aligned_to(out, vec_bytes);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vec4) {
    const int64_t blocks = ceil_div(d * (f / 4), kThreads);
    segment_sum_kernel<T, 4><<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(xp, wp, op, d, f, fanout);
  } else {
    const int64_t blocks = ceil_div(d * f, kThreads);
    segment_sum_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0,
                               st>>>(xp, wp, op, d, f, fanout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [d*fanout, f]; w: [d*fanout] (same dtype as x); out: [d, f].
REPRO_API int segment_sum_f32(const void* x, const void* w, void* out,
                              int64_t d, int64_t f, int fanout, void* stream) {
  return launch<float>(x, w, out, d, f, fanout, stream);
}

REPRO_API int segment_sum_bf16(const void* x, const void* w, void* out,
                               int64_t d, int64_t f, int fanout,
                               void* stream) {
  return launch<__nv_bfloat16>(x, w, out, d, f, fanout, stream);
}

REPRO_API const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
