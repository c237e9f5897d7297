// Shared helpers for the port's Hopper kernels (plain C interface, built by
// kernels/build.py with nvcc for sm_90a and loaded through ctypes).
//
// Every entry point takes its CUDA stream as an opaque pointer (PyTorch's
// current stream), launches asynchronously, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

static inline bool aligned_to(const void* p, int64_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes)) == 0;
}

static inline cudaStream_t as_stream(void* stream) {
  return reinterpret_cast<cudaStream_t>(stream);
}

static inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The widest copy unit (16, 8, 4, 2 or 1 bytes) that divides a row of
// `row_bytes` and keeps every row start of each base pointer aligned (a null
// pointer is aligned to anything).  The bitwise row copies (K1, K5, K6) move
// rows in units of this size, so they are exact for any element type.
static inline int64_t copy_unit(int64_t row_bytes, const void* a,
                                const void* b, const void* c = nullptr) {
  for (int64_t w = 16; w > 1; w /= 2) {
    if (row_bytes % w == 0 && aligned_to(a, w) && aligned_to(b, w) &&
        aligned_to(c, w))
      return w;
  }
  return 1;
}

// Call f with a value of the copy-unit type of `unit` bytes (a copy_unit
// result), so one generic launcher serves every unit width.
template <typename F>
cudaError_t with_unit(int64_t unit, F&& f) {
  switch (unit) {
    case 16:
      return f(uint4{});
    case 8:
      return f(uint2{});
    case 4:
      return f(0u);
    case 2:
      return f(static_cast<unsigned short>(0));
    default:
      return f(static_cast<unsigned char>(0));
  }
}

// Grid of a persistent kernel (K4, K6): at most `per_sm` blocks on each SM
// of the current device, and no more blocks than there are work items.
static inline cudaError_t persistent_grid(int64_t work, int per_sm,
                                          int64_t* grid) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  *grid = work < cap ? work : cap;
  return cudaSuccess;
}

// f32 <-> storage-type conversions used by the reductions
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}
