"""The port's CUDA sources, run on the host.

There is no nvcc or card here, so each ``csrc/*.cu`` file is compiled with
the host C++ compiler against a small header that emulates the CUDA
builtins the kernels use: a block runs as ``blockDim`` std::threads with a
std::barrier for ``__syncthreads``, and ``kernel<<<grid, block, ...>>>``
becomes a loop over the grid.  The wrappers in ``kernels.ops`` then drive
these builds through the same ctypes entry points (argument types, pointers,
shapes) and are held against the plain versions: the combine and the refresh
scatter bit-equal, the segment sum and the fused layer within rtol=1e-5 /
1e-4, flash attention (K8) within 1e-5 in f32 and 1e-2 in bf16, its
log-sum-exp within 1e-4 of a plain logsumexp and its backward kernel's
gradients within 2e-2 of each one's largest magnitude.  The
``cuda_pipeline.h`` primitives of the multi-buffered combine and scatter
(K4, K6) run as synchronous copies and dynamic shared memory as a static
buffer, so the ring's slot arithmetic is checked but not its overlap.
``__shfl_xor_sync`` and ``__shfl_sync`` exchange through a block-wide
buffer between two barriers of the warp, so every lane of a warp calls
them together (K8's row reductions, K1's source addresses; a lane that has
left the kernel drops out of the barrier), while the other warps run on
(K8's producer waits on a barrier meanwhile).  ``ldst.cuh``'s cache-hinted
loads and stores (K1) become plain ones.  K8's bf16 bodies run on
``wgmma.cuh``'s warpgroup primitives and ``tma.cuh``'s tensor-map loads;
their emulation (descriptors decoded as the PTX ISA defines them, operands
read through the 32/64/128-byte swizzle, the m64nNk16 accumulator and
A-fragment layouts, TMA boxes of 4 and 5 dims with zero fill as
synchronous copies, named barriers, ``setmaxnreg`` as a no-op, sm_90's
float2 ``atomicAdd`` as two atomic adds) is held against numpy by the
probe ``tests/wgmma_probe.cu`` (4-D loads, the K-major SS and the RS
products), which also runs on the card, and through the backward kernel
against the plain VJP (5-D loads, the MN-major SS product).  This checks
the kernels' index math, masking, tile choice and the barriers between
threads' shared-memory writes and a product that reads them; it says
nothing about speed
or about what nvcc accepts, which only the card shows.
"""
import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.kernels import build, ops, ref

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <memory>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) alignas(n)
#define __grid_constant__
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchTimeout = 702, cudaErrorMisalignedAddress = 716 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2; return 0; }
template <class T> cudaError_t cudaFuncSetAttribute(T, int, int) {
  return 0; }
template <class T> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, T, int, size_t) { *n = 2; return 0; }
typedef struct CUstream_st* cudaStream_t;
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
// the kernel's dynamic shared memory (set where it is declared): shared
// addresses (tma.cuh's smem_addr) are offsets from it
inline thread_local unsigned char* emu_smem_base = nullptr;
inline thread_local std::barrier<>* emu_warp_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barrier->arrive_and_wait(); }
// an error a kernel raised (tma.cuh's emulation: a wait past its time
// limit, a misaligned bulk copy), returned by the next cudaGetLastError
inline std::atomic<int> emu_error{0};
inline cudaError_t cudaGetLastError() { return emu_error.exchange(0); }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
// sm_90's vector atomicAdd (K8's backward adds dQ with it)
inline float2 atomicAdd(float2* p, float2 v) {
  std::atomic_ref<float> x(p->x), y(p->y);
  return {x.fetch_add(v.x), y.fetch_add(v.y)}; }
template <class T> T __ldg(const T* p) { return *p; }
inline unsigned char emu_shfl_buf[1024 * 8];
template <class T> T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= 8, "emulated shuffle of 8 bytes at most");
  const unsigned t = threadIdx.x + blockDim.x * (threadIdx.y +
                                                 blockDim.y * threadIdx.z);
  std::memcpy(emu_shfl_buf + 8 * t, &v, sizeof(T));
  __syncwarp();
  T out;
  std::memcpy(&out, emu_shfl_buf + 8 * (t ^ lane_mask), sizeof(T));
  __syncwarp();
  return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "emulated shuffle of 8 bytes at most");
  const unsigned t = threadIdx.x + blockDim.x * (threadIdx.y +
                                                 blockDim.y * threadIdx.z);
  std::memcpy(emu_shfl_buf + 8 * t, &v, sizeof(T));
  __syncwarp();
  T out;
  std::memcpy(&out, emu_shfl_buf + 8 * ((t & ~31u) + (src_lane & 31)),
              sizeof(T));
  __syncwarp();
  return out;
}
template <class F> void emu_launch(dim3 grid, dim3 block, F f) {
  gridDim = grid; blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    std::barrier<> bar(nt);
    emu_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warps;  // __syncwarp's
    for (unsigned w = 0; 32 * w < nt; ++w)
      warps.emplace_back(new std::barrier<>(std::min(32u, nt - 32 * w)));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nt; ++t)
      ts.emplace_back([&, t] {
        blockIdx = dim3(bx, by, bz);
        threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                         t / (block.x * block.y));
        emu_warp_barrier = warps[t / 32].get();
        f();
        emu_warp_barrier->arrive_and_drop();
        bar.arrive_and_drop();
      });
    for (auto& th : ts) th.join();
  }
}
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.x) << 16; float f; std::memcpy(&f, &u, 4);
  return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  __nv_bfloat16 b; b.x = (unsigned short)((u + 0x7FFF + ((u >> 16) & 1))
                                         >> 16);
  return b; }
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
"""

# wgmma.cuh's primitives as the PTX ISA defines them.  A descriptor is
# decoded as the hardware does (start, LBO, SBO, layout type) and each
# operand element read from shared memory through the canonical K-major or
# MN-major layout and the 32/64/128-byte swizzle of its address; a thread
# computes its own accumulator elements (the m64nNk16 D layout), so an
# SS product needs no exchange.  The RS product's A fragments (the m16n8k16
# layout, a 16-row slice a warp) are exchanged between the lanes of a warp
# through a block-wide buffer between two warp barriers.  Products run
# synchronously at issue, so fence / commit / wait are no-ops, as is
# setmaxnreg.  Named barriers count threads per id and fail the launch
# after EMU_WAIT_SECONDS instead of hanging.
WGMMA_H = r"""
#pragma once
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include "cuda_runtime.h"
#include "cuda_bf16.h"
#include "tma.cuh"
__host__ __device__ constexpr uint64_t wgmma_layout_type(int w) {
  return w == 128 ? 1 : w == 64 ? 2 : 3; }
inline uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                          int swizzle_bytes) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) |
         uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 |
         wgmma_layout_type(swizzle_bytes) << 62; }
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
template <int R> inline void wgmma_fence_acc(float (&)[R]) {}
template <int R> inline void setmaxnreg_inc() {}
template <int R> inline void setmaxnreg_dec() {}
struct EmuNamedBar { std::mutex m; std::condition_variable cv;
                     int arrived = 0; unsigned gen = 0; };
inline EmuNamedBar emu_named[16];
inline void emu_named_bar(int id, int count, bool wait) {
  EmuNamedBar& nb = emu_named[id];
  std::unique_lock<std::mutex> lk(nb.m);
  const unsigned gen = nb.gen;
  if (++nb.arrived == count) {
    nb.arrived = 0;
    ++nb.gen;
    nb.cv.notify_all();
  } else if (wait && !nb.cv.wait_for(
      lk, std::chrono::seconds(EMU_WAIT_SECONDS),
      [&] { return nb.gen != gen || emu_error.load(); })) {
    emu_error = cudaErrorLaunchTimeout;
  }
}
inline void named_bar_sync(int id, int count) {
  emu_named_bar(id, count, true); }
inline void named_bar_arrive(int id, int count) {
  emu_named_bar(id, count, false); }
inline uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(__float2bfloat16_rn(lo).x) |
         uint32_t(__float2bfloat16_rn(hi).x) << 16; }
inline float exp2_ftz(float x) {
  const float y = std::exp2(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y; }
inline float emu_bf(uint16_t x) {
  __nv_bfloat16 b; b.x = x; return __bfloat162float(b); }
// element (mn, k) of the operand a descriptor names
inline float emu_operand(uint64_t desc, int mn, int k, bool k_major) {
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t lbo = uint32_t((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  const int type = int(desc >> 62);
  const uint32_t w = type == 1 ? 128 : type == 2 ? 64 : 32;
  if (type == 0) emu_error = cudaErrorInvalidValue;  // K8 always swizzles
  const uint32_t off = k_major
      ? start + (mn % 8) * w + (mn / 8) * sbo + 2 * k
      : start + 2 * (mn % (w / 2)) + (mn / (w / 2)) * lbo + (k % 8) * w +
            (k / 8) * sbo;
  const uint32_t at = off ^ (((off >> 7) & (w / 16 - 1)) << 4);
  uint16_t x;
  std::memcpy(&x, emu_smem_base + at, 2);
  return emu_bf(x);
}
template <int N>
inline void wgmma_ss_mn(float (&d)[N / 2], uint64_t a, uint64_t b,
                        int scale_d) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * w + l / 4 + 8 * (i >> 1);
      const int col = 8 * j + 2 * (l % 4) + (i & 1);
      float sum = 0.f;
      for (int k = 0; k < 16; ++k)
        sum += emu_operand(a, row, k, false) * emu_operand(b, col, k, false);
      d[4 * j + i] = (scale_d ? d[4 * j + i] : 0.f) + sum;
    }
}
template <int N> void emu_store(float (&d)[N / 2], int scale_d, int j,
                                int i, float sum) {
  d[4 * j + i] = (scale_d ? d[4 * j + i] : 0.f) + sum; }
template <int N>
inline void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                     int scale_d) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * w + l / 4 + 8 * (i >> 1);
      const int col = 8 * j + 2 * (l % 4) + (i & 1);
      float sum = 0.f;
      for (int k = 0; k < 16; ++k)
        sum += emu_operand(a, row, k, true) * emu_operand(b, col, k, true);
      emu_store<N>(d, scale_d, j, i, sum);
    }
}
inline uint32_t emu_afrag[1024][4];
template <int N>
inline void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                     int scale_d) {
  const unsigned tid = threadIdx.x, lane = tid & 31u;
  std::memcpy(emu_afrag[tid], a, sizeof a);
  __syncwarp();
  float A[16][16];   // this warp's 16-row slice
  for (int q = 0; q < 32; ++q) {
    const uint32_t* f = emu_afrag[tid - lane + q];
    const int gr = q / 4, c = 2 * (q % 4);
    for (int e = 0; e < 2; ++e) {
      A[gr][c + e] = emu_bf(uint16_t(e ? f[0] >> 16 : f[0] & 0xFFFFu));
      A[gr + 8][c + e] = emu_bf(uint16_t(e ? f[1] >> 16 : f[1] & 0xFFFFu));
      A[gr][c + 8 + e] = emu_bf(uint16_t(e ? f[2] >> 16 : f[2] & 0xFFFFu));
      A[gr + 8][c + 8 + e] =
          emu_bf(uint16_t(e ? f[3] >> 16 : f[3] & 0xFFFFu));
    }
  }
  __syncwarp();
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = lane / 4 + 8 * (i >> 1);
      const int col = 8 * j + 2 * (lane % 4) + (i & 1);
      float sum = 0.f;
      for (int k = 0; k < 16; ++k)
        sum += A[row][k] * emu_operand(b, col, k, false);
      emu_store<N>(d, scale_d, j, i, sum);
    }
}
"""

# tma.cuh's primitives as the PTX ISA defines them.  An mbarrier keeps,
# in its 8 bytes, a pending-arrival count, the expected count, a signed tx
# count and the phase bit; a phase completes when no arrival is pending and
# the tx count is zero, and then the barrier moves to the next phase with
# its pending count reset.  mbar_arrive_warp is __syncwarp (a barrier of the
# warp's threads here) and one arrival by lane 0.  try_wait.parity(p) is true once the phase of
# parity p has completed (the current phase's parity differs from p).  Bulk
# copies are synchronous memcpys that complete their bytes on the barrier;
# a misaligned one sets an error.  A wait spins for at most
# EMU_WAIT_SECONDS; past it (a wrong parity, a lost arrival) it sets an
# error that the C entry point returns, so the wrapper raises instead of
# the test hanging, and every later wait of the launch returns at once.
TMA_H = r"""
#pragma once
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include "cuda_runtime.h"
#ifndef EMU_WAIT_SECONDS
#define EMU_WAIT_SECONDS 20
#endif
struct EmuMbar { int64_t pending, expected, tx; uint64_t phase; };
inline EmuMbar emu_unpack(uint64_t v) {
  EmuMbar b;
  b.pending = int64_t(v & 0x1FFFFF);
  b.expected = int64_t((v >> 21) & 0x1FFFFF);
  b.tx = int64_t((v >> 42) & 0x1FFFFF);
  if (b.tx & 0x100000) b.tx -= 0x200000;       // signed 21 bits
  b.phase = v >> 63;
  return b;
}
inline uint64_t emu_pack(const EmuMbar& b) {
  return uint64_t(b.pending & 0x1FFFFF) |
         uint64_t(b.expected & 0x1FFFFF) << 21 |
         uint64_t(b.tx & 0x1FFFFF) << 42 | b.phase << 63;
}
template <class F> inline void emu_mbar_update(uint64_t* bar, F f) {
  std::atomic_ref<uint64_t> a(*bar);
  uint64_t old = a.load();
  for (;;) {
    EmuMbar b = emu_unpack(old);
    f(b);
    if (b.pending < 0) { emu_error = cudaErrorInvalidValue; return; }
    if (b.pending == 0 && b.tx == 0) {
      b.phase ^= 1;
      b.pending = b.expected;
    }
    if (a.compare_exchange_weak(old, emu_pack(b))) return;
  }
}
inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::atomic_ref<uint64_t>(*bar).store(
      emu_pack(EmuMbar{int64_t(count), int64_t(count), 0, 0}));
}
inline void fence_mbarrier_init() {}
inline void mbar_arrive(uint64_t* bar) {
  emu_mbar_update(bar, [](EmuMbar& b) { b.pending -= 1; });
}
inline void mbar_arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  emu_mbar_update(bar, [&](EmuMbar& b) { b.tx += bytes; b.pending -= 1; });
}
inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  return emu_unpack(std::atomic_ref<uint64_t>(*bar).load()).phase != parity;
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const auto limit = std::chrono::steady_clock::now() +
                     std::chrono::seconds(EMU_WAIT_SECONDS);
  while (!mbar_try_wait(bar, parity)) {
    if (emu_error.load()) return;
    if (std::chrono::steady_clock::now() > limit) {
      emu_error = cudaErrorLaunchTimeout;
      return;
    }
    std::this_thread::yield();
  }
}
inline bool emu_bulk_ok(const void* a, const void* b, uint32_t bytes) {
  const bool ok = (uintptr_t(a) | uintptr_t(b) | bytes) % 16 == 0;
  if (!ok) emu_error = cudaErrorMisalignedAddress;
  return ok;
}
inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  if (!emu_bulk_ok(dst, src, bytes)) return;
  std::memcpy(dst, src, bytes);
  emu_mbar_update(bar, [&](EmuMbar& b) { b.tx -= bytes; });
}
inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  if (emu_bulk_ok(dst, src, bytes)) std::memcpy(dst, src, bytes);
}
inline void bulk_commit() {}
inline void fence_proxy_async() {}
template <int N> inline void bulk_wait_read() {}
template <int N> inline void bulk_wait() {}
inline uint32_t smem_addr(const void* p) {
  return uint32_t(static_cast<const unsigned char*>(p) - emu_smem_base); }
// a 4-D map is a 5-D one whose outermost dim and box are 1
struct CUtensorMap { const unsigned char* base; uint64_t dims[5];
                     uint64_t strides[4]; uint32_t box[5]; int swizzle; };
template <int R>
inline cudaError_t emu_encode(CUtensorMap* map, const void* base,
                              const uint64_t (&dims)[R],
                              const uint64_t (&strides)[R - 1],
                              const uint32_t (&box)[R], int swizzle_bytes) {
  bool ok = uintptr_t(base) % 16 == 0 && box[0] * 2 == uint32_t(
      swizzle_bytes) && (swizzle_bytes == 32 || swizzle_bytes == 64 ||
                         swizzle_bytes == 128);
  for (int i = 0; i < R - 1; ++i) ok = ok && strides[i] % 16 == 0;
  for (int i = 0; i < R; ++i) ok = ok && box[i] >= 1 && box[i] <= 256;
  if (!ok) return cudaErrorInvalidValue;
  map->base = static_cast<const unsigned char*>(base);
  for (int i = 0; i < 5; ++i) {
    map->dims[i] = i < R ? dims[i] : 1;
    map->box[i] = i < R ? box[i] : 1;
    if (i < 4) map->strides[i] = i < R - 1 ? strides[i] : 0;
  }
  map->swizzle = swizzle_bytes;
  return cudaSuccess;
}
inline cudaError_t encode_tensor_map_4d(CUtensorMap* map, const void* base,
                                        const uint64_t (&dims)[4],
                                        const uint64_t (&strides)[3],
                                        const uint32_t (&box)[4],
                                        int swizzle_bytes) {
  return emu_encode<4>(map, base, dims, strides, box, swizzle_bytes); }
inline cudaError_t encode_tensor_map_5d(CUtensorMap* map, const void* base,
                                        const uint64_t (&dims)[5],
                                        const uint64_t (&strides)[4],
                                        const uint32_t (&box)[5],
                                        int swizzle_bytes) {
  return emu_encode<5>(map, base, dims, strides, box, swizzle_bytes); }
// one box, rows of box[0] bf16 (one swizzle row each), coordinates outside
// the tensor read as zero; the destination must start a swizzle span
inline void tma_load_5d(void* dst, const CUtensorMap* map, int c0, int c1,
                        int c2, int c3, int c4, uint64_t* bar) {
  const uint32_t w = uint32_t(map->swizzle), at0 = smem_addr(dst);
  if (at0 % (8 * w)) { emu_error = cudaErrorMisalignedAddress; return; }
  const int c[5] = {c0, c1, c2, c3, c4};
  uint32_t row = 0;
  for (uint32_t i4 = 0; i4 < map->box[4]; ++i4)
  for (uint32_t i3 = 0; i3 < map->box[3]; ++i3)
  for (uint32_t i2 = 0; i2 < map->box[2]; ++i2)
  for (uint32_t i1 = 0; i1 < map->box[1]; ++i1, ++row)
    for (uint32_t e = 0; e < map->box[0]; ++e) {
      const int64_t x[5] = {int64_t(c[0]) + e, int64_t(c[1]) + i1,
                            int64_t(c[2]) + i2, int64_t(c[3]) + i3,
                            int64_t(c[4]) + i4};
      bool in = true;
      for (int i = 0; i < 5; ++i)
        in = in && x[i] >= 0 && uint64_t(x[i]) < map->dims[i];
      uint16_t v = 0;
      if (in)
        std::memcpy(&v, map->base + 2 * x[0] + x[1] * map->strides[0] +
                        x[2] * map->strides[1] + x[3] * map->strides[2] +
                        x[4] * map->strides[3], 2);
      const uint32_t off = at0 + row * w + 2 * e;
      std::memcpy(emu_smem_base + (off ^ (((off >> 7) & (w / 16 - 1)) << 4)),
                  &v, 2);
    }
  const uint32_t bytes = 2 * map->box[0] * map->box[1] * map->box[2] *
                         map->box[3] * map->box[4];
  emu_mbar_update(bar, [&](EmuMbar& b) { b.tx -= bytes; });
}
inline void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                        int c2, int c3, uint64_t* bar) {
  tma_load_5d(dst, map, c0, c1, c2, c3, 0, bar); }
"""

# ldst.cuh's cache-hinted loads and stores as plain ones: the hints change
# where lines live in L2, never the bits
LDST_H = r"""
#pragma once
#include <cstdint>
inline uint64_t l2_evict_last_policy() { return 0; }
template <class V> V load_reused(const V* p, uint64_t) { return *p; }
template <class V> void store_streaming(V* p, V v) { *p = v; }
"""

CUDA_PIPELINE_H = r"""
#pragma once
#include <cstddef>
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
"""

_DYNAMIC_SMEM = re.compile(r"extern __shared__ (?:__align__\((\d+)\) )?"
                           r"unsigned char (\w+)\[\];")
_LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def _emulated(src: str) -> str:
    def repl(m):
        grid, block = [c.strip() for c in m.group(2).split(",")][:2]
        return (f"emu_launch(dim3({grid}), dim3({block}), "
                f"[&]{{ {m.group(1)}({m.group(3)}); }});")
    # blocks run one after another here, so one static buffer per kernel
    # serves as its dynamic shared memory
    src = _DYNAMIC_SMEM.sub(r"alignas(1024) static unsigned char \2[1 << 18]; "
                            r"emu_smem_base = \2;", src)
    return _LAUNCH.sub(repl, src)


def _write_headers(out):
    """The emulation headers, and the port's own common.cuh, into ``out``."""
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out / "cuda_bf16.h").write_text(CUDA_BF16_H)
    (out / "cuda_pipeline.h").write_text(CUDA_PIPELINE_H)
    (out / "wgmma.cuh").write_text(WGMMA_H)
    (out / "tma.cuh").write_text(TMA_H)
    (out / "ldst.cuh").write_text(LDST_H)
    shutil.copy(build.CSRC / "common.cuh", out / "common.cuh")


def _compile(cxx, out, name, cuda_src):
    """``cuda_src`` rewritten for the host and built into ``out``."""
    src = out / f"{name}.cpp"
    src.write_text(_emulated(cuda_src))
    lib = out / f"lib{name}.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-I", str(out), str(src), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    return lib


@pytest.fixture(scope="module")
def emulated_ops(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "CUDA sources")
    out = tmp_path_factory.mktemp("cuda_emu")
    _write_headers(out)

    def compile_one(name):
        lib = _compile(cxx, out, name,
                       (build.CSRC / f"{name}.cu").read_text())
        return name, build._bind(name, lib)

    with ThreadPoolExecutor(4) as pool:
        libs = dict(pool.map(compile_one, build._KERNELS))
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "library", libs.__getitem__)
    mp.setattr(ops, "_on_cpu", lambda t: False)
    mp.setattr(ops, "_stream", lambda t: None)
    ops.reset_kernel_launches()
    yield ops
    mp.undo()


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [100, 7, 16])
@pytest.mark.parametrize("case", ["mixed", "no_cache", "all_hit"])
def test_emulated_combine_bit_equal(emulated_ops, dtype, f, case):
    rng = np.random.default_rng(f)
    k, m, n = 40, 13, 200
    cache = torch.from_numpy(rng.standard_normal((k, f)).astype(
        np.float32)).to(dtype)
    cache[0, :2] = torch.tensor([-0.0, 0.0])
    miss = torch.from_numpy(rng.standard_normal((m, f)).astype(
        np.float32)).to(dtype)
    slots = rng.integers(-1, k, n).astype(np.int32)
    if case == "no_cache":
        cache, slots = None, np.full(n, -1, np.int32)
    if case == "all_hit":
        slots, miss = rng.integers(0, k, n).astype(np.int32), miss[:0]
    mi = np.where(slots < 0, rng.integers(0, max(m, 1), n), 0).astype(
        np.int32)
    got = emulated_ops.assemble_features(cache, miss, slots, mi)
    want = ref.assemble_features(cache, miss, torch.from_numpy(slots),
                                 torch.from_numpy(mi))
    assert torch.equal(_bits(got), _bits(want))


def _combine_inputs(dtype, f, case, n=203, seed=0):
    """Cache, miss block and tables with -0.0, a denormal and a NaN payload
    in the source rows; ``n`` = 203 leaves a ragged last 8-row block."""
    rng = np.random.default_rng(seed + f)
    k, m = 40, 13
    cache = torch.from_numpy(rng.standard_normal((k, f)).astype(
        np.float32)).to(dtype)
    miss = torch.from_numpy(rng.standard_normal((m, f)).astype(
        np.float32)).to(dtype)
    special = torch.tensor([-0.0, 1e-40, float("nan")])[:f]
    cache[0, :special.numel()] = special.to(dtype)
    miss[0, :special.numel()] = special.to(dtype)
    slots = rng.integers(-1, k, n).astype(np.int32)
    if case == "no_cache":
        cache, slots = None, np.full(n, -1, np.int32)
    if case == "all_hit":
        slots, miss = rng.integers(0, k, n).astype(np.int32), miss[:0]
    mi = np.where(slots < 0, rng.integers(0, max(m, 1), n), 0).astype(
        np.int32)
    return cache, miss, slots, mi


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [100, 7])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_emulated_pipelined_combine_bit_equal(emulated_ops, dtype, f, depth):
    """``assemble_features`` at every depth: K1 at depth 1, K4 at 2..4, for
    f32, bf16 and an odd bf16 width (staged with plain loads), against the
    plain combine bit for bit, -0.0, denormals and NaN payloads included."""
    kernel = "cache_combine" if depth == 1 else "cache_combine_pipelined"
    for case in ("mixed", "no_cache", "all_hit"):
        cache, miss, slots, mi = _combine_inputs(dtype, f, case)
        want = ref.assemble_features(cache, miss, torch.from_numpy(slots),
                                     torch.from_numpy(mi))
        before = emulated_ops.kernel_launches()
        got = emulated_ops.assemble_features(cache, miss, slots, mi, depth)
        after = emulated_ops.kernel_launches()
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == kernel) for k in after}, case
        assert torch.equal(_bits(got), _bits(want)), case


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [100, 7])
def test_emulated_legacy_combine_bit_equal(emulated_ops, dtype, f):
    """K7 with the (sel, row) tables against its plain version."""
    rng = np.random.default_rng(f)
    cache, miss, _, _ = _combine_inputs(dtype, f, "mixed")
    n = 150
    sel = rng.integers(0, 2, n).astype(np.int32)
    row = np.where(sel == 0, rng.integers(0, cache.shape[0], n),
                   rng.integers(0, miss.shape[0], n)).astype(np.int32)
    before = emulated_ops.kernel_launches()["cache_combine_legacy"]
    got = emulated_ops.cache_combine_legacy(cache, miss, sel, row)
    assert emulated_ops.kernel_launches()["cache_combine_legacy"] == \
        before + 1
    want = ref.cache_combine_legacy(cache, miss, torch.from_numpy(sel),
                                    torch.from_numpy(row))
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype,f", [(torch.float32, 100),
                                     (torch.bfloat16, 32)])
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_emulated_combine_bulk_ring_wraps(emulated_ops, dtype, f, depth):
    """K4's bulk-copy route (rows of a multiple of 16 bytes: 400-B f32 and
    64-B bf16) over n = 2,003 rows: 63 stages of 32 rows on 4 emulated
    CTAs, so every CTA's ring wraps at every depth and the last stage is
    ragged.  Bit-equal to the plain combine."""
    for case in ("mixed", "no_cache", "all_hit"):
        cache, miss, slots, mi = _combine_inputs(dtype, f, case, n=2003,
                                                 seed=depth)
        want = ref.assemble_features(cache, miss, torch.from_numpy(slots),
                                     torch.from_numpy(mi))
        got = emulated_ops.assemble_features(cache, miss, slots, mi, depth)
        assert torch.equal(_bits(got), _bits(want)), case


def _k1_inputs(dtype, f, case, n, seed=0):
    """K1's cases: a cache and a miss block whose first rows hold -0.0, a
    denormal and NaNs with payloads of their own (bits a float round trip
    would not keep), and index tables for ``case``: "mixed" slots,
    "no_cache" (every slot -1), "all_hit" (a peer gather: every slot hits
    and the miss block is empty) and "misaligned" (mixed, the cache and
    miss block as views one element off a 16-byte boundary, so K1 copies
    in a narrower unit)."""
    rng = np.random.default_rng(seed * 1000 + n * 10 + f)
    k, m = 90, 37
    ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    off = 1 if case == "misaligned" else 0
    special = torch.tensor([0x8000, 0x0001, 0x7FC5, 0xFFA1] if dtype ==
                           torch.bfloat16 else
                           [-2 ** 31, 0x00000001, 0x7FC01234, -0x5FEDCC],
                           dtype=torch.int32).to(ibits)

    def block(rows):
        x = torch.from_numpy(rng.standard_normal(rows * f + off).astype(
            np.float32)).to(dtype)[off:].view(rows, f)
        flat = x.view(-1).view(ibits)
        flat[:special.numel()] = special[:flat.numel()]
        return x

    cache, miss = block(k), block(m)
    slots = rng.integers(-1, k, n).astype(np.int32)
    slots[:4] = [0, -1, 0, -1]
    if case == "no_cache":
        cache, slots = None, np.full(n, -1, np.int32)
    mi = np.where(slots < 0, rng.integers(0, m, n), 0).astype(np.int32)
    mi[:4] = 0
    if case == "all_hit":
        slots, mi, miss = np.abs(slots), np.zeros(n, np.int32), miss[:0]
    return cache, miss, slots, mi


@pytest.mark.parametrize("case", ["mixed", "no_cache", "all_hit",
                                  "misaligned"])
@pytest.mark.parametrize("dtype,f", [(torch.float32, 1),
                                     (torch.float32, 47),
                                     (torch.float32, 100),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 7),
                                     (torch.bfloat16, 47)])
@pytest.mark.parametrize("n", [75, 17])
def test_emulated_k1_groups_bit_equal(emulated_ops, n, dtype, f, case):
    """K1's 32-row warp groups: a ragged last group (n = 75) and a lone
    short one (n = 17); copy units of 16 bytes (f32 at 100 and 256), 4
    (f32 at 1 and 47, and every misaligned f32 view) and 2 (odd bf16
    widths), so a lane's run of units crosses rows at every stride; bit
    for bit against the plain combine, one K1 launch a call."""
    cache, miss, slots, mi = _k1_inputs(dtype, f, case, n)
    if case == "misaligned":
        assert cache.data_ptr() % 16 and miss.data_ptr() % 16
    want = ref.assemble_features(cache, miss, torch.from_numpy(slots),
                                 torch.from_numpy(mi))
    before = emulated_ops.kernel_launches()
    if case == "all_hit":
        got = emulated_ops.gather_rows(cache, slots)
    else:
        got = emulated_ops.assemble_features(cache, miss, slots, mi)
    after = emulated_ops.kernel_launches()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == "cache_combine") for k in after}
    assert torch.equal(_bits(got), _bits(want))


def test_emulated_gather_rows_and_ring_budget(emulated_ops):
    block = torch.randn(30, 12)
    slots = np.array([3, 0, 29, 3, 7], np.int32)
    for depth in (1, 2, 4):
        assert torch.equal(emulated_ops.gather_rows(block, slots, depth),
                           block[torch.from_numpy(slots).long()])
    wide = torch.zeros(16, 2000)
    with pytest.raises(ValueError, match="shared memory"):
        emulated_ops.gather_rows(wide, slots, 4)
    with pytest.raises(ValueError, match="1..4"):
        emulated_ops.gather_rows(block, slots, 5)
    # K4's entry point takes only depths 2..4 (depth 1 is K1's)
    out = torch.empty(5, 12)
    slots_t = torch.from_numpy(slots)
    with pytest.raises(RuntimeError, match="launch failed"):
        emulated_ops._launch("cache_combine_pipelined",
                             "cache_combine_pipelined_f32", block,
                             block.data_ptr(), None, slots_t.data_ptr(),
                             slots_t.data_ptr(), out.data_ptr(), 5, 12, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,fanout,f", [(37, 5, 100), (20, 3, 7),
                                        (9, 10, 256)])
def test_emulated_segment_sum(emulated_ops, dtype, d, fanout, f):
    g = torch.Generator().manual_seed(d)
    x = torch.randn(d * fanout, f, generator=g).to(dtype)
    w = torch.rand(d * fanout, generator=g).to(dtype)
    got = emulated_ops.segment_weighted_sum_regular(x, w, fanout)
    want = ref.segment_weighted_sum_regular(x, w, fanout)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)     # one bf16 rounding of the sum
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("d,fanout,f,o", [
    (300, 10, 100, 256),     # layer-1 widths, short tiles
    (37, 5, 100, 47),        # layer-2 widths
    (20, 3, 7, 5),           # everything ragged
    (9, 4, 33, 300),         # two column tiles
    (8448, 2, 20, 40),       # enough rows for the tall-tile variant
    (20, 25, 256, 47)])      # layer-2 slabs: the ring wraps, a tail tile
@pytest.mark.parametrize("bias", [True, False])
def test_emulated_fused_layer(emulated_ops, d, fanout, f, o, bias):
    g = torch.Generator().manual_seed(o)
    xs, xn = torch.randn(d, f, generator=g), torch.randn(d * fanout, f,
                                                         generator=g)
    we, ss = torch.rand(d * fanout, generator=g), torch.rand(d, generator=g)
    ws = torch.randn(f, o, generator=g) / f ** 0.5
    wa = torch.randn(f, o, generator=g) / f ** 0.5
    b = torch.randn(o, generator=g) if bias else None
    got = emulated_ops.fused_gnn_update(xs, xn, we, ss, ws, wa, b, fanout)
    want = ref.fused_gnn_update(xs, xn, we, ss, ws, wa, b, fanout)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_emulated_fused_layer_unaligned_views(emulated_ops):
    """x_self and x_nbr as views one float off a 16-byte boundary take K2's
    plain-load route (the ring bulk-copies whole rows) and give what the
    aligned copies give through the ring, within 1e-4 of the plain
    version."""
    d, fanout, f, o = 40, 6, 100, 47
    g = torch.Generator().manual_seed(3)
    xs = torch.randn(d * f + 1, generator=g)[1:].view(d, f)
    xn = torch.randn(d * fanout * f + 1, generator=g)[1:].view(d * fanout, f)
    we, ss = torch.rand(d * fanout, generator=g), torch.rand(d, generator=g)
    ws = torch.randn(f, o, generator=g) / f ** 0.5
    wa = torch.randn(f, o, generator=g) / f ** 0.5
    b = torch.randn(o, generator=g)
    assert xs.data_ptr() % 16 and xn.data_ptr() % 16
    got = emulated_ops.fused_gnn_update(xs, xn, we, ss, ws, wa, b, fanout)
    ring = emulated_ops.fused_gnn_update(xs.clone(), xn.clone(), we, ss, ws,
                                         wa, b, fanout)
    want = ref.fused_gnn_update(xs, xn, we, ss, ws, wa, b, fanout)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ring, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [100, 7])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_emulated_cache_update_bit_equal(emulated_ops, dtype, f, depth):
    """K5 (depth 1) and K6 (depth 2..4) through ``update_cache_rows``:
    M = 53 admitted rows (not a multiple of 8) with aliased slots, against
    the plain keep-last scatter, bit for bit."""
    rng = np.random.default_rng(depth * 100 + f)
    k, m = 90, 53
    cache = torch.from_numpy(rng.standard_normal((k, f)).astype(
        np.float32)).to(dtype)
    rows = torch.from_numpy(rng.standard_normal((m, f)).astype(
        np.float32)).to(dtype)
    rows[0, :2] = torch.tensor([-0.0, 1e-40])
    slots = rng.integers(0, k, m).astype(np.int32)
    slots[5] = slots[40]                  # a slot named twice: last wins
    kernel = "cache_update" if depth == 1 else "cache_update_pipelined"
    before = emulated_ops.kernel_launches()[kernel]
    got = emulated_ops.update_cache_rows(cache, rows, slots, depth)
    assert emulated_ops.kernel_launches()[kernel] == before + 1
    want = ref.cache_update(cache, rows, torch.from_numpy(slots))
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.equal(_bits(got), _bits(cache))   # rows really moved


def test_emulated_cache_update_empty_and_ring_budget(emulated_ops):
    cache = torch.zeros(10, 4)
    assert emulated_ops.update_cache_rows(
        cache, torch.zeros(0, 4), np.zeros(0, np.int32), 2) is cache
    wide = torch.zeros(16, 2000)
    with pytest.raises(ValueError, match="shared memory"):
        emulated_ops.scatter_rows_(wide.clone(), wide[:8],
                                   torch.arange(8, dtype=torch.int32), 4)


def test_emulated_launches_are_counted(emulated_ops):
    before = emulated_ops.kernel_launches()
    x = torch.randn(12, 8)
    emulated_ops.segment_weighted_sum_regular(x, torch.rand(12), 3)
    after = emulated_ops.kernel_launches()
    assert after["segment_sum"] == before["segment_sum"] + 1
    assert after["cache_combine"] == before["cache_combine"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pos0", [
    ((1, 100, 2, 2, 16), 0),      # ragged length, a position across CTAs
    ((1, 70, 1, 3, 32), 5),       # G = 3: CTAs start mid-position
    ((2, 20, 1, 1, 64), 0),       # G = 1, two batch rows
    ((1, 40, 1, 2, 128), 2),      # the widest head
    ((1, 70, 1, 1, 112), 0),      # zamba2-7b's head: 7 k16 steps, G = 1
    ((1, 40, 2, 2, 112), 3),      # D 112 with GQA, two KV heads
    ((1, 512, 1, 2, 32), 0),      # 4 key tiles: the 3-stage ring wraps
    ((1, 512, 1, 3, 16), 1)])     # ... with G = 3
def test_emulated_flash_attention(emulated_ops, dtype, shape, pos0):
    """K8 through its ctypes entry point against the plain flash attention:
    f32 (the FMA body) within 1e-5 (the online softmax sums in another
    order), bf16 (the tensor-core body) within 1e-2 (p rounded to bf16 for
    P V, and one rounding of an f32 value that differs in its last
    bits)."""
    b, s, hkv, g, d = shape
    gen = torch.Generator().manual_seed(s + d)
    q = torch.randn(b, s, hkv, g, d, generator=gen).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=gen).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen).to(dtype)
    before = emulated_ops.kernel_launches()["flash_attention"]
    got = emulated_ops.flash_attention(q, k, v, 512, pos0)
    assert emulated_ops.kernel_launches()["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, 512, pos0)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_flash_attention_batch_boundary(emulated_ops, dtype):
    """B 2 at a ragged S 100, batch 1's K scaled by 8 and its V negated:
    batch 0's 128-key tile reaches past S into TMA's zero fill (the map's
    S extent), never into batch 1's first keys, and batch 1's tile starts
    at its own keys; mixing either way would move the outputs far past
    1e-2.  (V keeps its magnitude: 1e-2 is sized for p rounded to bf16
    against values of order 1.)"""
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(2, 100, 1, 2, 64, generator=gen)
    k = torch.randn(2, 100, 1, 64, generator=gen)
    v = torch.randn(2, 100, 1, 64, generator=gen)
    k[1] *= 8
    v[1] *= -1
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = emulated_ops.flash_attention(q, k, v, 512)
    want = ref.flash_attention(q, k, v, 512)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("offset", [1, 4])
def test_emulated_flash_attention_refuses_misaligned_bf16(emulated_ops,
                                                          offset):
    """K8's entry point refuses a bf16 q off a 16-byte boundary (offset by
    one element, 2 bytes, or four, 8 bytes): the bf16 body copies 16 bytes
    a thread.  The wrapper raises and counts no launch."""
    n = 1 * 64 * 1 * 2 * 16
    q = torch.randn(n + offset).to(torch.bfloat16)[offset:].view(
        1, 64, 1, 2, 16)
    k = torch.randn(1, 64, 1, 16).to(torch.bfloat16)
    before = emulated_ops.kernel_launches()["flash_attention"]
    with pytest.raises(RuntimeError, match="launch failed"):
        emulated_ops.flash_attention(q, k, k)
    assert emulated_ops.kernel_launches()["flash_attention"] == before
    # the same values from an aligned copy launch
    got = emulated_ops.flash_attention(q.clone(), k, k)
    torch.testing.assert_close(got.float(), ref.flash_attention(
        q, k, k).float(), rtol=1e-2, atol=1e-2)


def test_emulated_flash_attention_refuses_other_head_dims(emulated_ops):
    q = torch.zeros(1, 8, 1, 1, 24)
    k = torch.zeros(1, 8, 1, 24)
    with pytest.raises(ValueError, match="head dim"):
        emulated_ops.flash_attention(q, k, k)
    # the C entry point refuses it too
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="launch failed"):
        emulated_ops._launch("flash_attention", "flash_attention_f32", q,
                             q.data_ptr(), k.data_ptr(), k.data_ptr(),
                             out.data_ptr(), 1, 8, 1, 1, 24, 0)


@pytest.mark.parametrize("shape,pos0", [
    ((1, 100, 2, 1, 16), 0),      # S under 512: a tail tile; D 16
    ((1, 100, 1, 3, 64), 5),      # G = 3: tiles of 21 positions, a CTA's
                                  # first tile starts before its keys
    ((1, 512, 1, 1, 64), 0),      # S a multiple of 512: 4 key blocks
    ((1, 40, 1, 3, 112), 5)])     # zamba2-7b's head, padded to 128
def test_emulated_flash_attention_backward(emulated_ops, shape, pos0):
    """K8's backward kernel through autograd (the lse forward, then
    ``flash_attention_bwd_bf16``) against the plain VJP on the same bf16
    inputs and cotangent.  Tolerance: each gradient within 2e-2 of its
    largest magnitude, elementwise.  The kernel rounds P and dS to bf16 as
    tensor-core operands (a relative 2^-9 each, over up to S terms a sum)
    and sums in f32 in another order than the plain version, which keeps
    both in f32; both round the result once to bf16 (2^-8 apart at most
    when the f32 values straddle a rounding boundary)."""
    b, s, hkv, g, d = shape
    gen = torch.Generator().manual_seed(s * d + g + pos0)
    q, cot = (torch.randn(b, s, hkv, g, d, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = emulated_ops.kernel_launches()
    trace.reset()
    with torch.profiler.profile():       # the attn.vjp span records
        out = emulated_ops.flash_attention(qg, kg, vg, 512, pos0)
        got = torch.autograd.grad(out, (qg, kg, vg), cot)
    after = emulated_ops.kernel_launches()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    vjp = trace.summary()["attn.vjp"]
    assert vjp["count"] == 1 and vjp["vjp_kernel"] == 1 and \
        "vjp_plain" not in vjp
    want = ref.flash_attention_vjp(q, k, v, cot, 512, pos0)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        err = (a.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        assert err <= 2e-2 * top, (name, err, top)


@pytest.mark.parametrize("shape", [(1, 100, 2, 1, 16), (1, 70, 1, 3, 64)])
def test_emulated_flash_attention_lse(emulated_ops, shape):
    """The bf16 forward's log-sum-exp against a plain f32 logsumexp of the
    scaled, causally masked scores: within 1e-4 relative (the kernel's m
    and l in f32 through exp2 and log2; the output within K8's 1e-2)."""
    b, s, hkv, g, d = shape
    gen = torch.Generator().manual_seed(s + g)
    q = torch.randn(b, s, hkv, g, d, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(b, s, hkv, d, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    out, lse = emulated_ops._flash_lse_op(q, k, v, 512)
    scores = torch.einsum("bqhgd,bkhd->bhqgk", q.float(), k.float()) / d ** 0.5
    pos = torch.arange(s)
    scores = scores.masked_fill(pos[None, :] > pos[:, None, None], -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.float(), ref.flash_attention(
        q, k, v, 512).float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("d", [64, 112])
def test_emulated_flash_backward_group_limit(emulated_ops, d):
    """``ops.FLASH_BWD_MAX_GROUP``, by which the forward picks the kernel's
    gradient, is the library's own limit: its scratch query sizes a group
    of that many heads and refuses one more."""
    lib = emulated_ops.library("flash_attention_bwd")
    g = emulated_ops.FLASH_BWD_MAX_GROUP
    assert lib.flash_attention_bwd_scratch_floats(1, 512, 1, g, d) > 0
    assert lib.flash_attention_bwd_scratch_floats(1, 512, 1, g + 1, d) == 0


PROBE_CU = Path(__file__).resolve().parent / "wgmma_probe.cu"


def probe_inputs(d):
    """The probe's operands (small integers: every product and sum exact
    in bf16 and f32) and numpy's products: A K^T [64][128] and P V
    [64][Dp], zero in the padding columns at D 112."""
    rng = np.random.default_rng(d)
    a, k, v = (rng.integers(-4, 5, (n, d)).astype(np.float32)
               for n in (64, 128, 128))
    pm = rng.integers(-2, 3, (64, 128)).astype(np.float32)
    dp = 128 if d == 112 else d
    want_r = np.zeros((64, dp), np.float32)
    want_r[:, :d] = pm @ v
    return [torch.from_numpy(x).to(torch.bfloat16) for x in (a, k, v, pm)], \
        a @ k.T, want_r


@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
def test_emulated_wgmma_layouts_match_numpy(tmp_path, d):
    """The emulated TMA tensor loads (32-, 64- and 128-byte swizzle, zero
    columns past D at 112), descriptors and wgmma products compose, as K8
    composes them, into numpy's products: A K^T with both operands K-major
    (the SS product, D / 16 k16 steps) and P V with P as A fragments in
    registers and V read MN-major (the RS product).  The same probe runs
    on the card in ``tests/test_torch_cuda.py``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "CUDA sources")
    _write_headers(tmp_path)
    lib = ctypes.CDLL(str(_compile(cxx, tmp_path, "wgmma_probe",
                                   PROBE_CU.read_text())))
    lib.wgmma_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7
    lib.wgmma_probe.restype = ctypes.c_int
    ins, want_s, want_r = probe_inputs(d)
    ds = torch.zeros(64, 128)
    dr = torch.zeros(64, want_r.shape[1])
    assert lib.wgmma_probe(d, *(t.data_ptr() for t in (*ins, ds, dr)),
                           None) == 0
    np.testing.assert_array_equal(ds.numpy(), want_s)
    np.testing.assert_array_equal(dr.numpy(), want_r)


# One wait on tma.cuh's emulated mbarrier after a bulk copy completed its
# phase 0: waiting again on parity 0 passes at once, on parity 1 (a phase
# that never completes) it must time out and the entry point return an
# error; a bulk copy off a 16-byte boundary returns an error too.
_TMA_PROBE_CU = r"""
#include "common.cuh"
#include "tma.cuh"
namespace {
__global__ void probe_kernel(const unsigned char* src, unsigned char* dst,
                             int parity) {
  __align__(16) __shared__ unsigned char buf[64];
  __align__(8) __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 64);
    bulk_load(buf, src, 64, &bar);
  }
  mbar_wait(&bar, 0);
  mbar_wait(&bar, parity);
  for (int i = threadIdx.x; i < 64; i += 32) dst[i] = buf[i];
}
}  // namespace
REPRO_API int tma_probe(const void* src, void* dst, int parity) {
  probe_kernel<<<1, 32>>>(static_cast<const unsigned char*>(src),
                          static_cast<unsigned char*>(dst), parity);
  return cudaGetLastError();
}
"""


def test_emulated_tma_wrong_parity_times_out(tmp_path):
    """The emulated try_wait.parity follows the PTX ISA (a completed phase
    of parity 0 passes, the pending phase of parity 1 does not) and a wait
    past its limit (1 s here) makes the launch return an error instead of
    hanging; a misaligned bulk copy returns an error."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "CUDA sources")
    _write_headers(tmp_path)
    (tmp_path / "tma.cuh").write_text(TMA_H.replace(
        "#ifndef EMU_WAIT_SECONDS", "#define EMU_WAIT_SECONDS 1\n"
        "#ifndef EMU_WAIT_SECONDS"))
    lib = ctypes.CDLL(str(_compile(cxx, tmp_path, "tma_probe",
                                   _TMA_PROBE_CU)))
    lib.tma_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int]
    lib.tma_probe.restype = ctypes.c_int
    src = torch.arange(80, dtype=torch.uint8)
    dst = torch.zeros(64, dtype=torch.uint8)
    assert lib.tma_probe(src.data_ptr(), dst.data_ptr(), 0) == 0
    assert torch.equal(dst, src[:64])
    assert lib.tma_probe(src.data_ptr(), dst.data_ptr(), 1) == 702
    assert lib.tma_probe(src.data_ptr() + 1, dst.data_ptr(), 0) == 716
