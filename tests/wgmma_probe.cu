// A probe of K8's tensor-core layouts: TMA tensor loads in each swizzle
// mode, the shared-memory descriptors and the wgmma SS and RS products,
// composed as flash_attention.cu composes them, on one warpgroup.
//
//   ds[64][128] = A K^T   A [64][D] and K [128][D] by TMA (K-major, D / 16
//                         k16 steps), wgmma m64n128k16 SS
//   dr[64][Dp]  = P V     P [64][128] as A fragments in registers, V
//                         [128][D] by TMA read MN-major, wgmma m64n{Dp}k16 RS
//
// D in {16, 32, 64, 112, 128}: rows of Dp = D (128 at D 112, TMA's zero
// columns) bf16 stored as regions of Cw = min(Dp, 64) columns in 2 Cw byte
// swizzle.  Built with nvcc against csrc/ on the card
// (tests/test_torch_cuda.py) and with the host compiler against the
// emulated headers (tests/test_torch_kernels_emulated.py); both hold the
// products against numpy.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int D>
struct Probe {
  static constexpr int kDp = D == 112 ? 128 : D;
  static constexpr int kCw = kDp < 64 ? kDp : 64;
  static constexpr int kW = 2 * kCw;
  static constexpr int kNc = kDp / kCw;
  static constexpr uint32_t kABytes = 64 * kDp * 2;
  static constexpr uint32_t kBBytes = 128 * kDp * 2;
  static constexpr size_t kSmem = 1024 + kABytes + 2 * kBBytes + 8;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
probe_kernel(const __grid_constant__ CUtensorMap amap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const bf16* __restrict__ p, float* __restrict__ ds,
             float* __restrict__ dr) {
  using L = Probe<D>;
  constexpr int kW = L::kW, kCw = L::kCw, kDp = L::kDp;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* as =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = as + L::kABytes;
  unsigned char* vs = ks + L::kBBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + L::kBBytes);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) {
    mbar_init(bar, 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(bar, L::kABytes + 2 * L::kBBytes);
    for (int c = 0; c < L::kNc; ++c) {
      tma_load_4d(as + c * 64 * kW, &amap, c * kCw, 0, 0, 0, bar);
      tma_load_4d(ks + c * 128 * kW, &kmap, c * kCw, 0, 0, 0, bar);
      tma_load_4d(vs + c * 128 * kW, &vmap, c * kCw, 0, 0, 0, bar);
    }
  }
  mbar_wait(bar, 0);

  float s[64];
  const uint64_t a_desc = smem_desc(as, 16, 8 * kW, kW);
  const uint64_t k_desc = smem_desc(ks, 16, 8 * kW, kW);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int region = kd * 16 / kCw, col = (kd * 16) % kCw;
    wgmma_ss<128>(s, a_desc + ((region * 64 * kW + 2 * col) >> 4),
                  k_desc + ((region * 128 * kW + 2 * col) >> 4), kd > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_acc(s);

  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  auto pair = [&](int row, int col) {
    const bf16* x = p + row * 128 + col;
    return pack_bf16x2(__bfloat162float(x[0]), __bfloat162float(x[1]));
  };
  float o[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) o[i] = 0.f;
  const uint64_t v_desc = smem_desc(vs, 128 * kW, 8 * kW, kW);
  uint32_t pa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pair(r0, 16 * kk + c0);
    pa[kk][1] = pair(r0 + 8, 16 * kk + c0);
    pa[kk][2] = pair(r0, 16 * kk + 8 + c0);
    pa[kk][3] = pair(r0 + 8, 16 * kk + 8 + c0);
  }
  wgmma_fence_acc(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs<kDp>(o, pa[kk], v_desc + ((16 * kk * kW) >> 4), 1);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_acc(o);

#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ds[(r0 + 8 * (i >> 1)) * 128 + 8 * j + c0 + (i & 1)] = s[4 * j + i];
#pragma unroll
  for (int j = 0; j < kDp / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dr[(r0 + 8 * (i >> 1)) * kDp + 8 * j + c0 + (i & 1)] = o[4 * j + i];
}

template <int D>
cudaError_t run(const void* a, const void* k, const void* v, const void* p,
                void* ds, void* dr, cudaStream_t st) {
  using L = Probe<D>;
  const uint32_t box_a[4] = {L::kCw, 1, 64, 1};
  const uint32_t box_b[4] = {L::kCw, 1, 128, 1};
  const uint64_t dims_a[4] = {D, 1, 64, 1};
  const uint64_t dims_b[4] = {D, 1, 128, 1};
  const uint64_t str_a[3] = {2 * D, 2 * D, 64 * 2 * D};
  const uint64_t str_b[3] = {2 * D, 2 * D, 128 * 2 * D};
  CUtensorMap amap, kmap, vmap;
  cudaError_t err = encode_tensor_map_4d(&amap, a, dims_a, str_a, box_a,
                                         L::kW);
  if (err == cudaSuccess)
    err = encode_tensor_map_4d(&kmap, k, dims_b, str_b, box_b, L::kW);
  if (err == cudaSuccess)
    err = encode_tensor_map_4d(&vmap, v, dims_b, str_b, box_b, L::kW);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  probe_kernel<D><<<1, 128, L::kSmem, st>>>(
      amap, kmap, vmap, static_cast<const bf16*>(p), static_cast<float*>(ds),
      static_cast<float*>(dr));
  return cudaGetLastError();
}

}  // namespace

// a [64][d], k and v [128][d], p [64][128] bf16; ds [64][128] and dr
// [64][dp] f32 (dp = 128 at d 112, else d)
REPRO_API int wgmma_probe(int d, const void* a, const void* k,
                          const void* v, const void* p, void* ds, void* dr,
                          void* stream) {
  cudaStream_t st = as_stream(stream);
  switch (d) {
    case 16: return static_cast<int>(run<16>(a, k, v, p, ds, dr, st));
    case 32: return static_cast<int>(run<32>(a, k, v, p, ds, dr, st));
    case 64: return static_cast<int>(run<64>(a, k, v, p, ds, dr, st));
    case 112: return static_cast<int>(run<112>(a, k, v, p, ds, dr, st));
    case 128: return static_cast<int>(run<128>(a, k, v, p, ds, dr, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
