// COSMO horizontal diffusion for Hopper, route `simt`: the first port of
// `hdiff_pallas` (src/repro/kernels/hdiff/hdiff.py), unchanged but for its
// namespace. hdiff.cu sends it every grid the `tma` route does not take (a
// grid row that is not a multiple of 16 bytes long), and it is the "before"
// of the two routes' comparison on the card. Its helpers (`widen`, `store`,
// `limit`) serve both routes.
//
// Same function: src (nz, ny, nx), fp32 or bf16, gives out of the same shape
// and type. Per plane, on the interior: a 5-point Laplacian, x and y fluxes
// of it zeroed by the sign limiter `flx * dif > 0`, and
// `s - coeff * ((flx_c - flx_m) + (fly_c - fly_m))`. The outer 2-cell ring
// of every plane is copied through.
//
// Numbers. Whatever the storage type, a value is widened to fp32 on load,
// computed in fp32 and rounded once on store. Every operation is an `_rn`
// intrinsic, in the order of the plain PyTorch version (kernels/hdiff/ref.py),
// so nvcc contracts nothing into a fused multiply-add: a contraction of
// `s - coeff * (...)` would round once where the plain version rounds twice,
// and near zero that can flip the limiter's sign test. The output therefore
// equals the plain version's to the bit.
//
// Design. The TPU kernel holds block_z whole planes in VMEM per grid step;
// here one block of tile_x x tile_y threads covers a tile_y x tile_x patch of
// block_z planes. It loads the patch plus its 2-cell halo of all block_z
// planes into dynamic shared memory in one pass (every load of the pass in
// flight before the one barrier), then each thread computes its column of
// block_z outputs, reading the 5 Laplacians it needs and the 4 limited fluxes
// from shared memory. Neighbouring threads take neighbouring x, so loads and
// stores coalesce. Halo cells outside the grid load as 0; only ring cells,
// which copy through, would read them.
//
// Bound. Each element is read once and written once: 8 bytes per point in
// fp32, 33.6 MB at the COSMO grid 64 x 256 x 256, 0.0100 ms at 3.35 TB/s;
// about 30 flops per point (126 MFLOP, 0.0019 ms at 67 TFLOP/s), so the
// kernel is bound by bytes. The halo makes each block read
// (ty+4)(tx+4)/(ty tx) times its patch; the L2 cache serves most of the
// re-read. At this size a launch's own overhead is of the order of the bound.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

constexpr int kHalo = 2;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// flx, zeroed where flx * dif > 0 (the flux limiter)
__device__ __forceinline__ float limit(float flx, float dif) {
  return __fmul_rn(flx, dif) > 0.f ? 0.f : flx;
}

template <typename T>
__global__ void hdiff_kernel(const T* __restrict__ src, T* __restrict__ out,
                             int nz, int ny, int nx, int bz, float coeff) {
  extern __shared__ float patch[];   // [bz][ty + 4][tx + 4], fp32
  const int tx = blockDim.x, ty = blockDim.y;
  const int pw = tx + 2 * kHalo, ph = ty + 2 * kHalo;
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty, z0 = blockIdx.z * bz;
  const int64_t plane = (int64_t)ny * nx;
  const int n = bz * ph * pw;
  for (int i = threadIdx.y * tx + threadIdx.x; i < n; i += tx * ty) {
    const int c = i % pw, r = (i / pw) % ph, p = i / (pw * ph);
    const int z = z0 + p, y = y0 - kHalo + r, x = x0 - kHalo + c;
    float v = 0.f;
    if (z < nz && y >= 0 && y < ny && x >= 0 && x < nx)
      v = widen(src[z * plane + (int64_t)y * nx + x]);
    patch[i] = v;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const bool ring = y < kHalo || y >= ny - kHalo || x < kHalo ||
                    x >= nx - kHalo;
  for (int p = 0; p < bz && z0 + p < nz; ++p) {
    const int64_t o = (z0 + p) * plane + (int64_t)y * nx + x;
    if (ring) {
      out[o] = src[o];
      continue;
    }
    const float* c = patch + (p * ph + threadIdx.y + kHalo) * pw +
                     threadIdx.x + kHalo;
    auto s = [&](int dy, int dx) { return c[dy * pw + dx]; };
    auto lap = [&](int dy, int dx) {
      return __fsub_rn(
          __fmul_rn(4.f, s(dy, dx)),
          __fadd_rn(__fadd_rn(__fadd_rn(s(dy - 1, dx), s(dy + 1, dx)),
                              s(dy, dx - 1)),
                    s(dy, dx + 1)));
    };
    const float lap_c = lap(0, 0);
    const float flx_c = limit(__fsub_rn(lap(0, 1), lap_c),
                              __fsub_rn(s(0, 1), s(0, 0)));
    const float flx_m = limit(__fsub_rn(lap_c, lap(0, -1)),
                              __fsub_rn(s(0, 0), s(0, -1)));
    const float fly_c = limit(__fsub_rn(lap(1, 0), lap_c),
                              __fsub_rn(s(1, 0), s(0, 0)));
    const float fly_m = limit(__fsub_rn(lap_c, lap(-1, 0)),
                              __fsub_rn(s(0, 0), s(-1, 0)));
    const float div = __fadd_rn(__fsub_rn(flx_c, flx_m),
                                __fsub_rn(fly_c, fly_m));
    store(out + o, __fsub_rn(s(0, 0), __fmul_rn(coeff, div)));
  }
}

template <typename T>
int launch(const void* src, void* out, int nz, int ny, int nx, int tile_x,
           int tile_y, int block_z, float coeff, cudaStream_t stream) {
  const size_t smem = (size_t)block_z * (tile_y + 2 * kHalo) *
                      (tile_x + 2 * kHalo) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hdiff_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y,
                  (nz + block_z - 1) / block_z);
  hdiff_kernel<T><<<grid, dim3(tile_x, tile_y), smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(out), nz, ny, nx, block_z,
      coeff);
  return (int)cudaGetLastError();
}

}  // namespace simt
