// COSMO vertical advection (the u-stage of gridtools'
// vertical_advection_dycore) for Hopper, route `simt`: the first port of
// `vadvc_pallas` (src/repro/kernels/vadvc/vadvc.py), unchanged but for its
// namespace and its launch function, which vadvc.cu's `vadvc_launch` calls
// for route 0. It is the "before" of the two routes' comparison on the card.
//
// Same function: four fp32 fields
// ustage, upos, utens, utens_stage (nz, ny, nx) and the staggered wcon
// (nz + 1, ny, nx + 1) give out (nz, ny, nx). Per (y, x) column, a Thomas
// tridiagonal solve along z: the forward sweep builds ccol and dcol from wcon
// averaged onto the u-point, BET_M, BET_P and DTR_STAGE; the backward sweep
// writes DTR_STAGE * (data - upos).
//
// Numbers. Every operation is an `_rn` intrinsic (the reciprocal is
// `__fdiv_rn(1, x)`), in the order of the plain PyTorch version
// (kernels/vadvc/ref.py, itself in the order of the JAX oracle
// repro/kernels/vadvc/ref.py), so nvcc contracts nothing and the output equals
// the plain version's to the bit. The levels k = 0 and k = nz - 1 take the
// oracle's rules: no lower coefficient and only the upper correction at k = 0,
// no upper coefficient and only the lower correction at nz - 1, with the
// neighbours' indices clamped. So nz = 1 reads wcon levels 0 and 1 and gets a
// correction of 0 (the Pallas kernel reads ustage[1], out of range there), and
// nz = 2 runs the two end levels only.
//
// Design. The TPU kernel holds a (nz, tile_y, nx) slab of all five fields in
// VMEM and vectorises the sweeps over the plane. Here one thread owns one
// column and walks it: neighbouring threads take neighbouring x, so every load
// and store of a level coalesces. ustage at k - 1, k, k + 1 and the wcon
// interface sum shared by levels k and k + 1 ride in registers; ccol and dcol
// of every level wait in shared memory for the backward sweep (2 nz floats a
// thread, laid out [level][thread] so that a warp's accesses fall in distinct
// banks): 64 KB for 128 columns at nz = 64. wcon is indexed with the strides
// the wrapper passes (its rows are nx + 1 long).
//
// Bound. The four fields and wcon are read once and out written once: about
// 101 MB at the COSMO grid 64 x 256 x 256, 0.030 ms at 3.35 TB/s; about 25
// flops per point, so bytes bound it. The backward sweep reads upos a second
// time (from L2 at best). Each thread's 2 nz levels are a chain that waits on
// its own loads, so the kernel needs many resident columns to cover the
// latency, and the shared-memory scratch limits how many an SM holds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

__global__ void vadvc_kernel(const float* __restrict__ ustage,
                             const float* __restrict__ upos,
                             const float* __restrict__ utens,
                             const float* __restrict__ utens_stage,
                             const float* __restrict__ wcon,
                             float* __restrict__ out, int nz, int ny, int nx,
                             int64_t w_sz, int64_t w_sy, float dtr,
                             float bet_m, float bet_p) {
  extern __shared__ float scratch[];   // ccol [nz][threads], dcol likewise
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float* ccol = scratch;
  float* dcol = scratch + (int64_t)nz * threads;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= nx || y >= ny) return;       // no barrier follows
  const int64_t plane = (int64_t)ny * nx;
  const int64_t col = (int64_t)y * nx + x;
  const float* w = wcon + (int64_t)y * w_sy + x;

  // forward sweep
  float wsum = __fadd_rn(w[1], w[0]);   // interface k (here 0)
  float u_km1 = ustage[col], u_k = u_km1;
  float c_prev = 0.f, d_prev = 0.f;
  for (int k = 0; k < nz; ++k) {
    const int64_t at = k * plane + col;
    const float u_kp1 = ustage[(k + 1 < nz ? k + 1 : nz - 1) * plane + col];
    const float wnext = __fadd_rn(w[(k + 1) * w_sz + 1], w[(k + 1) * w_sz]);
    const float gav = __fmul_rn(-0.25f, wsum);
    const float gcv = __fmul_rn(0.25f, wnext);
    const float as_ = __fmul_rn(gav, bet_m);
    const float cs = __fmul_rn(gcv, bet_m);
    float acol = __fmul_rn(gav, bet_p);
    float ccol_k = __fmul_rn(gcv, bet_p);
    const float corr_lo = __fmul_rn(-as_, __fsub_rn(u_km1, u_k));
    const float corr_hi = __fmul_rn(-cs, __fsub_rn(u_kp1, u_k));
    const bool first = k == 0, last = k == nz - 1;
    const float corr = first  ? corr_hi
                       : last ? corr_lo
                              : __fadd_rn(corr_lo, corr_hi);
    if (first) acol = 0.f;
    if (last) ccol_k = 0.f;
    const float bcol = __fsub_rn(__fsub_rn(dtr, acol), ccol_k);
    const float rhs = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dtr, upos[at]), utens[at]),
                  utens_stage[at]),
        corr);
    const float divided =
        __fdiv_rn(1.f, __fsub_rn(bcol, __fmul_rn(c_prev, acol)));
    c_prev = __fmul_rn(ccol_k, divided);
    d_prev = __fmul_rn(__fsub_rn(rhs, __fmul_rn(d_prev, acol)), divided);
    ccol[k * threads + tid] = c_prev;
    dcol[k * threads + tid] = d_prev;
    wsum = wnext;
    u_km1 = u_k;
    u_k = u_kp1;
  }

  // backward sweep
  float next = 0.f;
  for (int k = nz - 1; k >= 0; --k) {
    const int64_t at = k * plane + col;
    const float data = __fsub_rn(dcol[k * threads + tid],
                                 __fmul_rn(ccol[k * threads + tid], next));
    out[at] = __fmul_rn(dtr, __fsub_rn(data, upos[at]));
    next = data;
  }
}

int launch(const float* ustage, const float* upos, const float* utens,
           const float* utens_stage, const float* wcon, float* out, int nz,
           int ny, int nx, long long w_sz, long long w_sy, int tile_x,
           int tile_y, float dtr, float bet_m, float bet_p,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * nz * tile_x * tile_y * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vadvc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  vadvc_kernel<<<grid, dim3(tile_x, tile_y), smem, stream>>>(
      ustage, upos, utens, utens_stage, wcon, out, nz, ny, nx, w_sz, w_sy,
      dtr, bet_m, bet_p);
  return (int)cudaGetLastError();
}

}  // namespace simt
