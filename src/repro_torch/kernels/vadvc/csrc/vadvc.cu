// COSMO vertical advection (the u-stage of gridtools'
// vertical_advection_dycore) for Hopper, route `prefetch`.
//
// Replaces the TPU kernel `vadvc_pallas` (body `_vadvc_kernel`) of
// src/repro/kernels/vadvc/vadvc.py. Same function: four fp32 fields
// ustage, upos, utens, utens_stage (nz, ny, nx) and the staggered wcon
// (nz + 1, ny, nx + 1) give out (nz, ny, nx). Per (y, x) column, a Thomas
// tridiagonal solve along z: the forward sweep builds ccol and dcol from wcon
// averaged onto the u-point, BET_M, BET_P and DTR_STAGE; the backward sweep
// writes DTR_STAGE * (data - upos). Route `simt` (vadvc_simt.cuh, the first
// port) is kept as the "before" of the two routes' comparison.
//
// Numbers. As in the simt route: every operation is an `_rn` intrinsic (the
// reciprocal is `__fdiv_rn(1, x)`) in the order of the plain PyTorch version
// (kernels/vadvc/ref.py), nothing is contracted, and the end levels k = 0 and
// nz - 1 take the oracle's rules (nz = 1 and 2 included), so the output
// equals the plain version's to the bit.
//
// Bound. The four fields and wcon are read once and out written once: about
// 101 MB at the COSMO grid 64 x 256 x 256, 0.030 ms at 3.35 TB/s; about 25
// flops a point, so bytes bound it. The simt route waited on memory inside
// the chain: each level's six loads were issued at the top of a loop that was
// not unrolled, so every one of the 2 nz dependent steps of a column paid a
// device-memory latency under load (about 0.7 us: 0.088 ms for 128 steps),
// and 65,536 columns are too few threads to hide it.
//
// Design. A thread still owns one column (neighbouring threads take
// neighbouring x, so every load and store of a level coalesces), but its
// loads are issued ahead of use: the forward sweep keeps the six values of
// kAhead levels in a register ring (ustage[k + 1], wcon[k + 1][x], wcon[k +
// 1][x + 1], upos[k], utens[k], utens_stage[k]), the loop unrolled by kAhead
// so the ring's indices are constants; each level takes its values from the
// ring and, its arithmetic done, refills the slot with level k + kAhead's
// loads (unconditionally: see `fetch`). The chain then waits on arithmetic
// only (one `__fdiv_rn` and about 20 fp32 operations a level). Registers
// were kept over a cp.async ring in shared memory: a thread reads only its
// own column, so a register ring needs no barrier and leaves the shared
// memory to the sweep's scratch. kAhead = 8: a ring of 4 or 16 levels took
// 10-16% and 117-122% longer at the COSMO grid (16: 128 registers a thread).
// wcon is read with plain 4-byte loads (its rows of nx + 1 floats are not
// 16-byte aligned). upos is read once: the forward sweep keeps it in shared
// memory beside ccol and dcol for the backward sweep, which reads no device
// memory but writes out; re-reading it there, 16 levels ahead, took 14-21%
// longer (tools/stencil_variants.py, PERF.md). The scratch
// is [level][thread], so a warp's accesses fall in distinct banks, 12 nz
// bytes a column: at nz = 64 an SM holds at most 288 columns (9 blocks of
// 32), and the COSMO grid's 65,536 columns take 1.7 waves. One wave is out
// of reach: ccol and dcol alone, for every column, would need 33.5 MB of
// the SMs' 30 MB. With the loads ahead, a wave's bytes, not its chain, set
// its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vadvc_simt.cuh"

namespace prefetch {

constexpr int kAhead = 8;        // forward: levels whose loads are in flight
// threads a block may take: the rings hold about 100 registers a thread,
// so 1024 threads would not fit an SM's 65,536
constexpr int kMaxThreads = 512;

struct Level {                    // the loads of forward level k
  float u_kp1, w0, w1, up, ut, uts;
};

__global__ void __launch_bounds__(kMaxThreads) vadvc_prefetch_kernel(
    const float* __restrict__ ustage, const float* __restrict__ upos,
    const float* __restrict__ utens, const float* __restrict__ utens_stage,
    const float* __restrict__ wcon, float* __restrict__ out, int nz, int ny,
    int nx, int64_t w_sz, int64_t w_sy, float dtr, float bet_m,
    float bet_p) {
  extern __shared__ float scratch[];   // ccol [nz][threads], dcol, ucol
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float* ccol = scratch;
  float* dcol = ccol + (int64_t)nz * threads;
  float* ucol = dcol + (int64_t)nz * threads;     // upos, kept
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= nx || y >= ny) return;       // no barrier follows
  const int64_t plane = (int64_t)ny * nx;
  const int64_t col = (int64_t)y * nx + x;
  const float* w = wcon + (int64_t)y * w_sy + x;

  // level k's loads; past the last level the last level's (never used),
  // so that every slot is refilled unconditionally: a conditional refill
  // would make nvcc copy the ring's registers each level, and a copy waits
  // for the load in flight
  auto fetch = [&](int k, Level& l) {
    k = k < nz ? k : nz - 1;
    const int64_t at = k * plane + col;
    l.u_kp1 = ustage[(k + 1 < nz ? k + 1 : nz - 1) * plane + col];
    l.w0 = w[(k + 1) * w_sz];
    l.w1 = w[(k + 1) * w_sz + 1];
    l.up = upos[at];
    l.ut = utens[at];
    l.uts = utens_stage[at];
  };

  // forward sweep
  Level ring[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) fetch(j, ring[j]);
  float wsum = __fadd_rn(w[1], w[0]);   // interface k (here 0)
  float u_km1 = ustage[col], u_k = u_km1;
  float c_prev = 0.f, d_prev = 0.f;
  for (int k0 = 0; k0 < nz; k0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int k = k0 + j;
      if (k >= nz) break;
      const Level l = ring[j];
      const float u_kp1 = l.u_kp1;
      const float wnext = __fadd_rn(l.w1, l.w0);
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
          __fadd_rn(__fadd_rn(__fmul_rn(dtr, l.up), l.ut), l.uts), corr);
      const float divided =
          __fdiv_rn(1.f, __fsub_rn(bcol, __fmul_rn(c_prev, acol)));
      c_prev = __fmul_rn(ccol_k, divided);
      d_prev = __fmul_rn(__fsub_rn(rhs, __fmul_rn(d_prev, acol)), divided);
      ccol[k * threads + tid] = c_prev;
      dcol[k * threads + tid] = d_prev;
      ucol[k * threads + tid] = l.up;
      wsum = wnext;
      u_km1 = u_k;
      u_k = u_kp1;
      fetch(k + kAhead, ring[j]);   // the slot's values are dead: reuse it
    }
  }

  // backward sweep
  float next = 0.f;
  for (int k = nz - 1; k >= 0; --k) {
    const int at = k * threads + tid;
    const float data = __fsub_rn(dcol[at], __fmul_rn(ccol[at], next));
    out[k * plane + col] = __fmul_rn(dtr, __fsub_rn(data, ucol[at]));
    next = data;
  }
}

int launch(const float* ustage, const float* upos, const float* utens,
           const float* utens_stage, const float* wcon, float* out, int nz,
           int ny, int nx, long long w_sz, long long w_sy, int tile_x,
           int tile_y, float dtr, float bet_m, float bet_p,
           cudaStream_t stream) {
  const size_t smem = (size_t)3 * nz * tile_x * tile_y * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vadvc_prefetch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  vadvc_prefetch_kernel<<<grid, dim3(tile_x, tile_y), smem, stream>>>(
      ustage, upos, utens, utens_stage, wcon, out, nz, ny, nx, w_sz, w_sy,
      dtr, bet_m, bet_p);
  return (int)cudaGetLastError();
}

}  // namespace prefetch

extern "C" {

// Launches route `prefetch` (1) or `simt` (0) on `stream` and returns the
// launch's cudaError_t (0 on success). The four fields and out are
// contiguous fp32 (nz, ny, nx); wcon is fp32 (nz + 1, ny, nx + 1) with
// strides (w_sz, w_sy, 1) in elements.
int vadvc_launch(const void* ustage, const void* upos, const void* utens,
                 const void* utens_stage, const void* wcon, void* out, int nz,
                 int ny, int nx, long long w_sz, long long w_sy, int tile_x,
                 int tile_y, float dtr, float bet_m, float bet_p, int route,
                 void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto launch = route == 1 ? prefetch::launch : simt::launch;
  return launch(f(ustage), f(upos), f(utens), f(utens_stage), f(wcon),
                static_cast<float*>(out), nz, ny, nx, w_sz, w_sy, tile_x,
                tile_y, dtr, bet_m, bet_p, static_cast<cudaStream_t>(stream));
}

const char* vadvc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
