// RG-LRU linear recurrence for Hopper.
//
// Replaces the TPU kernel `rglru_scan_pallas` (body `_lru_kernel`) of
// src/repro/kernels/rglru_scan/rglru_scan.py. Same function: a, b (B, S, W)
// fp32 give h (B, S, W) fp32 with h_t = a_t h_{t-1} + b_t from h_{-1} = 0.
// Every step rounds the product and then the sum (no fused multiply-add),
// the order of the plain PyTorch version `a[:, t] * h + b[:, t]`.
//
// Two routes, chosen by the wrapper from S alone (`route(S)`):
// - "chunked" (this file) for S longer than one chunk (the wrapper's
//   chunk, 32 positions; tools/ssd_variants.py times 32-256);
// - "serial" (rglru_serial.cuh): the first port, unchanged, one thread per
//   channel over the whole sequence, for S <= one chunk (the decode-shaped
//   S = 1 and 4 among them); on it the two agree to the bit.
//
// The chunked route: the sequence is cut into chunks of L positions, run in
// parallel, in two launches.
//   1. Aggregates, one thread per (channel, chunk but the last, sequence):
//      the chunk's product A_c = prod a_t and its local scan from zero L_c
//      (the chunk's last h had the state entering it been 0), into scratch
//      (B, nc - 1, W) x 2.
//   2. Apply, one thread per (channel, chunk, sequence): the state entering
//      chunk c by the chain carry_{k+1} = A_k carry_k + L_k over k < c
//      (each thread walks the same chain in the same order, so chunk c + 1
//      sees exactly the carry chunk c ended with), then the recurrence over
//      the chunk from that carry, each step rounded as the serial route
//      rounds it. The chunks run in the reverse of launch 1's order, so
//      the a and b launch 1 read last are still in L2 when launch 2 starts.
// Neighbouring threads take neighbouring channels (coalesced across W),
// and each thread loads 8 steps' a and b before it runs them. Against the
// serial recurrence only the carry differs: it is the chunk aggregates'
// rounding instead of the step-by-step one, and the card holds the route to
// the plain version at the same 2 ulps of |want| + 1e-6 per element as the
// serial route. chip_smoke.rglru_chunked_loop does the same operations in
// the same order in plain PyTorch: on the card the two agree to the bit,
// and it stays within a third of the limit at B = 2, S = 2300.
//
// Bound. Each element of a and b is read once and each h written once: 12
// bytes per (position, channel), 141 MB at B = 2, S = 2300, W = 2560, 0.042
// ms at 3.35 TB/s; 2 flops per element is nothing. This route reads a and b
// twice (launch 1, then launch 2), 235 MB in all less what launch 2 finds in
// L2: about 0.07 ms at 3.35 TB/s. It takes about 0.090 ms there (chunks of
// 32 to 128 alike, 256 slower; launch 1 36-43 us, launch 2 48-51 us), 2.7x
// faster than the serial route. With 32-position chunks a B = 2, S = 2300,
// W = 2560 call runs 368,640 threads, enough to keep the card's memory
// busy. What still holds it back: the second read of a and b (one launch
// with a look-back over published carries would read them once), and the
// carry chain of up to nc - 1 dependent steps at the start of each thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rglru_serial.cuh"

namespace chunked {

constexpr int kThreads = 128;
constexpr int kAhead = 8;      // steps loaded before they run

// error codes of the launch beside cudaError_t's (which are >= 0)
constexpr int kBadChunk = -1;

// One thread's chunk: positions [t0, t0 + n) of channel column `base`. With
// `carry` = 0 the local scan; `prod` receives the product of the a's.
template <bool kStore, bool kProd>
__device__ __forceinline__ float run_chunk(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float* __restrict__ h,
                                           int64_t base, int t0, int n, int W,
                                           float carry, float* prod) {
  float hv = carry, pv = 1.f;
  for (int u0 = 0; u0 < n; u0 += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u0 + u < n) {
        av[u] = a[base + (int64_t)(t0 + u0 + u) * W];
        bv[u] = b[base + (int64_t)(t0 + u0 + u) * W];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u0 + u < n) {
        hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
        if (kProd) pv = __fmul_rn(pv, av[u]);
        if (kStore) h[base + (int64_t)(t0 + u0 + u) * W] = hv;
      }
    }
  }
  if (kProd) *prod = pv;
  return hv;
}

// 1. A_c and L_c of chunk c = blockIdx.y (< nc - 1) of sequence blockIdx.z.
__global__ void __launch_bounds__(kThreads)
    rglru_aggregate_kernel(const float* __restrict__ a,
                           const float* __restrict__ b, float* __restrict__ agg,
                           int S, int W, int L, int nc) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, bi = blockIdx.z;
  float prod;
  const float local = run_chunk<false, true>(
      a, b, nullptr, (int64_t)bi * S * W + w, c * L, L, W, 0.f, &prod);
  const int64_t k = ((int64_t)bi * (nc - 1) + c) * W + w;
  const int64_t half = (int64_t)gridDim.z * (nc - 1) * W;
  agg[k] = prod;
  agg[half + k] = local;
}

// 2. Chunk c of sequence bi, launched in the reverse of launch 1's order:
// the carry from the aggregates of chunks 0 .. c - 1, then the recurrence.
__global__ void __launch_bounds__(kThreads)
    rglru_apply_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ h, const float* __restrict__ agg,
                       int S, int W, int L, int nc) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int c = nc - 1 - blockIdx.y, bi = gridDim.z - 1 - blockIdx.z;
  const int64_t half = (int64_t)gridDim.z * (nc - 1) * W;
  const float* ap = agg + (int64_t)bi * (nc - 1) * W + w;
  const float* lp = ap + half;
  float carry = 0.f;
  for (int k0 = 0; k0 < c; k0 += kAhead) {
    float av[kAhead], lv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (k0 + u < c) {
        av[u] = ap[(int64_t)(k0 + u) * W];
        lv[u] = lp[(int64_t)(k0 + u) * W];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (k0 + u < c) carry = __fadd_rn(__fmul_rn(av[u], carry), lv[u]);
  }
  run_chunk<true, false>(a, b, h, (int64_t)bi * S * W + w, c * L,
                         min(L, S - c * L), W, carry, nullptr);
}

}  // namespace chunked

extern "C" {

// Launches on `stream` and returns 0, the launch's cudaError_t or a negative
// code of `chunked`. a, b and h are contiguous fp32 (B, S, W); S >= 1.
// `route` 0 is the serial route (`agg` and `chunk` unused); 1 the chunked
// route with chunks of `chunk` positions and `agg` fp32 scratch of
// 2 * B * (ceil(S / chunk) - 1) * W (may be null when S <= chunk).
int rglru_scan_launch(const void* a, const void* b, void* h, void* agg, int B,
                      int S, int W, int route, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* hf = static_cast<float*>(h);
  if (route == 0) {
    const dim3 grid((W + serial::kThreads - 1) / serial::kThreads, B);
    serial::rglru_scan_kernel<<<grid, serial::kThreads, 0, s>>>(af, bf, hf, S,
                                                                W);
    return (int)cudaGetLastError();
  }
  if (route != 1 || chunk <= 0) return chunked::kBadChunk;
  const int nc = (S + chunk - 1) / chunk;
  const int wb = (W + chunked::kThreads - 1) / chunked::kThreads;
  float* ag = static_cast<float*>(agg);
  if (nc > 1) {
    chunked::rglru_aggregate_kernel<<<dim3(wb, nc - 1, B), chunked::kThreads,
                                      0, s>>>(af, bf, ag, S, W, chunk, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  chunked::rglru_apply_kernel<<<dim3(wb, nc, B), chunked::kThreads, 0, s>>>(
      af, bf, hf, ag, S, W, chunk, nc);
  return (int)cudaGetLastError();
}

const char* rglru_scan_error_string(int err) {
  if (err == chunked::kBadChunk) return "the chunked route takes a chunk >= 1";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
