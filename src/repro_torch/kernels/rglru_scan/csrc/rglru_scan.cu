// RG-LRU linear recurrence for Hopper.
//
// Replaces the TPU kernel `rglru_scan_pallas` (body `_lru_kernel`) of
// src/repro/kernels/rglru_scan/rglru_scan.py. Same function: a, b (B, S, W)
// fp32 give h (B, S, W) fp32 with h_t = a_t h_{t-1} + b_t from h_{-1} = 0.
// Each step rounds the product and then the sum (no fused multiply-add), the
// order of the plain PyTorch version `a[:, t] * h + b[:, t]`, so the two agree
// to the bit.
//
// Design. The TPU grid runs chunks of the sequence in order and carries the
// (1, W) state in VMEM scratch; here the state of one channel lives in one
// thread's register and the thread walks the whole sequence. Neighbouring
// threads take neighbouring channels, so every load and store of a step is
// coalesced across W. Each thread loads the next 8 steps' a and b before it
// runs them (the loads do not depend on the state), so 8 loads are in flight
// where one would wait alone.
//
// Bound. Each element of a and b is read once and each h written once: 12
// bytes per (position, channel), 63 MB at B = 1, S = 2048, W = 2560, 19 us
// at 3.35 TB/s; 2 flops per element is nothing. The recurrence is sequential
// in S, and at B = 1, W = 2560 the grid is 20 blocks of 128 threads on a
// card of 132 SMs: each thread waits on its loads once per 8 steps, so this
// kernel is bound by memory latency, far from its byte bound. Splitting S
// into chunks scanned in parallel with a carry fix-up afterwards is the
// later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;      // steps loaded before they run

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t base = (int64_t)blockIdx.y * S * W + w;
  float hv = 0.f;
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < S) {
        av[u] = a[base + (int64_t)(t0 + u) * W];
        bv[u] = b[base + (int64_t)(t0 + u) * W];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < S) {
        hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
        h[base + (int64_t)(t0 + u) * W] = hv;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// a, b and h are contiguous fp32 (B, S, W); S >= 1.
int rglru_scan_launch(const void* a, const void* b, void* h, int B, int S,
                      int W, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rglru_scan_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return (int)cudaGetLastError();
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
