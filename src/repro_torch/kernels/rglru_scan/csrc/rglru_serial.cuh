// The "serial" route of the RG-LRU linear recurrence: the first Hopper port
// of the TPU kernel (`rglru_scan_pallas`, src/repro/kernels/rglru_scan/
// rglru_scan.py), unchanged. It serves the decode-shaped short sequences
// (S <= one chunk of the chunked route) and, launched directly, the
// "before" of the redesign's before/after comparison.
//
// Design. The TPU grid runs chunks of the sequence in order and carries the
// (1, W) state in VMEM scratch; here the state of one channel lives in one
// thread's register and the thread walks the whole sequence. Neighbouring
// threads take neighbouring channels, so every load and store of a step is
// coalesced across W. Each thread loads the next 8 steps' a and b before it
// runs them (the loads do not depend on the state), so 8 loads are in flight
// where one would wait alone. Each step rounds the product and then the sum
// (no fused multiply-add), the order of the plain version, so the two agree
// to the bit.
//
// At B = 1, W = 2560 the grid is 20 blocks of 128 threads on a card of 132
// SMs, and each thread waits on its loads once per 8 steps: bound by memory
// latency, far from its byte bound.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace serial {

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

}  // namespace serial
