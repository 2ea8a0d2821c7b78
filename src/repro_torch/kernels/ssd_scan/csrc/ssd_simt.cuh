// The "simt" route of the Mamba2 SSD scan: the first Hopper port of the
// TPU kernel (`ssd_scan_pallas`, src/repro/kernels/ssd_scan/ssd_scan.py),
// unchanged. It serves fp32 inputs, the shapes the wgmma route does not
// take (P != 64, N not 64 or 128: the spec's small cases among them) and,
// launched directly, the "before" of the redesign's before/after
// comparison on bf16 inputs.
//
// Design. The TPU grid (batch, head, chunk) runs the chunk axis in order and
// carries the (N, P) state in VMEM scratch; CUDA blocks run in no order, so
// the chunk axis is a loop inside one block that keeps the state in shared
// memory. The state's columns are independent over P, so one block per
// (slice of 16 of the P columns, head, sequence): at mamba2-780m's H = 48,
// P = 64 that is 192 blocks for one sequence, more than the card's 132 SMs,
// with no reduction across blocks. Per chunk of 64 positions (not the
// model's 256: the (Q, Q) fp32 score tile of a 256-chunk alone would be
// 256 KB, past the 227 KB a block may hold) the block
//   1. loads dt and forms cum_i = sum_{j <= i} dt_j a,
//   2. stages the chunk's B and C rows (Q x N) and its x columns (Q x 16),
//   3. scores s_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i,
//   4. writes y_i = sum_j s_ij x_j + exp(cum_i) C_i . state (the state as it
//      stood before the chunk),
//   5. updates state = exp(cum_last) state + sum_j exp(cum_last - cum_j)
//      dt_j B_j (x) x_j.
// A sequence the chunk does not divide ends with a shorter chunk, masked
// here (the Pallas kernel asserts S % chunk == 0; prefill prompts do not
// oblige). Shared memory at Q = 64, N = 128: the B and C tiles (33 KB each,
// rows padded by one float against bank conflicts), the score tile (16 KB),
// the state slice (8 KB) and x (4 KB), about 96 KB, two blocks per SM.
//
// It is far from the function's bound: plain fp32 FMAs out of shared
// memory (two shared loads per FMA), every P slice recomputes the chunk's
// C B^T scores (4 slices x 48 heads = 192 times per chunk at mamba2-780m),
// loads and math do not overlap, and each block walks the whole sequence.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

constexpr int kChunk = 64;     // positions per chunk step
constexpr int kPTile = 16;     // state columns (of P) per block
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* a;
  float* y;
  float* state;
  int S, H, P, G, N;
};

size_t smem_floats(int n) {
  return 2 * (size_t)kChunk * (n + 1)   // B and C tiles, padded rows
       + (size_t)kChunk * kChunk        // scores
       + (size_t)kChunk * kPTile        // x columns
       + (size_t)kPTile * (n + 1)       // state slice, padded rows
       + 4 * (size_t)kChunk;            // dt, cum, exp(cum), weights
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  const int p0 = blockIdx.x * kPTile;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int np = min(kPTile, a.P - p0);
  const int N = a.N, N1 = a.N + 1;
  const int g = h / (a.H / a.G);
  const float a_h = a.a[h];
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* b_s = smem;                       // [kChunk][N1]
  float* c_s = b_s + kChunk * N1;          // [kChunk][N1]
  float* s_s = c_s + kChunk * N1;          // [kChunk][kChunk]
  float* x_s = s_s + kChunk * kChunk;      // [kChunk][kPTile]
  float* st_s = x_s + kChunk * kPTile;     // [kPTile][N1]
  float* dt_s = st_s + kPTile * N1;        // [kChunk]
  float* cum_s = dt_s + kChunk;            // [kChunk]
  float* ecum_s = cum_s + kChunk;          // [kChunk] exp(cum_i)
  float* w_s = ecum_s + kChunk;            // [kChunk] exp(cum_last - cum_j) dt_j

  const T* x = static_cast<const T*>(a.x);
  const T* bm = static_cast<const T*>(a.b);
  const T* cm = static_cast<const T*>(a.c);

  for (int i = tid; i < kPTile * N1; i += kThreads) st_s[i] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += kChunk) {
    const int q = min(kChunk, a.S - c0);
    for (int i = tid; i < q; i += kThreads)
      dt_s[i] = a.dt[((int64_t)bi * a.S + c0 + i) * a.H + h];
    for (int i = tid; i < q * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const int64_t off = (((int64_t)bi * a.S + c0 + r) * a.G + g) * N + n;
      b_s[r * N1 + n] = to_f32(bm[off]);
      c_s[r * N1 + n] = to_f32(cm[off]);
    }
    for (int i = tid; i < q * np; i += kThreads) {
      const int r = i / np, p = i % np;
      x_s[r * kPTile + p] =
          to_f32(x[(((int64_t)bi * a.S + c0 + r) * a.H + h) * a.P + p0 + p]);
    }
    __syncthreads();
    if (tid == 0) {
      // cumsum of da = dt a, one rounding per product and per sum
      float run = 0.f;
      for (int i = 0; i < q; ++i) {
        run = __fadd_rn(run, __fmul_rn(dt_s[i], a_h));
        cum_s[i] = run;
      }
    }
    __syncthreads();
    for (int i = tid; i < q; i += kThreads) {
      ecum_s[i] = expf(cum_s[i]);
      w_s[i] = expf(cum_s[q - 1] - cum_s[i]) * dt_s[i];
    }
    // intra-chunk scores, j <= i
    for (int i = tid; i < q * q; i += kThreads) {
      const int r = i / q, j = i % q;
      float s = 0.f;
      if (j <= r) {
        const float* cr = c_s + r * N1;
        const float* br = b_s + j * N1;
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(cr[n], br[n], dot);
        s = dot * expf(cum_s[r] - cum_s[j]) * dt_s[j];
      }
      s_s[r * kChunk + j] = s;
    }
    __syncthreads();
    // y = intra + exp(cum_i) C_i . state (state from before this chunk)
    for (int i = tid; i < q * np; i += kThreads) {
      const int r = i / np, p = i % np;
      const float* sr = s_s + r * kChunk;
      float intra = 0.f;
      for (int j = 0; j <= r; ++j) intra = fmaf(sr[j], x_s[j * kPTile + p], intra);
      const float* cr = c_s + r * N1;
      const float* sp = st_s + p * N1;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(cr[n], sp[n], inter);
      a.y[(((int64_t)bi * a.S + c0 + r) * a.H + h) * a.P + p0 + p] =
          intra + ecum_s[r] * inter;
    }
    __syncthreads();
    // state = exp(cum_last) state + sum_j w_j B_j (x) x_j
    const float decay = expf(cum_s[q - 1]);
    for (int i = tid; i < np * N; i += kThreads) {
      const int p = i / N, n = i % N;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc = fmaf(b_s[j * N1 + n], x_s[j * kPTile + p] * w_s[j], acc);
      st_s[p * N1 + n] = st_s[p * N1 + n] * decay + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < np * N; i += kThreads) {
    const int p = i / N, n = i % N;
    a.state[(((int64_t)bi * a.H + h) * a.P + p0 + p) * N + n] = st_s[p * N1 + n];
  }
}

template <typename T>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_floats(a.N) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.P + kPTile - 1) / kPTile, a.H, b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace simt
