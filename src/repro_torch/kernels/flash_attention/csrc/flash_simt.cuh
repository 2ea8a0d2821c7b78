// The SIMT route of the flash-attention kernel (see flash_attention.cu):
// fp32 inputs, and bf16 inputs at head dims the tensor-core route does not
// take (any d <= 256). It is the kernel of the port's first prefill slice,
// unchanged.
//
// Design. One block per (block of bq query positions, kv head, sequence):
// its rows are the bq positions times the g query heads of the kv head (row
// r = position r / g, head r % g), so the g heads share every K/V tile
// staged in shared memory. bq is chosen so a block holds about 64 rows
// (bq = 7 at starcoder2-7b's g = 9). The block loads its rows of q into
// shared memory as fp32, pre-scaled, then walks only the keys its rows can
// see -- up to its last position when causal, from its first position's
// window start -- in tiles of 32 positions: load the K and V tile as fp32,
// score every row against it with plain fp32 FMAs (one thread per (row,
// position) pair; no TF32 or tensor cores, so fp32 inputs meet the 5e-5
// tolerance), update the per-row (m, l) with one warp per row, and add
// p @ V into an fp32 accumulator in shared memory.
//
// Bound. At d = 128 prefill attention is bound by its flops, here on the
// fp32 FMA pipe (67 TFLOP/s): every FMA reads both operands from shared
// memory, and loads and math do not overlap.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

constexpr int kTile = 32;       // key positions per step: one per lane in the softmax
constexpr int kThreads = 256;
constexpr int kRowTarget = 64;  // query rows (positions x heads) per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, skv, hq, hkv, d;
  int bq;           // query positions per block
  int causal;
  int window;       // 0: no window
  float scale;      // softmax scale
};

inline size_t smem_floats(int rows, int d) {
  return (size_t)rows * d            // q rows
       + (size_t)kTile * (d + 1)     // K tile, rows padded against bank conflicts
       + (size_t)kTile * d           // V tile
       + (size_t)rows * kTile        // scores, then probabilities
       + (size_t)rows * d            // accumulator
       + 3 * (size_t)rows;           // m, l, correction
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args a) {
  const int q0 = blockIdx.x * a.bq;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = a.hq / a.hkv;
  const int nq = min(a.bq, a.sq - q0);
  const int rows = nq * g;
  const int d = a.d;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + rows * d;
  float* v_s = k_s + kTile * (d + 1);
  float* p_s = v_s + kTile * d;
  float* acc = p_s + rows * kTile;
  float* m_s = acc + rows * d;
  float* l_s = m_s + rows;
  float* c_s = l_s + rows;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int64_t off =
        (((int64_t)bi * a.sq + q0 + r / g) * a.hq + (int64_t)h * g + r % g) * d + c;
    q_s[i] = to_f32(q[off]) * a.scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // keys any row of the block can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = a.skv;
  if (a.causal) k_hi = min(a.skv, q0 + nq);
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  const int warp = tid / 32, lane = tid % 32;

  for (int t0 = k_lo; t0 < k_hi; t0 += kTile) {
    const int cnt = min(kTile, k_hi - t0);
    for (int i = tid; i < cnt * d; i += kThreads) {
      const int j = i / d, c = i % d;
      const int64_t off = (((int64_t)bi * a.skv + t0 + j) * a.hkv + h) * d + c;
      k_s[j * (d + 1) + c] = to_f32(k[off]);
      v_s[j * d + c] = to_f32(v[off]);
    }
    __syncthreads();

    for (int i = tid; i < rows * kTile; i += kThreads) {
      const int r = i / kTile, j = i % kTile;
      const int qp = q0 + r / g, kp = t0 + j;
      float s = kNegInf;
      if (j < cnt && (!a.causal || kp <= qp) &&
          (a.window <= 0 || kp > qp - a.window)) {
        const float* qr = q_s + r * d;
        const float* kr = k_s + j * (d + 1);
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot;
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kThreads / 32) {
      const float s = p_s[r * kTile + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = lane < cnt ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < rows * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const float* pr = p_s + r * kTile;
      float pv = 0.f;
      for (int j = 0; j < cnt; ++j) pv = fmaf(pr[j], v_s[j * d + c], pv);
      acc[i] = acc[i] * c_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int64_t off =
        (((int64_t)bi * a.sq + q0 + r / g) * a.hq + (int64_t)h * g + r % g) * d + c;
    store(out + off, acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

// Query positions per block for g query heads per kv head.
inline int block_q(int g) { return g >= kRowTarget ? 1 : kRowTarget / g; }

template <typename T>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const int rows = a.bq * (a.hq / a.hkv);
  const size_t smem = smem_floats(rows, a.d) * sizeof(float);
  auto kernel = flash_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + a.bq - 1) / a.bq, a.hkv, b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace simt
