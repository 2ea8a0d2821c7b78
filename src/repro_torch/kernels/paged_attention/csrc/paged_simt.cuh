// The "simt" route of paged attention: the first Hopper port of the TPU
// kernel, unchanged. It serves fp32 q at more than 64 query rows per kv
// head, head dims that the other routes do not take, and, launched
// directly, the "before" of the redesign's before/after comparison on
// bf16 inputs.
//
// Design. The k * g query rows of a sequence and kv head (the k rows
// folded with the g query heads of the kv head, row r = j * g + gi) split
// into blocks of at most 64 rows, so that any k up to a page (k = 128 rows
// of a chunked-prefill step at g = 9: 1152 rows) fits shared memory. One
// block per (sequence, kv head, block of rows). Its rows sit in shared
// memory as fp32, pre-scaled. The block walks the sequence's pages in
// order, only up to the page holding the last position its last row sees
// (lengths[b] + j - 1 for row j) -- table entries past it may be 0 or a
// trash slot and are never read -- in steps of 32 positions: it loads and
// dequantizes the
// step's K and V rows into shared memory, scores every query row against
// them with plain fp32 FMAs (no TF32, no tensor cores: the fp32 cases must
// meet 5e-5), updates the per-row (m, l) with one warp per row, and adds
// p @ V into an fp32 accumulator in shared memory. Element offsets are
// 64-bit: L * P * T * hkv * d passes 2^31 as the serving pool grows.
//
// It issues one 4-byte load per element with no overlap of loads and
// math; at decode batch sizes its b * hkv blocks occupy a small part of
// the 132 SMs; blocks of rows of one (sequence, kv head) each read its
// K/V again.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

constexpr int kTile = 32;       // positions per step: one per lane in the softmax
constexpr int kThreads = 256;
constexpr int kMaxRows = 64;    // query rows per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int8_t* k_quant;
  const int8_t* v_quant;
  const void* k_scale;
  const void* v_scale;
  const int32_t* page_table;
  const int32_t* lengths;
  void* out;
  int rows;         // k: query rows per sequence
  int row_block;    // query rows (of the k * g) per block
  int hq, hkv, d;
  int64_t pages;    // pages per layer (P)
  int t;            // tokens per page (T)
  int slots;        // page-table width
  int64_t layer;    // 0 for flat pools
  float scale;      // softmax scale
};

size_t smem_floats(int kg, int d) {   // kg: rows of one block
  return (size_t)kg * d            // q rows
       + (size_t)kTile * (d + 1)   // K step, rows padded against bank conflicts
       + (size_t)kTile * d         // V step
       + (size_t)kg * kTile        // scores, then probabilities
       + (size_t)kg * d            // accumulator
       + 3 * (size_t)kg;           // m, l, correction
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Args a) {
  const int bi = blockIdx.x;
  const int h = blockIdx.y;
  const int g = a.hq / a.hkv;
  const int r0 = blockIdx.z * a.row_block;       // first row of the block
  const int kg = min(a.row_block, a.rows * g - r0);
  const int d = a.d;
  const int t = a.t;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kg * d;
  float* v_s = k_s + kTile * (d + 1);
  float* p_s = v_s + kTile * d;
  float* acc = p_s + kg * kTile;
  float* m_s = acc + kg * d;
  float* l_s = m_s + kg;
  float* c_s = l_s + kg;

  const QT* q = static_cast<const QT*>(a.q);
  const PT* kf = static_cast<const PT*>(a.k_pages);
  const PT* vf = static_cast<const PT*>(a.v_pages);
  const PT* ks = static_cast<const PT*>(a.k_scale);
  const PT* vs = static_cast<const PT*>(a.v_scale);
  QT* out = static_cast<QT*>(a.out);

  for (int i = tid; i < kg * d; i += kThreads) {
    const int r = r0 + i / d, c = i % d;
    const int64_t off =
        (((int64_t)bi * a.rows + r / g) * a.hq + (int64_t)h * g + r % g) * d + c;
    q_s[i] = to_f32(q[off]) * a.scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < kg; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int len = a.lengths[bi];
  const int span = len + (r0 + kg - 1) / g;   // positions the last row sees
  const int n_pages = min((span + t - 1) / t, a.slots);
  const int warp = tid / 32, lane = tid % 32;

  for (int n = 0; n < n_pages; ++n) {
    const int64_t pid = a.page_table[(int64_t)bi * a.slots + n];
    const int64_t row0 = (a.layer * a.pages + pid) * t;   // first token row
    const int valid = min(t, span - n * t);
    for (int t0 = 0; t0 < valid; t0 += kTile) {
      const int cnt = min(kTile, valid - t0);
      for (int i = tid; i < cnt * d; i += kThreads) {
        const int j = i / d, c = i % d;
        const int64_t srow = (row0 + t0 + j) * a.hkv + h;   // scale row
        const int64_t off = srow * d + c;
        k_s[j * (d + 1) + c] =
            to_f32(kf[off]) + (float)a.k_quant[off] * to_f32(ks[srow]);
        v_s[j * d + c] =
            to_f32(vf[off]) + (float)a.v_quant[off] * to_f32(vs[srow]);
      }
      __syncthreads();

      const int pos0 = n * t + t0;
      for (int i = tid; i < kg * kTile; i += kThreads) {
        const int r = i / kTile, j = i % kTile;
        float s = kNegInf;
        if (j < cnt && pos0 + j < len + (r0 + r) / g) {
          const float* qr = q_s + r * d;
          const float* kr = k_s + j * (d + 1);
          float dot = 0.f;
          for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
          s = dot;
        }
        p_s[i] = s;
      }
      __syncthreads();

      for (int r = warp; r < kg; r += kThreads / 32) {
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

      for (int i = tid; i < kg * d; i += kThreads) {
        const int r = i / d, c = i % d;
        const float* pr = p_s + r * kTile;
        float pv = 0.f;
        for (int j = 0; j < cnt; ++j) pv = fmaf(pr[j], v_s[j * d + c], pv);
        acc[i] = acc[i] * c_s[r] + pv;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < kg * d; i += kThreads) {
    const int lr = i / d, r = r0 + lr, c = i % d;
    const int64_t off =
        (((int64_t)bi * a.rows + r / g) * a.hq + (int64_t)h * g + r % g) * d + c;
    store(out + off, acc[i] / fmaxf(l_s[lr], 1e-30f));
  }
}

template <typename QT, typename PT>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const int kg = a.rows * (a.hq / a.hkv);
  const int n_blocks = (kg + a.row_block - 1) / a.row_block;
  const size_t smem = smem_floats(a.row_block, a.d) * sizeof(float);
  auto kernel = paged_attention_kernel<QT, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b, a.hkv, n_blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace simt
