// The "split" route of paged attention: at most 64 query rows per kv head
// (k * g <= 64: k = 1 decode and the k = 4 verify at g = 9), any dtype,
// head dims 16, 32, 64, 128 and 256.
//
// Bound. Such a call does 4 * k * g flops per dequantized K/V element, far
// below the card's ratio of flops to bytes: the least time is the bytes of
// K and V (float tier, int8 tier and scales of every visible position)
// over the 3.35 TB/s of HBM. What keeps a kernel from it is too few blocks
// (b * hkv is 8-16 at decode batch sizes, on 132 SMs), loads that do not
// overlap the math, and, at 1.8 fp32 FMAs per byte at g = 9, issue slots
// spent on anything but FMAs.
//
// Design.
// - Work split. One block of 256 threads per (split of positions, kv head,
//   sequence) holds all k * g rows of its kv head, so K/V are read once.
//   The wrapper picks the number of splits from static shapes alone (b,
//   hkv, the table's positions, the SM count): enough that the grid fills
//   the card twice. It never reads the lengths on the host, which would
//   synchronise the stream. A split that starts past the last position any
//   row sees writes an empty partial (m = -1e30, l = 0) and loads nothing.
// - Loads. Tiles of 32 positions (16 at d = 256) come into shared memory
//   by cp.async, 16 bytes a copy, through a ring of two stages: the copies
//   of tile t + 1 are in flight while tile t is computed. 256 / tile
//   threads share a position, so each looks its page up once a tile. Both
//   tiers and the scales are read, as the function demands; the float
//   tier is then dequantized in place (float + int8 * scale, rounded as
//   the plain version rounds it). K rows are padded by 16 bytes so that
//   the score loop's 16-byte reads of 8 neighbouring positions hit
//   distinct banks.
// - Math in fp32 on the CUDA cores, R rows (2 up to 32 rows, else 4) by
//   one position, or R rows by 4 columns, a thread at a time: each shared
//   memory read of K or V feeds R rows, and only the last group of rows
//   computes rows that do not exist. Scores against q in shared memory
//   (pre-scaled as the plain version scales it), 4 partial sums a row;
//   one warp per row updates the online softmax (m, l), masked p = 0;
//   acc = acc * corr + p V in shared memory, read and written once a
//   tile.
// - Combine. Every block writes its rows' (m, l) and unnormalised
//   accumulator to a scratch buffer; the last block of a (sequence, kv
//   head) to finish, found by an atomic counter, combines them:
//   O = sum_s exp(m_s - M) acc_s / sum_s exp(m_s - M) l_s, and resets the
//   counter to 0 for the next launch. One launch per call. With one split
//   the block writes O itself.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace split {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;      // k * g rows per kv head
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename QT>
__device__ __forceinline__ void store4(QT* p, float4 x, float inv) {
  store(p, x.x * inv);
  store(p + 1, x.y * inv);
  store(p + 2, x.z * inv);
  store(p + 3, x.w * inv);
}

// positions per tile
__host__ __device__ inline int tile_positions(int d) {
  return d <= 128 ? 32 : 16;
}

__host__ __device__ inline int log2i(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

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
  float2* part_ml;  // (b, hkv, splits, k * g): (m, l)
  float* part_acc;  // (b, hkv, splits, k * g, d)
  int* counters;    // (b, hkv), 0 between launches
  int rows;         // k: query rows per sequence
  int hq, hkv, d;   // d a power of two, 16 .. 256
  int64_t pages;    // pages per layer (P)
  int t;            // tokens per page (T)
  int slots;        // page-table width
  int64_t layer;    // 0 for flat pools
  float scale;      // softmax scale
  int splits;
  int chunk;        // positions per split, a multiple of the tile
};

// Shared memory, in bytes, in the order of the kernel's carve-up; the
// combine reuses it from the start.
template <typename PT>
struct Smem {
  int kg, d, tp;
  __host__ __device__ int k_stride() const { return d + 4; }   // floats
  __host__ __device__ size_t q() const { return (size_t)kg * d * 4; }
  __host__ __device__ size_t acc() const { return (size_t)kg * d * 4; }
  __host__ __device__ size_t kf() const { return (size_t)tp * (d + 4) * 4; }
  __host__ __device__ size_t vf() const { return (size_t)tp * d * 4; }
  __host__ __device__ size_t i8() const { return (size_t)tp * d; }
  // bf16 pools land in a raw area and are widened into kf / vf
  __host__ __device__ size_t raw() const {
    return std::is_same<PT, float>::value ? 0 : (size_t)tp * d * 2;
  }
  __host__ __device__ size_t stage() const {
    return kf() + vf() + 2 * i8() + 2 * raw();
  }
  __host__ __device__ size_t p() const { return (size_t)kg * tp * 4; }
  __host__ __device__ size_t main() const {
    return q() + acc() + 2 * stage() + p() + 4 * (size_t)kg * 4 +
           2 * (size_t)tp * 4 + 16;
  }
  __host__ __device__ size_t combine() const {
    return (size_t)kMaxSplits * kg * 12 + (size_t)kg * 4 + 16;
  }
  __host__ __device__ size_t total() const {
    return main() > combine() ? main() : combine();
  }
};

// R: rows a thread scores and accumulates at once (register blocking)
template <typename QT, typename PT, int R>
__global__ void __launch_bounds__(kThreads, 2)
    paged_attention_split_kernel(Args a) {
  const int s = blockIdx.x;     // split
  const int h = blockIdx.y;     // kv head
  const int bi = blockIdx.z;    // sequence
  const int g = a.hq / a.hkv;
  const int kg = a.rows * g;
  const int d = a.d;
  const int tid = threadIdx.x;
  const int tp = tile_positions(d);
  const int tp_shift = log2i(tp);
  const int ncol = d / 4;                   // float4 columns
  const int ncol_shift = log2i(ncol);
  const int n_grp = (kg + R - 1) / R;       // groups of R rows
  const Smem<PT> L{kg, d, tp};
  const int ks_stride = L.k_stride();

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float4* acc_s = reinterpret_cast<float4*>(smem + L.q());
  uint8_t* stage0 = smem + L.q() + L.acc();
  float* p_s = reinterpret_cast<float*>(stage0 + 2 * L.stage());
  float* m_s = p_s + kg * tp;
  float* l_s = m_s + kg;
  float* c_s = l_s + kg;
  int* lim_s = reinterpret_cast<int*>(c_s + kg);   // positions row r sees
  float* ksc_s = reinterpret_cast<float*>(lim_s + kg);  // this tile's scales
  float* vsc_s = ksc_s + tp;
  int* flag_s = reinterpret_cast<int*>(vsc_s + tp);
  auto kf_s = [&](int st) {
    return reinterpret_cast<float*>(stage0 + st * L.stage());
  };
  auto vf_s = [&](int st) {
    return reinterpret_cast<float*>(stage0 + st * L.stage() + L.kf());
  };
  auto kq_s = [&](int st) {
    return reinterpret_cast<int8_t*>(stage0 + st * L.stage() + L.kf() +
                                     L.vf());
  };
  auto vq_s = [&](int st) { return kq_s(st) + L.i8(); };
  auto kraw_s = [&](int st) {
    return reinterpret_cast<PT*>(stage0 + st * L.stage() + L.kf() + L.vf() +
                                 2 * L.i8());
  };
  auto vraw_s = [&](int st) { return kraw_s(st) + tp * d; };

  const PT* kf = static_cast<const PT*>(a.k_pages);
  const PT* vf = static_cast<const PT*>(a.v_pages);
  const PT* ks = static_cast<const PT*>(a.k_scale);
  const PT* vs = static_cast<const PT*>(a.v_scale);
  const QT* q = static_cast<const QT*>(a.q);
  QT* out = static_cast<QT*>(a.out);
  const int pair = bi * a.hkv + h;

  const int len = a.lengths[bi];
  const int span = min(len + a.rows - 1, a.slots * a.t);  // last row's view
  const int start = s * a.chunk;
  const int end = min(start + a.chunk, span);
  const int n_tiles = end > start ? (end - start + tp - 1) / tp : 0;

  // output element offset of row r, column 0
  auto out_off = [&](int r) {
    return (((int64_t)bi * a.rows + r / g) * a.hq + (int64_t)h * g + r % g) *
           d;
  };

  if (n_tiles > 0) {
    for (int i = tid; i < kg * ncol; i += kThreads) {
      const int r = i >> ncol_shift, c = (i & (ncol - 1)) * 4;
      const QT* src = q + out_off(r) + c;
      *reinterpret_cast<float4*>(q_s + r * d + c) = make_float4(
          to_f32(src[0]) * a.scale, to_f32(src[1]) * a.scale,
          to_f32(src[2]) * a.scale, to_f32(src[3]) * a.scale);
      acc_s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int r = tid; r < kg; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
      lim_s[r] = len + r / g;
    }
  }

  // loads: thread (lj, lsub) copies part of position lj's rows; the
  // threads with lsub = 0 carry its scales to the next tile in registers
  const int tpp = kThreads / tp;
  const int lj = tid / tpp, lsub = tid % tpp;
  float next_ks = 0.f, next_vs = 0.f;
  auto issue = [&](int t) {
    const int st = t & 1;
    const int p = start + t * tp + lj;
    if (p < end) {
      const int64_t pid = a.page_table[(int64_t)bi * a.slots + p / a.t];
      const int64_t row = ((a.layer * a.pages + pid) * a.t + p % a.t) *
                          a.hkv + h;
      const int64_t off = row * d;
      if (std::is_same<PT, float>::value) {
        for (int c = lsub * 4; c < d; c += tpp * 4) {
          hopper::cp_async16(hopper::smem_u32(kf_s(st) + lj * ks_stride + c),
                             kf + off + c);
          hopper::cp_async16(hopper::smem_u32(vf_s(st) + lj * d + c),
                             vf + off + c);
        }
      } else {
        for (int c = lsub * 8; c < d; c += tpp * 8) {
          hopper::cp_async16(hopper::smem_u32(kraw_s(st) + lj * d + c),
                             kf + off + c);
          hopper::cp_async16(hopper::smem_u32(vraw_s(st) + lj * d + c),
                             vf + off + c);
        }
      }
      for (int c = lsub * 16; c < d; c += tpp * 16) {
        hopper::cp_async16(hopper::smem_u32(kq_s(st) + lj * d + c),
                           a.k_quant + off + c);
        hopper::cp_async16(hopper::smem_u32(vq_s(st) + lj * d + c),
                           a.v_quant + off + c);
      }
      if (lsub == 0) {
        next_ks = to_f32(ks[row]);
        next_vs = to_f32(vs[row]);
      }
    } else if (lsub == 0) {
      next_ks = next_vs = 0.f;
    }
    hopper::cp_async_commit();
  };

  if (n_tiles > 0) issue(0);
  float cur_ks = next_ks, cur_vs = next_vs;
  const int warp = tid / 32, lane = tid % 32;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int p0 = start + t * tp;
    const int cnt = min(tp, end - p0);
    if (t + 1 < n_tiles) {
      issue(t + 1);
    } else {
      hopper::cp_async_commit();   // an empty group keeps wait<1> uniform
    }
    hopper::cp_async_wait<1>();
    if (lsub == 0) {
      ksc_s[lj] = cur_ks;
      vsc_s[lj] = cur_vs;
    }
    __syncthreads();

    // dequantize: float + int8 * scale, rounded as the plain version does;
    // positions past the tile's count become 0
    {
      float* kd = kf_s(st);
      float* vd = vf_s(st);
      const int8_t* k8 = kq_s(st);
      const int8_t* v8 = vq_s(st);
      const bool ok = lj < cnt;
      const float ksc = ksc_s[lj], vsc = vsc_s[lj];
      for (int c = lsub * 4; c < d; c += tpp * 4) {
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (ok) {
          float4 kfl, vfl;
          if constexpr (std::is_same<PT, float>::value) {
            kfl = *reinterpret_cast<const float4*>(kd + lj * ks_stride + c);
            vfl = *reinterpret_cast<const float4*>(vd + lj * d + c);
          } else {
            const PT* kr = kraw_s(st) + lj * d + c;
            const PT* vr = vraw_s(st) + lj * d + c;
            kfl = make_float4(to_f32(kr[0]), to_f32(kr[1]), to_f32(kr[2]),
                              to_f32(kr[3]));
            vfl = make_float4(to_f32(vr[0]), to_f32(vr[1]), to_f32(vr[2]),
                              to_f32(vr[3]));
          }
          const char4 kq = *reinterpret_cast<const char4*>(k8 + lj * d + c);
          const char4 vq = *reinterpret_cast<const char4*>(v8 + lj * d + c);
          kx.x = __fadd_rn(kfl.x, __fmul_rn((float)kq.x, ksc));
          kx.y = __fadd_rn(kfl.y, __fmul_rn((float)kq.y, ksc));
          kx.z = __fadd_rn(kfl.z, __fmul_rn((float)kq.z, ksc));
          kx.w = __fadd_rn(kfl.w, __fmul_rn((float)kq.w, ksc));
          vx.x = __fadd_rn(vfl.x, __fmul_rn((float)vq.x, vsc));
          vx.y = __fadd_rn(vfl.y, __fmul_rn((float)vq.y, vsc));
          vx.z = __fadd_rn(vfl.z, __fmul_rn((float)vq.z, vsc));
          vx.w = __fadd_rn(vfl.w, __fmul_rn((float)vq.w, vsc));
        }
        *reinterpret_cast<float4*>(kd + lj * ks_stride + c) = kx;
        *reinterpret_cast<float4*>(vd + lj * d + c) = vx;
      }
    }
    __syncthreads();

    // scores, R rows by one position a thread at a time (rows past kg
    // read row kg - 1 and are not written); 4 partial sums a row
    {
      const float* kd = kf_s(st);
      for (int i = tid; i < n_grp * tp; i += kThreads) {
        const int r0 = (i >> tp_shift) * R, j = i & (tp - 1);
        const float* kr = kd + j * ks_stride;
        const int r_end = min(r0 + R, kg);
        float4 dot[R];
#pragma unroll
        for (int e = 0; e < R; ++e) dot[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < cnt && p0 + j < lim_s[r_end - 1]) {
          for (int c = 0; c < d; c += 4) {
            const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
            for (int e = 0; e < R; ++e) {
              const float4 q4 = *reinterpret_cast<const float4*>(
                  q_s + min(r0 + e, kg - 1) * d + c);
              dot[e].x = fmaf(q4.x, k4.x, dot[e].x);
              dot[e].y = fmaf(q4.y, k4.y, dot[e].y);
              dot[e].z = fmaf(q4.z, k4.z, dot[e].z);
              dot[e].w = fmaf(q4.w, k4.w, dot[e].w);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < R; ++e) {
          const int r = r0 + e;
          if (r < kg)
            p_s[r * tp + j] = j < cnt && p0 + j < lim_s[r]
                                  ? (dot[e].x + dot[e].y) + (dot[e].z + dot[e].w)
                                  : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row; masked positions get p = 0
    for (int r = warp; r < kg; r += kThreads / 32) {
      const float x = lane < tp ? p_s[r * tp + lane] : kNegInf;
      const bool valid = x != kNegInf;
      float mx = x;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = valid ? expf(x - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < tp) p_s[r * tp + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V, R rows by 4 columns a thread at a time;
    // p is 0 and V is 0 past the tile's count, so whole steps of 4
    // positions run
    {
      const float* vd = vf_s(st);
      const int cnt4 = (cnt + 3) & ~3;
      for (int i = tid; i < n_grp * ncol; i += kThreads) {
        const int r0 = (i >> ncol_shift) * R, c = (i & (ncol - 1)) * 4;
        float4 o[R];
#pragma unroll
        for (int e = 0; e < R; ++e) {
          const int r = min(r0 + e, kg - 1);
          const float cr = c_s[r];
          o[e] = acc_s[r * ncol + c / 4];
          o[e].x *= cr;
          o[e].y *= cr;
          o[e].z *= cr;
          o[e].w *= cr;
        }
        for (int j = 0; j < cnt4; j += 4) {
          float4 v4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v4[u] = *reinterpret_cast<const float4*>(vd + (j + u) * d + c);
#pragma unroll
          for (int e = 0; e < R; ++e) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                p_s + min(r0 + e, kg - 1) * tp + j);
            const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              o[e].x = fmaf(pu[u], v4[u].x, o[e].x);
              o[e].y = fmaf(pu[u], v4[u].y, o[e].y);
              o[e].z = fmaf(pu[u], v4[u].z, o[e].z);
              o[e].w = fmaf(pu[u], v4[u].w, o[e].w);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < R; ++e)
          if (r0 + e < kg) acc_s[(r0 + e) * ncol + c / 4] = o[e];
      }
    }
    cur_ks = next_ks;
    cur_vs = next_vs;
    __syncthreads();
  }

  if (a.splits == 1) {   // the only split: write O
    for (int i = tid; i < kg * ncol; i += kThreads) {
      const int r = i >> ncol_shift, c = (i & (ncol - 1)) * 4;
      store4(out + out_off(r) + c, acc_s[i], 1.f / fmaxf(l_s[r], 1e-30f));
    }
    return;
  }

  // this split's partial
  const int64_t part0 = ((int64_t)pair * a.splits + s) * kg;
  for (int r = tid; r < kg; r += kThreads)
    a.part_ml[part0 + r] = n_tiles > 0 ? make_float2(m_s[r], l_s[r])
                                       : make_float2(kNegInf, 0.f);
  if (n_tiles > 0)
    for (int i = tid; i < kg * ncol; i += kThreads)
      reinterpret_cast<float4*>(a.part_acc + part0 * d)[i] = acc_s[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) flag_s[0] = atomicAdd(a.counters + pair, 1) == a.splits - 1;
  __syncthreads();
  if (!flag_s[0]) return;
  __threadfence();

  // the last block of this (sequence, kv head): combine every split
  float2* ml_s = reinterpret_cast<float2*>(smem);   // (splits, kg)
  float* w_s = reinterpret_cast<float*>(ml_s + kMaxSplits * kg);
  float* lsum_s = w_s + kMaxSplits * kg;
  const int64_t base = (int64_t)pair * a.splits * kg;
  for (int i = tid; i < a.splits * kg; i += kThreads)
    ml_s[i] = __ldcg(a.part_ml + base + i);
  __syncthreads();
  for (int r = tid; r < kg; r += kThreads) {
    float mx = kNegInf;
    for (int sp = 0; sp < a.splits; ++sp) mx = fmaxf(mx, ml_s[sp * kg + r].x);
    float lsum = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) {
      const float2 ml = ml_s[sp * kg + r];
      const float w = ml.y > 0.f ? expf(ml.x - mx) : 0.f;
      w_s[sp * kg + r] = w;
      lsum += ml.y * w;
    }
    lsum_s[r] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  const float4* acc_g = reinterpret_cast<const float4*>(a.part_acc + base * d);
  for (int i = tid; i < kg * ncol; i += kThreads) {
    const int r = i >> ncol_shift, c = (i & (ncol - 1)) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < a.splits; ++sp) {
      // an empty split's accumulator was never written: its weight is 0
      // and its (loaded) value unused
      const float w = w_s[sp * kg + r];
      const float4 x = __ldcg(acc_g + (int64_t)sp * kg * ncol + i);
      if (w != 0.f) {
        o.x = fmaf(w, x.x, o.x);
        o.y = fmaf(w, x.y, o.y);
        o.z = fmaf(w, x.z, o.z);
        o.w = fmaf(w, x.w, o.w);
      }
    }
    store4(out + out_off(r) + c, o, 1.f / lsum_s[r]);
  }
  if (tid == 0) a.counters[pair] = 0;
}

template <typename QT, typename PT>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const Smem<PT> L{a.rows * (a.hq / a.hkv), a.d, tile_positions(a.d)};
  const size_t smem = L.total();
  auto kernel = L.kg <= 32 ? paged_attention_split_kernel<QT, PT, 2>
                           : paged_attention_split_kernel<QT, PT, 4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.hkv, b), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace split
