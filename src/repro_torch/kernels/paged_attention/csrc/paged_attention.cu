// Paged attention (GQA, 1 or k query rows per sequence) for Hopper.
//
// Replaces the TPU kernel `paged_attention_pallas` (body `_paged_kernel`)
// of src/repro/kernels/paged_attention/paged_attention.py. Same function:
// K and V live in a page pool shared by two tiers -- a float pool (fast
// pages) and an int8 pool with one scale per (token, kv head) row (slow
// pages) -- and each is read as `float + int8 * scale`, which is exact on
// either tier because the other tier's cell holds zeros. A (b, slots) page
// table names each sequence's pages; pools are flat (P, T, hkv, d) or
// layer-stacked (L, P, T, hkv, d) with the layer index as an argument.
// q is (b, k, hq, d): k consecutive query rows per sequence, row j seeing
// lengths[b] + j positions (k = 1 is plain decode). The softmax is fp32
// online softmax: masked scores are -1e30 and the normaliser is clamped
// at 1e-30, as in the reference. Table entries past the page holding a
// row's last position are never read. Element offsets are 64-bit.
//
// Three routes, chosen by the wrapper (`route(q_dtype, rows, d)`, rows =
// k * g query rows per kv head) from static shapes alone:
// - "split" (paged_split.cuh): k * g <= 64, any dtype, d = 16, 32, 64,
//   128 or 256. Bound by bytes; splits the positions over blocks and
//   combines the splits in the same launch.
// - "wgmma" (this file): bf16 q, k * g > 64, d = 64, 128 or 256. The
//   chunk-fill steps (k = 128 at g = 9: 1152 rows per kv head).
// - "simt" (paged_simt.cuh): the first port, unchanged, for the rest
//   (fp32 q at k * g > 64, other head dims).
//
// The wgmma route.
// Bound. At k = 128 a call does 4 * k * g flops per dequantized K/V
// element: 10.6 GFLOP against 22 MB at starcoder2-7b's shapes, above the
// card's ratio, so it is bound by operations. The function's products are
// fp32; the tensor cores take bf16.
//
// Numbers. The card holds the kernel to its plain version at 2 ulps of
// |want| in bf16 + 1e-6 per element. The float tier of K and V is fp32 and
// P is fp32, so each goes through the tensor cores as three bf16 pieces
// (hi + mid + lo, each the rounding of what the ones before left: fp32's
// 24 significant bits). The int8 tier is exact in bf16; its scale, one per
// position, multiplies S's columns (K) and P's columns (V) in fp32:
//   S = ks * (Q Kq^T) + Q Khi^T + Q Kmid^T + Q Klo^T
//   O += sum_{i + j <= 2} P_i V_j + sum_i (P * vs)_i Vq
// 13 bf16 products for the function's 2 (cross terms below 2^-16 of the
// hi product are dropped). The CPU emulation of this arithmetic
// (tests/test_torch_paged_attention.py) meets the limit; two pieces each
// do not, and K or P in one piece is far over it. A tile whose float
// part (K or V) is zero throughout skips that part's products, and one
// whose int8 part is zero skips those: on a page of one tier, 9 (float)
// or 4 (int8) products. The skipped products would add exact zeros, so
// the result is the same to the bit; both tiers are still read. S is
// scaled after the product (Q stays exact), the plain version scales q
// before it: at d = 128 the two round s apart by about |s| 2^-24, which
// the limit's 1e-6 floor notices where outputs cancel on data several
// times the spec inputs' magnitude (tools/paged_variants.py).
//
// Design.
// - Work split. One block of two warpgroups (256 threads) per (128 query
//   rows, kv head, sequence); warpgroup c owns rows 64 c .. 64 c + 63 of
//   the block (row r = j * g + gi: the k rows folded with the g query
//   heads). Row blocks of one (sequence, kv head) are neighbours in launch
//   order, so the K/V they all read come from L2 after the first.
// - Loads. Q once, by 16-byte loads into the 128-byte-swizzled K-major
//   layout wgmma reads. Tiles of kBN positions (64; 16 at d = 256, for
//   shared memory) walk the sequence's pages only up to the last position
//   the block's last row sees: the float tier by cp.async, 16 bytes a
//   copy, into a raw staging tile issued two tiles ahead; the int8 tier
//   straight into registers, one tile ahead. Every thread then converts
//   its share of the tile into the bf16 operand tiles (K and V: hi, mid,
//   lo and the int8 tile, each swizzled as TMA would) and the scales.
// - Math, per tile and warpgroup: S by SS wgmma (Q and K from shared
//   memory, n = kBN); the scale times log2(e) in fp32 after the products;
//   online softmax in exp2 on the accumulator fragments (ex2.approx,
//   masked p = 0); O corrected in registers; P and P * vs cut into three
//   bf16 pieces as A fragments (the accumulator's layout is the A
//   operand's); O += by RS wgmma with V an MN-major operand, n = d.
// - Epilogue. O / max(l, 1e-30) rounded to bf16, stored from registers.
//
// ptxas (sm_90a, nvcc 12.9; registers a thread): wgmma 232-253 at d = 64,
// 128, 256; split 110-113; no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "paged_simt.cuh"
#include "paged_split.cuh"

namespace tc {

using namespace hopper;

constexpr int kBM = 128;                 // query rows per block
constexpr int kThreads = 256;            // two warpgroups of 64 rows
constexpr int kRow = 128;                // bytes of one swizzled row: 64 bf16
constexpr int kPieces = 3;               // bf16 pieces of an fp32 operand
constexpr float kNegInf = -1e30f;

template <int D, typename PT>
struct Tile {
  static constexpr int kBN = D <= 128 ? 64 : 16;      // positions per tile
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kPiece = kBN * D * 2;          // one bf16 operand tile
  static constexpr int kOps = kPieces + 1;            // pieces, then int8
  static constexpr int kRaw = kBN * D * (int)sizeof(PT);  // float tier tile
  // 8-wide column groups of one tile a thread converts, per tensor
  static constexpr int kGroups = kBN * D / 8 / kThreads;
  // 1024 bytes of slack align the tiles to the swizzle's 1024-byte atom;
  // Q | K operand tiles | V operand tiles | raw K | raw V | K, V scales |
  // two words of tier flags
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kOps * kPiece + 2 * kRaw + 2 * kBN * 4 + 8;
  static_assert(kBN * D / 8 % kThreads == 0, "groups per thread");
};

struct Args {
  const __nv_bfloat16* q;
  const void* k_pages;
  const void* v_pages;
  const int8_t* k_quant;
  const int8_t* v_quant;
  const void* k_scale;
  const void* v_scale;
  const int32_t* page_table;
  const int32_t* lengths;
  __nv_bfloat16* out;
  int rows;          // k: query rows per sequence
  int hq, hkv;
  int64_t pages;     // pages per layer (P)
  int t;             // tokens per page (T)
  int slots;         // page-table width
  int64_t layer;     // 0 for flat pools
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 values of a raw tile (16-byte aligned) as fp32; 0 unless `ok`
__device__ __forceinline__ void load8(const float* p, bool ok,
                                      float (&x)[8]) {
  const float4 a = ok ? reinterpret_cast<const float4*>(p)[0]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 b = ok ? reinterpret_cast<const float4*>(p)[1]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool ok,
                                      float (&x)[8]) {
  const uint4 w = ok ? *reinterpret_cast<const uint4*>(p)
                     : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ws[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_i8(uint32_t w, int k) {
  const float lo = (float)(int8_t)((w >> (16 * k)) & 0xffu);
  const float hi = (float)(int8_t)((w >> (16 * k + 8)) & 0xffu);
  return bits(__floats2bfloat162_rn(lo, hi));
}

// 8 fp32 values as three uint4s of bf16 pieces (hi, mid, lo) and 8 int8
// values (two words) as one uint4 of exact bf16s
__device__ __forceinline__ void split8(const float (&x)[8], uint2 q8,
                                       uint4 (&out)[kPieces + 1]) {
  uint32_t p[kPieces][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split3(x[2 * e], x[2 * e + 1], p[0][e], p[1][e], p[2][e]);
#pragma unroll
  for (int pc = 0; pc < kPieces; ++pc)
    out[pc] = make_uint4(p[pc][0], p[pc][1], p[pc][2], p[pc][3]);
  out[kPieces] = make_uint4(pack_i8(q8.x, 0), pack_i8(q8.x, 1),
                            pack_i8(q8.y, 0), pack_i8(q8.y, 1));
}

template <int D, typename PT>
__global__ void __launch_bounds__(kThreads, 1)
    paged_attention_wgmma_kernel(const Args a) {
  using T = Tile<D, PT>;
  constexpr int BN = T::kBN;
  constexpr int G = T::kGroups;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;
  const uint32_t s_k = s_q + T::kQBytes;           // K: hi, mid, lo, int8
  const uint32_t s_v = s_k + T::kOps * T::kPiece;  // V: the same
  const uint32_t s_rk = s_v + T::kOps * T::kPiece;
  const uint32_t s_rv = s_rk + T::kRaw;
  // generic pointer of a shared address
  auto gp = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  const PT* rk = reinterpret_cast<const PT*>(gp(s_rk));
  const PT* rv = reinterpret_cast<const PT*>(gp(s_rv));
  float* sc_k = reinterpret_cast<float*>(gp(s_rv + T::kRaw));
  float* sc_v = sc_k + BN;
  // per tile parity: which operands of the tile hold a nonzero value
  unsigned* tier_s = reinterpret_cast<unsigned*>(sc_v + BN);
  constexpr unsigned kKf = 1, kKq = 2, kVf = 4, kVq = 8;

  const PT* kf = static_cast<const PT*>(a.k_pages);
  const PT* vf = static_cast<const PT*>(a.v_pages);
  const PT* ks = static_cast<const PT*>(a.k_scale);
  const PT* vs = static_cast<const PT*>(a.v_scale);

  // block -> (row block, kv head, sequence)
  const int g = a.hq / a.hkv;
  const int kg = a.rows * g;
  const int nrb = (kg + kBM - 1) / kBM;
  int id = blockIdx.x;
  const int rb = id % nrb;
  id /= nrb;
  const int h = id % a.hkv;
  const int bi = id / a.hkv;
  const int r0 = rb * kBM;
  const int len = a.lengths[bi];
  // positions the block's last row sees; tiles [0, n_tiles)
  const int end = min(len + (min(r0 + kBM, kg) - 1) / g, a.slots * a.t);
  const int n_tiles = (end + BN - 1) / BN;
  const int tid = threadIdx.x;

  auto pool_row = [&](int p) {
    const int64_t pid = a.page_table[(int64_t)bi * a.slots + p / a.t];
    return ((a.layer * a.pages + pid) * a.t + p % a.t) * a.hkv + h;
  };
  auto q_off = [&](int r) {
    return (((int64_t)bi * a.rows + r / g) * a.hq + (int64_t)h * g + r % g) *
           D;
  };

  // Q rows r0 .. r0 + 127 in 64-wide swizzled boxes; rows past kg are 0
  for (int i = tid; i < kBM * D / 8; i += kThreads) {
    const int r = i / (D / 8), c8 = i % (D / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < kg)
      v = *reinterpret_cast<const uint4*>(a.q + q_off(r0 + r) + c8 * 8);
    *reinterpret_cast<uint4*>(gp(s_q + (c8 / 8) * kBM * kRow + r * kRow +
                                 (((c8 % 8) ^ (r % 8)) << 4))) = v;
  }

  // the float tier of tile t into the raw tiles
  auto issue = [&](int t) {
    const int p0 = t * BN;
    constexpr int per = D * (int)sizeof(PT) / 16;   // copies per row
    for (int i = tid; i < BN * per; i += kThreads) {
      const int j = i / per, cb = i % per;
      if (p0 + j >= end) continue;
      const int64_t off = pool_row(p0 + j) * D;
      cp_async16(s_rk + (j * per + cb) * 16,
                 reinterpret_cast<const uint8_t*>(kf + off) + cb * 16);
      cp_async16(s_rv + (j * per + cb) * 16,
                 reinterpret_cast<const uint8_t*>(vf + off) + cb * 16);
    }
    cp_async_commit();
  };
  // the int8 tier of tile t into registers: group n of this thread is
  // position (tid + n * kThreads) / (D / 8), columns 8 * (.. % (D / 8))
  uint2 k8[G], v8[G];
  auto prefetch8 = [&](int t) {
    const int p0 = t * BN;
#pragma unroll
    for (int n = 0; n < G; ++n) {
      const int i = tid + n * kThreads;
      const int j = i / (D / 8), c8 = i % (D / 8);
      k8[n] = v8[n] = make_uint2(0u, 0u);
      if (p0 + j < end) {
        const int64_t off = pool_row(p0 + j) * D + c8 * 8;
        k8[n] = *reinterpret_cast<const uint2*>(a.k_quant + off);
        v8[n] = *reinterpret_cast<const uint2*>(a.v_quant + off);
      }
    }
  };
  // tile t's operand tiles and scales from the raw tiles and registers;
  // positions past `end` become 0. The tile's tier flags gather which of
  // K's and V's float and int8 parts hold a nonzero value.
  auto convert = [&](int t) {
    const int p0 = t * BN;
    unsigned nz = 0;
#pragma unroll
    for (int n = 0; n < G; ++n) {
      const int i = tid + n * kThreads;
      const int j = i / (D / 8), c8 = i % (D / 8);
      const bool ok = p0 + j < end;
      const uint32_t dst =
          (c8 / 8) * BN * kRow + j * kRow + (((c8 % 8) ^ (j % 8)) << 4);
      float xk[8], xv[8];
      load8(rk + j * D + c8 * 8, ok, xk);
      load8(rv + j * D + c8 * 8, ok, xv);
      uint4 pk[kPieces + 1], pv[kPieces + 1];
      split8(xk, k8[n], pk);
      split8(xv, v8[n], pv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        nz |= (xk[e] != 0.f ? kKf : 0u) | (xv[e] != 0.f ? kVf : 0u);
      nz |= ((k8[n].x | k8[n].y) ? kKq : 0u) | ((v8[n].x | v8[n].y) ? kVq : 0u);
#pragma unroll
      for (int pc = 0; pc <= kPieces; ++pc) {
        *reinterpret_cast<uint4*>(gp(s_k + pc * T::kPiece + dst)) = pk[pc];
        *reinterpret_cast<uint4*>(gp(s_v + pc * T::kPiece + dst)) = pv[pc];
      }
    }
    if (tid < BN) {
      const bool ok = p0 + tid < end;
      const int64_t row = ok ? pool_row(p0 + tid) : 0;
      sc_k[tid] = ok ? to_f32(ks[row]) : 0.f;
      sc_v[tid] = ok ? to_f32(vs[row]) : 0.f;
    }
    nz = __reduce_or_sync(0xffffffffu, nz);
    if (tid % 32 == 0 && nz) atomicOr(&tier_s[t & 1], nz);
    fence_proxy_async();
  };

  if (tid == 0) tier_s[0] = tier_s[1] = 0u;
  issue(0);
  prefetch8(0);
  cp_async_wait<0>();
  __syncthreads();
  convert(0);   // its proxy fence also orders Q's stores before wgmma
  __syncthreads();
  if (n_tiles > 1) {
    issue(1);
    prefetch8(1);
  }

  // warpgroup c owns rows 64 c .. 64 c + 63 of the block
  const int c = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wtid = tid % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  // this thread's rows in the accumulator fragment: row_a and row_a + 8;
  // its columns in each 8-column chunk: col and col + 1
  const int row_a = r0 + 64 * c + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  int lim[2];   // positions each of the two rows sees (0 past kg)
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lim[r] = row_a + 8 * r < kg ? len + (row_a + 8 * r) / g : 0;
  const uint32_t q_rows = s_q + 64 * c * kRow;

  float o[D / 2];  // the 64 x d accumulator fragment: d / 2 a thread
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int p0 = t * BN;
    // S = ks * (Q Kq^T) + Q Khi^T + Q Kmid^T + Q Klo^T, d in steps of 16
    // (32 bytes of a 128-byte row); op kPieces is the int8 tile. A part
    // that is zero throughout the tile (the other tier's page) adds
    // exact zeros: its products are skipped, uniformly per block.
    const unsigned tier = tier_s[t & 1];
    float sc[BN / 2];
    auto s_products = [&](int op, int first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da =
            desc(q_rows + (kk / 4) * kBM * kRow + (kk % 4) * 32, 16, 1024);
        const uint64_t db = desc(s_k + op * T::kPiece + (kk / 4) * BN * kRow +
                                     (kk % 4) * 32,
                                 16, 1024);
        if constexpr (BN == 64)
          wgmma_ss_n64(sc, da, db, !first || kk > 0);
        else
          wgmma_ss_n16(sc, da, db, !first || kk > 0);
      }
    };
    if (tier & kKq) {
      wgmma_fence();
      s_products(kPieces, 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sc[i] = __fmul_rn(sc[i], sc_k[8 * (i / 4) + col + (i & 1)]);
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    }
    if (tier & kKf) {
      wgmma_fence();
#pragma unroll
      for (int pc = kPieces - 1; pc >= 0; --pc) s_products(pc, 0);  // lo first
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
    }

    // scale (log2 domain), mask, online softmax; masked p = 0
    bool ok[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int kp = p0 + 8 * (i / 4) + col + (i & 1);
      ok[i] = kp < lim[(i >> 1) & 1];
      sc[i] = ok[i] ? __fmul_rn(sc[i], a.scale_log2) : kNegInf;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      mx[r] = fmaxf(mx[r], sc[i]);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ok[i] ? ex2(sc[i] - m[r]) : 0.f;
      sum[r] += sc[i];
    }
    // per-thread partial row sums; the quad's are added at the end
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // P and P * vs as A fragments, three bf16 pieces each: k-step kk holds
    // positions 16 kk .. 16 kk + 15, register r the pair sc[8 kk + 2 r],
    // sc[8 kk + 2 r + 1]
    uint32_t pa[kPieces][BN / 16][4], pq[kPieces][BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const int pos = 8 * (i / 4) + col;
        split3(sc[i], sc[i + 1], pa[0][kk][r], pa[1][kk][r], pa[2][kk][r]);
        split3(__fmul_rn(sc[i], sc_v[pos]), __fmul_rn(sc[i + 1], sc_v[pos + 1]),
               pq[0][kk][r], pq[1][kk][r], pq[2][kk][r]);
      }

    // O += sum_{i + j <= 2} P_i V_j + sum_i (P vs)_i Vq: V's rows are
    // positions (the K dimension) with d contiguous, an MN-major operand;
    // its 64-wide atoms of d lie BN rows apart (leading byte offset), its
    // 8-position groups 1024 bytes apart (stride byte offset)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kPieces * (kPieces + 1) / 2 + kPieces; ++n) {
        // (i, j) with i + j <= 2, then (P vs)_i with the int8 tile; the
        // smaller terms first
        constexpr int kI[9] = {2, 1, 0, 1, 0, 0, 2, 1, 0};
        constexpr int kJ[9] = {0, 1, 2, 0, 1, 0, 3, 3, 3};
        if (!(tier & (n < 6 ? kVf : kVq))) continue;
        const uint32_t(&frag)[4] = n < 6 ? pa[kI[n]][kk] : pq[kI[n]][kk];
        const uint64_t db =
            desc(s_v + kJ[n] * T::kPiece + kk * 16 * kRow, BN * kRow, 1024);
        if constexpr (D == 64)
          wgmma_rs_n64(o, frag, db);
        else if constexpr (D == 128)
          wgmma_rs_n128(o, frag, db);
        else
          wgmma_rs_n256(o, frag, db);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);

    // tile t + 1 into the operand tiles once both warpgroups are done with
    // tile t; then the raw tiles take tile t + 2
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) convert(t + 1);
    __syncthreads();
    if (tid == 0) tier_s[t & 1] = 0u;   // read by this tile only
    if (t + 2 < n_tiles) {
      issue(t + 2);
      prefetch8(t + 2);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row_a + 8 * r;
    if (rr >= kg) continue;
    __nv_bfloat16* dst = a.out + q_off(rr) + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(
          o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
  }
}

template <int D, typename PT>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  using T = Tile<D, PT>;
  auto kernel = paged_attention_wgmma_kernel<D, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const int kg = a.rows * (a.hq / a.hkv);
  const int blocks = (kg + kBM - 1) / kBM * a.hkv * b;
  kernel<<<blocks, kThreads, T::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename PT>
cudaError_t launch_d(const Args& a, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<64, PT>(a, b, stream);
    case 128:
      return launch<128, PT>(a, b, stream);
    default:
      return launch<256, PT>(a, b, stream);
  }
}

}  // namespace tc

// error codes of the launches beside cudaError_t's (which are >= 0)
constexpr int kBadHeadDim = -3;
constexpr int kBadSplit = -4;

extern "C" {

// Query rows per block for k * g rows on the simt route: the fewest
// blocks of at most 64 rows, balanced.
int paged_attention_row_block(int kg) {
  const int n_blocks = (kg + simt::kMaxRows - 1) / simt::kMaxRows;
  return (kg + n_blocks - 1) / n_blocks;
}

// The simt route. Launches on `stream` and returns the launch's
// cudaError_t (0 on success). Tensors are contiguous; `q_bf16` /
// `pool_bf16` pick bf16 over fp32 for q and out, and for the float pools
// and scales.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_quant,
                           const void* v_quant, const void* k_scale,
                           const void* v_scale, const void* page_table,
                           const void* lengths, void* out, int b, int rows,
                           int hq, int hkv, int d, long long pages, int t,
                           int slots, long long layer, float scale,
                           int q_bf16, int pool_bf16, void* stream) {
  simt::Args a{q, k_pages, v_pages,
               static_cast<const int8_t*>(k_quant),
               static_cast<const int8_t*>(v_quant),
               k_scale, v_scale,
               static_cast<const int32_t*>(page_table),
               static_cast<const int32_t*>(lengths),
               out, rows, paged_attention_row_block(rows * (hq / hkv)),
               hq, hkv, d, pages, t, slots, layer, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && pool_bf16)
    err = simt::launch<__nv_bfloat16, __nv_bfloat16>(a, b, s);
  else if (q_bf16)
    err = simt::launch<__nv_bfloat16, float>(a, b, s);
  else if (pool_bf16)
    err = simt::launch<float, __nv_bfloat16>(a, b, s);
  else
    err = simt::launch<float, float>(a, b, s);
  return (int)err;
}

// Dynamic shared memory a block of each route takes, in bytes.
int paged_attention_split_smem(int kg, int d, int pool_bf16) {
  const int tp = split::tile_positions(d);
  return (int)(pool_bf16 ? split::Smem<__nv_bfloat16>{kg, d, tp}.total()
                         : split::Smem<float>{kg, d, tp}.total());
}
int paged_attention_wgmma_smem(int d, int pool_bf16) {
  switch (d) {
    case 64:
      return pool_bf16 ? tc::Tile<64, __nv_bfloat16>::kSmem
                       : tc::Tile<64, float>::kSmem;
    case 128:
      return pool_bf16 ? tc::Tile<128, __nv_bfloat16>::kSmem
                       : tc::Tile<128, float>::kSmem;
    case 256:
      return pool_bf16 ? tc::Tile<256, __nv_bfloat16>::kSmem
                       : tc::Tile<256, float>::kSmem;
    default:
      return kBadHeadDim;
  }
}

// The split route: k * g <= 64, d in {16, 32, 64, 128, 256}; `splits`
// blocks of `chunk` positions (a multiple of the tile: 32, 16 at d > 128)
// cover the table's slots * t positions. `part_ml` (b * hkv * splits * k *
// g float2s) and `part_acc` (the same times d floats) are scratch;
// `counters` holds b * hkv ints that are 0, and are 0 again after the
// launch. Pool tensors 16-byte aligned.
int paged_attention_split_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_quant, const void* v_quant, const void* k_scale,
    const void* v_scale, const void* page_table, const void* lengths,
    void* out, void* part_ml, void* part_acc, void* counters, int b,
    int rows, int hq, int hkv, int d, long long pages, int t, int slots,
    long long layer, float scale, int splits, int chunk, int q_bf16,
    int pool_bf16, void* stream) {
  const int tp = split::tile_positions(d);
  if (rows * (hq / hkv) > split::kMaxRows || d < 16 || d > 256 ||
      (d & (d - 1)) ||
      splits < 1 || splits > split::kMaxSplits || chunk % tp ||
      (long long)splits * chunk < (long long)slots * t)
    return kBadSplit;
  split::Args a{q, k_pages, v_pages,
                static_cast<const int8_t*>(k_quant),
                static_cast<const int8_t*>(v_quant),
                k_scale, v_scale,
                static_cast<const int32_t*>(page_table),
                static_cast<const int32_t*>(lengths),
                out, static_cast<float2*>(part_ml),
                static_cast<float*>(part_acc), static_cast<int*>(counters),
                rows, hq, hkv, d, pages, t, slots, layer, scale, splits,
                chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && pool_bf16)
    err = split::launch<__nv_bfloat16, __nv_bfloat16>(a, b, s);
  else if (q_bf16)
    err = split::launch<__nv_bfloat16, float>(a, b, s);
  else if (pool_bf16)
    err = split::launch<float, __nv_bfloat16>(a, b, s);
  else
    err = split::launch<float, float>(a, b, s);
  return (int)err;
}

// The wgmma route: bf16 q and out, d in {64, 128, 256}, k * g > 64
// (fewer rows run, but waste most of a block); q, out and the pools
// 16-byte aligned. `scale_log2` is the softmax scale times log2(e).
int paged_attention_wgmma_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_quant, const void* v_quant, const void* k_scale,
    const void* v_scale, const void* page_table, const void* lengths,
    void* out, int b, int rows, int hq, int hkv, int d, long long pages,
    int t, int slots, long long layer, float scale_log2, int pool_bf16,
    void* stream) {
  if (d != 64 && d != 128 && d != 256) return kBadHeadDim;
  tc::Args a{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
             static_cast<const int8_t*>(k_quant),
             static_cast<const int8_t*>(v_quant),
             k_scale, v_scale,
             static_cast<const int32_t*>(page_table),
             static_cast<const int32_t*>(lengths),
             static_cast<__nv_bfloat16*>(out), rows, hq, hkv, pages, t, slots,
             layer, scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = pool_bf16 ? tc::launch_d<__nv_bfloat16>(a, b, d, s)
                              : tc::launch_d<float>(a, b, d, s);
  return (int)err;
}

const char* paged_attention_error_string(int err) {
  switch (err) {
    case kBadHeadDim:
      return "the wgmma route takes head dims 64, 128 and 256";
    case kBadSplit:
      return "the split route takes k * g <= 64 rows, d in {16, 32, 64, "
             "128, 256} and a split plan that covers the table";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
