// Blocked online-softmax attention (GQA, causal / sliding window) for Hopper.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_flash_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py. Same function:
// q (b, sq, hq, d) and k, v (b, skv, hkv, d) give out (b, sq, hq, d), query
// head h attending kv head h / g (g = hq / hkv). With `causal`, key position
// kp is visible to query position qp when kp <= qp; with `window` > 0, when
// kp > qp - window (positions aligned at 0). Scores, probabilities and sums
// are fp32 as in the Pallas kernel; masked scores are -1e30 and the
// normaliser is clamped at 1e-30. Any sq and skv are taken: ragged tiles are
// masked here, so prompts need no padding.
//
// Two routes, chosen by the wrapper from the dtype and the head dim alone:
// "wgmma" (this file) for bf16 at d = 64, 128 and 256; "simt"
// (flash_simt.cuh) for fp32 inputs, whose 5e-5 tolerance the tensor cores
// cannot meet, and for any other d.
//
// Bound. Prefill attention does 4 d flops per visible (query, key) pair and
// moves q, k, v and out once. At starcoder2-7b's causal prefill (s = 2048,
// 36 heads, d = 128) that is 38.7 GFLOP against 21 MB, far above the card's
// 295 flops per byte, so the least time is the flops over the bf16 tensor
// cores' 989 TFLOP/s: 0.039 ms. What keeps a kernel from it is feeding the
// tensor cores: loads that do not overlap the math, and the softmax's
// exponentials and shuffles between the two products.
//
// Design of the wgmma route:
// - Work split. One block of BM / 64 warpgroups per (BM query positions,
//   query head, sequence); warpgroup c owns rows 64 c .. 64 c + 63. BM and
//   the key tile BN are template parameters, the launch shape the wrapper
//   picks (`block_q`, `block_k`): BM = 64 or 128, BN = 64 or 128, every
//   pair whose shared memory fits a block (not BN = 128 at d = 256). The
//   first design's launch, BM = 128 with two warpgroups and BN = 128 (64
//   at d = 256), is one of them. Block ids run over the heads fastest, so the g heads of one kv head
//   are neighbours and read its K/V tiles from L2; then over the sequences;
//   then over the query blocks, last first, so that under a causal mask the
//   longest blocks start first and the grid's tail is short.
// - Loads. TMA, into a ring of 2 stages of key tiles in shared memory:
//   BN = 128 keys at d <= 128 (Q 32 KB + 2 x 64 KB), 64 keys at d = 256
//   (Q 64 KB + 2 x 64 KB); a third stage, or 64-key tiles at d = 128,
//   measured no faster on the card. Per stage a K and a V barrier that the
//   TMA completes, so S = Q K^T starts before V has landed. Thread 0 loads
//   Q and the first stages; after that the warpgroup that releases a stage
//   last (a count per stage in shared memory) loads the tile kStages ahead
//   into it. The tensor maps are 4-D over the contiguous (b, s, h, d)
//   tensors with the 128-byte swizzle, whose box is at most 64 bf16 wide:
//   a row of d is d / 64 boxes, and every wgmma descriptor uses the same
//   swizzle. TMA fills rows past sq and skv with zeros; such keys are
//   masked all the same, and no output row >= sq is written.
// - Why no producer warp. FlashAttention-3 gives one warpgroup to the
//   loads and moves registers to the consumers with setmaxnreg. ptxas
//   (CUDA 12.9) compiled that 384-thread layout at the launch bound's 168
//   registers a thread whatever setmaxnreg asked, spilled 112-256 bytes of
//   stack at d = 128 and 256 and serialised the wgmmas: 17% slower at
//   starcoder2-7b's s = 2048, 90% at recurrentgemma-2b's d = 256. A single
//   producer warp (9 warps, 3 on one of the SM's four register files) gets
//   168 as well (tools/flash_variants.py). With 8 warps a thread may hold
//   255 registers, and the loads cost one thread a few instructions per
//   tile.
// - Math, per key tile and warpgroup: S = Q K^T by wgmma with both operands
//   in shared memory (bf16 products, fp32 sums); the softmax scale times
//   log2(e) applied in fp32 after the product, for exp2; masking only on
//   tiles that cross the diagonal, the window's edge or skv (tiles that no
//   row of the block can see are never loaded); the row max and sum by
//   quad shuffles on the accumulator fragment, O corrected in registers;
//   then O += P V by wgmma with P from registers (the accumulator's layout
//   is the A operand's) and V read as a transposed, MN-major operand, n =
//   d per product. exp2 is the special-function unit's ex2.approx (3-6%
//   faster than exp2f). The two warpgroups run unsynchronised
//   but for the loads, so one's softmax overlaps the other's products.
// - Epilogue. O / max(l, 1e-30) in fp32, rounded to bf16, stored from
//   registers.
//
// Why P is split. The function keeps P in fp32 (the TPU kernel and the
// plain version do), and the card holds this kernel to the plain version at
// 2 ulps of |want| in bf16 + 1e-6 per element. Rounding P to bf16 once
// before P V, as the JAX model's attention_core does, misses that limit
// 180-710 fold; two bf16 pieces, hi + lo (16 significant bits), still miss
// it 1.16-1.24 fold at s = 600 with g = 10 and at d = 256 with a window,
// where outputs near 0 are held to about 1e-6 (CPU emulations of this
// kernel's arithmetic in tests/test_torch_flash_attention.py). So
// P = hi + mid + lo, three bf16 pieces with fp32's 24 significant bits, and
// P V is three products into one fp32 accumulator: the kernel does 8 d
// flops per visible pair on the tensor cores, twice the function's.
//
// ptxas (sm_90a, nvcc 12.9; registers a thread): d = 64 243, d = 128 244,
// d = 256 230, no spills; the simt kernels 64 (fp32 and bf16).

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_simt.cuh"
#include "hopper.cuh"

namespace wg {

constexpr int kStages = 2;                // depth of the K/V ring
constexpr int kRow = 128;                 // bytes of one swizzled row: 64 bf16
constexpr float kNegInf = -1e30f;

// error codes of the launch beside cudaError_t's (which are >= 0)
constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -2;
constexpr int kBadHeadDim = -3;
constexpr int kBadTile = -4;

// BM query positions per block (BM / 64 consumer warpgroups), BN keys per
// tile of the K/V ring
template <int D, int BM, int BN>
struct Tile {
  static_assert(BM == 64 || BM == 128, "block_q");
  static_assert(BN == 64 || BN == 128, "block_k");
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kConsumers = BM / 64;          // warpgroups
  static constexpr int kThreads = 128 * kConsumers;
  static constexpr int kBoxes = D / 64;               // 64-wide boxes per row
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;        // one K or one V tile
  // barriers: Q, then K and V per stage; then a release count per stage
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages) + 4 * kStages;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte atom
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  static constexpr bool kFits = kSmem <= 232448;      // 227 KB a block
};

struct Params {
  __nv_bfloat16* out;
  int b, sq, skv, hq, hkv;
  int causal, window;
  float scale_log2;  // softmax scale * log2(e)
};

using namespace hopper;

template <int D, int BM, int BN>
__global__ void __launch_bounds__(Tile<D, BM, BN>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  using T = Tile<D, BM, BN>;
  constexpr int kBM = T::kBM;
  constexpr int kConsumers = T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;
  const uint32_t s_k = s_q + T::kQBytes;             // kStages K tiles
  const uint32_t s_v = s_k + kStages * T::kKVBytes;  // kStages V tiles
  const uint32_t s_bar = s_v + kStages * T::kKVBytes;
  const uint32_t bar_q = s_bar;
  auto bar_k = [=](int s) { return s_bar + 8u * (1 + s); };
  auto bar_v = [=](int s) { return s_bar + 8u * (1 + kStages + s); };
  // per stage, how many times a warpgroup has released it
  uint32_t* released = reinterpret_cast<uint32_t*>(
      smem_raw + (s_bar - raw) + 8 * (1 + 2 * kStages));

  // block -> (query block, query head, sequence)
  const int nqb = (p.sq + kBM - 1) / kBM;
  int id = blockIdx.x;
  const int h = id % p.hq;
  id /= p.hq;
  const int bi = id % p.b;
  const int q0 = (nqb - 1 - id / p.b) * kBM;
  const int kvh = h / (p.hq / p.hkv);
  // the key tiles any row of the block can see: [t0, t0 + n_tiles)
  const int q_end = min(q0 + kBM, p.sq);
  int k_lo = 0, k_hi = p.skv;
  if (p.causal) k_hi = min(p.skv, q_end);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t0 = k_lo / BN;
  const int n_tiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - t0 : 0;

  // key tile t into stage t % kStages: its K and its V, each completing
  // its own barrier, so that S = Q K^T can start before V has landed
  auto load_tile = [&](int t) {
    const int st = t % kStages;
    const int k0 = (t0 + t) * BN;
    mbar_expect_tx(bar_k(st), T::kKVBytes);
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load(s_k + st * T::kKVBytes + j * BN * kRow, &tk, bar_k(st), 64 * j,
               kvh, k0, bi);
    mbar_expect_tx(bar_v(st), T::kKVBytes);
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load(s_v + st * T::kKVBytes + j * BN * kRow, &tv, bar_v(st), 64 * j,
               kvh, k0, bi);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, T::kQBytes);
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load(s_q + j * kBM * kRow, &tq, bar_q, 64 * j, h, q0, bi);
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_tile(t);
  }
  __syncthreads();

  // warpgroup c owns query rows 64 c .. 64 c + 63 of the block
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  // this thread's query positions in the accumulator fragment: row0 and
  // row0 + 8; its columns in each 8-column chunk: col and col + 1
  const int row0 = q0 + 64 * c + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const int wq_lo = q0 + 64 * c, wq_hi = wq_lo + 63;
  const uint32_t q_rows = s_q + 64 * c * kRow;

  float o[D / 2];  // the 64 x d accumulator fragment: d / 2 a thread
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = (t0 + t) * BN;
    const uint32_t k_tile = s_k + s * T::kKVBytes;
    const uint32_t v_tile = s_v + s * T::kKVBytes;

    // S = Q K^T over d in steps of 16 (32 bytes of a 128-byte row)
    float sc[BN / 2];
    mbar_wait(bar_k(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da =
          desc(q_rows + (kk / 4) * kBM * kRow + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          desc(k_tile + (kk / 4) * BN * kRow + (kk % 4) * 32, 16, 1024);
      if constexpr (BN == 128)
        wgmma_ss_n128(sc, da, db, kk);
      else
        wgmma_ss_n64(sc, da, db, kk);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // scale (log2 domain), mask, online softmax
    const bool masked = k0 + BN > p.skv || (p.causal && k0 + BN - 1 > wq_lo) ||
                        (p.window > 0 && k0 <= wq_hi - p.window);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float x = __fmul_rn(sc[i], p.scale_log2);
      if (masked) {
        const int kp = k0 + 8 * (i / 4) + col + (i & 1);
        const int qp = row0 + 8 * ((i >> 1) & 1);
        if (kp >= p.skv || (p.causal && kp > qp) ||
            (p.window > 0 && kp <= qp - p.window))
          x = kNegInf;
      }
      sc[i] = x;
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
      sc[i] = ex2(sc[i] - m[r]);
      sum[r] += sc[i];
    }
    // per-thread partial row sums; the quad's are added at the end
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // P as A fragments, three bf16 pieces: k-step kk holds keys 16 kk ..
    // 16 kk + 15, register r the pair sc[8 kk + 2 r], sc[8 kk + 2 r + 1]
    uint32_t pa[3][BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], pa[0][kk][r],
               pa[1][kk][r], pa[2][kk][r]);

    // O += P V: V's rows are keys (the K dimension) with d contiguous, an
    // MN-major operand. One n = d product per 16 keys and piece: the
    // descriptor's 64-wide swizzle atoms of d lie BN rows apart (leading
    // byte offset), its 8-key groups 1024 bytes apart (stride byte offset).
    mbar_wait(bar_v(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t db = desc(v_tile + kk * 16 * kRow, BN * kRow, 1024);
#pragma unroll
      for (int piece = 0; piece < 3; ++piece) {
        if constexpr (D == 64)
          wgmma_rs_n64(o, pa[piece][kk], db);
        else if constexpr (D == 128)
          wgmma_rs_n128(o, pa[piece][kk], db);
        else
          wgmma_rs_n256(o, pa[piece][kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);

    // the stage is free once both warpgroups are done with it: the one
    // that releases it last loads tile t + kStages into it
    named_barrier_sync(1 + c, 128);
    if (tid == 0 && atomicAdd(&released[s], 1u) % kConsumers == kConsumers - 1
        && t + kStages < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_tile(t + kStages);
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
    const int qp = row0 + 8 * r;
    if (qp >= p.sq) continue;
    __nv_bfloat16* dst =
        p.out + (((int64_t)bi * p.sq + qp) * p.hq + h) * D + col;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(
          o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
  }
}

// The 4-D map of a contiguous bf16 (batch, seq, heads, d) tensor: a box is
// 64 of d by `rows` positions of one head, 128-byte swizzled.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d,
              int heads, int seq, int batch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)seq * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BM, int BN>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int causal, int window,
           float scale_log2, cudaStream_t stream) {
  using T = Tile<D, BM, BN>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kNoEncoder;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, D, hq, sq, b, BM) ||
      !make_map(enc, &tk, k, D, hkv, skv, b, BN) ||
      !make_map(enc, &tv, v, D, hkv, skv, b, BN))
    return kEncodeFailed;
  const Params p{static_cast<__nv_bfloat16*>(out), b, sq, skv, hq, hkv,
                 causal, window, scale_log2};
  auto kernel = flash_wgmma_kernel<D, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (sq + BM - 1) / BM * hq * b;
  kernel<<<blocks, T::kThreads, T::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// every (block_q, block_k) instance at head dim D whose shared memory fits
template <int D>
int launch_tile(const void* q, const void* k, const void* v, void* out, int b,
                int sq, int skv, int hq, int hkv, int causal, int window,
                float scale_log2, int block_q, int block_k,
                cudaStream_t stream) {
#define FLASH_TILE(BM, BN)                                                  \
  if constexpr (Tile<D, BM, BN>::kFits) {                                   \
    if (block_q == BM && block_k == BN)                                     \
      return launch<D, BM, BN>(q, k, v, out, b, sq, skv, hq, hkv, causal,   \
                               window, scale_log2, stream);                 \
  }
  FLASH_TILE(64, 64)
  FLASH_TILE(64, 128)
  FLASH_TILE(128, 64)
  FLASH_TILE(128, 128)
#undef FLASH_TILE
  return kBadTile;
}

}  // namespace wg

extern "C" {

// The simt route. Launches on `stream` and returns the launch's cudaError_t
// (0 on success). q, k, v and out are contiguous and share one dtype: bf16
// if `bf16`, else fp32. sq, skv >= 1; hq is a multiple of hkv; d <= 256.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int b, int sq, int skv, int hq, int hkv,
                           int d, int causal, int window, float scale,
                           int bf16, void* stream) {
  simt::Args a{q, k, v, out, sq, skv, hq, hkv, d,
               simt::block_q(hq / hkv), causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? simt::launch<__nv_bfloat16>(a, b, s)
                         : simt::launch<float>(a, b, s);
  return (int)err;
}

// The wgmma route: bf16 q, k, v and out, contiguous, 16-byte aligned;
// d in {64, 128, 256}; `scale_log2` is the softmax scale times log2(e);
// `block_q` query positions (64 or 128) and `block_k` keys (64 or 128) a
// tile, a pair whose shared memory fits (`flash_attention_wgmma_smem`).
// Returns 0, a cudaError_t, or one of wg's negative codes.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* out, int b, int sq, int skv, int hq,
                                 int hkv, int d, int causal, int window,
                                 float scale_log2, int block_q, int block_k,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return wg::launch_tile<64>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                 window, scale_log2, block_q, block_k, s);
    case 128:
      return wg::launch_tile<128>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                  window, scale_log2, block_q, block_k, s);
    case 256:
      return wg::launch_tile<256>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                  window, scale_log2, block_q, block_k, s);
    default:
      return wg::kBadHeadDim;
  }
}

// Dynamic shared memory of a wgmma block at head dim d and the tile, or
// -1 where no instance is built (the tile does not fit a block).
int flash_attention_wgmma_smem(int d, int block_q, int block_k) {
#define FLASH_SMEM(D, BM, BN)                                  \
  if (d == D && block_q == BM && block_k == BN)                \
    return wg::Tile<D, BM, BN>::kFits ? wg::Tile<D, BM, BN>::kSmem : -1;
#define FLASH_SMEM_D(D) \
  FLASH_SMEM(D, 64, 64) FLASH_SMEM(D, 64, 128) FLASH_SMEM(D, 128, 64) \
  FLASH_SMEM(D, 128, 128)
  FLASH_SMEM_D(64)
  FLASH_SMEM_D(128)
  FLASH_SMEM_D(256)
#undef FLASH_SMEM_D
#undef FLASH_SMEM
  return -1;
}

const char* flash_attention_error_string(int err) {
  switch (err) {
    case wg::kNoEncoder:
      return "the driver has no cuTensorMapEncodeTiled";
    case wg::kEncodeFailed:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case wg::kBadHeadDim:
      return "the wgmma route takes head dims 64, 128 and 256";
    case wg::kBadTile:
      return "no wgmma instance at this (block_q, block_k): 64 or 128 each, "
             "within 227 KB of shared memory";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
