// Mamba2 SSD (state-space duality) chunked scan for Hopper.
//
// Replaces the TPU kernel `ssd_scan_pallas` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_scan/ssd_scan.py. Same function, as the chunked form
// `ssd_chunked` of src/repro/models/ssm.py computes it: x (B, S, H, P), B and
// C (B, S, G, N), dt (B, S, H) post-softplus and a (H,) < 0 give
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t,   y_t = h_t . C_t
//
// with y (B, S, H, P) fp32 and, unlike the Pallas kernel, the final state
// h_S (B, H, P, N) fp32 as well, which prefill hands to decode. Head h reads
// group h / (H / G) of B and C. dt and a are fp32; all sums are fp32.
//
// Two routes, chosen by the wrapper from static shapes alone
// (`route(dtype, S, P, N, G)`):
// - "wgmma" (this file): bf16 x, B, C (as mamba2's prefill passes them), P =
//   64, N = 64 or 128, any S >= 1 and any G dividing H.
// - "simt" (ssd_simt.cuh): the first port, unchanged, for fp32 inputs and
//   every other shape (the spec's small cases: P = 8-32, N = 8 or 16).
//
// The wgmma route: the chunked decomposition itself, chunk-parallel across
// the sequence; only the small state pass runs in order. Chunks of Q
// positions, a template parameter the launch picks (`chunk`: 128, the
// default kChunk, or 64; chip_smoke.py's kernel phase times both); the
// last chunk may be short and is masked (rows past S load as zeros). Three
// launches on one stream, per call:
//   1. Chunk states, one block (one warpgroup) per (head, chunk, sequence):
//      cum_j = sum_{i <= j} dt_i a by a warp scan, w_j = exp(cum_last -
//      cum_j) dt_j, and state_c (P x N) = (w . x)^T B on the tensor cores:
//      A = (w . x)^T from registers (fp32, split into bf16 pieces), B the
//      chunk's B rows in shared memory as an MN-major operand. It writes
//      state_c and exp(cum_last) to scratch.
//   2. State pass, one thread per 4 state elements of a (head, sequence):
//      h_c = exp(cum_last,c) h_{c-1} + state_c in fp32 FMAs over the chunks,
//      8 chunks' loads in flight, in place: chunk c's slot becomes the
//      state entering chunk c; the last h is the final state.
//   3. Chunk scan, one block of Q / 64 warpgroups per (head, chunk,
//      sequence), warpgroup w owning rows 64 w .. 64 w + 63: C B^T (Q x Q)
//      on the tensor cores (bf16 x bf16, exact products); then h_prev, in
//      registers since the block began, as bf16 pieces into B's tile (free
//      once every warpgroup is past C B^T), y = C . h_prev^T on the tensor
//      cores and its rows times exp(cum_i); then the scores s_ij =
//      (C B^T)_ij exp(cum_i - cum_j) dt_j (j <= i, else 0), split into bf16
//      pieces as A fragments (the accumulator's layout is the A operand's),
//      and y += s . x on the tensor cores with x an MN-major operand (exact
//      in bf16). Warpgroup 0 of a 128-chunk skips the k-steps past its
//      diagonal. y is written once, fp32. Every global load of a block is
//      issued before its first wait.
// Sharing B's tile with h_prev's pieces brings the chunk-scan block to 82
// KB of shared memory, two blocks an SM (the launch bound holds ptxas to
// 128 registers, with 232 bytes spilled): 107-114 us against 147 us with a
// tile of its own at one block an SM (B = 3, S = 1536; tools/ssd_variants.py,
// PERF.md). C B^T is recomputed per head: on the tensor cores it is 4.2
// MFLOP per (chunk, head) at Q = 128, N = 128, 7 us of the card's bf16 peak
// over a B = 3, S = 1536 call; sharing it across heads would cost a round
// trip of fp32 score tiles through memory. Every operand tile sits in
// shared memory in one layout: rows of positions (or of P for h_prev),
// 64-column boxes of 128-byte rows with the 128-byte swizzle, loaded by
// cp.async 16 bytes a copy. The same B tile is a K-major operand of C B^T
// and an MN-major operand of the chunk state; only the descriptor differs.
//
// Numbers. The card holds the kernel to the plain version (`ref.ssd_chunked`,
// chunks of 256) with `chip_smoke.ssd_limit`: 256 * 2^-23 * sqrt(S) *
// max |want| per output tensor. B, C and x are exact in bf16; the fp32
// operands -- the scores, w . x and h_prev -- go through the tensor cores
// as kPieces = 2 bf16 pieces each (16 significant bits; 3 pieces measured
// 8-25% slower for no gain the limit can see). The CPU emulation of this
// arithmetic (chip_smoke.ssd_wgmma_loop, tests/test_torch_ssd_scan.py)
// stays within a few hundredths of the limit at S up to 1536; the scores
// or w . x in one piece go 1.6-3.6x over it, h_prev in one piece stays
// inside it (0.3-0.8).
//
// Bound. The function (chip_smoke.ssd_bytes_and_flops, the yardstick both
// routes share) moves about 93 MB at B = 3, S = 1536, H = 48, P = 64, N = 128
// (bf16 inputs, fp32 y and final state): 0.028 ms at 3.35 TB/s; its 0.120 ms
// bound counts the products outside C B^T at the fp32 rate. This route does
// them on the bf16 tensor cores (27 GFLOP issued, pieces included: 0.027 ms
// at 989 TFLOP/s), so what bounds it is memory: the chunk states (B * S / Q
// * H * P * N fp32, 57 MB at Q = 128) are written, read and written by the
// state pass, and read again, about 226 MB beside the function's 93, plus x
// read twice: about 0.10 ms at 3.35 TB/s. The route takes about 0.215 ms
// there (chunk states 45 us, state pass 53, chunk scan 107-114). What
// still holds it back: that traffic; the chunk scan's phases, which do not
// overlap within a block (loads, then C B^T, then h_prev's pieces, then two
// products); and the state pass at 2.1 TB/s. A look-back that folds the
// state pass into the chunk-state kernel (each chunk waiting for the one
// before it) was slower: the waiting blocks hold the SMs, and the chunk
// states then run one chunk level at a time.
//
// ptxas (sm_90a, nvcc 12.9; registers a thread, at Q = 128, N = 128, 2
// pieces): chunk states 154, state pass 56, chunk scan 128 (232 bytes
// spilled); all of them in build/kernels/ssd_scan.log, printed by
// chip_smoke.py's device phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_simt.cuh"

namespace tc {

using namespace hopper;

constexpr int kP = 64;         // head dim the route takes: one warpgroup's rows
constexpr int kRow = 128;      // bytes of one swizzled row: 64 bf16
constexpr int kChunk = 128;    // the default chunk (the first design's)
constexpr int kChunks[] = {64, 128};  // the chunks a launch may take
constexpr int kPieces = 2;     // bf16 pieces of an fp32 operand (3 also builds)

// error codes of the launch beside cudaError_t's (which are >= 0)
constexpr int kBadShape = -1;

template <int Q, int N, int Pieces>
struct Cfg {
  static_assert(Q == 64 || Q == 128, "chunk");
  static_assert(N == 64 || N == 128, "state size");
  static constexpr int kScanThreads = 128 * (Q / 64);   // chunk-scan block
  static constexpr int kTileX = Q * kP * 2;             // x: Q x 64 bf16
  static constexpr int kTileQN = Q * N * 2;             // B or C: Q x N bf16
  static constexpr int kPiece = kP * N * 2;             // h_prev piece: 64 x N
  // h_prev's pieces take B's tile once C B^T is done with it, where they fit
  static constexpr bool kAlias = Pieces * kP <= Q;
  // 1024 bytes of slack align the tiles to the swizzle's 1024-byte atom;
  // chunk states: x | B | dt, cum, w
  static constexpr int kSmemState = 1024 + kTileX + kTileQN + 3 * Q * 4;
  // chunk scan: C | B (then h_prev's pieces) | x | [h_prev's pieces] | dt,
  // cum
  static constexpr int kSmemScan = 1024 + 2 * kTileQN + kTileX +
                                   (kAlias ? 0 : Pieces * kPiece) + 2 * Q * 4;
  // chunk-scan blocks an SM should hold: two where the alias brings the
  // shared memory under half the SM's, so that one block's loads overlap
  // the other's products (the launch bound holds ptxas to 128 registers)
  static constexpr int kScanBlocks = kAlias ? 2 : 1;
};

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  const float* dt;
  const float* a;
  float* y;
  float* state;    // final state (B, H, P, N)
  float* states;   // scratch (B, nc, H, P, N): chunk states, then h_prev
  float* decay;    // scratch (B, nc, H): exp(cum_last) of each chunk
  int S, H, G, nc;
};

// Byte offset of (row r, 8-column group g) in a tile of R rows whose
// columns run in 64-wide boxes of R swizzled 128-byte rows.
template <int R>
__device__ __forceinline__ uint32_t tile_off(int r, int g) {
  return (g / 8) * R * kRow + r * kRow + (((g % 8) ^ (r % 8)) << 4);
}

// Rows [0, R) of a row-major bf16 matrix (`cols` wide, row stride `ld`
// elements) into the tile at `dst`, by cp.async; rows >= `valid` are zeros.
template <int R, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, uint8_t* dst_gen,
                                          const __nv_bfloat16* src, int64_t ld,
                                          int valid, int tid) {
  constexpr int kGroups = COLS / 8;
  for (int i = tid; i < R * kGroups; i += THREADS) {
    const int r = i / kGroups, g = i % kGroups;
    const uint32_t off = tile_off<R>(r, g);
    if (r < valid)
      cp_async16(dst + off, src + r * ld + g * 8);
    else
      *reinterpret_cast<uint4*>(dst_gen + off) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The dt of position s0 + j for head h (0 past the sequence, j < q).
__device__ __forceinline__ float load_dt(const Args& a, int bi, int h,
                                         int s0, int q, int j) {
  return j < q ? a.dt[((int64_t)bi * a.S + s0 + j) * a.H + h] : 0.f;
}

// cum_s[j] = sum_{i <= j} dt_s[i] a_h by warp 0, once every thread has
// stored its dt_s: each lane sums Q / 32 neighbours, a shuffle scan adds
// the lanes before it. Synchronises the block before and after.
template <int Q>
__device__ __forceinline__ void chunk_cumsum(float a_h, const float* dt_s,
                                             float* cum_s, int tid) {
  __syncthreads();
  if (tid < 32) {
    constexpr int E = Q / 32;
    float v[E], run = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = run = __fadd_rn(run, __fmul_rn(dt_s[tid * E + e], a_h));
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl = __fadd_rn(incl, t);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) cum_s[tid * E + e] = __fadd_rn(excl, v[e]);
  }
  __syncthreads();
}

// 1. state_c = (w . x)^T B for one (head, chunk, sequence); exp(cum_last).
template <int Q, int N, int Pieces>
__global__ void __launch_bounds__(128, 1) ssd_state_kernel(const Args a) {
  using C = Cfg<Q, N, Pieces>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_x = (raw + 1023u) & ~1023u;
  const uint32_t s_b = s_x + C::kTileX;
  auto gp = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  float* dt_s = reinterpret_cast<float*>(gp(s_b + C::kTileQN));
  float* cum_s = dt_s + Q;
  float* w_s = cum_s + Q;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(gp(s_x));

  const int h = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int s0 = c * Q, q = min(Q, a.S - s0);
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x;

  load_tile<Q, kP, 128>(s_x, gp(s_x),
                        a.x + (((int64_t)bi * a.S + s0) * a.H + h) * kP,
                        (int64_t)a.H * kP, q, tid);
  load_tile<Q, N, 128>(s_b, gp(s_b),
                       a.b + (((int64_t)bi * a.S + s0) * a.G + g) * N,
                       (int64_t)a.G * N, q, tid);
  cp_async_commit();
  if (tid < Q) dt_s[tid] = load_dt(a, bi, h, s0, q, tid);
  chunk_cumsum<Q>(a.a[h], dt_s, cum_s, tid);
  const float last = cum_s[Q - 1];   // = cum at q - 1: padded dt is 0
  for (int j = tid; j < Q; j += 128) w_s[j] = expf(last - cum_s[j]) * dt_s[j];
  if (tid == 0) a.decay[((int64_t)bi * a.nc + c) * a.H + h] = expf(last);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // A = (w . x)^T: row m = p, column k = position j. This thread's
  // fragment rows: prow (registers 0, 2) and prow + 8 (1, 3); columns
  // 16 kk + col, + 1 (registers 0, 1) and + 8, + 9 (2, 3).
  const int warp = tid / 32, lane = tid % 32;
  const int prow = 16 * warp + lane / 4, col = 2 * (lane % 4);
  uint32_t fr[Q / 16][Pieces][4];
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = prow + 8 * (r & 1), j = 16 * kk + col + 8 * (r >> 1);
      const float x0 = __bfloat162float(
          xs[(tile_off<Q>(j, p / 8) + (p % 8) * 2) / 2]);
      const float x1 = __bfloat162float(
          xs[(tile_off<Q>(j + 1, p / 8) + (p % 8) * 2) / 2]);
      uint32_t pc[Pieces];
      split_pieces<Pieces>(w_s[j] * x0, w_s[j + 1] * x1, pc);
#pragma unroll
      for (int k = 0; k < Pieces; ++k) fr[kk][k][r] = pc[k];
    }

  // state_c (64 x N) = sum over k-steps and pieces of A . B, B = the chunk's
  // B rows (K = positions, N contiguous): an MN-major operand whose 64-wide
  // atoms of N lie Q rows apart, its 8-position groups 1024 bytes apart
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    const uint64_t db = desc(s_b + kk * 16 * kRow, Q * kRow, 1024);
#pragma unroll
    for (int k = 0; k < Pieces; ++k) {
      if constexpr (N == 128)
        wgmma_rs_n128(acc, fr[kk][k], db);
      else
        wgmma_rs_n64(acc, fr[kk][k], db);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);

  float* dst = a.states + (((int64_t)bi * a.nc + c) * a.H + h) * kP * N;
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(dst + (prow + 8 * r) * N + 8 * i + col) =
          make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
}

// 2. h_c = decay_c h_{c-1} + state_c over the chunks of one (head,
// sequence), 4 elements a thread; chunk c's slot (c > 0) becomes h_{c-1},
// the state entering chunk c; the last h is the final state.
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;  // chunks loaded before they run

__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(const Args a, int pn) {
  const int h = blockIdx.y, bi = blockIdx.z;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (e >= pn) return;
  const int64_t step = (int64_t)a.H * pn / 4;   // one chunk, in float4s
  float4* st = reinterpret_cast<float4*>(
      a.states + ((int64_t)bi * a.nc * a.H + h) * pn + e);
  const float* dec = a.decay + (int64_t)bi * a.nc * a.H + h;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += kPassAhead) {
    float4 sv[kPassAhead];
    float dv[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u)
      if (c0 + u < a.nc) {
        sv[u] = st[(c0 + u) * step];
        dv[u] = dec[(int64_t)(c0 + u) * a.H];
      }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u)
      if (c0 + u < a.nc) {
        if (c0 + u > 0) st[(c0 + u) * step] = hv;
        hv.x = fmaf(hv.x, dv[u], sv[u].x);
        hv.y = fmaf(hv.y, dv[u], sv[u].y);
        hv.z = fmaf(hv.z, dv[u], sv[u].z);
        hv.w = fmaf(hv.w, dv[u], sv[u].w);
      }
  }
  *reinterpret_cast<float4*>(a.state + ((int64_t)bi * a.H + h) * pn + e) = hv;
}

// 3. y for one (head, chunk, sequence): exp(cum_i) C_i . h_prev + the
// causal scores times x. The scores go through the tensor cores as
// SPieces bf16 pieces: Pieces, or 1 under ssm_bf16_intra (the scores
// rounded to bf16 once, as the model's plain version rounds them).
template <int Q, int N, int Pieces, int SPieces>
__global__ void __launch_bounds__(Cfg<Q, N, Pieces>::kScanThreads,
                                  Cfg<Q, N, Pieces>::kScanBlocks)
    ssd_chunk_scan_kernel(const Args a) {
  using C = Cfg<Q, N, Pieces>;
  constexpr int T = C::kScanThreads;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_c = (raw + 1023u) & ~1023u;
  const uint32_t s_b = s_c + C::kTileQN;
  const uint32_t s_x = s_b + C::kTileQN;
  const uint32_t s_h = C::kAlias ? s_b : s_x + C::kTileX;
  auto gp = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  float* dt_s = reinterpret_cast<float*>(
      gp(s_x + C::kTileX + (C::kAlias ? 0 : Pieces * C::kPiece)));
  float* cum_s = dt_s + Q;

  const int h = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int s0 = c * Q, q = min(Q, a.S - s0);
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x;
  const int64_t bc_row = (((int64_t)bi * a.S + s0) * a.G + g) * N;

  load_tile<Q, N, T>(s_c, gp(s_c), a.c + bc_row, (int64_t)a.G * N, q, tid);
  load_tile<Q, N, T>(s_b, gp(s_b), a.b + bc_row, (int64_t)a.G * N, q, tid);
  load_tile<Q, kP, T>(s_x, gp(s_x),
                      a.x + (((int64_t)bi * a.S + s0) * a.H + h) * kP,
                      (int64_t)a.H * kP, q, tid);
  cp_async_commit();
  // dt and h_prev (64 x N fp32; zero for the first chunk, not read) into
  // registers, every load issued before the first is used
  const float dt_j = tid < Q ? load_dt(a, bi, h, s0, q, tid) : 0.f;
  constexpr int kHpIters = kP * N / 8 / T;
  float4 hv[kHpIters][2];
  if (c > 0) {
    const float4* hp = reinterpret_cast<const float4*>(
        a.states + (((int64_t)bi * a.nc + c) * a.H + h) * kP * N);
#pragma unroll
    for (int it = 0; it < kHpIters; ++it) {
      hv[it][0] = hp[2 * (tid + it * T)];
      hv[it][1] = hp[2 * (tid + it * T) + 1];
    }
  }
  if (tid < Q) dt_s[tid] = dt_j;
  chunk_cumsum<Q>(a.a[h], dt_s, cum_s, tid);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // warpgroup wg owns rows 64 wg .. 64 wg + 63 of the chunk; this thread's
  // accumulator rows are row and row + 8, its columns in each 8-column
  // chunk col and col + 1
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row = 64 * wg + 16 * warp + lane / 4, col = 2 * (lane % 4);
  const uint32_t c_rows = s_c + 64 * wg * kRow;

  // C B^T (rows of this warpgroup x all Q positions), C and B K-major in
  // shared memory, N in steps of 16
  float cb[Q / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t k_off = (kk / 4) * Q * kRow + (kk % 4) * 32;
    const uint64_t da = desc(c_rows + k_off, 16, 1024);
    const uint64_t db = desc(s_b + k_off, 16, 1024);
    if constexpr (Q == 128)
      wgmma_ss_n128(cb, da, db, kk);
    else
      wgmma_ss_n64(cb, da, db, kk);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(cb);

  // y = exp(cum_i) C_i . h_prev: h_prev's pieces K-major in shared memory
  // (in B's tile, once every warpgroup is done with it, where they fit),
  // then the product with C, its rows times exp(cum_i)
  const float cum_r[2] = {cum_s[row], cum_s[row + 8]};
  float acc[kP / 2];
  if (c > 0) {
    if (C::kAlias) __syncthreads();
#pragma unroll
    for (int it = 0; it < kHpIters; ++it) {
      const int i = tid + it * T, p = i / (N / 8), gi = i % (N / 8);
      const float v[8] = {hv[it][0].x, hv[it][0].y, hv[it][0].z,
                          hv[it][0].w, hv[it][1].x, hv[it][1].y,
                          hv[it][1].z, hv[it][1].w};
      uint32_t pc[4][Pieces];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_pieces<Pieces>(v[2 * e], v[2 * e + 1], pc[e]);
#pragma unroll
      for (int k = 0; k < Pieces; ++k)
        *reinterpret_cast<uint4*>(gp(s_h + k * C::kPiece) +
                                  tile_off<kP>(p, gi)) =
            make_uint4(pc[0][k], pc[1][k], pc[2][k], pc[3][k]);
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < Pieces; ++k)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t da =
            desc(c_rows + (kk / 4) * Q * kRow + (kk % 4) * 32, 16, 1024);
        const uint64_t db = desc(
            s_h + k * C::kPiece + (kk / 4) * kP * kRow + (kk % 4) * 32, 16,
            1024);
        wgmma_ss_n64(acc, da, db, k > 0 || kk > 0);
      }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    const float e_r[2] = {expf(cum_r[0]), expf(cum_r[1])};
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) acc[i] *= e_r[(i >> 1) & 1];
  } else {
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) acc[i] = 0.f;
  }

  // the scores as A fragments: k-step kk holds positions 16 kk .. 16 kk +
  // 15, register r the pair cb[8 kk + 2 r], cb[8 kk + 2 r + 1]
  uint32_t fr[Q / 16][SPieces][4];
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row + 8 * (r & 1), j = 16 * kk + col + 8 * (r >> 1);
      const float ci = cum_r[r & 1];
      const float s0v = j <= i ? cb[8 * kk + 2 * r] * expf(ci - cum_s[j]) *
                                     dt_s[j]
                               : 0.f;
      const float s1v = j + 1 <= i ? cb[8 * kk + 2 * r + 1] *
                                         expf(ci - cum_s[j + 1]) * dt_s[j + 1]
                                   : 0.f;
      uint32_t pc[SPieces];
      split_pieces<SPieces>(s0v, s1v, pc);
#pragma unroll
      for (int k = 0; k < SPieces; ++k) fr[kk][k][r] = pc[k];
    }

  // y += s . x: x's rows are positions (the K dimension) with P contiguous,
  // an MN-major operand; k-steps wholly past this warpgroup's last row add
  // zeros and are skipped
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    if (16 * kk > 64 * wg + 63) break;
    const uint64_t db = desc(s_x + kk * 16 * kRow, Q * kRow, 1024);
#pragma unroll
    for (int k = 0; k < SPieces; ++k) wgmma_rs_n64(acc, fr[kk][k], db);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= q) continue;
    float* dst = a.y + (((int64_t)bi * a.S + s0 + i) * a.H + h) * kP + col;
#pragma unroll
    for (int k = 0; k < kP / 8; ++k)
      *reinterpret_cast<float2*>(dst + 8 * k) =
          make_float2(acc[4 * k + 2 * r], acc[4 * k + 2 * r + 1]);
  }
}

template <int Q, int N, int Pieces, int SPieces>
int launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<Q, N, Pieces>;
  auto k1 = ssd_state_kernel<Q, N, Pieces>;
  auto k3 = ssd_chunk_scan_kernel<Q, N, Pieces, SPieces>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemState);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k3, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemScan);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.nc, B);   // heads fastest: they share B and C rows
  k1<<<grid, 128, C::kSmemState, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int pn = kP * N;
  ssd_state_pass_kernel<<<dim3((pn / 4 + kPassThreads - 1) / kPassThreads,
                               a.H, B),
                          kPassThreads, 0, stream>>>(a, pn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k3<<<grid, C::kScanThreads, C::kSmemScan, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

namespace {

template <int Q, bool Intra>
int launch_chunk(const tc::Args& args, int B, int N, cudaStream_t s) {
  constexpr int kS = Intra ? 1 : tc::kPieces;
  if (N == 128) return tc::launch<Q, 128, tc::kPieces, kS>(args, B, s);
  if (N == 64) return tc::launch<Q, 64, tc::kPieces, kS>(args, B, s);
  return tc::kBadShape;
}

template <bool Intra>
int launch_any(const void* x, const void* b, const void* c, const void* dt,
               const void* a, void* y, void* state, void* chunk_states,
               void* chunk_decay, int B, int S, int H, int P, int G, int N,
               int bf16, int route, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    simt::Args args{x, b, c, static_cast<const float*>(dt),
                    static_cast<const float*>(a), static_cast<float*>(y),
                    static_cast<float*>(state), S, H, P, G, N};
    cudaError_t err = bf16 ? simt::launch<__nv_bfloat16, Intra>(args, B, s)
                           : simt::launch<float, Intra>(args, B, s);
    return (int)err;
  }
  if (route != 1 || !bf16 || P != tc::kP || (chunk != 64 && chunk != 128))
    return tc::kBadShape;
  tc::Args args{static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(b),
                static_cast<const __nv_bfloat16*>(c),
                static_cast<const float*>(dt),
                static_cast<const float*>(a),
                static_cast<float*>(y),
                static_cast<float*>(state),
                static_cast<float*>(chunk_states),
                static_cast<float*>(chunk_decay),
                S, H, G, (S + chunk - 1) / chunk};
  return chunk == 64 ? launch_chunk<64, Intra>(args, B, N, s)
                     : launch_chunk<128, Intra>(args, B, N, s);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0, the launch's cudaError_t or a negative
// code of tc. x (B, S, H, P), b and c (B, S, G, N) are contiguous and share
// one dtype: bf16 if `bf16`, else fp32; dt (B, S, H) and a (H,) are fp32; y
// (B, S, H, P) and state (B, H, P, N) are fp32 outputs. S >= 1, G divides H,
// N <= 256. `route` 0 is the simt route (the scratch unused); 1 the wgmma
// route: bf16, P = 64, N = 64 or 128, x, b, c 16-byte aligned, chunks
// of `chunk` positions (64 or 128; the simt route ignores it),
// `chunk_states` fp32 scratch of B * nc * H * P * N and `chunk_decay` of
// B * nc * H, nc = ceil(S / chunk).
int ssd_scan_launch(const void* x, const void* b, const void* c,
                    const void* dt, const void* a, void* y, void* state,
                    void* chunk_states, void* chunk_decay, int B, int S, int H,
                    int P, int G, int N, int bf16, int route, int chunk,
                    void* stream) {
  return launch_any<false>(x, b, c, dt, a, y, state, chunk_states,
                           chunk_decay, B, S, H, P, G, N, bf16, route, chunk,
                           stream);
}

// `ssd_scan_launch` under ssm_bf16_intra: the intra-chunk scores rounded
// to bf16 (one piece on the wgmma route) and, on the simt route, x too
// in their product; the states as `ssd_scan_launch` computes them.
int ssd_scan_launch_bf16_intra(const void* x, const void* b, const void* c,
                               const void* dt, const void* a, void* y,
                               void* state, void* chunk_states,
                               void* chunk_decay, int B, int S, int H, int P,
                               int G, int N, int bf16, int route, int chunk,
                               void* stream) {
  return launch_any<true>(x, b, c, dt, a, y, state, chunk_states,
                          chunk_decay, B, S, H, P, G, N, bf16, route, chunk,
                          stream);
}

// The wgmma route's default chunk and its pieces, as built; whether a
// chunk is built (1) or not (0).
int ssd_scan_wgmma_chunk() { return tc::kChunk; }
int ssd_scan_wgmma_pieces() { return tc::kPieces; }
int ssd_scan_wgmma_built(int chunk) {
  for (int q : tc::kChunks)
    if (q == chunk) return 1;
  return 0;
}

// Dynamic shared memory of the wgmma route's chunk-scan block (its largest)
// at state size n and the chunk, or a negative code for one the route
// does not take.
int ssd_scan_wgmma_smem(int n, int chunk) {
  if (chunk == 128 && n == 128) return tc::Cfg<128, 128, tc::kPieces>::kSmemScan;
  if (chunk == 128 && n == 64) return tc::Cfg<128, 64, tc::kPieces>::kSmemScan;
  if (chunk == 64 && n == 128) return tc::Cfg<64, 128, tc::kPieces>::kSmemScan;
  if (chunk == 64 && n == 64) return tc::Cfg<64, 64, tc::kPieces>::kSmemScan;
  return tc::kBadShape;
}

const char* ssd_scan_error_string(int err) {
  if (err == tc::kBadShape)
    return "the wgmma route takes bf16, P = 64, N = 64 or 128, chunks of "
           "64 or 128";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
