// COSMO horizontal diffusion for Hopper, route `tma`.
//
// Replaces the TPU kernel `hdiff_pallas` (body `_hdiff_kernel`) of
// src/repro/kernels/hdiff/hdiff.py. Same function: src (nz, ny, nx), fp32 or
// bf16, gives out of the same shape and type. Per plane, on the interior: a
// 5-point Laplacian, x and y fluxes of it zeroed by the sign limiter
// `flx * dif > 0`, and `s - coeff * ((flx_c - flx_m) + (fly_c - fly_m))`. The
// outer 2-cell ring of every plane is copied through. Route `simt`
// (hdiff_simt.cuh, the first port) takes the grids this route does not.
//
// Numbers. As in the simt route: every value is widened to fp32, every
// operation is an `_rn` intrinsic in the order of the plain PyTorch version
// (kernels/hdiff/ref.py), nothing is contracted into a fused multiply-add,
// and the result is rounded once on store, so the output equals the plain
// version's to the bit. A Laplacian computed once and read by five outputs is
// the same fp32 value the simt route computes five times.
//
// Bound. Each element is read once and written once: 33.6 MB in fp32 at the
// COSMO grid 64 x 256 x 256 (0.0100 ms at 3.35 TB/s), 16.8 MB in bf16; about
// 30 flops a point, so bytes bound it. The simt route ran at 21% (fp32) and 9%
// (bf16) of that: it was bound by instructions, not bytes (runtime division
// and modulo for every element loaded, five Laplacians rebuilt from 25
// shared-memory reads for every output, ring cells read from device memory a
// second time).
//
// Design. The tile (TX x TY cells, P planes) is a template parameter, and
// the work items advance in mixed radix, so no division is left in the
// loops. One block of 256 threads runs per slot the SMs hold (persistent
// blocks); each walks the items (P planes of one tile) blockIdx.x,
// blockIdx.x + gridDim.x, ... and keeps a ring of kStages TMA boxes in
// flight on mbarriers. The box (P, TY + 4, W) starts at (z0, y0 - 2,
// x0 - A) of a 3-D tensor map over (nz, ny, nx), A being the elements of 16
// bytes, W = TX + 2 A: a box must start on a 16-byte boundary of its row
// (one at x0 - 2 never completes its barrier). TMA writes zeros where the
// box leaves the grid, which is what the simt route's loader does by hand.
// Per plane the block builds the (TY + 2) x (TX + 2) Laplacian tile once
// into shared memory, by walks down its columns (3 reads a cell; its two
// edge columns by a flat pass); then thread (c, g) walks rows
// g R .. g R + R - 1 of column c (R = TY TX / 256), keeping the column's
// centre and its up / down neighbours of both the source and the Laplacian
// in registers, so each output reads 3 source and 3 Laplacian values: about
// 10 shared accesses an output with the tile's, against the simt route's 29.
// Ring cells store the source element from the box. A warp is 32
// neighbouring x of one row, so its 4-byte (2-byte) stores coalesce into
// whole 128-byte lines (half lines, which the next warp completes); 16-byte
// stores would take a shuffle or a staging pass per output. The ring has no
// "empty" barriers: the block's barrier after the stage's last plane frees
// the stage, and thread 0 then refills it with the item kStages ahead.
// kStages = 3: a ring of 2 was 11% faster for fp32 at 128 x 32 but 3%
// slower for bf16, one of 4 at most 2% faster and up to 12% slower
// (tools/stencil_variants.py, PERF.md).

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hdiff_simt.cuh"
#include "hopper.cuh"

namespace tma {

using simt::limit;
using simt::store;
using simt::widen;

constexpr int kThreads = 256;
constexpr int kStages = 3;

// error codes of the launch beside cudaError_t's (which are >= 0)
constexpr int kNoEncoder = -1;
constexpr int kEncodeFailed = -2;
constexpr int kBadTile = -3;

template <typename T, int TX, int TY, int P>
struct Layout {
  static constexpr int kA = 16 / sizeof(T);             // elements in 16 B
  static constexpr int kW = TX + 2 * kA;                // x0 - kA ..
  static constexpr int kX0 = kA - 2;                    // box column of x0 - 2
  static constexpr int kH = TY + 4;
  static constexpr int kBoxBytes = P * kH * kW * sizeof(T);
  static constexpr int kStageStride = (kBoxBytes + 127) / 128 * 128;
  static constexpr int kLapW = TX + 2, kLapH = TY + 2;
  static constexpr int kLapOff = kStages * kStageStride;
  static constexpr int kBarOff =
      (kLapOff + kLapH * kLapW * 4 + 7) / 8 * 8;
  // 128 bytes of slack to align the boxes for TMA
  static constexpr int kSmem = 128 + kBarOff + 8 * kStages;
  static constexpr int kRows = kThreads / TX;           // thread rows
  static constexpr int kR = TY / kRows;                 // output rows a
                                                        // thread walks
  static constexpr int kRL = (kLapH + kRows - 1) / kRows;  // Laplacian rows
  static_assert(TX % 32 == 0 && kThreads % TX == 0 && TY % kRows == 0,
                "a warp takes 32 columns of one row");
};

template <typename T, int TX, int TY, int P>
__global__ void __launch_bounds__(kThreads)
    hdiff_tma_kernel(const __grid_constant__ CUtensorMap map,
                     T* __restrict__ out, int nz, int ny, int nx,
                     float coeff) {
  using L = Layout<T, TX, TY, P>;
  constexpr int W = L::kW, LW = L::kLapW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - raw);
  float* lap = reinterpret_cast<float*>(smem + L::kLapOff);
  const uint32_t bars = base + L::kBarOff;
  const int tid = threadIdx.x;

  const int tiles_x = (nx + TX - 1) / TX, tiles_y = (ny + TY - 1) / TY;
  const int items = (nz + P - 1) / P * tiles_y * tiles_x;
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / gridDim.x + 1
                       : 0;
  // item -> (tile x, tile y, plane group), and the step of gridDim.x items
  // in that mixed radix, so that walking the items divides nothing
  const int3 first = make_int3(blockIdx.x % tiles_x,
                               blockIdx.x / tiles_x % tiles_y,
                               blockIdx.x / tiles_x / tiles_y);
  const int3 step = make_int3(gridDim.x % tiles_x,
                              gridDim.x / tiles_x % tiles_y,
                              gridDim.x / tiles_x / tiles_y);
  auto advance = [&](int3& q) {
    q.x += step.x;
    q.y += step.y;
    q.z += step.z;
    if (q.x >= tiles_x) {
      q.x -= tiles_x;
      ++q.y;
    }
    if (q.y >= tiles_y) {
      q.y -= tiles_y;
      ++q.z;
    }
  };
  int3 ahead = first;                  // thread 0: the next item to load
  auto issue = [&](int j) {            // this block's item j into its stage
    const int s = j % kStages;
    hopper::mbar_expect_tx(bars + 8 * s, L::kBoxBytes);
    hopper::tma_load_3d(base + s * L::kStageStride, &map, bars + 8 * s,
                        ahead.x * TX - L::kA, ahead.y * TY - 2, ahead.z * P);
    advance(ahead);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(bars + 8 * s, 1);
    hopper::fence_mbar_init();
    for (int j = 0; j < kStages && j < mine; ++j) issue(j);
  }
  __syncthreads();

  const int c = tid % TX, g = tid / TX, r0 = g * L::kR;
  int3 at = first;
  for (int j = 0; j < mine; ++j, advance(at)) {
    const int bx = at.x, by = at.y, bz = at.z;
    const int s = j % kStages;
    hopper::mbar_wait(bars + 8 * s, (j / kStages) & 1);
    const T* box = reinterpret_cast<const T*>(smem + s * L::kStageStride);
    const int x = bx * TX + c;
    for (int p = 0; p < P && bz * P + p < nz; ++p) {
      const T* pl = box + p * L::kH * W;
      // the Laplacian of the cells (y0 - 1 .. y0 + TY, x0 - 1 .. x0 + TX),
      // once each: columns x0 .. x0 + TX - 1 by thread (c, g) walking rows
      // g RL .. g RL + RL - 1 (3 reads a cell), the two edge columns by a
      // flat pass (5 reads a cell)
      {
        const int rl = g * L::kRL;
        const T* q = pl + (rl + 1) * W + L::kX0 + c + 2;   // centre of lap(rl)
        float* lo = lap + rl * LW + c + 1;
        float up = widen(q[-W]), mid = widen(q[0]);
#pragma unroll
        for (int k = 0; k < L::kRL; ++k) {
          if (rl + k < L::kLapH) {
            const float dn = widen(q[(k + 1) * W]);
            lo[k * LW] = __fsub_rn(
                __fmul_rn(4.f, mid),
                __fadd_rn(__fadd_rn(__fadd_rn(up, dn), widen(q[k * W - 1])),
                          widen(q[k * W + 1])));
            up = mid;
            mid = dn;
          }
        }
      }
      for (int i = tid; i < 2 * L::kLapH; i += kThreads) {
        const int r = i >> 1, cc = i & 1 ? TX + 1 : 0;
        const T* q = pl + (r + 1) * W + L::kX0 + cc + 1;
        lap[r * LW + cc] = __fsub_rn(
            __fmul_rn(4.f, widen(q[0])),
            __fadd_rn(__fadd_rn(__fadd_rn(widen(q[-W]), widen(q[W])),
                                widen(q[-1])),
                      widen(q[1])));
      }
      __syncthreads();
      // outputs: rows r0 .. r0 + kR - 1 of column c, walking down y
      const T* sc = pl + (r0 + 2) * W + L::kX0 + c + 2;   // s at (r0, c)
      const float* lc = lap + (r0 + 1) * LW + c + 1;    // lap at (r0, c)
      float s_up = widen(sc[-W]), s_c = widen(sc[0]);
      float l_up = lc[-LW], l_c = lc[0];
      T* o = out + ((int64_t)(bz * P + p) * ny + by * TY + r0) * nx + x;
#pragma unroll
      for (int k = 0; k < L::kR; ++k) {
        const float s_dn = widen(sc[(k + 1) * W]);
        const float s_w = widen(sc[k * W - 1]), s_e = widen(sc[k * W + 1]);
        const float l_dn = lc[(k + 1) * LW];
        const float l_w = lc[k * LW - 1], l_e = lc[k * LW + 1];
        const float flx_c = limit(__fsub_rn(l_e, l_c), __fsub_rn(s_e, s_c));
        const float flx_m = limit(__fsub_rn(l_c, l_w), __fsub_rn(s_c, s_w));
        const float fly_c =
            limit(__fsub_rn(l_dn, l_c), __fsub_rn(s_dn, s_c));
        const float fly_m =
            limit(__fsub_rn(l_c, l_up), __fsub_rn(s_c, s_up));
        const float div = __fadd_rn(__fsub_rn(flx_c, flx_m),
                                    __fsub_rn(fly_c, fly_m));
        const int y = by * TY + r0 + k;
        if (x < nx && y < ny) {
          if (y < 2 || y >= ny - 2 || x < 2 || x >= nx - 2)
            o[(int64_t)k * nx] = sc[k * W];
          else
            store(o + (int64_t)k * nx, __fsub_rn(s_c, __fmul_rn(coeff, div)));
        }
        s_up = s_c;
        s_c = s_dn;
        l_up = l_c;
        l_c = l_dn;
      }
      __syncthreads();   // the Laplacian tile and, after the last plane, the
                         // stage are free
    }
    if (tid == 0 && j + kStages < mine) issue(j + kStages);
  }
}

// The 3-D map of a contiguous (nz, ny, nx) grid, boxes of (P, TY + 4, W).
template <typename T, int TX, int TY, int P>
bool make_map(hopper::EncodeTiled enc, CUtensorMap* map, const void* src,
              int nz, int ny, int nx) {
  using L = Layout<T, TX, TY, P>;
  const cuuint64_t dims[3] = {(cuuint64_t)nx, (cuuint64_t)ny,
                              (cuuint64_t)nz};
  const cuuint64_t strides[2] = {(cuuint64_t)nx * sizeof(T),
                                 (cuuint64_t)ny * nx * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)L::kW, (cuuint32_t)L::kH,
                             (cuuint32_t)P};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, type, 3, const_cast<void*>(src), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int TX, int TY, int P>
int launch(const void* src, void* out, int nz, int ny, int nx, float coeff,
           cudaStream_t stream) {
  using L = Layout<T, TX, TY, P>;
  const hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return kNoEncoder;
  CUtensorMap map;
  if (!make_map<T, TX, TY, P>(enc, &map, src, nz, ny, nx))
    return kEncodeFailed;
  auto kernel = hdiff_tma_kernel<T, TX, TY, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, L::kSmem)) != cudaSuccess)
    return (int)err;
  const long long items = (long long)((nz + P - 1) / P) *
                          ((ny + TY - 1) / TY) * ((nx + TX - 1) / TX);
  const int blocks = (int)(items < (long long)sms * per_sm
                               ? items
                               : (long long)sms * per_sm);
  kernel<<<blocks, kThreads, L::kSmem, stream>>>(
      map, static_cast<T*>(out), nz, ny, nx, coeff);
  return (int)cudaGetLastError();
}

template <int V>
using I = std::integral_constant<int, V>;

// f(I<TX>, I<TY>, I<P>) for the tiles the route is built for: tile_x 64 or
// 128, tile_y 16 or 32, 1, 2 or 4 planes a stage (the wrapper's
// TMA_TILE_SPACE); kBadTile for any other.
template <int TX, int TY, typename F>
int with_p(int p, F&& f) {
  switch (p) {
    case 1: return f(I<TX>{}, I<TY>{}, I<1>{});
    case 2: return f(I<TX>{}, I<TY>{}, I<2>{});
    case 4: return f(I<TX>{}, I<TY>{}, I<4>{});
    default: return kBadTile;
  }
}

template <int TX, typename F>
int with_y(int ty, int p, F&& f) {
  switch (ty) {
    case 16: return with_p<TX, 16>(p, f);
    case 32: return with_p<TX, 32>(p, f);
    default: return kBadTile;
  }
}

template <typename F>
int with_tile(int tx, int ty, int p, F&& f) {
  switch (tx) {
    case 64: return with_y<64>(ty, p, f);
    case 128: return with_y<128>(ty, p, f);
    default: return kBadTile;
  }
}

template <typename T>
int launch_tile(const void* src, void* out, int nz, int ny, int nx, int tx,
                int ty, int p, float coeff, cudaStream_t s) {
  return with_tile(tx, ty, p, [&](auto TX, auto TY, auto P) {
    return launch<T, decltype(TX)::value, decltype(TY)::value,
                  decltype(P)::value>(src, out, nz, ny, nx, coeff, s);
  });
}

template <typename T>
int smem_of(int tx, int ty, int p) {
  return with_tile(tx, ty, p, [](auto TX, auto TY, auto P) {
    return Layout<T, decltype(TX)::value, decltype(TY)::value,
                  decltype(P)::value>::kSmem;
  });
}

}  // namespace tma

extern "C" {

// Launches route `tma` (1) or `simt` (0) on `stream` and returns 0, a
// cudaError_t, or one of tma's negative codes. src and out are contiguous
// (nz, ny, nx), fp32 (bf16 = 0) or bf16 (bf16 = 1); for `tma`, src is 16-byte
// aligned, nx times the element size is a multiple of 16 and the tile is one
// the route is built for.
int hdiff_launch(const void* src, void* out, int nz, int ny, int nx,
                 int tile_x, int tile_y, int block_z, float coeff, int bf16,
                 int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (bf16)
      return tma::launch_tile<__nv_bfloat16>(src, out, nz, ny, nx, tile_x,
                                             tile_y, block_z, coeff, s);
    return tma::launch_tile<float>(src, out, nz, ny, nx, tile_x, tile_y,
                                   block_z, coeff, s);
  }
  if (bf16)
    return simt::launch<__nv_bfloat16>(src, out, nz, ny, nx, tile_x, tile_y,
                                       block_z, coeff, s);
  return simt::launch<float>(src, out, nz, ny, nx, tile_x, tile_y, block_z,
                             coeff, s);
}

// The dynamic shared memory of one `tma` block at this tile, or kBadTile.
int hdiff_tma_smem(int tile_x, int tile_y, int block_z, int bf16) {
  return bf16 ? tma::smem_of<__nv_bfloat16>(tile_x, tile_y, block_z)
              : tma::smem_of<float>(tile_x, tile_y, block_z);
}

const char* hdiff_error_string(int err) {
  switch (err) {
    case tma::kNoEncoder:
      return "the driver has no cuTensorMapEncodeTiled";
    case tma::kEncodeFailed:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case tma::kBadTile:
      return "the tma route is not built for this tile";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
