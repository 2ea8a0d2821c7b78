"""KernelSpec for COSMO horizontal diffusion (NERO, thesis Ch. 3).

The validation cases' shapes and dtypes, the tolerances and the input
generator are copies of the JAX package's ``repro/kernels/hdiff/spec.py``.
The tune space and the cost model are the Hopper kernels' own: the tiles
the "tma" route is built for (see ``csrc/hdiff.cu``), each costed on the
route its grid takes (`hdiff.route`).

`work` is the function's work, the same for every route and for the
plain version: the grid read and written once, `FLOPS_PER_POINT` a cell
off the tensor cores. The cost counter (`repro_torch.core.hlo_cost`)
records it for each call and `chip_smoke.py` bounds the kernel by it.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.configs.cosmo_stencil import cosmo_grid
from repro_torch.core.autotune import (HBM_BW, LAUNCH_OVERHEAD_S,
                                       MAX_THREADS, MEM_LATENCY_S, NUM_SMS,
                                       blocks_per_sm, issue_time,
                                       stream_time)
from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.hdiff import ref
from repro_torch.kernels.hdiff.hdiff import (TMA_THREADS, TMA_TILE_SPACE,
                                             hdiff, simt_smem_bytes,
                                             tma_box_width, tma_smem_bytes)

FLOPS_PER_POINT = 30.0
DEFAULT_SHAPE = {"nz": 8, "ny": 32, "nx": 48}
_G = cosmo_grid()                                # COSMO production grid
BENCH_SHAPE = {"nz": _G.nz, "ny": _G.ny, "nx": _G.nx}
TUNE_SPACE = TMA_TILE_SPACE
# PR 14's tune space, over which `simt_cost` gave the first port its knee
SIMT_TUNE_SPACE = {"tile_x": (32, 64, 128), "tile_y": (4, 8, 16, 32),
                   "block_z": (1, 2, 4, 8)}
# The tma route's costs, fitted by `tools/stencil_fit.py` to
# `chip_smoke.py`'s stencil sweep at the COSMO grid (PERF.md): the warp
# instructions of a pass of the block's threads over 256 cells of the
# Laplacian tile, of a row of the output walk, of a plane's barriers and
# set-up, and of an item's wait, decode and refill; and the rate at which
# L2 hands the boxes' 128-byte lines to the SMs.
LAP_PASS_ISSUE = 36.6
OUT_ROW_ISSUE = 29.0
PLANE_ISSUE = 4.63
ITEM_ISSUE = 179.0
HALO_L2_BW = 2.64e12


def box_lines(tile_x: int, dtype_bytes: int, nx: int) -> float:
    """128-byte lines a row of a tma box spans, on average over the tiles
    of a grid row: the box starts 16 bytes before its tile."""
    lead, width = 16, tma_box_width(tile_x, dtype_bytes) * dtype_bytes
    tiles = math.ceil(nx / tile_x)
    starts = [bx * tile_x * dtype_bytes - lead for bx in range(tiles)]
    return sum((s + width - 1) // 128 - s // 128 + 1 for s in starts) / tiles


def tma_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple:
    """(shared bytes per block, estimated seconds) of the tma route: the
    largest of the grid's bytes (read once, written once) at the memory
    rate, the boxes' lines (the halo read again) at `HALO_L2_BW` and the
    SMs' instruction issue; plus the ring's fill (one box's latency and
    one item's work) and one launch. Persistent blocks, as many as the
    SMs hold, each walk ceil(items / blocks) items of block_z planes."""
    nz, ny, nx = grid_shape
    tx, ty, bz = tile["tile_x"], tile["tile_y"], tile["block_z"]
    smem = tma_smem_bytes(tx, ty, bz, dtype_bytes)
    per_sm = blocks_per_sm(TMA_THREADS, smem)
    if not per_sm:
        return smem, math.inf
    items = math.ceil(nz / bz) * math.ceil(ny / ty) * math.ceil(nx / tx)
    blocks = min(items, NUM_SMS * per_sm)
    on_sm = math.ceil(blocks / NUM_SMS)
    warps = TMA_THREADS // 32
    per_item = warps * (ITEM_ISSUE + min(bz, nz) * (
        PLANE_ISSUE + LAP_PASS_ISSUE * math.ceil(
            (ty + 2) * (tx + 2) / TMA_THREADS)
        + OUT_ROW_ISSUE * tx * ty / TMA_THREADS))
    t_issue = issue_time(math.ceil(items / blocks) * on_sm * per_item,
                         on_sm * warps)
    t_mem = 2 * nz * ny * nx * dtype_bytes / HBM_BW
    t_l2 = items * min(bz, nz) * (ty + 2 * ref.HALO) * box_lines(
        tx, dtype_bytes, nx) * 128 / HALO_L2_BW
    t_fill = MEM_LATENCY_S + issue_time(per_item, warps)
    return smem, max(t_mem, t_l2, t_issue) + t_fill + LAUNCH_OVERHEAD_S


def simt_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple | None:
    """PR 14's model of the simt route: each block reads its patch and
    halo, (ty+4)(tx+4)/(ty tx) times the patch, and writes the patch; its
    threads issue all block_z planes' loads before one barrier. None when
    the block would exceed the card's threads per block."""
    nz, ny, nx = grid_shape
    tx, ty, bz = tile["tile_x"], tile["tile_y"], tile["block_z"]
    if tx * ty > MAX_THREADS:
        return None
    smem = simt_smem_bytes(tx, ty, bz)
    halo = (ty + 2 * ref.HALO) * (tx + 2 * ref.HALO) / (ty * tx)
    blocks = math.ceil(nz / bz) * math.ceil(ny / ty) * math.ceil(nx / tx)
    t = stream_time(nz * ny * nx * dtype_bytes * (halo + 1), blocks, tx * ty,
                    smem, bz * halo * dtype_bytes)
    return smem, math.inf if t is None else t


def hdiff_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple | None:
    """(shared bytes per block, estimated seconds) on the route the grid
    takes (`hdiff.route`: rows a multiple of 16 bytes go to "tma")."""
    if grid_shape[2] * dtype_bytes % 16 == 0:
        return tma_cost(grid_shape, tile, dtype_bytes)
    return simt_cost(grid_shape, tile, dtype_bytes)


def work(src, coeff=None) -> dict:
    """{"bytes", "flops": {"fp32": flops}} of one call: src and out each
    once, `FLOPS_PER_POINT` flops a cell."""
    del coeff
    return {"bytes": 2 * src.numel() * src.element_size(),
            "flops": {"fp32": FLOPS_PER_POINT * src.numel()}}


def example_inputs(shape=None, dtype=np.float32, seed: int = 0) -> dict:
    s = {**DEFAULT_SHAPE, **(shape or {})}
    rng = np.random.default_rng(seed)
    return {"src": rng.normal(size=(s["nz"], s["ny"], s["nx"])).astype(dtype)}


SPEC = registry.register(KernelSpec(
    name="hdiff",
    fn=hdiff,
    ref_fn=ref.hdiff,
    arg_names=("src",),
    example_inputs=example_inputs,
    tol={"float32": 1e-5, "bfloat16": 0.12},
    cases=(
        KernelCase({"nz": 4, "ny": 16, "nx": 24}),
        KernelCase({"nz": 8, "ny": 32, "nx": 48}),
        KernelCase({"nz": 8, "ny": 24, "nx": 128}),
        KernelCase({"nz": 4, "ny": 16, "nx": 24}, dtype="bfloat16"),
    ),
    tune_space=TUNE_SPACE,
    cost_fn=hdiff_cost,
    flops=lambda g: FLOPS_PER_POINT * g[0] * g[1] * g[2],
    grid_of=lambda src: tuple(src.shape),
    shape_keys=("nz", "ny", "nx"),
    default_shape=DEFAULT_SHAPE,
    bench_shape=BENCH_SHAPE,
    dtypes=("float32", "bfloat16"),
))
