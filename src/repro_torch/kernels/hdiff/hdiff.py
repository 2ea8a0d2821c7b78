"""COSMO horizontal diffusion: the wrapper of the CUDA kernels in
``csrc/hdiff.cu``.

Two routes, chosen by `route` from the dtype and the grid's row length
alone: "tma", persistent blocks fed by a ring of TMA boxes with the
Laplacian computed once a cell (``csrc/hdiff.cu``), for grids whose rows
are a multiple of 16 bytes long (a tensor map's row stride must be);
"simt", the first port (``csrc/hdiff_simt.cuh``), for the rest. On CUDA
tensors `hdiff` checks its arguments, allocates the output and launches
on the current stream at the given tile, or raises: no route is taken
because another failed, and there is no fallback to the plain version. On
CPU tensors it runs the plain version (`repro_torch.kernels.hdiff.ref.hdiff`),
and the tile has no effect. ``hdiff.launches`` counts kernel launches,
``hdiff.launches_by_route`` splits them by route and ``hdiff.plain_calls``
counts the calls that went to the plain version because the tensor lay on
the CPU. Under the cost counter (`repro_torch.core.hlo_cost`) a call is
one entry of its function's work (`spec.work`; `repro_torch.kernels.count`).

The tile names the work of one step: ``tile_x`` x ``tile_y`` cells of
``block_z`` planes. The "tma" route is built for the tiles of
`TMA_TILE_SPACE` (one box of the ring each, walked by 256 threads); the
"simt" route runs a block of ``tile_x`` x ``tile_y`` threads over that
patch of ``block_z`` planes.
"""
from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from repro_torch.core.autotune import MAX_THREADS, SMEM_BYTES
from repro_torch.kernels import count
from repro_torch.kernels.hdiff import ref

ROUTES = ("tma", "simt")
_ROUTE_ARG = {"simt": 0, "tma": 1}        # hdiff_launch's `route`
# as csrc/hdiff.cu builds it: tiles of at least 1024 cells (smaller ones
# pay the halo and a plane's barriers over too few outputs: 1.4-2.4x the
# best tile on the card, PERF.md)
TMA_TILE_SPACE = {"tile_x": (64, 128), "tile_y": (16, 32),
                  "block_z": (1, 2, 4)}
TMA_THREADS = 256
TMA_STAGES = 3                             # boxes in the ring
_DTYPES = (torch.float32, torch.bfloat16)


def route(dtype, nx: int) -> str:
    """The kernel a launch on a (nz, ny, nx) grid of `dtype` takes: "tma"
    when a row of the grid is a multiple of 16 bytes, else "simt"."""
    return "tma" if nx * dtype.itemsize % 16 == 0 else "simt"


def simt_smem_bytes(tile_x: int, tile_y: int, block_z: int) -> int:
    """Shared memory of one "simt" block: its fp32 patch plus halo, all
    planes."""
    return block_z * (tile_y + 2 * ref.HALO) * (tile_x + 2 * ref.HALO) * 4


def tma_box_width(tile_x: int, dtype_bytes: int) -> int:
    """Columns of a "tma" box: the tile and 16 bytes on each side (a box
    starts on a 16-byte boundary, 16 bytes before the tile, to cover its
    2-cell halo)."""
    return tile_x + 2 * (16 // dtype_bytes)


def tma_smem_bytes(tile_x: int, tile_y: int, block_z: int,
                   dtype_bytes: int) -> int:
    """Shared memory of one "tma" block, as csrc/hdiff.cu lays it out: 128
    bytes of alignment slack, `TMA_STAGES` boxes of block_z x (tile_y + 4)
    x `tma_box_width` elements (each rounded up to 128 bytes), the fp32
    Laplacian tile (tile_y + 2) x (tile_x + 2), one mbarrier per stage."""
    box = block_z * (tile_y + 2 * ref.HALO) * tma_box_width(
        tile_x, dtype_bytes) * dtype_bytes
    lap_off = TMA_STAGES * (-(-box // 128) * 128)
    bar_off = -(-(lap_off + (tile_y + 2) * (tile_x + 2) * 4) // 8) * 8
    return 128 + bar_off + 8 * TMA_STAGES


def tma_tiles() -> list[dict]:
    """Every tile the "tma" route is built for."""
    names = sorted(TMA_TILE_SPACE)
    return [dict(zip(names, v)) for v in itertools.product(
        *(TMA_TILE_SPACE[n] for n in names))]


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("hdiff")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hdiff_launch.argtypes = [vp, vp] + [i32] * 6 + [ctypes.c_float, i32,
                                                        i32, vp]
    lib.hdiff_launch.restype = i32
    lib.hdiff_tma_smem.argtypes = [i32] * 4
    lib.hdiff_tma_smem.restype = i32
    lib.hdiff_error_string.argtypes = [i32]
    lib.hdiff_error_string.restype = ctypes.c_char_p
    return lib


def _check(src, tile_x, tile_y, block_z) -> str:
    """Raises on what the kernels do not take; returns the route."""
    if src.ndim != 3 or src.numel() == 0:
        raise ValueError(f"src {tuple(src.shape)}: expected a non-empty "
                         f"(nz, ny, nx) grid")
    if src.dtype not in _DTYPES:
        raise TypeError(f"src {src.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    tile = (tile_x, tile_y, block_z)
    kind = route(src.dtype, src.shape[2])
    if kind == "tma":
        if {"tile_x": tile_x, "tile_y": tile_y, "block_z": block_z} \
                not in tma_tiles() or tma_smem_bytes(
                    *tile, src.element_size()) > SMEM_BYTES:
            raise ValueError(f"tile {tile}: the tma route takes the tiles "
                             f"of {TMA_TILE_SPACE} whose ring fits in "
                             f"{SMEM_BYTES} bytes of shared memory")
        if src.data_ptr() % 16:
            raise ValueError("src is not 16-byte aligned: the tma route "
                             "reads it through a tensor map")
    elif min(tile) < 1 or tile_x * tile_y > MAX_THREADS \
            or simt_smem_bytes(*tile) > SMEM_BYTES:
        raise ValueError(f"tile {tile}: a simt block takes at most "
                         f"{MAX_THREADS} threads and {SMEM_BYTES} bytes of "
                         f"shared memory")
    return kind


def launch(src, out, tile_x: int, tile_y: int, block_z: int, kind: str,
           coeff: float = ref.COEFF) -> None:
    """One launch of route `kind` into out, with no checks and no counts
    (`hdiff` checks and counts; `chip_smoke.py`'s before/after pairs call
    this directly). Raises on a launch error."""
    nz, ny, nx = src.shape
    lib = _lib()
    with torch.cuda.device(src.device):
        err = lib.hdiff_launch(
            src.data_ptr(), out.data_ptr(), nz, ny, nx, tile_x, tile_y,
            block_z, coeff, int(src.dtype == torch.bfloat16),
            _ROUTE_ARG[kind],
            torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"hdiff kernel launch failed ({kind} route): "
                           f"{lib.hdiff_error_string(err).decode()}")


def hdiff(src, coeff: float = ref.COEFF, *, tile_x: int = 64,
          tile_y: int = 16, block_z: int = 1):
    """src: (nz, ny, nx) float32 or bfloat16 -> the same, as `ref.hdiff`."""
    def work():
        from repro_torch.kernels.hdiff.spec import work
        return work(src)

    return count.call(
        "hdiff", src.device, lambda: route(src.dtype, src.shape[-1]), work,
        lambda: _run(src, coeff, tile_x, tile_y, block_z),
        lambda: torch.empty_like(src), inputs=(src,))


def _run(src, coeff, tile_x, tile_y, block_z):
    if not src.is_cuda:
        hdiff.plain_calls += 1
        return ref.hdiff(src, coeff)
    kind = _check(src, tile_x, tile_y, block_z)
    out = torch.empty_like(src)
    launch(src, out, tile_x, tile_y, block_z, kind, coeff)
    hdiff.launches += 1
    hdiff.launches_by_route[kind] += 1
    return out


hdiff.launches = 0
hdiff.launches_by_route = dict.fromkeys(ROUTES, 0)
hdiff.plain_calls = 0
