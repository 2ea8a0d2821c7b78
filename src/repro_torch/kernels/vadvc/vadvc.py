"""COSMO vertical advection: the wrapper of the CUDA kernels in
``csrc/vadvc.cu``.

Two routes: "prefetch", which issues each column's loads levels ahead of
the Thomas chain (``csrc/vadvc.cu``), and "simt", the first port
(``csrc/vadvc_simt.cuh``). `route` sends every grid to "prefetch": it
reads with plain loads and takes any shape the simt route takes, which is
kept as the "before" of the two routes' comparison on the card
(`launch(..., "simt")`). On CUDA tensors `vadvc` checks its arguments,
allocates the output and launches on the current stream at the given
tile, or raises: there is no fallback. On CPU tensors it runs the plain
version (`repro_torch.kernels.vadvc.ref.vadvc`), and the tile has no
effect. ``vadvc.launches`` counts kernel launches,
``vadvc.launches_by_route`` splits them by route and
``vadvc.plain_calls`` counts the calls that went to the plain version
because the tensors lay on the CPU. Under the cost counter
(`repro_torch.core.hlo_cost`) a call is one entry of its function's work
(`spec.work`; `repro_torch.kernels.count`).

The tile is the kernel's launch shape, the same on both routes: a block
of ``tile_x`` x ``tile_y`` threads, one per (y, x) column, with the
forward sweep's ccol and dcol of every level in shared memory, and on
the prefetch route upos beside them (`smem_bytes`; `simt_smem_bytes`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.autotune import MAX_THREADS, SMEM_BYTES
from repro_torch.kernels import count
from repro_torch.kernels.vadvc import ref

ROUTES = ("prefetch", "simt")
AHEAD = 8              # forward levels in flight, as csrc/vadvc.cu builds it
PREFETCH_MAX_THREADS = 512   # the prefetch kernel's launch bound, idem
_ROUTE_ARG = {"simt": 0, "prefetch": 1}   # vadvc_launch's `route`


def route(nz: int, ny: int, nx: int) -> str:
    """The kernel a launch on a (nz, ny, nx) grid takes: "prefetch", for
    every grid (its loads need no alignment)."""
    del nz, ny, nx
    return "prefetch"


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("vadvc")
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.vadvc_launch.argtypes = [vp] * 6 + [i32] * 3 + [i64] * 2 \
        + [i32] * 2 + [f32] * 3 + [i32, vp]
    lib.vadvc_launch.restype = i32
    lib.vadvc_error_string.argtypes = [i32]
    lib.vadvc_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(nz: int, tile_x: int, tile_y: int) -> int:
    """Shared memory of one prefetch block: ccol, dcol and upos of every
    level, fp32 (its ring of loads lives in registers)."""
    return 3 * nz * tile_x * tile_y * 4


def simt_smem_bytes(nz: int, tile_x: int, tile_y: int) -> int:
    """Shared memory of one simt block: ccol and dcol of every level,
    fp32."""
    return 2 * nz * tile_x * tile_y * 4


def launch(ustage, upos, utens, utens_stage, wcon, out, tile_x: int,
           tile_y: int, kind: str) -> None:
    """One launch of route `kind` into out, with no checks and no counts
    (`vadvc` checks and counts; `chip_smoke.py`'s before/after pairs call
    this directly). Raises on a launch error."""
    nz, ny, nx = ustage.shape
    lib = _lib()
    with torch.cuda.device(ustage.device):
        err = lib.vadvc_launch(
            *(t.data_ptr() for t in (ustage, upos, utens, utens_stage, wcon,
                                     out)), nz, ny, nx,
            wcon.stride(0), wcon.stride(1), tile_x, tile_y, ref.DTR_STAGE,
            ref.BET_M, ref.BET_P, _ROUTE_ARG[kind],
            torch.cuda.current_stream(ustage.device).cuda_stream)
    if err:
        raise RuntimeError(f"vadvc kernel launch failed ({kind} route): "
                           f"{lib.vadvc_error_string(err).decode()}")


def vadvc(ustage, upos, utens, utens_stage, wcon, *, tile_x: int = 32,
          tile_y: int = 4):
    """Fields (nz, ny, nx) and wcon (nz+1, ny, nx+1), float32 -> out
    (nz, ny, nx) float32, as `ref.vadvc`."""
    def work():
        from repro_torch.kernels.vadvc.spec import work
        return work(ustage, upos, utens, utens_stage, wcon)

    return count.call(
        "vadvc", ustage.device, lambda: route(*ustage.shape), work,
        lambda: _run(ustage, upos, utens, utens_stage, wcon, tile_x, tile_y),
        lambda: torch.empty_like(ustage), inputs=(ustage,))


def _run(ustage, upos, utens, utens_stage, wcon, tile_x, tile_y):
    fields = (ustage, upos, utens, utens_stage)
    if not ustage.is_cuda:
        vadvc.plain_calls += 1
        return ref.vadvc(*fields, wcon)
    shape = tuple(ustage.shape)
    if len(shape) != 3 or ustage.numel() == 0 \
            or any(tuple(f.shape) != shape for f in fields) \
            or tuple(wcon.shape) != (shape[0] + 1, shape[1], shape[2] + 1):
        raise ValueError(f"fields {[tuple(f.shape) for f in fields]}, wcon "
                         f"{tuple(wcon.shape)}: expected four non-empty "
                         f"(nz, ny, nx) fields and wcon (nz+1, ny, nx+1)")
    if any(t.device != ustage.device for t in (*fields, wcon)):
        raise ValueError("all inputs must lie on one device")
    if any(t.dtype != torch.float32 for t in (*fields, wcon)):
        raise TypeError("the kernel takes float32")
    if not all(f.is_contiguous() for f in fields) or wcon.stride(2) != 1:
        raise ValueError("the fields must be contiguous and wcon's rows "
                         "dense")
    nz, ny, nx = shape
    kind = route(nz, ny, nx)
    threads, smem = (PREFETCH_MAX_THREADS, smem_bytes) \
        if kind == "prefetch" else (MAX_THREADS, simt_smem_bytes)
    if min(tile_x, tile_y) < 1 or tile_x * tile_y > threads \
            or smem(nz, tile_x, tile_y) > SMEM_BYTES:
        raise ValueError(f"tile ({tile_x}, {tile_y}) at nz={nz}: a "
                         f"{kind} block takes at most {threads} threads and "
                         f"{SMEM_BYTES} bytes of shared memory")
    out = torch.empty_like(ustage)
    launch(*fields, wcon, out, tile_x, tile_y, kind)
    vadvc.launches += 1
    vadvc.launches_by_route[kind] += 1
    return out


vadvc.launches = 0
vadvc.launches_by_route = dict.fromkeys(ROUTES, 0)
vadvc.plain_calls = 0
