"""KernelSpec for COSMO vertical advection (NERO, thesis Ch. 3).

The validation cases' shapes, the tolerance and the input generator are
copies of the JAX package's ``repro/kernels/vadvc/spec.py``. The tune
space and the cost model are the Hopper kernel's own: a block of
``tile_x`` x ``tile_y`` columns, one thread each, with 2 nz floats of
shared memory a column (see ``csrc/vadvc.cu``), costed by
``core.autotune.stream_time``.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.configs.cosmo_stencil import cosmo_grid
from repro_torch.core.autotune import MAX_THREADS, stream_time
from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.vadvc import ref
from repro_torch.kernels.vadvc.vadvc import smem_bytes, vadvc

FLOPS_PER_POINT = 25.0
DEFAULT_SHAPE = {"nz": 16, "ny": 8, "nx": 32}
_G = cosmo_grid()                                # COSMO production grid
BENCH_SHAPE = {"nz": _G.nz, "ny": _G.ny, "nx": _G.nx}
TUNE_SPACE = {"tile_x": (32, 64, 128), "tile_y": (1, 2, 4, 8)}


def vadvc_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple | None:
    """(shared bytes per block, estimated seconds); None when the block
    would exceed the card's threads per block. Bytes: four fields and
    wcon (a row of tile_x + 1 per block) read, upos read again by the
    backward sweep, out written; a thread keeps one level's six loads in
    flight."""
    nz, ny, nx = grid_shape
    tx, ty = tile["tile_x"], tile["tile_y"]
    if tx * ty > MAX_THREADS:
        return None
    smem = smem_bytes(nz, tx, ty)
    bx = math.ceil(nx / tx)
    field = nz * ny * nx * dtype_bytes
    wcon = (nz + 1) * ny * (nx + bx) * dtype_bytes
    t = stream_time(6 * field + wcon, bx * math.ceil(ny / ty), tx * ty, smem,
                    6 * dtype_bytes)
    return smem, math.inf if t is None else t


def example_inputs(shape=None, dtype=np.float32, seed: int = 0) -> dict:
    s = {**DEFAULT_SHAPE, **(shape or {})}
    nz, ny, nx = s["nz"], s["ny"], s["nx"]
    rng = np.random.default_rng(seed)
    return {
        "ustage": rng.normal(size=(nz, ny, nx)).astype(dtype),
        "upos": rng.normal(size=(nz, ny, nx)).astype(dtype),
        "utens": (rng.normal(size=(nz, ny, nx)) * 0.1).astype(dtype),
        "utens_stage": (rng.normal(size=(nz, ny, nx)) * 0.1).astype(dtype),
        "wcon": (rng.normal(size=(nz + 1, ny, nx + 1)) * 0.3).astype(dtype),
    }


SPEC = registry.register(KernelSpec(
    name="vadvc",
    fn=vadvc,
    ref_fn=ref.vadvc,
    arg_names=("ustage", "upos", "utens", "utens_stage", "wcon"),
    example_inputs=example_inputs,
    tol={"float32": 5e-5},
    cases=(
        KernelCase({"nz": 8, "ny": 4, "nx": 16}),
        KernelCase({"nz": 16, "ny": 8, "nx": 32}),
        KernelCase({"nz": 16, "ny": 8, "nx": 32}),
        KernelCase({"nz": 32, "ny": 4, "nx": 24}),
    ),
    tune_space=TUNE_SPACE,
    cost_fn=vadvc_cost,
    flops=lambda g: FLOPS_PER_POINT * g[0] * g[1] * g[2],
    grid_of=lambda ustage, *rest: tuple(ustage.shape),
    shape_keys=("nz", "ny", "nx"),
    default_shape=DEFAULT_SHAPE,
    bench_shape=BENCH_SHAPE,
))
