"""KernelSpec for COSMO horizontal diffusion (NERO, thesis Ch. 3).

The validation cases' shapes and dtypes, the tolerances and the input
generator are copies of the JAX package's ``repro/kernels/hdiff/spec.py``.
The tune space and the cost model are the Hopper kernel's own: a block of
``tile_x`` x ``tile_y`` threads over ``block_z`` planes (see
``csrc/hdiff.cu``), costed by ``core.autotune.stream_time``.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.configs.cosmo_stencil import cosmo_grid
from repro_torch.core.autotune import MAX_THREADS, stream_time
from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.hdiff import ref
from repro_torch.kernels.hdiff.hdiff import hdiff, smem_bytes

FLOPS_PER_POINT = 30.0
DEFAULT_SHAPE = {"nz": 8, "ny": 32, "nx": 48}
_G = cosmo_grid()                                # COSMO production grid
BENCH_SHAPE = {"nz": _G.nz, "ny": _G.ny, "nx": _G.nx}
TUNE_SPACE = {"tile_x": (32, 64, 128), "tile_y": (4, 8, 16, 32),
              "block_z": (1, 2, 4, 8)}


def hdiff_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple | None:
    """(shared bytes per block, estimated seconds); None when the block
    would exceed the card's threads per block. Each block reads its patch
    and halo, (ty+4)(tx+4)/(ty tx) times the patch, and writes the patch;
    its threads issue all block_z planes' loads before one barrier."""
    nz, ny, nx = grid_shape
    tx, ty, bz = tile["tile_x"], tile["tile_y"], tile["block_z"]
    if tx * ty > MAX_THREADS:
        return None
    smem = smem_bytes(tx, ty, bz)
    halo = (ty + 2 * ref.HALO) * (tx + 2 * ref.HALO) / (ty * tx)
    blocks = math.ceil(nz / bz) * math.ceil(ny / ty) * math.ceil(nx / tx)
    t = stream_time(nz * ny * nx * dtype_bytes * (halo + 1), blocks, tx * ty,
                    smem, bz * halo * dtype_bytes)
    return smem, math.inf if t is None else t


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
