"""KernelSpec for COSMO vertical advection (NERO, thesis Ch. 3).

The validation cases' shapes, the tolerance and the input generator are
copies of the JAX package's ``repro/kernels/vadvc/spec.py``. The tune
space and the cost model are the Hopper kernel's own: a block of
``tile_x`` x ``tile_y`` columns, one thread each, with 3 nz floats of
shared memory a column, on the "prefetch" route that every grid takes
(see ``csrc/vadvc.cu``), costed by ``core.autotune.stream_time``. The
tune space stops at 512 threads, the kernel's launch bound.

`work` is the function's work, the same for every route and for the
plain version: the four fields and wcon read and out written once,
`FLOPS_PER_POINT` a cell off the tensor cores. The cost counter
(`repro_torch.core.hlo_cost`) records it for each call and
`chip_smoke.py` bounds the kernel by it.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.configs.cosmo_stencil import cosmo_grid
from repro_torch.core.autotune import MEM_LATENCY_S, stream_time
from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.vadvc import ref
from repro_torch.kernels.vadvc.vadvc import (AHEAD, PREFETCH_MAX_THREADS,
                                             smem_bytes, vadvc)

FLOPS_PER_POINT = 25.0
DEFAULT_SHAPE = {"nz": 16, "ny": 8, "nx": 32}
_G = cosmo_grid()                                # COSMO production grid
BENCH_SHAPE = {"nz": _G.nz, "ny": _G.ny, "nx": _G.nx}
TUNE_SPACE = {"tile_x": (32, 64, 128), "tile_y": (1, 2, 4)}
# The prefetch route's costs: a level of a column's dependent chain
# (stated from the instructions: the reciprocal and about 20 fp32
# operations forward, a product and two differences backward), and the
# share of the memory rate its six streams of 4-byte loads and its stores
# reach, fitted by `tools/stencil_fit.py` to `chip_smoke.py`'s stencil
# sweep at the COSMO grid (PERF.md).
FWD_LEVEL_S = 3e-8
BWD_LEVEL_S = 5e-9
STREAM_EFFICIENCY = 0.756


def vadvc_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple | None:
    """(shared bytes per block, estimated seconds); None when the block
    would exceed the prefetch kernel's threads per block. Bytes: four
    fields and wcon (a row of tile_x + 1 per block) read once, out
    written, at `STREAM_EFFICIENCY` of the memory rate, `AHEAD` levels of
    six loads in flight a thread; the blocks in waves of as many as the
    SMs hold, a wave taking at least one column's chain of 2 nz levels
    after its first loads."""
    nz, ny, nx = grid_shape
    tx, ty = tile["tile_x"], tile["tile_y"]
    if tx * ty > PREFETCH_MAX_THREADS:
        return None
    smem = smem_bytes(nz, tx, ty)
    bx = math.ceil(nx / tx)
    field = nz * ny * nx * dtype_bytes
    wcon = (nz + 1) * ny * (nx + bx) * dtype_bytes
    chain = MEM_LATENCY_S + nz * (FWD_LEVEL_S + BWD_LEVEL_S)
    t = stream_time((5 * field + wcon) / STREAM_EFFICIENCY,
                    bx * math.ceil(ny / ty), tx * ty, smem,
                    AHEAD * 6 * dtype_bytes, min_wave_s=chain)
    return smem, math.inf if t is None else t


def work(ustage, upos, utens, utens_stage, wcon) -> dict:
    """{"bytes", "flops": {"fp32": flops}} of one call: the five inputs
    and out each once, `FLOPS_PER_POINT` flops a cell."""
    fields = (ustage, upos, utens, utens_stage, wcon)
    return {"bytes": sum(t.numel() * t.element_size() for t in fields)
            + ustage.numel() * ustage.element_size(),
            "flops": {"fp32": FLOPS_PER_POINT * ustage.numel()}}


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
