"""KernelSpec for the RG-LRU linear recurrence.

The validation cases, tolerance and input generator are copies of the
JAX package's ``repro/kernels/rglru_scan/spec.py`` (the decode-shaped
S = 1 and S = 4 cases included). The tune space is the chunked route's
``chunk`` (the reference's name): 32, 64, 128 or 256 positions
(`rglru_scan.CHUNKS`), 32 the launch before tiles; the route follows
from S and the chunk (`rglru_scan.route`: serial when S fits one
chunk). `rglru_cost` is the Hopper model the knee is taken from; `work`
does not depend on the tile.

`work` is the function's work, the same for every route and for the
plain version: a and b read and h written once, a multiply and an add
per element. The cost counter (`repro_torch.core.hlo_cost`) records it
for each call and `chip_smoke.py` bounds the kernel by it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.autotune import HBM_BW, LAUNCH_OVERHEAD_S
from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.rglru_scan import ref
from repro_torch.kernels.rglru_scan.rglru_scan import CHUNK, CHUNKS, \
    route, rglru_scan

DEFAULT_SHAPE = {"B": 2, "S": 128, "W": 32}
# the main path's hybrid prefill: recurrentgemma-2b, 2 prompts of 2300
BENCH_SHAPE = {"B": 2, "S": 2300, "W": 2560}
TUNE_SPACE = {"chunk": CHUNKS}
# Fitted by `tools/serve_fit.py` to the kernel phase's tile sweeps on an
# H100 80GB HBM3 at 700 W (log(estimate / measured) by least squares over
# every chunk of every swept grid): one thread's step of the recurrence, a
# dependent FMA on loads it waits for.
ROW_STEP_S = 2.52e-7


def rglru_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple:
    """(0 shared bytes, estimated seconds): the longer of the bytes and
    one thread's chain. Chunked route (S over one chunk): a and b read
    twice (the aggregates' launch and the apply's), h written once; a
    thread walks the carry over the earlier chunks and then its own chunk
    (nc + chunk steps of `ROW_STEP_S`); two launches. Serial route: a, b
    and h once, a thread walks all S positions; one launch."""
    B, S, W = grid_shape
    q = tile["chunk"]
    elems = B * S * W * 4
    if route(S, q) == "serial":
        return 0, max(3 * elems / HBM_BW, S * ROW_STEP_S) \
            + LAUNCH_OVERHEAD_S
    nc = -(-S // q)
    return 0, max(5 * elems / HBM_BW, (nc + q) * ROW_STEP_S) \
        + 2 * LAUNCH_OVERHEAD_S


def work(a, b) -> dict:
    """{"bytes", "flops": {"fp32": flops}} of one call: a, b and h each
    once, 2 flops per element."""
    return {"bytes": a.numel() * a.element_size()
            + b.numel() * b.element_size() + a.numel() * 4,
            "flops": {"fp32": 2 * a.numel()}}


def example_inputs(shape=None, dtype=np.float32, seed: int = 0) -> dict:
    s = {**DEFAULT_SHAPE, **(shape or {})}
    B, S, W = s["B"], s["S"], s["W"]
    rng = np.random.default_rng(seed)
    return {
        "a": rng.uniform(0.85, 0.999, size=(B, S, W)).astype(dtype),
        "b": (rng.normal(size=(B, S, W)) * 0.1).astype(dtype),
    }


SPEC = registry.register(KernelSpec(
    name="rglru_scan",
    fn=rglru_scan,
    ref_fn=ref.lru_scan,
    arg_names=("a", "b"),
    example_inputs=example_inputs,
    tol={"float32": 1e-5},
    cases=(
        KernelCase({"B": 2, "S": 64, "W": 32}),
        KernelCase({"B": 1, "S": 128, "W": 64}),
        KernelCase({"B": 3, "S": 96, "W": 16}),
        # decode-shaped steps (the serve path's per-token shapes)
        KernelCase({"B": 4, "S": 1, "W": 64}),
        KernelCase({"B": 2, "S": 4, "W": 32}),
    ),
    tune_space=TUNE_SPACE,
    cost_fn=rglru_cost,
    grid_of=lambda a, b: tuple(a.shape),
    shape_keys=("B", "S", "W"),
    fixed_tile=lambda grid: {"chunk": CHUNK},
    default_shape=DEFAULT_SHAPE,
    bench_shape=BENCH_SHAPE,
))
