"""KernelSpec for the RG-LRU linear recurrence.

The validation cases, tolerance and input generator are copies of the
JAX package's ``repro/kernels/rglru_scan/spec.py`` (the decode-shaped
S = 1 and S = 4 cases included). The route follows from S alone (S = 1
and 4 serial, the others chunked) and its chunk length is fixed
(`rglru_scan.CHUNK`), so the spec has no tunable tiles.

`work` is the function's work, the same for every route and for the
plain version: a and b read and h written once, a multiply and an add
per element. The cost counter (`repro_torch.core.hlo_cost`) records it
for each call and `chip_smoke.py` bounds the kernel by it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.rglru_scan import ref
from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan

DEFAULT_SHAPE = {"B": 2, "S": 128, "W": 32}


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
))
