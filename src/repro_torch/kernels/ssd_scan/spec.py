"""KernelSpec for the Mamba2 SSD chunked scan.

The validation cases, tolerance and input generator are copies of the
JAX package's ``repro/kernels/ssd_scan/spec.py`` (the decode-shaped
S = 1 and S = 4 cases included), so that the CPU tests and
`chip_smoke.py` hold the kernel to the same cases (all of which take the
simt route: their P and N are below the wgmma route's). Each route's
chunk length is fixed (`ssd_scan.CHUNK`, `ssd_scan.WGMMA_CHUNK`), so the
spec has no tunable tiles.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

DEFAULT_SHAPE = {"B": 2, "S": 64, "H": 4, "P": 16, "G": 1, "N": 8}


def example_inputs(shape=None, dtype=np.float32, seed: int = 0) -> dict:
    s = {**DEFAULT_SHAPE, **(shape or {})}
    B, S, H, P, G, N = (s[k] for k in ("B", "S", "H", "P", "G", "N"))
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(B, S, H, P)).astype(dtype),
        "b_mat": (rng.normal(size=(B, S, G, N)) * 0.5).astype(dtype),
        "c_mat": (rng.normal(size=(B, S, G, N)) * 0.5).astype(dtype),
        "dt": np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(dtype),
        "a": (-np.exp(rng.uniform(0.0, 1.0, size=(H,)))).astype(dtype),
    }


SPEC = registry.register(KernelSpec(
    name="ssd_scan",
    fn=ssd_scan,
    ref_fn=ref.ssd_chunked,
    arg_names=("x", "b_mat", "c_mat", "dt", "a"),
    example_inputs=example_inputs,
    tol={"float32": 2e-4},
    cases=(
        KernelCase({"B": 2, "S": 64, "H": 4, "P": 16, "G": 1, "N": 8}),
        KernelCase({"B": 1, "S": 128, "H": 4, "P": 32, "G": 2, "N": 16}),
        KernelCase({"B": 2, "S": 64, "H": 6, "P": 8, "G": 3, "N": 8}),
        # decode-shaped steps (the serve path's per-token shapes)
        KernelCase({"B": 4, "S": 1, "H": 4, "P": 16, "G": 1, "N": 8}),
        KernelCase({"B": 1, "S": 4, "H": 4, "P": 16, "G": 2, "N": 8}),
    ),
))
