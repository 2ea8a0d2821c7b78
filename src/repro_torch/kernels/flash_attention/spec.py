"""KernelSpec for blocked flash attention (prefill).

The validation cases, tolerances and input generator are copies of the
JAX package's ``repro/kernels/flash_attention/spec.py`` so that the CPU
tests and `chip_smoke.py` hold the kernel to the same cases. The launch
shapes are fixed by the route (`flash_attention.route`), so the spec has
no tunable tiles: the wgmma route (bf16, d = 64, 128, 256) runs 128 query
positions of one head per block against key tiles of 128 (64 at d =
256); the simt route about 64 query rows per block (positions times the
g heads of a kv head) against key tiles of 32.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention

DEFAULT_SHAPE = {"b": 2, "sq": 128, "skv": 128, "hq": 4, "hkv": 2, "d": 64}


def example_inputs(shape=None, dtype=np.float32, seed: int = 0) -> dict:
    s = {**DEFAULT_SHAPE, **(shape or {})}
    rng = np.random.default_rng(seed)
    return {
        "q": rng.normal(size=(s["b"], s["sq"], s["hq"], s["d"])).astype(dtype),
        "k": rng.normal(size=(s["b"], s["skv"], s["hkv"],
                              s["d"])).astype(dtype),
        "v": rng.normal(size=(s["b"], s["skv"], s["hkv"],
                              s["d"])).astype(dtype),
    }


SPEC = registry.register(KernelSpec(
    name="flash_attention",
    fn=flash_attention,
    ref_fn=ref.attention,
    arg_names=("q", "k", "v"),
    example_inputs=example_inputs,
    tol={"float32": 5e-5, "bfloat16": 0.03},
    cases=(
        KernelCase({"b": 2, "sq": 128, "skv": 128, "hq": 4, "hkv": 2,
                    "d": 64}),
        KernelCase({"b": 1, "sq": 256, "skv": 256, "hq": 8, "hkv": 1,
                    "d": 32}),
        KernelCase({"b": 2, "sq": 128, "skv": 128, "hq": 4, "hkv": 4,
                    "d": 64}, kwargs={"causal": False}),
        KernelCase({"b": 1, "sq": 256, "skv": 256, "hq": 2, "hkv": 2,
                    "d": 64}, kwargs={"window": 64}),
        KernelCase({"b": 1, "sq": 128, "skv": 128, "hq": 2, "hkv": 2,
                    "d": 128}, dtype="bfloat16"),
    ),
))
