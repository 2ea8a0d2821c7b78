"""KernelSpec for blocked flash attention (prefill).

The validation cases, tolerances and input generator are copies of the
JAX package's ``repro/kernels/flash_attention/spec.py`` so that the CPU
tests and `chip_smoke.py` hold the kernel to the same cases. The launch
shapes are fixed by the route (`flash_attention.route`), so the spec has
no tunable tiles: the wgmma route (bf16, d = 64, 128, 256) runs 128 query
positions of one head per block against key tiles of 128 (64 at d =
256); the simt route about 64 query rows per block (positions times the
g heads of a kv head) against key tiles of 32.

`work` is the function's least work, the same for every route and for
the plain version: the bytes of q, k, v and the output, each once, and
4 d flops per (query, key) pair the causal mask or the window lets
through. The cost counter (`repro_torch.core.hlo_cost`) records it for
each call and `chip_smoke.py` bounds the kernel by it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention

DEFAULT_SHAPE = {"b": 2, "sq": 128, "skv": 128, "hq": 4, "hkv": 2, "d": 64}


def visible_pairs(sq: int, skv: int, causal: bool = True,
                  window: int = 0) -> int:
    """(query, key) pairs the mask lets through, queries and keys aligned
    at 0: with `causal` key kp is visible to query qp when kp <= qp, with
    `window` when kp > qp - window (the sum over queries in closed
    form)."""
    if causal:
        m = min(sq, skv)
        pairs = m * (m + 1) // 2 + (sq - m) * skv
    else:
        pairs = sq * skv
    if window:
        n = max(0, sq - window)
        pairs -= n * (n + 1) // 2
    return pairs


def work(q, k, v, *, causal: bool = True, window: int = 0,
         softmax_scale=None) -> dict:
    """{"bytes", "flops": {rate class: flops}} of one call: q, k, v and
    the output each once; 4 d flops per visible pair (`visible_pairs`),
    on the tensor cores ("bf16") for bf16 inputs, else "fp32"."""
    del softmax_scale
    b, sq, hq, d = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * b * hq * d * visible_pairs(sq, k.shape[1], causal, window)
    cls = "bf16" if q.dtype in (torch.bfloat16, torch.float16) else "fp32"
    return {"bytes": nbytes, "flops": {cls: flops}}


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
