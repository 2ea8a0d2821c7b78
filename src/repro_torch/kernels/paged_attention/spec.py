"""KernelSpec for paged decode attention.

The validation cases, tolerances and input generator are copies of the
JAX package's ``repro/kernels/paged_attention/spec.py`` so that the CPU
tests and `chip_smoke.py` hold the kernel to the same cases; one wide
case of the port's own follows them. The launch shape is fixed (one block
per sequence, kv head and 64 query rows), so the spec has no tunable
tiles yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import paged_attention
from repro_torch.kernels.paged_attention.quant import quantize_page

DEFAULT_SHAPE = {"b": 2, "pages": 16, "page_tokens": 16, "slots": 4,
                 "hq": 4, "hkv": 2, "d": 32, "k": 1}


def example_inputs(shape=None, dtype=np.float32, seed: int = 0) -> dict:
    """Mixed-tier pool: odd page ids live in the slow (int8) tier, even in
    the fast (float) tier; each sequence gets distinct pages and a random
    valid length (>= 1). ``k > 1`` emits a (b, k, hq, d) q with lengths
    drawn so that the last row still fits the table."""
    s = {**DEFAULT_SHAPE, **(shape or {})}
    b, pages, t, slots = s["b"], s["pages"], s["page_tokens"], s["slots"]
    hq, hkv, d, k = s["hq"], s["hkv"], s["d"], s.get("k", 1)
    if b * slots > pages:
        raise ValueError("each sequence needs distinct pages")
    if k < 1 or slots * t - (k - 1) < 1:
        raise ValueError(f"k={k} rows do not fit {slots} x {t} positions")
    rng = np.random.default_rng(seed)

    def pool(raw):
        slow = (np.arange(pages) % 2 == 1)[:, None, None, None]
        quant, qscale = quantize_page(raw)     # the serve tier's format
        fast = np.where(slow, 0.0, raw).astype(dtype)
        qq = np.where(slow, quant, 0).astype(np.int8)
        sc = np.where(slow, qscale, 0.0)[..., 0].astype(dtype)
        return fast, qq, sc

    kf, kq, ks = pool(rng.normal(size=(pages, t, hkv, d)))
    vf, vq, vs = pool(rng.normal(size=(pages, t, hkv, d)))
    table = rng.permutation(pages)[:b * slots].reshape(b, slots)
    q_shape = (b, hq, d) if k == 1 else (b, k, hq, d)
    return {
        "q": rng.normal(size=q_shape).astype(dtype),
        "k_pages": kf, "v_pages": vf,
        "k_quant": kq, "v_quant": vq,
        "k_scale": ks, "v_scale": vs,
        "page_table": table.astype(np.int32),
        "lengths": rng.integers(1, slots * t - (k - 1) + 1, b)
        .astype(np.int32),
    }


SPEC = registry.register(KernelSpec(
    name="paged_attention",
    fn=paged_attention,
    ref_fn=ref.paged_attention,
    arg_names=("q", "k_pages", "v_pages", "k_quant", "v_quant",
               "k_scale", "v_scale", "page_table", "lengths"),
    example_inputs=example_inputs,
    tol={"float32": 5e-5, "bfloat16": 0.04},
    cases=(
        KernelCase({"b": 2, "pages": 16, "page_tokens": 16, "slots": 4,
                    "hq": 4, "hkv": 2, "d": 32}),
        KernelCase({"b": 1, "pages": 32, "page_tokens": 8, "slots": 8,
                    "hq": 8, "hkv": 4, "d": 64}),
        KernelCase({"b": 2, "pages": 12, "page_tokens": 16, "slots": 2,
                    "hq": 4, "hkv": 4, "d": 16}),
        KernelCase({"b": 2, "pages": 16, "page_tokens": 16, "slots": 4,
                    "hq": 4, "hkv": 2, "d": 32}, dtype="bfloat16"),
        # multi-query-row (speculative verify): k consecutive causal rows
        KernelCase({"b": 2, "pages": 16, "page_tokens": 16, "slots": 4,
                    "hq": 4, "hkv": 2, "d": 32, "k": 4}),
        KernelCase({"b": 1, "pages": 32, "page_tokens": 8, "slots": 8,
                    "hq": 8, "hkv": 4, "d": 64, "k": 3}),
        KernelCase({"b": 2, "pages": 16, "page_tokens": 16, "slots": 4,
                    "hq": 4, "hkv": 2, "d": 32, "k": 2}, dtype="bfloat16"),
        # the port's own (not in the JAX spec): a chunk-fill-wide step,
        # k = page_tokens rows at starcoder2-7b's g = 9 -- 288 query rows
        # per kv head, more than one block of rows
        KernelCase({"b": 2, "pages": 16, "page_tokens": 32, "slots": 4,
                    "hq": 18, "hkv": 2, "d": 32, "k": 32}),
    ),
))
