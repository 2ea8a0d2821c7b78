"""KernelSpec for blocked flash attention (prefill).

The validation cases, tolerances and input generator are copies of the
JAX package's ``repro/kernels/flash_attention/spec.py`` so that the CPU
tests and `chip_smoke.py` hold the kernel to the same cases. The tune
space is the wgmma route's (bf16, d = 64, 128, 256), with the
reference's names: ``block_q`` query positions of one head a block (64
or 128: one or two consumer warpgroups) and ``block_k`` keys a tile of
the K/V ring (64 or 128), each pair a template instance where its shared
memory fits a block (`flash_attention.wgmma_launchable`); the launch
before tiles, 128 x 128 (128 x 64 at d = 256), is one of them
(`flash_attention.fixed_tile`). The simt route (about 64 query rows a
block against 32-key tiles) reads no tile; its cost is flat in it.
`flash_cost` is the Hopper model the knee is taken from; `work` does not
depend on the tile.

`work` is the function's least work, the same for every route and for
the plain version: the bytes of q, k, v and the output, each once, and
4 d flops per (query, key) pair the causal mask or the window lets
through. The cost counter (`repro_torch.core.hlo_cost`) records it for
each call and `chip_smoke.py` bounds the kernel by it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.autotune import (HBM_BW, ISSUE_PER_CLOCK,
                                       LAUNCH_OVERHEAD_S, NUM_SMS,
                                       PEAK_FLOPS, REGISTERS_PER_SM,
                                       SM_CLOCK_HZ, TENSOR_BF16_FLOPS,
                                       blocks_per_sm)
from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    TILE_SPACE, WGMMA_HEAD_DIMS, fixed_tile, flash_attention,
    wgmma_launchable, wgmma_smem_bytes)

DEFAULT_SHAPE = {"b": 2, "sq": 128, "skv": 128, "hq": 4, "hkv": 2, "d": 64}
# the main path's prefill: starcoder2-7b, one 2048-token prompt
BENCH_SHAPE = {"b": 1, "sq": 2048, "skv": 2048, "hq": 36, "hkv": 4, "d": 128}
# The wgmma route's registers a thread (ptxas: 230-244) and bf16 pieces of
# P in P V, from the kernel's design; then, fitted by `tools/serve_fit.py`
# to the kernel phase's tile sweeps on an H100 80GB HBM3 at 700 W
# (log(estimate / measured) by least squares over every launchable tile
# of every swept grid and the knees `chip_smoke.py`'s audit timed beside
# the launch before tiles), warp instructions per score outside the products
# (scale, mask, max, exp2, sum, the 3-piece split), a key tile's fixed
# cost in a warpgroup (barrier waits, the row max and sum shuffles, the
# stage's release), and each instance's factor on its key tiles' time
# against the 128 x 128 instance's (what the products and instruction
# counts do not see: a warpgroup alone on its K/V ring, the stage's size;
# 64 query rows over 128-key tiles are the slowest).
WGMMA_REGISTERS = 256
P_PIECES = 3
SOFTMAX_INSTR = 8.7
KEY_TILE_S = 2.53e-6
TILE_FACTOR_Q64_K64 = 0.671
TILE_FACTOR_Q64_K128 = 1.16
TILE_FACTOR_Q128_K64 = 0.698


def flash_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple | None:
    """(shared bytes per block, estimated seconds) of a causal call (the
    prefill's mask). wgmma route (bf16, d in 64, 128, 256): each block of
    ``block_q`` positions walks the ``block_k``-key tiles its causal rows
    see; a tile costs the SM its products (QK^T and 3 pieces of P V at
    the tensor-core rate) and its softmax's instructions, overlapped when
    the SM holds two warpgroups or more and added when it holds one, plus
    `KEY_TILE_S`, times the instance's `TILE_FACTOR_*` (1 for 128 x
    128). The tiles spread over the SMs, and no call is shorter than its
    longest block, nor than its bytes at the memory rate: q, k, v and
    the output once, or, when more, the K and V tiles the blocks load,
    once per kv head (its q heads' blocks share them through L2). None
    where the tile is not built (shared memory). Other routes read no
    tile: the bytes and the flops at the fp32 rate, the same for every
    tile."""
    b, sq, skv, hq, hkv, d = grid_shape
    nbytes = (2 * b * sq * hq + 2 * b * skv * hkv) * d * dtype_bytes
    if dtype_bytes != 2 or d not in WGMMA_HEAD_DIMS:
        flops = 4 * b * hq * d * visible_pairs(sq, skv)
        return 0, max(nbytes / HBM_BW, flops / PEAK_FLOPS) \
            + LAUNCH_OVERHEAD_S
    bq, bk = tile["block_q"], tile["block_k"]
    if not wgmma_launchable(d, bq, bk):
        return None
    smem = wgmma_smem_bytes(d, bq, bk)
    threads = 128 * (bq // 64)
    per_sm = min(blocks_per_sm(threads, smem),
                 REGISTERS_PER_SM // (threads * WGMMA_REGISTERS))
    if not per_sm:
        return None
    nqb = -(-sq // bq)
    walks = [-(-min(skv, (j + 1) * bq) // bk) for j in range(nqb)]
    mma = 2 * bq * bk * d * (1 + P_PIECES) / (TENSOR_BF16_FLOPS / NUM_SMS)
    soft = bq * bk * SOFTMAX_INSTR / 32 / (ISSUE_PER_CLOCK * SM_CLOCK_HZ)
    factor = {(64, 64): TILE_FACTOR_Q64_K64, (64, 128): TILE_FACTOR_Q64_K128,
              (128, 64): TILE_FACTOR_Q128_K64}.get((bq, bk), 1.0)
    alone = (mma + soft + KEY_TILE_S) * factor
    shared = ((max(mma, soft) if per_sm * bq // 64 >= 2 else mma + soft)
              + KEY_TILE_S / per_sm) * factor
    kv_reads = b * hkv * sum(walks) * bk * d * 2 * dtype_bytes
    t = max(b * hq * sum(walks) * shared / NUM_SMS, max(walks) * alone,
            max(nbytes, kv_reads) / HBM_BW)
    return smem, t + LAUNCH_OVERHEAD_S


def _grid_of(q, k, *rest):
    b, sq, hq, d = q.shape
    return b, sq, k.shape[1], hq, k.shape[2], d


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
    tune_space=TILE_SPACE,
    cost_fn=flash_cost,
    grid_of=_grid_of,
    shape_keys=("b", "sq", "skv", "hq", "hkv", "d"),
    fixed_tile=lambda grid: fixed_tile(grid[-1]),
    default_shape=DEFAULT_SHAPE,
    bench_shape=BENCH_SHAPE,
    dtypes=("float32", "bfloat16"),
))
