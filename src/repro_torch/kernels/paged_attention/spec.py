"""KernelSpec for paged decode attention.

The validation cases, tolerances and input generator are copies of the
JAX package's ``repro/kernels/paged_attention/spec.py`` so that the CPU
tests and `chip_smoke.py` hold the kernel to the same cases; one wide
case of the port's own follows them. Every route takes one kv head a
block; the split route's positions a block are its tile (below).

`work` is the function's least work, the same for every route and for
the plain version: q and the output once, and for every position a row
can see the float, int8 and scale entries of K and V once. It depends on
the lengths: on a real tensor it reads them (from the card, a sync), on
``meta`` it counts every sequence at the table's capacity, and the
record says which. The cost counter (`repro_torch.core.hlo_cost`)
records it for each call and `chip_smoke.py` bounds the kernel by it.

The tune space is the split route's: ``pages_per_block``, the whole
pages each block walks (0: the plan from the SM count, the route's
launch before tiles; `paged_attention.split_plan`). The reference's
``head_block`` has no counterpart: every route takes one kv head a block
with all its k * g query rows, so that K and V are read once. The wgmma
and simt routes read no tile, and their cost is flat in it.
`paged_cost` is the Hopper model the knee is taken from; `work` does not
depend on the tile.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.autotune import (HBM_BW, LAUNCH_OVERHEAD_S, NUM_SMS,
                                       stream_time)
from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    TILE_SPACE, paged_attention, route, split_plan, split_tile)
from repro_torch.kernels.paged_attention.quant import quantize_page

DEFAULT_SHAPE = {"b": 2, "pages": 16, "page_tokens": 16, "slots": 4,
                 "hq": 4, "hkv": 2, "d": 32, "k": 1}
# the main path's decode: starcoder2-7b, 4 rows, 128-token pages
BENCH_SHAPE = {"b": 4, "pages": 512, "page_tokens": 128, "slots": 24,
               "hq": 36, "hkv": 4, "d": 128, "k": 1}
SPLIT_THREADS = 256
POOL_BYTES = 4           # the serving pools' float tier is float32
# Fitted by `tools/serve_fit.py` to the kernel phase's tile sweeps on an
# H100 80GB HBM3 at 700 W (log(estimate / measured) by least squares over
# every launchable tile of every swept grid): a block's set-up, q load and
# partial write, the rate at which one block walks its tiles' bytes
# (loads in a ring of two), its fp32 math per query row and position, and
# the combine's read of the partials by the last block of a (sequence,
# kv head).
SPLIT_BLOCK_S = 4.45e-6
SPLIT_BLOCK_BW = 1.77e10         # bytes/s one block walks
SPLIT_ROW_POS_S = 7.13e-9        # s a block spends per (query row, position)
SPLIT_COMBINE_BW = 7.49e10       # bytes/s of partials the last block reads


def split_smem_bytes(kg: int, d: int, pool_bytes: int = POOL_BYTES) -> int:
    """Dynamic shared memory of a split block (csrc `split::Smem::total`)
    for kg = k * g query rows at head dim d."""
    tp = split_tile(d)
    kf, vf, i8 = tp * (d + 4) * 4, tp * d * 4, tp * d
    raw = 0 if pool_bytes == 4 else tp * d * 2
    stage = kf + vf + 2 * i8 + 2 * raw
    main = 2 * kg * d * 4 + 2 * stage + kg * tp * 4 + 16 * kg + 8 * tp + 16
    return max(main, 64 * kg * 12 + kg * 4 + 16)


def paged_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple | None:
    """(shared bytes per block, estimated seconds) of one call on the
    route its shapes take, q of `dtype_bytes` (2: bf16) and float32
    pools, every sequence at the table's capacity (the model sees no
    lengths). Split route: b * hkv * splits blocks in waves, each wave
    the longer of its bytes at the memory rate (`stream_time`: the
    bytes in flight of a tile a block) and one block's walk
    (`SPLIT_BLOCK_S` + for each position it walks, at most the table's,
    the longer of its bytes at `SPLIT_BLOCK_BW` and its k * g rows' math
    at `SPLIT_ROW_POS_S`), then the
    combine's read of every split's partials; None when
    ``pages_per_block`` does not split the positions into whole tiles
    in at most `MAX_SPLITS`. Other routes read no tile: their bytes at
    the memory rate and one launch, the same for every tile."""
    b, t, slots, hq, hkv, d, k = grid_shape
    kg = k * (hq // hkv)
    q_dtype = torch.bfloat16 if dtype_bytes == 2 else torch.float32
    positions = slots * t
    per_pos = 2 * (d * (POOL_BYTES + 1) + POOL_BYTES)
    nbytes = b * hkv * positions * per_pos + 2 * b * k * hq * d * dtype_bytes
    if route(q_dtype, kg, d) != "split":
        return 0, nbytes / HBM_BW + LAUNCH_OVERHEAD_S
    try:
        splits, chunk = split_plan(b, hkv, positions, d, NUM_SMS,
                                   page_tokens=t,
                                   pages_per_block=tile["pages_per_block"])
    except ValueError:
        return None
    smem = split_smem_bytes(kg, d)
    tp = split_tile(d)
    walked = -(-min(chunk, positions) // tp) * tp
    walk = SPLIT_BLOCK_S + walked * max(per_pos / SPLIT_BLOCK_BW,
                                        kg * SPLIT_ROW_POS_S)
    t_run = stream_time(nbytes, b * hkv * splits, SPLIT_THREADS, smem,
                        tp * per_pos / SPLIT_THREADS, min_wave_s=walk)
    if t_run is None:
        return None
    combine = splits * kg * (d + 2) * 4 / SPLIT_COMBINE_BW \
        if splits > 1 else 0.0
    return smem, t_run + combine


def _grid_of(q, k_pages, *rest):
    """(b, page_tokens, slots, hq, hkv, d, k) of a call: its grid shape
    (`shape_keys`), flat or layer-stacked pools alike. The pool's page
    count is left out: no route's cost depends on it, and a pool that
    grows (the numpy mode's, padded to a power of two) would key a new
    knee at every size."""
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    k = q.shape[1] if q.ndim == 4 else 1
    t, hkv = k_pages.shape[-3], k_pages.shape[-2]
    return b, t, rest[5].shape[1], hq, hkv, d, k


def work(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
         page_table, lengths, layer=None, *, softmax_scale=None) -> dict:
    """{"bytes", "flops": {"fp32": flops}, "lengths"} of one call, k query
    rows per sequence (q (b, k, hq, d), or (b, hq, d) for k = 1), row r
    seeing lengths[b] + r positions. Bytes: q and the output, and per
    visible position 2 hkv (d (float + int8) + scale) bytes, the table
    and the lengths. Flops: 4 hq d per (row, visible position), at the
    fp32 peak, the yardstick every route is held to. "lengths" is
    "read" or, on ``meta``, "capacity": each sequence at slots x T - (k
    - 1), its longest length."""
    del v_pages, k_quant, v_quant, v_scale, layer, softmax_scale
    rows = q.shape[1] if q.ndim == 4 else 1
    hq, d, hkv = q.shape[-2], q.shape[-1], k_pages.shape[-2]
    if lengths.device.type == "meta":
        cap = page_table.shape[1] * k_pages.shape[-3] - (rows - 1)
        lens, source = [cap] * lengths.shape[0], "capacity"
    else:
        lens, source = lengths.tolist(), "read"
    per_pos = 2 * hkv * (d * (k_pages.element_size() + 1)
                         + k_scale.element_size())
    span = sum(n + rows - 1 for n in lens)
    nbytes = (2 * q.numel() * q.element_size() + span * per_pos
              + page_table.numel() * page_table.element_size()
              + lengths.numel() * lengths.element_size())
    flops = 4 * hq * d * sum(rows * n + rows * (rows - 1) // 2
                             for n in lens)
    return {"bytes": nbytes, "flops": {"fp32": flops}, "lengths": source}


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


def head_sharded_specs(k: int = 1, *, data_axis: str = "data",
                       model_axis: str = "model",
                       layer_stacked: bool = True) -> dict:
    """The kernel's calling convention for mesh-sharded serving: a
    `sharding.partition.P` per argument (plus ``"out"``) such that every
    shard's call is LOCAL, with no page gathered from another shard.

    Page capacity shards over the data axis (each decode row's pages live
    on the shard that decodes it, so the page table holds local slot
    ids) and kv heads over the model axis. Query heads shard over the
    model axis too: query head ``h`` attends kv head ``h // (hq / hkv)``,
    so when the model axis divides ``hq`` and ``hkv`` shard ``s``'s
    contiguous q-head block is exactly the ``g`` query heads of each of
    its kv heads. Pools are the serve layer's layer-stacked ``(L, C, t,
    hkv, hd)`` tensors (``layer_stacked=False``: the flat layout);
    ``k > 1`` is the verify shape ``(b, k, hq, d)``."""
    from repro_torch.sharding.partition import P

    d, m = data_axis, model_axis
    ll = (None,) if layer_stacked else ()
    pool = P(*ll, d, None, m, None)
    scale = P(*ll, d, None, m)
    q = P(d, m, None) if k == 1 else P(d, None, m, None)
    return {
        "q": q,
        "k_pages": pool, "v_pages": pool,
        "k_quant": pool, "v_quant": pool,
        "k_scale": scale, "v_scale": scale,
        "page_table": P(d, None), "lengths": P(d),
        "layer": P(),
        "out": q,
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
    tune_space=TILE_SPACE,
    cost_fn=paged_cost,
    grid_of=_grid_of,
    shape_keys=("b", "page_tokens", "slots", "hq", "hkv", "d", "k"),
    fixed_tile=lambda grid: {"pages_per_block": 0},
    default_shape=DEFAULT_SHAPE,
    bench_shape=BENCH_SHAPE,
    dtypes=("float32", "bfloat16"),
))
