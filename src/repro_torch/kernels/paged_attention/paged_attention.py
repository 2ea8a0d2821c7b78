"""Paged attention: the wrapper of the CUDA kernels in
``csrc/paged_attention.cu``.

Three routes, chosen by `route` from q's dtype, the query rows per kv
head (k * g) and the head dim alone: "split" (``csrc/paged_split.cuh``)
for at most 64 rows (decode, the k = 4 verify) at head dims 16-256 that
are powers of two, the positions split over blocks whose count `split_plan`
takes from static shapes (never from the lengths, which would be a read
from the card): by default from the SM count, or ``pages_per_block``
whole pages a block (the route's tile, `TILE_SPACE`); "wgmma" (the Hopper tensor-core kernel of
``csrc/paged_attention.cu``) for bf16 q at more rows (chunk-fill steps)
and head dims 64, 128, 256; "simt" (``csrc/paged_simt.cuh``, the first
port) for the rest. On CUDA tensors `paged_attention` checks its
arguments, allocates the output and launches its route's kernel on the
current stream, or raises: no route is ever taken because another
failed, and there is no fallback to the plain version. On CPU tensors it
runs the plain version (`repro_torch.kernels.paged_attention.ref`).
``paged_attention.launches`` counts kernel launches (one per call),
``paged_attention.launches_by_route`` splits them by route, and
``paged_attention.plain_calls`` counts the calls that went to the plain
version because the tensors lay on the CPU. The split route's launches
on one device share a counter buffer: launch them on one stream. Under
the cost counter (`repro_torch.core.hlo_cost`) a call is one entry of its
function's work (`spec.work`, which reads the lengths of a real tensor
and counts capacity on ``meta``; `repro_torch.kernels.count`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import count
from repro_torch.kernels.paged_attention import ref

MAX_HEAD_DIM = 256
ROUTES = ("split", "wgmma", "simt")
SPLIT_MAX_ROWS = 64          # k * g rows per kv head on the split route
SPLIT_HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_SPLITS = 64              # split::kMaxSplits
# the split route's launch shape: whole pages a block walks; 0 is the
# plan from the SM count (`split_plan`), the route's launch before tiles
TILE_SPACE = {"pages_per_block": (0, 1, 2, 4, 8, 16, 32)}
WGMMA_HEAD_DIMS = (64, 128, 256)
LOG2E = math.log2(math.e)
_DTYPES = (torch.float32, torch.bfloat16)


def route(q_dtype, rows: int, d: int) -> str:
    """The kernel a launch takes for `rows` = k * g query rows per kv head
    at head dim `d`: "split" for at most 64 rows at d in
    `SPLIT_HEAD_DIMS`, "wgmma" for bf16 q at more rows and d in
    `WGMMA_HEAD_DIMS`, else "simt"."""
    if rows <= SPLIT_MAX_ROWS:
        return "split" if d in SPLIT_HEAD_DIMS else "simt"
    if q_dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def split_tile(d: int) -> int:
    """Positions per tile of the split route (split::tile_positions)."""
    return 32 if d <= 128 else 16


def split_plan(b: int, hkv: int, positions: int, d: int, sms: int, *,
               page_tokens: int = 0,
               pages_per_block: int = 0) -> tuple[int, int]:
    """(splits, positions per split) for the split route. With
    ``pages_per_block`` > 0 every split walks that many whole pages of
    ``page_tokens`` (a `ValueError` when that is not a whole number of
    tiles or needs more than `MAX_SPLITS`); with 0, enough splits that b
    * hkv * splits blocks fill `sms` SMs twice, at most one per tile of
    the table's `positions` (slots * T) and `MAX_SPLITS`; each split a
    whole number of tiles, together covering every position."""
    tp = split_tile(d)
    if pages_per_block:
        chunk = pages_per_block * page_tokens
        splits = -(-positions // chunk) if chunk > 0 else 0
        if chunk <= 0 or chunk % tp or splits > MAX_SPLITS:
            raise ValueError(
                f"paged_attention: pages_per_block={pages_per_block} of "
                f"{page_tokens} positions is not a whole number of "
                f"{tp}-position tiles in at most {MAX_SPLITS} splits of "
                f"{positions} positions")
        return splits, chunk
    want = -(-2 * sms // (b * hkv))
    splits = max(1, min(want, -(-positions // tp), MAX_SPLITS))
    chunk = -(-(-(-positions // splits)) // tp) * tp
    return -(-positions // chunk), chunk


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: dict = {}     # device index -> int32 zeros, one per (b, kv head)


def split_scratch(device, b: int, hkv: int, kg: int, d: int,
                  positions: int, *, page_tokens: int = 0,
                  pages_per_block: int = 0) -> tuple:
    """The split route's plan (`split_plan`) and scratch for a launch:
    ``(splits, chunk, (m, l) pointer, accumulator pointer, counters
    pointer, keep)``; the pointers stay valid while ``keep`` is
    referenced."""
    splits, chunk = split_plan(b, hkv, positions, d, _sm_count(device.index),
                               page_tokens=page_tokens,
                               pages_per_block=pages_per_block)
    # (m, l) of every split's rows, then (16-byte aligned) their
    # accumulators; one split writes O itself and needs none
    n_rows = b * hkv * splits * kg if splits > 1 else 0
    n_ml = -(-2 * n_rows // 4) * 4
    part = torch.empty(n_ml + n_rows * d, device=device)
    counters = _counters(device, b * hkv)
    return (splits, chunk, part.data_ptr(), part.data_ptr() + 4 * n_ml,
            counters.data_ptr(), (part, counters))


def _counters(device, n: int):
    """The split route's completion counters: zeros, which every launch
    leaves at zero."""
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("paged_attention")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.paged_attention_launch.argtypes = (
        [vp] * 10 + [i32] * 5 + [i64, i32, i32, i64, ctypes.c_float,
                                 i32, i32, vp])
    lib.paged_attention_launch.restype = i32
    lib.paged_attention_split_launch.argtypes = (
        [vp] * 13 + [i32] * 5 + [i64, i32, i32, i64, ctypes.c_float]
        + [i32] * 4 + [vp])
    lib.paged_attention_split_launch.restype = i32
    lib.paged_attention_wgmma_launch.argtypes = (
        [vp] * 10 + [i32] * 5 + [i64, i32, i32, i64, ctypes.c_float, i32,
                                 vp])
    lib.paged_attention_wgmma_launch.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
           page_table, lengths, layer):
    stacked = k_pages.ndim == 5
    if stacked and layer is None:
        raise ValueError("layer-stacked pools need a layer index")
    if not stacked and layer is not None:
        raise ValueError("layer index given but pools are not layer-stacked")
    if k_pages.ndim not in (4, 5) or q.ndim not in (3, 4):
        raise ValueError(f"q {tuple(q.shape)} / pools {tuple(k_pages.shape)}:"
                         f" expected (b, [k,] hq, d) and ([L,] P, T, hkv, d)")
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "k_quant": k_quant, "v_quant": v_quant, "k_scale": k_scale,
               "v_scale": v_scale, "page_table": page_table,
               "lengths": lengths}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES:
        raise TypeError(f"q {q.dtype} / pools {k_pages.dtype}: the kernel "
                        f"takes float32 or bfloat16")
    for name in ("v_pages", "k_scale", "v_scale"):
        if tensors[name].dtype != k_pages.dtype:
            raise TypeError(f"{name} {tensors[name].dtype} != k_pages "
                            f"{k_pages.dtype}")
    for name in ("k_quant", "v_quant"):
        if tensors[name].dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {tensors[name].dtype}")
    for name in ("page_table", "lengths"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    pool_shape = tuple(k_pages.shape)
    hkv = pool_shape[-2]
    for name in ("v_pages", "k_quant", "v_quant"):
        if tuple(tensors[name].shape) != pool_shape:
            raise ValueError(f"{name} {tuple(tensors[name].shape)} != "
                             f"k_pages {pool_shape}")
    for name in ("k_scale", "v_scale"):
        if tuple(tensors[name].shape) != pool_shape[:-1]:
            raise ValueError(f"{name} {tuple(tensors[name].shape)} != "
                             f"{pool_shape[:-1]}")
    if pool_shape[-1] != d or d > MAX_HEAD_DIM or hq % hkv:
        raise ValueError(f"head dim {d} (pool {pool_shape[-1]}, max "
                         f"{MAX_HEAD_DIM}); hq {hq} must be a multiple of "
                         f"hkv {hkv}")
    if page_table.ndim != 2 or page_table.shape[0] != b or \
            tuple(lengths.shape) != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} for a batch of {b}")
    if stacked and not 0 <= int(layer) < pool_shape[0]:
        raise ValueError(f"layer {int(layer)} outside {pool_shape[0]} layers")
    rows = (q.shape[1] if q.ndim == 4 else 1) * (hq // hkv)
    kind = route(q.dtype, rows, d)
    if kind != "simt":
        # 16-byte copies of pool rows (and, on the wgmma route, of q rows)
        names = ("k_pages", "v_pages", "k_quant", "v_quant") + (
            ("q",) if kind == "wgmma" else ())
        for name in names:
            if tensors[name].data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned: the {kind} "
                                 f"route loads it 16 bytes at a time")
    return kind


def paged_attention(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
                    page_table, lengths, layer=None, *, softmax_scale=None,
                    pages_per_block: int = 0):
    """Same arguments and result as `ref.paged_attention`. Page-table
    entries must name pages of the pool; entries past a sequence's last
    page (``ceil((lengths[b] + k - 1) / T)``) are never read.
    ``pages_per_block`` is the split route's launch shape (`split_plan`);
    the wgmma and simt routes and the plain version read no tile."""
    args = (q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
            page_table, lengths, layer)

    def work():
        from repro_torch.kernels.paged_attention.spec import work
        return work(*args)

    def card_route():
        rows = (q.shape[1] if q.ndim == 4 else 1) * (q.shape[-2]
                                                     // k_pages.shape[-2])
        return route(q.dtype, rows, q.shape[-1])

    return count.call(
        "paged_attention", q.device, card_route, work,
        lambda: _run(*args, softmax_scale=softmax_scale,
                     pages_per_block=pages_per_block),
        lambda: torch.empty_like(q), inputs=(q,))


def _run(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
         page_table, lengths, layer, *, softmax_scale, pages_per_block=0):
    if not q.is_cuda:
        paged_attention.plain_calls += 1
        return ref.paged_attention(q, k_pages, v_pages, k_quant, v_quant,
                                   k_scale, v_scale, page_table, lengths,
                                   layer, softmax_scale=softmax_scale)
    kind = _check(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
                  page_table, lengths, layer)
    if pages_per_block not in TILE_SPACE["pages_per_block"]:
        raise ValueError(f"paged_attention: pages_per_block="
                         f"{pages_per_block} not in {TILE_SPACE}")
    rows = q.shape[1] if q.ndim == 4 else 1
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    pages, t, hkv = k_pages.shape[-4], k_pages.shape[-3], k_pages.shape[-2]
    slots = page_table.shape[1]
    lib = _lib()
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_quant.data_ptr(), v_quant.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr())
    lyr = 0 if layer is None else int(layer)
    q_bf16 = int(q.dtype == torch.bfloat16)
    pool_bf16 = int(k_pages.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "split":
            splits, chunk, *scratch, _keep = split_scratch(
                q.device, b, hkv, rows * (hq // hkv), d, slots * t,
                page_tokens=t, pages_per_block=pages_per_block)
            err = lib.paged_attention_split_launch(
                *ptrs, *scratch, b, rows, hq, hkv, d, pages, t, slots, lyr,
                scale, splits, chunk, q_bf16, pool_bf16, stream)
        elif kind == "wgmma":
            err = lib.paged_attention_wgmma_launch(
                *ptrs, b, rows, hq, hkv, d, pages, t, slots, lyr,
                scale * LOG2E, pool_bf16, stream)
        else:
            err = lib.paged_attention_launch(
                *ptrs, b, rows, hq, hkv, d, pages, t, slots, lyr, scale,
                q_bf16, pool_bf16, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed ({kind} "
                           f"route): "
                           f"{lib.paged_attention_error_string(err).decode()}")
    paged_attention.launches += 1
    paged_attention.launches_by_route[kind] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
paged_attention.plain_calls = 0
