"""Paged decode attention: the wrapper of the CUDA kernel in
``csrc/paged_attention.cu``.

On CUDA tensors `paged_attention` checks its arguments, allocates the
output and launches the kernel on the current stream, or raises: there
is no fallback. On CPU tensors it runs the plain version
(`repro_torch.kernels.paged_attention.ref`). ``paged_attention.launches``
counts kernel launches and ``paged_attention.plain_calls`` the calls
that went to the plain version because the tensors lay on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.paged_attention import ref

MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("paged_attention")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.paged_attention_launch.argtypes = (
        [vp] * 10 + [i32] * 5 + [i64, i32, i32, i64, ctypes.c_float,
                                 i32, i32, vp])
    lib.paged_attention_launch.restype = i32
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


def paged_attention(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
                    page_table, lengths, layer=None, *, softmax_scale=None):
    """Same arguments and result as `ref.paged_attention`. Page-table
    entries must name pages of the pool; entries past a sequence's last
    page (``ceil((lengths[b] + k - 1) / T)``) are never read."""
    if not q.is_cuda:
        paged_attention.plain_calls += 1
        return ref.paged_attention(q, k_pages, v_pages, k_quant, v_quant,
                                   k_scale, v_scale, page_table, lengths,
                                   layer, softmax_scale=softmax_scale)
    _check(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
           page_table, lengths, layer)
    rows = q.shape[1] if q.ndim == 4 else 1
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    pages, t, hkv = k_pages.shape[-4], k_pages.shape[-3], k_pages.shape[-2]
    lib = _lib()
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_quant.data_ptr(), v_quant.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, rows, hq, hkv, d, pages, t,
            page_table.shape[1], 0 if layer is None else int(layer), scale,
            int(q.dtype == torch.bfloat16),
            int(k_pages.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{lib.paged_attention_error_string(err).decode()}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.plain_calls = 0
