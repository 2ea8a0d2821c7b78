"""Prefill attention: the wrapper of the CUDA kernels in
``csrc/flash_attention.cu``.

Two routes, chosen by `route` from the dtype and the head dim alone:
"wgmma", the Hopper tensor-core kernel (TMA ring, warp-specialised), for
bf16 at head dims 64, 128 and 256; "simt", the fp32-FMA kernel of
``csrc/flash_simt.cuh``, for fp32 inputs (whose 5e-5 tolerance the tensor
cores cannot meet) and any other head dim. On CUDA tensors
`flash_attention` checks its arguments, allocates the output and launches
its route's kernel on the current stream, or raises: no route is ever
taken because another failed, and there is no fallback to the plain
version. On CPU tensors it runs the plain version
(`repro_torch.kernels.flash_attention.ref`). ``flash_attention.launches``
counts kernel launches, ``flash_attention.launches_by_route`` splits them
by route, and ``flash_attention.plain_calls`` counts the calls that went
to the plain version because the tensors lay on the CPU. Under the cost
counter (`repro_torch.core.hlo_cost`) a call is one entry of its
function's work (`spec.work`; `repro_torch.kernels.count`).

Under autograd (grad mode on and an input that requires grad) the call
goes through `FlashAttentionFn`: the forward as above, the backward by
recomputing the plain version under autograd from the saved q, k, v —
the reference's ``custom_vjp`` ("Pallas fwd, XLA bwd via the reference
formulation — recompute, no residuals"), with the causal mask, the
window, the GQA grouping and the softmax scale all reaching it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import count
from repro_torch.kernels.flash_attention import ref

MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128, 256)
ROUTES = ("wgmma", "simt")
LOG2E = math.log2(math.e)
_DTYPES = (torch.float32, torch.bfloat16)
# the wgmma route's launch shapes: query positions a block (one or two
# consumer warpgroups) and keys a tile of the K/V ring, each a template
# instance of csrc/flash_attention.cu where its shared memory fits a block
TILE_SPACE = {"block_q": (64, 128), "block_k": (64, 128)}
SMEM_BYTES = 232_448          # shared memory one block may use (227 KB)
STAGES = 2                    # depth of the K/V ring


def fixed_tile(d: int) -> dict:
    """The wgmma route's launch before tiles could be chosen: 128 query
    positions (two warpgroups), 128-key tiles, 64 at d = 256."""
    return {"block_q": 128, "block_k": 128 if d <= 128 else 64}


def wgmma_smem_bytes(d: int, block_q: int, block_k: int) -> int:
    """Dynamic shared memory of a wgmma block (csrc `Tile::kSmem`): 1024
    bytes of alignment slack, Q, `STAGES` K and V tiles, the barriers and
    the release counts."""
    return (1024 + block_q * d * 2 + 2 * STAGES * block_k * d * 2
            + 8 * (1 + 2 * STAGES) + 4 * STAGES)


def wgmma_launchable(d: int, block_q: int, block_k: int) -> bool:
    """True when csrc/flash_attention.cu builds this tile at head dim d."""
    return block_q in TILE_SPACE["block_q"] and \
        block_k in TILE_SPACE["block_k"] and \
        wgmma_smem_bytes(d, block_q, block_k) <= SMEM_BYTES


def route(dtype, d: int) -> str:
    """The kernel a launch on `dtype` inputs of head dim `d` takes:
    "wgmma" for bf16 at d in `WGMMA_HEAD_DIMS`, else "simt"."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "simt"


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("flash_attention")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [vp] * 4 + [i32] * 8 + [ctypes.c_float, i32, vp])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_wgmma_launch.argtypes = (
        [vp] * 4 + [i32] * 8 + [ctypes.c_float, i32, i32, vp])
    lib.flash_attention_wgmma_launch.restype = i32
    lib.flash_attention_wgmma_smem.argtypes = [i32] * 3
    lib.flash_attention_wgmma_smem.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (b, sq, hq, d) and "
                         f"(b, skv, hkv, d) twice")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} {x.dtype} != q {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q {q.dtype}: the kernel takes float32 or bfloat16")
    b, sq, hq, d = q.shape
    kb, skv, hkv, kd = k.shape
    if kb != b or kd != d or d > MAX_HEAD_DIM or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)}: batch and "
                         f"head dim must agree (max {MAX_HEAD_DIM}) and hq "
                         f"must be a multiple of hkv")
    if sq < 1 or skv < 1 or window < 0:
        raise ValueError(f"sq {sq}, skv {skv}, window {window}")
    if route(q.dtype, d) == "wgmma":
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned: the wgmma "
                                 f"route loads it by TMA")


def attention_vjp(q, k, v, grad_out, *, causal, window, softmax_scale):
    """(dq, dk, dv): autograd of `ref.attention` at (q, k, v) against
    `grad_out`, the forward recomputed."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref.attention(*leaves, causal=causal, window=window,
                            softmax_scale=softmax_scale)
        return torch.autograd.grad(out, leaves, grad_out)


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention`'s forward, `attention_vjp`'s backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale, tile):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softmax_scale)
        return _forward(q, k, v, causal=causal, window=window,
                        softmax_scale=softmax_scale, **tile)

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, softmax_scale = ctx.mask
        grads = attention_vjp(*ctx.saved_tensors, grad_out, causal=causal,
                              window=window, softmax_scale=softmax_scale)
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softmax_scale=None, block_q=None, block_k=None):
    """Same arguments and result as `ref.attention`: q (b, sq, hq, d), k and
    v (b, skv, hkv, d), any sq and skv. ``block_q`` / ``block_k`` set the
    wgmma route's launch shape (`TILE_SPACE`; None: `fixed_tile`); the
    simt route and the plain version read no tile. Differentiable
    (`FlashAttentionFn`, the forward at the same tile) when grad mode is
    on and an input requires grad."""
    tile = {"block_q": block_q, "block_k": block_k}
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, softmax_scale,
                                      tile)
    return _forward(q, k, v, causal=causal, window=window,
                    softmax_scale=softmax_scale, **tile)


def _forward(q, k, v, *, causal, window, softmax_scale, block_q=None,
             block_k=None):
    def work():
        from repro_torch.kernels.flash_attention.spec import work
        return work(q, k, v, causal=causal, window=window)

    return count.call(
        "flash_attention", q.device, lambda: route(q.dtype, q.shape[-1]),
        work, lambda: _run(q, k, v, causal=causal, window=window,
                           softmax_scale=softmax_scale, block_q=block_q,
                           block_k=block_k),
        lambda: torch.empty_like(q), inputs=(q, k, v))


def _run(q, k, v, *, causal, window, softmax_scale, block_q=None,
         block_k=None):
    if not q.is_cuda:
        flash_attention.plain_calls += 1
        return ref.attention(q, k, v, causal=causal, window=window,
                             softmax_scale=softmax_scale)
    _check(q, k, v, window)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    kind = route(q.dtype, d)
    lib = _lib()
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if kind == "wgmma":
        fixed = fixed_tile(d)
        bq = fixed["block_q"] if block_q is None else int(block_q)
        bk = fixed["block_k"] if block_k is None else int(block_k)
        if not wgmma_launchable(d, bq, bk):
            raise ValueError(f"flash_attention: block_q={bq}, block_k={bk} "
                             f"at d={d} is not a wgmma instance "
                             f"({TILE_SPACE}, within {SMEM_BYTES} bytes of "
                             f"shared memory)")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kind == "wgmma":
            err = lib.flash_attention_wgmma_launch(
                *ptrs, b, sq, skv, hq, hkv, d, int(bool(causal)), int(window),
                scale * LOG2E, bq, bk, stream)
        else:
            err = lib.flash_attention_launch(
                *ptrs, b, sq, skv, hq, hkv, d, int(bool(causal)), int(window),
                scale, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed ({kind} "
                           f"route): "
                           f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[kind] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention.plain_calls = 0
