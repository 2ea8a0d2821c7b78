"""Mamba2 SSD prefill scan: the wrapper of the CUDA kernels in
``csrc/ssd_scan.cu``.

Two routes, chosen by `route` from static shapes alone: "wgmma", the
chunk-parallel tensor-core scan (chunks of ``chunk`` positions, one of
`WGMMA_CHUNKS`, `WGMMA_CHUNK` unless the caller picks; the fp32
operands in `WGMMA_PIECES` bf16 pieces; three CUDA launches a call),
for bf16 inputs at P = 64 and N = 64 or 128 (mamba2's prefill); "simt",
the first port's fp32-FMA kernel (``csrc/ssd_simt.cuh``), for fp32
inputs and every other shape. On CUDA tensors `ssd_scan` checks its
arguments, allocates the outputs and the route's scratch and launches on
the current stream, or raises: no route is taken because another failed,
and there is no fallback to the plain version. On CPU tensors it runs
the plain chunked version (`repro_torch.kernels.ssd_scan.ref.ssd_chunked`).
``ssd_scan.launches`` counts calls that launched (one per call, whatever
the number of CUDA launches inside), ``ssd_scan.launches_by_route``
splits them by route, and ``ssd_scan.plain_calls`` counts the calls that
went to the plain version because the tensors lay on the CPU. Under the
cost counter (`repro_torch.core.hlo_cost`) a call is one entry of its
function's work (`spec.work`; `repro_torch.kernels.count`).

Under autograd (grad mode on and an input that requires grad) the call
goes through `SsdScanFn`: the forward as above, the backward by
recomputing the plain chunked version under autograd from the saved
inputs, which gives the gradients of x, B, C, dt and a (a final state
that nothing uses sends no gradient).

``bf16_intra=True`` (the ``ssm_bf16_intra`` config) rounds the
intra-chunk scores to bf16, and x with them in their product, as the
reference's plain version does: ``ssd_scan_launch_bf16_intra``, the
same routes with one bf16 piece of each score on the wgmma route; on the
CPU `ref.ssd_chunked(bf16_intra=True)`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count
from repro_torch.kernels.ssd_scan import ref

CHUNK = 64               # the simt kernel's chunk length (positions per step)
MAX_STATE = 256          # largest state size N its shared memory takes
WGMMA_CHUNK = 128        # the wgmma route's default chunk (csrc kChunk)
WGMMA_CHUNKS = (64, 128)  # the chunks csrc builds the wgmma route for
WGMMA_PIECES = 2         # bf16 pieces of each fp32 tensor-core operand
WGMMA_HEAD_DIM = 64      # P: one warpgroup's 64 rows
WGMMA_STATES = (64, 128)  # N
ROUTES = ("wgmma", "simt")
_ROUTE_ARG = {"simt": 0, "wgmma": 1}     # ssd_scan_launch's `route`
_DTYPES = (torch.float32, torch.bfloat16)


def route(dtype, S: int, P: int, N: int, G: int) -> str:
    """The kernel a launch on `dtype` x, B, C of these shapes takes:
    "wgmma" for bf16 at P = `WGMMA_HEAD_DIM` and N in `WGMMA_STATES`, else
    "simt". Any S >= 1 (a short last chunk is masked) and any G dividing H
    take the route their dtype, P and N give."""
    del S, G
    return "wgmma" if dtype == torch.bfloat16 and P == WGMMA_HEAD_DIM \
        and N in WGMMA_STATES else "simt"


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("ssd_scan")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ssd_scan_launch, lib.ssd_scan_launch_bf16_intra):
        fn.argtypes = [vp] * 9 + [i32] * 9 + [vp]
        fn.restype = i32
    lib.ssd_scan_wgmma_smem.argtypes = [i32, i32]
    lib.ssd_scan_wgmma_smem.restype = i32
    lib.ssd_scan_wgmma_built.argtypes = [i32]
    lib.ssd_scan_wgmma_built.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    # every instance the wrapper may launch, and the one it sizes by default
    built = {q: lib.ssd_scan_wgmma_built(q) for q in WGMMA_CHUNKS}
    if not all(built.values()) or lib.ssd_scan_wgmma_chunk() != WGMMA_CHUNK \
            or lib.ssd_scan_wgmma_pieces() != WGMMA_PIECES:
        raise RuntimeError(f"csrc/ssd_scan.cu builds chunks {built}, default "
                           f"{lib.ssd_scan_wgmma_chunk()}, pieces "
                           f"{lib.ssd_scan_wgmma_pieces()}; the wrapper "
                           f"launches {WGMMA_CHUNKS}, default {WGMMA_CHUNK}, "
                           f"pieces {WGMMA_PIECES}")
    return lib


def _check(x, b_mat, c_mat, dt, a):
    if x.ndim != 4 or b_mat.ndim != 4 or \
            tuple(b_mat.shape) != tuple(c_mat.shape):
        raise ValueError(f"x {tuple(x.shape)}, b {tuple(b_mat.shape)}, c "
                         f"{tuple(c_mat.shape)}: expected (B, S, H, P) and "
                         f"(B, S, G, N) twice")
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    if tuple(b_mat.shape[:2]) != (B, S) or tuple(dt.shape) != (B, S, H) \
            or tuple(a.shape) != (H,) or H % G or S < 1:
        raise ValueError(f"x {tuple(x.shape)}, b {tuple(b_mat.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}: batch and "
                         f"sequence must agree, dt (B, S, H), a (H,), G "
                         f"dividing H")
    if N > MAX_STATE:
        raise ValueError(f"state size {N} > {MAX_STATE}")
    for name, t in (("x", x), ("b_mat", b_mat), ("c_mat", c_mat),
                    ("dt", dt), ("a", a)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPES or b_mat.dtype != x.dtype or \
            c_mat.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, b {b_mat.dtype}, c {c_mat.dtype}: "
                        f"the kernel takes one of float32 or bfloat16")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt {dt.dtype}, a {a.dtype}: the kernel takes "
                        f"float32")
    if route(x.dtype, S, P, N, G) == "wgmma":
        for name, t in (("x", x), ("b_mat", b_mat), ("c_mat", c_mat)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned: the wgmma "
                                 f"route loads it 16 bytes a copy")


def wgmma_scratch(B: int, S: int, H: int, N: int, device,
                  chunk: int = WGMMA_CHUNK):
    """The wgmma route's scratch at the launched chunk: the chunk states
    (B, nc, H, P, N) fp32, then the states entering each chunk, and each
    chunk's decay (B, nc, H) fp32, nc = ceil(S / chunk)."""
    nc = -(-S // chunk)
    return (torch.empty(B, nc, H, WGMMA_HEAD_DIM, N, dtype=torch.float32,
                        device=device),
            torch.empty(B, nc, H, dtype=torch.float32, device=device))


def launch(x, b_mat, c_mat, dt, a, y, state, kind: str, *,
           scratch=None, bf16_intra: bool = False,
           chunk: int = WGMMA_CHUNK) -> None:
    """One launch of route `kind` into y and state, with no checks and no
    counts (`ssd_scan` checks and counts; tools and `chip_smoke.py`'s
    before/after pairs call this directly); the wgmma route at `chunk`
    (its scratch sized for it). Raises on a launch error."""
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    states = decay = None
    if kind == "wgmma":
        states, decay = scratch if scratch is not None else \
            wgmma_scratch(B, S, H, N, x.device, chunk)
    lib = _lib()
    fn = lib.ssd_scan_launch_bf16_intra if bf16_intra else \
        lib.ssd_scan_launch
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), dt.data_ptr(),
            a.data_ptr(), y.data_ptr(), state.data_ptr(),
            None if states is None else states.data_ptr(),
            None if decay is None else decay.data_ptr(), B, S, H, P, G, N,
            int(x.dtype == torch.bfloat16), _ROUTE_ARG[kind], int(chunk),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed ({kind} route): "
                           f"{lib.ssd_scan_error_string(err).decode()}")


def ssd_vjp(inputs, grad_y, grad_state, bf16_intra: bool = False):
    """Gradients of (x, b_mat, c_mat, dt, a): autograd of
    `ref.ssd_chunked` at `inputs` against the output gradients (either
    may be None), the forward recomputed."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        y, state = ref.ssd_chunked(*leaves, bf16_intra=bf16_intra)
        outs, grads = zip(*[(o, g) for o, g in ((y, grad_y),
                                                (state, grad_state))
                            if g is not None])
        return torch.autograd.grad(outs, leaves, grads)


class SsdScanFn(torch.autograd.Function):
    """`ssd_scan`'s forward, `ssd_vjp`'s backward."""

    @staticmethod
    def forward(ctx, x, b_mat, c_mat, dt, a, bf16_intra, chunk):
        ctx.save_for_backward(x, b_mat, c_mat, dt, a)
        ctx.set_materialize_grads(False)
        ctx.bf16_intra = bf16_intra
        return _forward(x, b_mat, c_mat, dt, a, bf16_intra, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        return ssd_vjp(ctx.saved_tensors, grad_y, grad_state,
                       ctx.bf16_intra) + (None, None)


def ssd_scan(x, b_mat, c_mat, dt, a, *, bf16_intra: bool = False,
             chunk=None):
    """x: (B, S, H, P); b_mat, c_mat: (B, S, G, N), x's dtype (float32 or
    bfloat16); dt: (B, S, H) and a: (H,) float32. Returns fp32 ``(y (B, S,
    H, P), final state (B, H, P, N))``, as `ref.ssd_chunked` (with its
    ``bf16_intra`` rounding when asked). ``chunk`` is the wgmma route's
    launch shape (`WGMMA_CHUNKS`; None: `WGMMA_CHUNK`); the simt route
    (chunks of `CHUNK`) and the plain version read no tile.
    Differentiable (`SsdScanFn`, the forward at the same chunk) when grad
    mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, b_mat, c_mat, dt, a)):
        return SsdScanFn.apply(x, b_mat, c_mat, dt, a, bf16_intra, chunk)
    return _forward(x, b_mat, c_mat, dt, a, bf16_intra, chunk)


def _forward(x, b_mat, c_mat, dt, a, bf16_intra: bool = False, chunk=None):
    def work():
        from repro_torch.kernels.ssd_scan.spec import work
        return work(x, b_mat, c_mat, dt, a, bf16_intra=bf16_intra)

    def empty():
        B, S, H, P = x.shape
        N = b_mat.shape[3]
        return (x.new_empty((B, S, H, P), dtype=torch.float32),
                x.new_empty((B, H, P, N), dtype=torch.float32))

    return count.call(
        "ssd_scan", x.device,
        lambda: route(x.dtype, x.shape[1], x.shape[3], b_mat.shape[3],
                      b_mat.shape[2]),
        work, lambda: _run(x, b_mat, c_mat, dt, a, bf16_intra, chunk), empty,
        inputs=(x, b_mat, c_mat, dt, a))


def _run(x, b_mat, c_mat, dt, a, bf16_intra: bool = False, chunk=None):
    if not x.is_cuda:
        ssd_scan.plain_calls += 1
        return ref.ssd_chunked(x, b_mat, c_mat, dt, a,
                               bf16_intra=bf16_intra)
    _check(x, b_mat, c_mat, dt, a)
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    kind = route(x.dtype, S, P, N, G)
    chunk = WGMMA_CHUNK if chunk is None else int(chunk)
    if kind == "wgmma" and chunk not in WGMMA_CHUNKS:
        raise ValueError(f"ssd_scan: chunk {chunk} is not a wgmma instance "
                         f"{WGMMA_CHUNKS}")
    y = torch.empty(B, S, H, P, dtype=torch.float32, device=x.device)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    launch(x, b_mat, c_mat, dt, a, y, state, kind, bf16_intra=bf16_intra,
           chunk=chunk)
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[kind] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
ssd_scan.plain_calls = 0
