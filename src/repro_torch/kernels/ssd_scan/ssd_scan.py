"""Mamba2 SSD prefill scan: the wrapper of the CUDA kernels in
``csrc/ssd_scan.cu``.

Two routes, chosen by `route` from static shapes alone: "wgmma", the
chunk-parallel tensor-core scan (chunks of `WGMMA_CHUNK` positions, the
fp32 operands in `WGMMA_PIECES` bf16 pieces; three CUDA launches a call),
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
went to the plain version because the tensors lay on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ssd_scan import ref

CHUNK = 64               # the simt kernel's chunk length (positions per step)
MAX_STATE = 256          # largest state size N its shared memory takes
WGMMA_CHUNK = 128        # the wgmma route's chunk length, as csrc builds it
WGMMA_PIECES = 2         # bf16 pieces of each fp32 tensor-core operand, idem
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
    lib.ssd_scan_launch.argtypes = [vp] * 9 + [i32] * 8 + [vp]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_wgmma_smem.argtypes = [i32]
    lib.ssd_scan_wgmma_smem.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    built = (lib.ssd_scan_wgmma_chunk(), lib.ssd_scan_wgmma_pieces())
    if built != (WGMMA_CHUNK, WGMMA_PIECES):
        raise RuntimeError(f"csrc/ssd_scan.cu builds chunk, pieces {built}, "
                           f"the wrapper sizes its scratch for "
                           f"{(WGMMA_CHUNK, WGMMA_PIECES)}")
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


def wgmma_scratch(B: int, S: int, H: int, N: int, device):
    """The wgmma route's scratch: the chunk states (B, nc, H, P, N) fp32,
    then the states entering each chunk, and each chunk's decay (B, nc,
    H) fp32, nc = ceil(S / `WGMMA_CHUNK`)."""
    nc = -(-S // WGMMA_CHUNK)
    return (torch.empty(B, nc, H, WGMMA_HEAD_DIM, N, dtype=torch.float32,
                        device=device),
            torch.empty(B, nc, H, dtype=torch.float32, device=device))


def launch(x, b_mat, c_mat, dt, a, y, state, kind: str, *,
           scratch=None) -> None:
    """One launch of route `kind` into y and state, with no checks and no
    counts (`ssd_scan` checks and counts; tools and `chip_smoke.py`'s
    before/after pairs call this directly). Raises on a launch error."""
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    states = decay = None
    if kind == "wgmma":
        states, decay = scratch if scratch is not None else \
            wgmma_scratch(B, S, H, N, x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), dt.data_ptr(),
            a.data_ptr(), y.data_ptr(), state.data_ptr(),
            None if states is None else states.data_ptr(),
            None if decay is None else decay.data_ptr(), B, S, H, P, G, N,
            int(x.dtype == torch.bfloat16), _ROUTE_ARG[kind],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed ({kind} route): "
                           f"{lib.ssd_scan_error_string(err).decode()}")


def ssd_scan(x, b_mat, c_mat, dt, a):
    """x: (B, S, H, P); b_mat, c_mat: (B, S, G, N), x's dtype (float32 or
    bfloat16); dt: (B, S, H) and a: (H,) float32. Returns fp32 ``(y (B, S,
    H, P), final state (B, H, P, N))``, as `ref.ssd_chunked`."""
    if not x.is_cuda:
        ssd_scan.plain_calls += 1
        return ref.ssd_chunked(x, b_mat, c_mat, dt, a)
    _check(x, b_mat, c_mat, dt, a)
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    kind = route(x.dtype, S, P, N, G)
    y = torch.empty(B, S, H, P, dtype=torch.float32, device=x.device)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    launch(x, b_mat, c_mat, dt, a, y, state, kind)
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[kind] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
ssd_scan.plain_calls = 0
