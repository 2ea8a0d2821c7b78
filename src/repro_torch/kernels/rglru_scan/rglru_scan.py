"""RG-LRU prefill recurrence: the wrapper of the CUDA kernels in
``csrc/rglru_scan.cu``.

Two routes, chosen by `route` from the sequence length alone: "chunked",
the chunk-parallel scan (chunks of `CHUNK` positions; two CUDA launches
a call), for S longer than one chunk; "serial", the first port's one
thread per channel over the whole sequence (``csrc/rglru_serial.cuh``),
for S <= `CHUNK` (the decode-shaped steps among them). On CUDA tensors
`rglru_scan` checks its arguments, allocates the output and the route's
scratch and launches on the current stream, or raises: there is no
fallback. On CPU tensors it runs the plain version
(`repro_torch.kernels.rglru_scan.ref.lru_scan`). ``rglru_scan.launches``
counts calls that launched (one per call), ``rglru_scan.launches_by_route``
splits them by route, and ``rglru_scan.plain_calls`` counts the calls that
went to the plain version because the tensors lay on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.rglru_scan import ref

CHUNK = 32               # the chunked route's chunk length
ROUTES = ("chunked", "serial")
_ROUTE_ARG = {"serial": 0, "chunked": 1}   # rglru_scan_launch's `route`


def route(S: int) -> str:
    """The kernel a launch over S positions takes: "chunked" when S spans
    more than one chunk, else "serial"."""
    return "chunked" if S > CHUNK else "serial"


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("rglru_scan")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [vp] * 4 + [i32] * 5 + [vp]
    lib.rglru_scan_launch.restype = i32
    lib.rglru_scan_error_string.argtypes = [i32]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def launch(a, b, h, kind: str, *, chunk: int = CHUNK) -> None:
    """One launch of route `kind` into h, with no checks and no counts
    (`rglru_scan` checks and counts; tools and `chip_smoke.py`'s
    before/after pairs call this directly). Raises on a launch error."""
    B, S, W = a.shape
    nc = -(-S // chunk)
    agg = torch.empty(2 * B * (nc - 1) * W, dtype=torch.float32,
                      device=a.device) if kind == "chunked" and nc > 1 \
        else None
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h.data_ptr(),
            None if agg is None else agg.data_ptr(), B, S, W,
            _ROUTE_ARG[kind], chunk,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed ({kind} route): "
                           f"{lib.rglru_scan_error_string(err).decode()}")


def rglru_scan(a, b):
    """a, b: (B, S, W) float32. Returns h: (B, S, W) float32 with
    ``h_t = a_t h_{t-1} + b_t`` from a zero state, as `ref.lru_scan`."""
    if not a.is_cuda:
        rglru_scan.plain_calls += 1
        return ref.lru_scan(a, b)
    if a.ndim != 3 or tuple(a.shape) != tuple(b.shape) or a.shape[1] < 1:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}: expected "
                         f"two (B, S, W) tensors, S >= 1")
    if b.device != a.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a {a.dtype}, b {b.dtype}: the kernel takes float32")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    kind = route(a.shape[1])
    h = torch.empty_like(a)
    launch(a, b, h, kind)
    rglru_scan.launches += 1
    rglru_scan.launches_by_route[kind] += 1
    return h


rglru_scan.launches = 0
rglru_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
rglru_scan.plain_calls = 0
