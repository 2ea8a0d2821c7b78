"""RG-LRU prefill recurrence: the wrapper of the CUDA kernel in
``csrc/rglru_scan.cu``.

On CUDA tensors `rglru_scan` checks its arguments, allocates the output
and launches the kernel on the current stream, or raises: there is no
fallback. On CPU tensors it runs the plain version
(`repro_torch.kernels.rglru_scan.ref.lru_scan`). ``rglru_scan.launches``
counts kernel launches and ``rglru_scan.plain_calls`` the calls that went
to the plain version because the tensors lay on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.rglru_scan import ref


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("rglru_scan")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [vp] * 3 + [i32] * 3 + [vp]
    lib.rglru_scan_launch.restype = i32
    lib.rglru_scan_error_string.argtypes = [i32]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


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
    B, S, W = a.shape
    h = torch.empty_like(a)
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: "
                           f"{lib.rglru_scan_error_string(err).decode()}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
rglru_scan.plain_calls = 0
