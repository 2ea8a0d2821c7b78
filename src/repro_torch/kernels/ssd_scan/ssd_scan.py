"""Mamba2 SSD prefill scan: the wrapper of the CUDA kernel in
``csrc/ssd_scan.cu``.

On CUDA tensors `ssd_scan` checks its arguments, allocates the outputs
and launches the kernel on the current stream, or raises: there is no
fallback. On CPU tensors it runs the plain chunked version
(`repro_torch.kernels.ssd_scan.ref.ssd_chunked`). ``ssd_scan.launches``
counts kernel launches and ``ssd_scan.plain_calls`` the calls that went
to the plain version because the tensors lay on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ssd_scan import ref

CHUNK = 64               # the kernel's chunk length (positions per step)
MAX_STATE = 256          # largest state size N its shared memory takes
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("ssd_scan")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp] * 7 + [i32] * 7 + [vp]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
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
    y = torch.empty(B, S, H, P, dtype=torch.float32, device=x.device)
    state = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), dt.data_ptr(),
            a.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, P, G, N,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.plain_calls = 0
