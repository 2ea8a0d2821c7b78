"""RG-LRU prefill recurrence: the wrapper of the CUDA kernels in
``csrc/rglru_scan.cu``.

Two routes, chosen by `route` from the sequence length and the chunk:
"chunked", the chunk-parallel scan (chunks of ``chunk`` positions, one
of `CHUNKS`, `CHUNK` unless the caller picks; two CUDA launches a
call), for S longer than one chunk; "serial", the first port's one
thread per channel over the whole sequence (``csrc/rglru_serial.cuh``),
for S <= the chunk (the decode-shaped steps among them). On CUDA tensors
`rglru_scan` checks its arguments, allocates the output and the route's
scratch and launches on the current stream, or raises: there is no
fallback. On CPU tensors it runs the plain version
(`repro_torch.kernels.rglru_scan.ref.lru_scan`). ``rglru_scan.launches``
counts calls that launched (one per call), ``rglru_scan.launches_by_route``
splits them by route, and ``rglru_scan.plain_calls`` counts the calls that
went to the plain version because the tensors lay on the CPU. Under the
cost counter (`repro_torch.core.hlo_cost`) a call is one entry of its
function's work (`spec.work`; `repro_torch.kernels.count`).

Under autograd (grad mode on and an input that requires grad) the call
goes through `RglruScanFn`. Its backward is the same recurrence run in
reverse: the gradient reaching ``h_t`` is ``lam_t = g_t + a_{t+1}
lam_{t+1}``, so ``lam = flip(scan(a', flip(g)))`` with ``a'`` the
flipped a shifted one step (``a'_t = a_{S-t}``; its first entry meets a
zero state and is ignored), then ``db = lam`` and ``da = lam * h_{t-1}``
with ``h_{-1} = 0``. The reverse scan is a call of `rglru_scan` itself —
the kernel on the card, counted as a launch — so no second kernel and no
plain loop over S.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count
from repro_torch.kernels.rglru_scan import ref

CHUNK = 32               # the chunked route's default chunk length
CHUNKS = (32, 64, 128, 256)   # the chunk lengths a launch may take
ROUTES = ("chunked", "serial")
_ROUTE_ARG = {"serial": 0, "chunked": 1}   # rglru_scan_launch's `route`


def route(S: int, chunk: int = CHUNK) -> str:
    """The kernel a launch over S positions in chunks of `chunk` takes:
    "chunked" when S spans more than one chunk, else "serial"."""
    return "chunked" if S > chunk else "serial"


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


def lru_vjp(a, h, grad_h, chunk=None):
    """(da, db) of ``h = scan(a, b)`` against `grad_h`, by the reverse
    scan (see the module docstring), launched at `chunk`."""
    a_rev = torch.zeros_like(a)
    a_rev[:, 1:] = a[:, 1:].flip(1)
    lam = rglru_scan(a_rev, grad_h.flip(1).contiguous(), chunk=chunk).flip(1)
    h_prev = torch.zeros_like(h)
    h_prev[:, 1:] = h[:, :-1]
    return lam * h_prev, lam


class RglruScanFn(torch.autograd.Function):
    """`rglru_scan`'s forward, `lru_vjp`'s backward."""

    @staticmethod
    def forward(ctx, a, b, chunk):
        h = _forward(a, b, chunk)
        ctx.save_for_backward(a, h)
        ctx.chunk = chunk
        return h

    @staticmethod
    def backward(ctx, grad_h):
        a, h = ctx.saved_tensors
        return lru_vjp(a, h, grad_h.to(torch.float32), ctx.chunk) + (None,)


def rglru_scan(a, b, *, chunk=None):
    """a, b: (B, S, W) float32. Returns h: (B, S, W) float32 with
    ``h_t = a_t h_{t-1} + b_t`` from a zero state, as `ref.lru_scan`.
    ``chunk`` is the launch shape (`CHUNKS`; None: `CHUNK`), which also
    sets the route (`route`); the plain version reads no tile.
    Differentiable (`RglruScanFn`: forward and reverse scan at the same
    chunk) when grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RglruScanFn.apply(a, b, chunk)
    return _forward(a, b, chunk)


def _forward(a, b, chunk=None):
    chunk = CHUNK if chunk is None else int(chunk)

    def work():
        from repro_torch.kernels.rglru_scan.spec import work
        return work(a, b)

    return count.call("rglru_scan", a.device,
                      lambda: route(a.shape[1], chunk), work,
                      lambda: _run(a, b, chunk), lambda: torch.empty_like(a),
                      inputs=(a, b))


def _run(a, b, chunk=CHUNK):
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
    if chunk not in CHUNKS:
        raise ValueError(f"rglru_scan: chunk {chunk} not in {CHUNKS}")
    kind = route(a.shape[1], chunk)
    h = torch.empty_like(a)
    launch(a, b, h, kind, chunk=chunk)
    rglru_scan.launches += 1
    rglru_scan.launches_by_route[kind] += 1
    return h


rglru_scan.launches = 0
rglru_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
rglru_scan.plain_calls = 0
