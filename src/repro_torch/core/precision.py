"""Number-system emulation + 2-norm error tracking (thesis Ch. 4): a copy
of ``repro/core/precision.py`` (numpy; the quantizers and error metrics
unchanged).

Bit-accurate software emulation of fixed-point Q(w,i), dynamic
floating-point (e,m), and posit(n,es) — the same methodology the thesis
uses (Xilinx ap_fixed / FloatX / universal libraries) before committing a
format to hardware. `precision_sweep_kernel` runs a registered kernel of
the port through ``kernels.api.numpy_fn``: on the card, through the
kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np


# ---------------------------------------------------------------------------
# Error metrics (thesis Eq. 4.1)
# ---------------------------------------------------------------------------
def relative_error_2norm(approx, exact) -> float:
    """||A' - A||_2 / ||A||_2 over flattened fields (vector 2-norm)."""
    a = np.asarray(approx, np.float64).ravel()
    e = np.asarray(exact, np.float64).ravel()
    denom = np.linalg.norm(e)
    return float(np.linalg.norm(a - e) / denom) if denom else 0.0


def induced_2norm_error(approx, exact) -> float:
    """Induced matrix 2-norm (largest singular value) ratio, 2D inputs."""
    a = np.asarray(approx, np.float64)
    e = np.asarray(exact, np.float64)
    if a.ndim != 2:
        a = a.reshape(a.shape[0], -1)
        e = e.reshape(e.shape[0], -1)
    denom = np.linalg.norm(e, 2)
    return float(np.linalg.norm(a - e, 2) / denom) if denom else 0.0


def accuracy_pct(approx, exact) -> float:
    return 100.0 * (1.0 - relative_error_2norm(approx, exact))


# ---------------------------------------------------------------------------
# Fixed point Q(w, i): w total bits (incl. sign), i integer bits
# ---------------------------------------------------------------------------
def quantize_fixed(x, w: int, i: int):
    x = np.asarray(x, np.float64)
    f = w - 1 - i
    scale = 2.0 ** f
    lo, hi = -(2.0 ** i), 2.0 ** i - 1.0 / scale
    return np.clip(np.rint(x * scale) / scale, lo, hi)


# ---------------------------------------------------------------------------
# Dynamic float (e exponent bits, m mantissa bits), FloatX-style
# ---------------------------------------------------------------------------
def quantize_float(x, e: int, m: int):
    x = np.asarray(x, np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    man, ex = np.frexp(x[nz])              # x = man * 2^ex, man in [0.5, 1)
    man_r = np.rint(man * 2 ** (m + 1)) / 2 ** (m + 1)
    bias = 2 ** (e - 1) - 1
    ex = np.clip(ex, -bias + 1, bias + 1)  # flush under/overflow to range edge
    out[nz] = np.ldexp(man_r, ex)
    maxv = (2 - 2.0 ** -m) * 2.0 ** bias
    return np.clip(out, -maxv, maxv)


# ---------------------------------------------------------------------------
# Posit(n, es) via exhaustive enumeration + nearest-value rounding (n <= 20)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def posit_values(n: int, es: int) -> np.ndarray:
    """All finite posit(n, es) values, sorted ascending."""
    assert 2 <= n <= 20, "enumeration practical for n <= 20"
    vals = []
    for p in range(2 ** n):
        if p == 0:
            vals.append(0.0)
            continue
        if p == 2 ** (n - 1):      # NaR
            continue
        bits = p
        sign = 1.0
        if bits & (1 << (n - 1)):  # negative: two's complement
            sign = -1.0
            bits = (1 << n) - bits if bits != (1 << (n - 1)) else bits
        body = [(bits >> (n - 2 - i)) & 1 for i in range(n - 1)]
        # regime: run of identical bits
        r0 = body[0]
        run = 1
        while run < len(body) and body[run] == r0:
            run += 1
        k = (run - 1) if r0 == 1 else -run
        rest = body[run + 1:] if run < len(body) else []
        e_bits = rest[:es]
        e_val = 0
        for b in e_bits:
            e_val = (e_val << 1) | b
        e_val <<= (es - len(e_bits))
        f_bits = rest[es:]
        frac = 1.0
        for i, b in enumerate(f_bits):
            frac += b * 2.0 ** -(i + 1)
        vals.append(sign * frac * 2.0 ** (k * (2 ** es) + e_val))
    return np.array(sorted(vals), np.float64)


def quantize_posit(x, n: int, es: int):
    x = np.asarray(x, np.float64)
    table = posit_values(n, es)
    idx = np.searchsorted(table, x)
    idx = np.clip(idx, 1, len(table) - 1)
    lo, hi = table[idx - 1], table[np.clip(idx, 0, len(table) - 1)]
    pick_hi = np.abs(hi - x) < np.abs(x - lo)
    return np.where(pick_hi, hi, lo)


# ---------------------------------------------------------------------------
# Format descriptors + sweep machinery
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NumberFormat:
    kind: str       # fixed | float | posit | native
    total_bits: int
    label: str
    quantizer: Callable = dataclasses.field(compare=False, default=None)

    def __call__(self, x):
        return self.quantizer(x) if self.quantizer else np.asarray(x)


def fmt_fixed(w, i):
    return NumberFormat("fixed", w, f"fixed({w},{i})",
                        lambda x: quantize_fixed(x, w, i))


def fmt_float(e, m):
    return NumberFormat("float", 1 + e + m, f"floatx({e},{m})",
                        lambda x: quantize_float(x, e, m))


def fmt_posit(n, es):
    return NumberFormat("posit", n, f"posit({n},{es})",
                        lambda x: quantize_posit(x, n, es))


FP32 = NumberFormat("native", 32, "float32", lambda x: np.asarray(x, np.float32))
BF16 = fmt_float(8, 7)
FP16 = fmt_float(5, 10)


def _is_data(v) -> bool:
    """Number formats apply to data, not indices: integer inputs (page
    tables, lengths, int8 pools) are structural and never quantized."""
    return not np.issubdtype(np.asarray(v).dtype, np.integer)


def precision_sweep(run_fn: Callable, inputs: dict, formats,
                    exact_out=None) -> list[dict]:
    """Run `run_fn(**quantized_inputs)` per format; track 2-norm error vs the
    fp64/fp32 exact output (thesis Fig. 4-2 flow: instrument -> explore ->
    error tracking). Integer-dtype inputs pass through unquantized."""
    if exact_out is None:
        exact_out = run_fn(**{k: np.asarray(v, np.float64) if _is_data(v)
                              else v for k, v in inputs.items()})
    rows = []
    for fmt in formats:
        qin = {k: fmt(v) if _is_data(v) else v for k, v in inputs.items()}
        out = run_fn(**qin)
        out = fmt(out)          # storage quantization of the result
        err = relative_error_2norm(out, exact_out)
        rows.append({"format": fmt.label, "kind": fmt.kind,
                     "bits": fmt.total_bits, "rel_err": err,
                     "accuracy_pct": 100.0 * (1.0 - err)})
    return rows


def precision_sweep_kernel(kernel, formats, *, shape=None, seed: int = 0,
                           device: str = "cuda") -> list[dict]:
    """`precision_sweep` over any registered kernel (name or KernelSpec):
    inputs come from the spec's `example_inputs`, each run from
    ``api.numpy_fn(kernel, device)`` (the kernel on a CUDA device, its
    plain version on the CPU)."""
    from repro_torch.kernels import api
    spec = api.as_spec(kernel)
    inputs = spec.example_inputs(shape=shape, dtype=np.float64, seed=seed)
    return precision_sweep(api.numpy_fn(spec, device=device), inputs,
                           formats)
