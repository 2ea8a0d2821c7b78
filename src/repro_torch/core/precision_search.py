"""PreciseFPGA (thesis Appendix B): automated fixed-point configuration
search without exhaustive sweep. A copy of
``repro/core/precision_search.py``; `search_kernel` runs the port's
kernels through ``kernels.api.numpy_fn``.

The thesis predicts resource/power per Q(w,i) config from C-synthesis
features and returns a power-vs-error Pareto curve. Here: a relative
energy model per bitwidth (datapath energy ~ w^1.25 for multipliers,
memory energy ~ w) plus the bit-accurate error from core.precision; the
search prunes with interval analysis (integer bits from the observed
dynamic range) instead of brute force.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import precision as prec


def required_integer_bits(x: np.ndarray) -> int:
    """Interval analysis: integer bits covering the dynamic range."""
    amax = float(np.max(np.abs(x)))
    return max(1, int(math.ceil(math.log2(max(amax, 1e-12) + 1e-12))) + 1)


def energy_model(w: int, ops: float, mem_bytes_per_op: float = 4.0) -> float:
    """Relative energy per run: multiplier array ~ w^1.25, memory ~ w/32."""
    return ops * ((w / 32.0) ** 1.25 + mem_bytes_per_op * w / 32.0)


@dataclasses.dataclass(frozen=True)
class SearchPoint:
    w: int
    i: int
    rel_err: float
    energy: float

    @property
    def label(self):
        return f"Q{self.w}.{self.w - 1 - self.i}"


def search_fixed_point(run_fn: Callable, inputs: dict, *,
                       widths: Sequence[int] = (8, 10, 12, 14, 16, 18, 20,
                                                24, 28, 32),
                       ops: float = 1e6, target_err: float = 0.01) -> dict:
    """Returns the Pareto curve + the cheapest config meeting target_err.

    Unlike a full (w x i) grid, integer bits are fixed by interval analysis
    over inputs and the exact output (the thesis' pruning step), so the
    search is linear in the number of widths. Integer-dtype inputs are
    structural (indices, lengths) and are neither quantized nor counted in
    the interval analysis.
    """
    exact = run_fn(**{k: np.asarray(v, np.float64) if prec._is_data(v)
                      else v for k, v in inputs.items()})
    data = [v for v in inputs.values() if prec._is_data(v)]
    i_bits = max(required_integer_bits(exact),
                 *(required_integer_bits(v) for v in data))
    points = []
    for w in widths:
        if w - 1 - i_bits < 1:
            continue
        fmt = prec.fmt_fixed(w, i_bits)
        out = fmt(run_fn(**{k: fmt(v) if prec._is_data(v) else v
                            for k, v in inputs.items()}))
        err = prec.relative_error_2norm(out, exact)
        points.append(SearchPoint(w, i_bits, err, energy_model(w, ops)))
    # Pareto: minimize (energy, err)
    pareto = []
    best_err = float("inf")
    for p in sorted(points, key=lambda p: p.energy):
        if p.rel_err < best_err:
            pareto.append(p)
            best_err = p.rel_err
    meeting = [p for p in points if p.rel_err <= target_err]
    chosen = min(meeting, key=lambda p: p.energy) if meeting else None
    return {"points": points, "pareto": pareto, "chosen": chosen,
            "integer_bits": i_bits,
            "configs_evaluated": len(points),
            "exhaustive_equivalent": len(points) * (max(widths) - 2)}


def search_kernel(kernel, *, shape=None, widths: Sequence[int] | None = None,
                  target_err: float = 0.01, seed: int = 0,
                  device: str = "cuda") -> dict:
    """`search_fixed_point` over any registered kernel (name or KernelSpec):
    inputs from the spec's `example_inputs`, the energy model's op count
    from its `flops`, each run from ``api.numpy_fn(kernel, device)``."""
    from repro_torch.kernels import api
    spec = api.as_spec(kernel)
    inputs = spec.example_inputs(shape=shape, dtype=np.float64, seed=seed)
    grid = spec.grid_of(*(inputs[n] for n in spec.arg_names))
    kw = {"widths": widths} if widths else {}
    return search_fixed_point(api.numpy_fn(spec, device=device), inputs,
                              ops=float(spec.flops(grid)),
                              target_err=target_err, **kw)
