"""NERO-style multi-objective window ("tile") auto-tuning (thesis §3.3.1)
with Hopper cost models: the port's counterpart of ``repro/core/autotune.py``.

The thesis frames window-size selection as a multi-objective search
(performance against on-chip resources). On an H100 the resource is the
shared memory one block asks for, and the performance is an analytic
estimate of the kernel's time from its bytes, its grid and the card's
occupancy rules (`stream_time`). The search, the Pareto front and the
knee rule are the reference's. Per-kernel cost models live on each
``KernelSpec`` (``repro_torch.kernels.<name>.spec``).

The card's constants are an H100 SXM's (NVIDIA's data sheet and the CUDA
occupancy rules for compute capability 9.0), except two that are this
model's own: ``LAUNCH_OVERHEAD_S``, the device time one launch adds to a
stream of launches (``chip_smoke.py``'s stencil phase measures it: 2.9 us
for a one-block hdiff launch on an H100 80GB HBM3 at 700 W), and
``MEM_LATENCY_S``, the latency of a device-memory load under load, which
sets how many bytes must be in flight to reach the memory rate. A kernel
bound by instructions rather than bytes is priced by `issue_time`: its
warp instructions over the SMs' issue rate (four schedulers an SM, one
warp instruction each a cycle, at ``SM_CLOCK_HZ``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable

import numpy as np

SMEM_BYTES = 232_448           # shared memory one block may use (227 KB)
SMEM_PER_SM = 233_472          # 228 KB per SM for all its resident blocks
SMEM_RESERVED = 1_024          # the system's share of each resident block
NUM_SMS = 132
MAX_THREADS = 1_024            # threads per block
MAX_THREADS_PER_SM = 2_048
MAX_BLOCKS_PER_SM = 32
HBM_BW = 3.35e12               # bytes/s
PEAK_FLOPS = 67e12             # fp32 outside the tensor cores
TENSOR_BF16_FLOPS = 989e12     # dense bf16 on the tensor cores
REGISTERS_PER_SM = 65_536
LAUNCH_OVERHEAD_S = 3e-6       # measured by chip_smoke.py
MEM_LATENCY_S = 8e-7           # stated: load latency under load
SM_CLOCK_HZ = 1.98e9           # boost clock
ISSUE_PER_CLOCK = 4            # warp instructions an SM issues a cycle
# A knee replaces a kernel's own launch shape (``spec.fixed_tile``) only
# where the cost model calls it this much faster: below that the serving
# kernels' fitted models mis-ranked tiles at grids the card swept and
# audited (`tools/serve_fit.py` prints each grid's knee over its own
# launch under the margin).
KNEE_MARGIN = 0.10

_DTYPE_BYTES = {"float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
                "int8": 1, "fp32": 4, "bf16": 2}


def dtype_nbytes(dtype) -> int:
    """Bytes per element for a dtype given as a str, numpy or torch dtype."""
    name = getattr(dtype, "name", None) or str(dtype)
    name = name.removeprefix("torch.")
    if name in _DTYPE_BYTES:
        return _DTYPE_BYTES[name]
    return int(np.dtype(name).itemsize)


def blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Blocks of `threads` threads and `smem_bytes` of shared memory that
    one SM holds at once; 0 when such a block cannot launch."""
    if not 0 < threads <= MAX_THREADS or smem_bytes > SMEM_BYTES:
        return 0
    return min(MAX_THREADS_PER_SM // threads,
               SMEM_PER_SM // (smem_bytes + SMEM_RESERVED),
               MAX_BLOCKS_PER_SM)


def stream_time(nbytes: float, blocks: int, threads: int, smem_bytes: int,
                inflight_per_thread: float,
                min_wave_s: float = 0.0) -> float | None:
    """Estimated seconds for a kernel of `blocks` blocks that moves
    `nbytes` through device memory, each thread keeping
    `inflight_per_thread` bytes of loads in flight; None when a block
    cannot launch. The blocks run in waves of as many as the SMs hold;
    by Little's law a wave reaches the memory rate only with
    ``HBM_BW * MEM_LATENCY_S`` bytes in flight, so a small last wave, or
    waves of few threads, run below it. A wave takes at least
    `min_wave_s` (a block's own dependent chain). Plus one launch."""
    per_sm = blocks_per_sm(threads, smem_bytes)
    if not per_sm:
        return None
    slots = NUM_SMS * per_sm
    per_block = nbytes / blocks
    need = HBM_BW * MEM_LATENCY_S

    def wave(n):
        return max(min_wave_s, n * per_block / (HBM_BW * min(
            1.0, n * threads * inflight_per_thread / need)))

    full, rest = divmod(blocks, slots)
    return full * wave(slots) + (wave(rest) if rest else 0.0) \
        + LAUNCH_OVERHEAD_S


def issue_time(warp_instructions_per_sm: float, warps_per_sm: int,
               saturating_warps: int = 16) -> float:
    """Seconds for an SM to issue `warp_instructions_per_sm`, with
    `warps_per_sm` resident: ``ISSUE_PER_CLOCK`` a cycle once
    `saturating_warps` are there to hide each other's latencies, in
    proportion below that."""
    rate = ISSUE_PER_CLOCK * min(1.0, warps_per_sm / saturating_warps)
    return warp_instructions_per_sm / (rate * SM_CLOCK_HZ)


@dataclasses.dataclass(frozen=True)
class Candidate:
    params: dict
    smem_bytes: int
    est_time_s: float
    feasible: bool


def _costs(cost_fn: Callable, grid_shape, space: dict, dtype_bytes: int,
           **cost_kwargs):
    """Every tile of `space`, in the search's order, with its cost:
    ``(tile, (smem_bytes, est_time_s) or None)``."""
    names = sorted(space)
    for combo in itertools.product(*(space[n] for n in names)):
        tile = dict(zip(names, combo))
        yield tile, cost_fn(grid_shape, tile, dtype_bytes, **cost_kwargs)


def autotune(cost_fn: Callable, grid_shape, space: dict, dtype_bytes: int,
             smem_budget: int = SMEM_BYTES, knee_slack: float = 4.0,
             **cost_kwargs) -> dict:
    """Exhaustive multi-objective search. Returns the Pareto front and the
    knee: the fastest front config whose shared memory stays within
    ``knee_slack`` x the smallest front footprint."""
    cands = []
    for tile, res in _costs(cost_fn, grid_shape, space, dtype_bytes,
                            **cost_kwargs):
        if res is None:
            continue
        smem, t = res
        cands.append(Candidate(tile, smem, t, smem <= smem_budget
                               and math.isfinite(t)))
    if not cands:
        raise ValueError(f"no tile in space {space} fits grid "
                         f"{tuple(grid_shape)}")
    feas = [c for c in cands if c.feasible] or cands
    # Pareto: minimize (smem, time)
    front = []
    for c in sorted(feas, key=lambda c: (c.est_time_s, c.smem_bytes)):
        if not front or c.smem_bytes < front[-1].smem_bytes:
            front.append(c)
    best = min(feas, key=lambda c: c.est_time_s)
    min_smem = min(c.smem_bytes for c in front)
    knee = min((c for c in front if c.smem_bytes <= knee_slack * min_smem),
               key=lambda c: c.est_time_s, default=best)
    return {"candidates": cands, "pareto": front, "fastest": best,
            "knee": knee}


def space_costs(spec, grid_shape, dtype="float32") -> list:
    """Every tile of ``spec.tune_space`` with its cost at this grid:
    ``(tile, (smem_bytes, est_time_s) or None)`` in the search's order;
    None where a block of that tile cannot launch."""
    return list(_costs(spec.cost_fn, tuple(grid_shape), spec.tune_space,
                       dtype_nbytes(dtype)))


def autotune_kernel(spec, grid_shape, dtype="float32", *,
                    smem_budget: int = SMEM_BYTES, knee_slack: float = 4.0,
                    space=None) -> dict:
    """Search ``spec.tune_space`` with ``spec.cost_fn`` for a KernelSpec
    (or anything shaped like one). A spec with a ``fixed_tile`` (its
    wrapper's own launch shape) keeps that as the knee unless the knee's
    estimate is `KNEE_MARGIN` below its estimate."""
    space = {k: list(v) for k, v in (space or spec.tune_space).items()}
    grid_shape = tuple(grid_shape)
    nbytes = dtype_nbytes(dtype)
    out = autotune(spec.cost_fn, grid_shape, space, dtype_bytes=nbytes,
                   smem_budget=smem_budget, knee_slack=knee_slack)
    fixed = getattr(spec, "fixed_tile", None)
    if fixed is not None:
        tile = fixed(grid_shape)
        cost = spec.cost_fn(grid_shape, tile, nbytes)
        if cost is not None and cost[0] <= smem_budget and \
                out["knee"].est_time_s > (1 - KNEE_MARGIN) * cost[1]:
            out["knee"] = Candidate(tile, cost[0], cost[1], True)
    return out
