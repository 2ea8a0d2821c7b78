"""Three-term roofline over a counted step — the port of the JAX package's
``repro/core/roofline.py``.

- compute term    = counted flops / peak FLOP/s, each rate class at its
                    own peak (`Hardware.peak`)
- memory term     = counted bytes accessed / HBM bandwidth
- collective term = collective operand bytes / link bandwidth

The reference reads these from compiled HLO (`cost_analysis`, its HLO
text for the collectives); the port counts them as the step dispatches
(`repro_torch.core.hlo_cost`), so there is no HLO text to parse and no
``parse_collectives``: the counter sees collective ops themselves
(``_c10d_functional.*``), and on one card there are none.

Flops come in rate classes, because the card runs them at different
peaks: "bf16" for products on the tensor cores (bf16 / fp16 operands),
"fp32" for fp32 products (TF32 off: the plain fp32 path, e.g. the flash
and SSD backwards' fp32 recompute) and for everything off the tensor
cores. A plain float is priced at the bf16 peak, as in the reference.

One entry, `H100_SXM`: the data sheet's peaks and bandwidths, and the
energy constants fitted on the card by ``chip_smoke.py --only napel``
(part ``energy``: NVML's energy counter over a bf16 matmul loop and an
HBM copy loop, each constant the loop's whole energy, idle power
included, over its work). The TPU and Trainium entries of the reference
are not restated here: the tests take them from the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.int32: 4, torch.int64: 8, torch.float16: 2, torch.bfloat16: 2,
    torch.float32: 4, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")

FLOP_CLASSES = ("bf16", "fp32")


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float       # bf16 FLOP/s per chip (tensor cores, dense)
    hbm_bw: float           # bytes/s per chip
    ici_bw: float           # bytes/s per link, one direction
    hbm_gib: float = 16.0
    # fp32 FLOP/s off the tensor cores; None prices "fp32" at peak_flops
    peak_flops_fp32: Optional[float] = None
    # energy per unit of work, picojoules; None counts the term as 0
    pj_per_flop: Optional[float] = None
    pj_per_hbm_byte: Optional[float] = None
    pj_per_link_byte: Optional[float] = None

    def as_dict(self):
        return dataclasses.asdict(self)

    def peak(self, flop_class: str) -> float:
        """FLOP/s of a rate class (`FLOP_CLASSES`)."""
        if flop_class == "fp32" and self.peak_flops_fp32 is not None:
            return self.peak_flops_fp32
        if flop_class not in FLOP_CLASSES:
            raise KeyError(f"flop class {flop_class!r} not in "
                           f"{FLOP_CLASSES}")
        return self.peak_flops


# NVIDIA H100 SXM5 80GB: 989 TFLOP/s dense bf16 on the tensor cores, 67
# TFLOP/s fp32 off them, 3.35 TB/s of HBM3, NVLink 4 at 450 GB/s a
# direction (one card runs no collective). hbm_gib is
# torch.cuda.get_device_properties(0).total_memory on the card
# (85,017,493,504 bytes), and the pJ constants are fitted there by
# `chip_smoke.py --only napel` on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit (PERF.md §5-6): a bf16 8192^3 matmul loop at 676
# TFLOP/s and 698 W, a 1 GiB copy loop at 3.00 TB/s and 398 W, idle 127 W;
# idle power included, as a step pays it. The link constant is not
# measured: one card moves no link byte.
H100_SXM = Hardware("h100_sxm", 989e12, 3.35e12, 450e9, 85017493504 / 2 ** 30,
                    peak_flops_fp32=67e12, pj_per_flop=0.9835,
                    pj_per_hbm_byte=132.7, pj_per_link_byte=None)

HARDWARE = {h.name: h for h in (H100_SXM,)}

Flops = Union[float, Mapping[str, float]]


def total_flops(flops: Flops) -> float:
    """A count's flops over every rate class."""
    return float(sum(flops.values())) if isinstance(flops, Mapping) \
        else float(flops)


def compute_seconds(flops: Flops, hw: Hardware) -> float:
    """Each rate class of `flops` over its peak; a float at the bf16
    peak."""
    if isinstance(flops, Mapping):
        return sum(f / hw.peak(c) for c, f in flops.items())
    return flops / hw.peak_flops


def roofline_terms(flops: Flops, bytes_accessed: float,
                   collective_bytes: float, hw: Hardware = H100_SXM) -> dict:
    compute_s = compute_seconds(flops, hw)
    memory_s = bytes_accessed / hw.hbm_bw
    collective_s = collective_bytes / hw.ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    return {**terms, "bottleneck": bottleneck.removesuffix("_s"),
            "step_time_bound_s": step_s,
            "roofline_fraction": compute_s / step_s if step_s > 0 else 0.0}


def model_flops(cfg, shape, chips: int) -> float:
    """Useful FLOPs per device (6ND train / 2ND prefill / 2N per decode tok)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * n * shape.seq_len * shape.global_batch
    elif shape.kind == "prefill":
        total = 2.0 * n * shape.seq_len * shape.global_batch
    else:  # decode: one new token per sequence
        total = 2.0 * n * shape.global_batch
    return total / chips
