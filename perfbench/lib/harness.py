"""One run of one cell: set-up, the measured window, the check, the
result line.

`run_cell` is the whole run after the look for the card, which
``perfbench/run.py`` makes; the tests call it on the CPU at a small size
(``overrides``). The traffic module of the cell's mix does the work and
returns a `Result`; this module turns it into the result line.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Optional

from perfbench.lib import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a traffic module is given: the cell's configuration and mix
    (after any test overrides), the seed, the window's length, whether to
    trace, the device, the limits of the check and the process's start
    on the host clock."""
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    limits: dict
    t_start: float
    control: bool = False


@dataclasses.dataclass
class Result:
    """What a traffic module returns. ``metrics``: end-to-end values by
    name (None where a run has no reading); ``record``: what the
    per-layer readers read (traced runs); ``checks``: ``[(name, value,
    limit)]``, each correct when value <= limit; ``device``: the line's
    device block. A limit of None is a number read and shown but not
    compared."""
    attempted: int
    failed: int
    metrics: dict
    checks: list
    device: dict
    record: Optional[dict] = None
    breakdown: Optional[dict] = None
    control: Optional[dict] = None


def limits(cell_name: str) -> dict:
    path = spec.BENCH_DIR / "limits" / f"{cell_name}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is one the
    benchmark may not load (names compared whole: ``repro_torch`` is not
    ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[dict] = None,
             t_start: Optional[float] = None, control: bool = False) -> dict:
    """Run one cell and return the result line as a dict. ``overrides``
    (tests only) replace keys of the configuration and the mix, and the
    limits. ``control`` (``perfbench/calibrate.py`` only) also reads the
    control, the reference in the lower precision, on the same inputs,
    into the line's ``control``."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.benchmark()
    cell = spec.cell(cell_name, bench)
    over = overrides or {}
    ctx = Context(
        config=_merge(spec.config(cell["config"]), over.get("config", {})),
        mix=_merge(spec.mix(cell["traffic"]), over.get("mix", {})),
        seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=device,
        limits=_merge(limits(cell_name), over.get("limits", {})),
        t_start=t_start, control=control)
    res = spec.traffic_module(ctx.mix["kind"]).run(ctx)
    checks = res.checks
    compared = [(v, lim) for _, v, lim in checks if lim is not None]
    correct = bool(compared) and all(v is not None and v <= lim
                                     for v, lim in compared)
    if trace:
        metrics = {}
        for m in spec.per_layer(bench, cell_name):
            value = spec.metric_reader(m["name"])(res.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in spec.end_to_end(bench, cell_name):
            value = res.metrics.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": res.device}
    if trace and res.breakdown is not None:
        line["breakdown"] = res.breakdown
    if res.control is not None:
        line["control"] = res.control
    line["checked"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in checks}
    return line
