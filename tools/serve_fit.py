#!/usr/bin/env python3
"""Fit the serving and prefill kernels' Hopper cost models to the card's
tile sweep:

    python3 tools/serve_fit.py chiprun_out/<run>.log [more logs ...]

Reads the tile-sweep rows of ``chip_smoke.py``'s kernel phase (each
launchable tile's `device_ms` at each swept grid) and its ``knees`` line
(the knee and the kernel's own launch, each timed, at each main-path
grid no sweep confirmed), the median over the logs given. Then fits the
constants each spec states for its tiled route by least squares on
log(estimate / measured) of every tile and, where the kernel's own
launch (``spec.fixed_tile``) was timed at the same grid, on each tile's
estimate over that launch's against the measured ratio, weighted by
`PAIR_WEIGHT` (the knee's choice turns on it), from the constants in the
source and from seeded random starts: paged attention's split route (a
block's set-up, the rate one block walks its tiles' bytes, its math per
query row and position, the combine's rate), flash attention's wgmma
route (warp instructions a score outside the products, a key tile's
fixed cost, each instance's factor against the 128 x 128 instance's),
the SSD scan's wgmma route (its share of the tensor-core rate, a chunk's
step of the state pass) and the RG-LRU scan's chunked route (one step of
the recurrence). Prints one JSON line per kernel: the constants before
and after (three significant digits: what goes into the spec), the
largest error factor, and per grid the knee (`autotune.autotune_kernel`,
the margin included), its measured time over the fastest tile's and over
the kernel's own launch's, and the rank correlation of estimate and
measurement, under both sets. Runs on the CPU; needs scipy.
"""
from __future__ import annotations

import json
import math
import statistics
import sys
from pathlib import Path

import numpy as np
from scipy.optimize import least_squares

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.autotune import (autotune_kernel,  # noqa: E402
                                       dtype_nbytes)
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import spec as flash_spec  # noqa
from repro_torch.kernels.paged_attention import spec as paged_spec  # noqa
from repro_torch.kernels.rglru_scan import spec as rglru_spec  # noqa: E402
from repro_torch.kernels.ssd_scan import spec as ssd_spec  # noqa: E402

FITS = {"paged_attention": (paged_spec, ("SPLIT_BLOCK_S", "SPLIT_BLOCK_BW",
                                         "SPLIT_ROW_POS_S",
                                         "SPLIT_COMBINE_BW")),
        "flash_attention": (flash_spec, ("SOFTMAX_INSTR", "KEY_TILE_S",
                                         "TILE_FACTOR_Q64_K64",
                                         "TILE_FACTOR_Q64_K128",
                                         "TILE_FACTOR_Q128_K64")),
        "ssd_scan": (ssd_spec, ("SSD_TENSOR_SHARE", "PASS_STEP_S")),
        "rglru_scan": (rglru_spec, ("ROW_STEP_S",))}
# the weight of a tile's ratio to the kernel's own launch against that of
# its time: the knee's choice turns on the ratio
PAIR_WEIGHT = 3.0
# each constant within 1/100 .. 100x the source's but: the split route's
# block set-up, which the sweeps do not tell from its walk, 1 ns .. 10
# us; the softmax's warp instructions a score, at least its eight named
# operations; a flash instance's factor against the 128 x 128
# instance's, 0.3 .. 3
BOUNDS = {"SSD_TENSOR_SHARE": (0.02, 1.0), "SPLIT_BLOCK_S": (1e-9, 1e-5),
          "SOFTMAX_INSTR": (8.0, 64.0),
          **{f"TILE_FACTOR_{t}": (0.3, 3.0)
             for t in ("Q64_K64", "Q64_K128", "Q128_K64")}}


def _grid(kernel, grid) -> tuple:
    """A sweep row's grid in the spec's `shape_keys`: logs written before
    the paged grid dropped the pool's page count hold it second."""
    if kernel == "paged_attention" and len(grid) == 8:
        grid = grid[:1] + grid[2:]
    return tuple(grid)


def sweeps(logs) -> dict:
    """{(kernel, grid, dtype): {tile (sorted items): median ms over the
    logs}} of every launchable tile swept or audited."""
    found: dict = {}
    for log in logs:
        for line in Path(log).read_text().splitlines():
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row.get("phase") == "knees":
                # the audit's knee and launch before tiles, each timed
                points = [(r, r[f"{n}"], r[f"{n}_ms"]) for r in row["rows"]
                          if "knee_ms" in r for n in ("knee", "fixed")]
            elif row.get("phase") == "kernel" and str(
                    row.get("case", "")).endswith("tile sweep"):
                points = [(row, t["tile"], t["device_ms"])
                          for t in row["tiles"] if t.get("launchable")]
            else:
                continue
            for r, tile, ms in points:
                key = (r["kernel"], _grid(r["kernel"], r["grid"]),
                       r["dtype"])
                found.setdefault(key, {}).setdefault(
                    tuple(sorted(tile.items())), []).append(ms)
    return {k: {t: statistics.median(v) for t, v in d.items()}
            for k, d in found.items()}


def spearman(xs, ys) -> float | None:
    if len(xs) < 3:
        return None
    rx, ry = np.argsort(np.argsort(xs)), np.argsort(np.argsort(ys))
    n = len(xs)
    return float(1 - 6 * ((rx - ry) ** 2).sum() / (n * (n * n - 1)))


def report(name, measured) -> dict:
    """Per swept grid, with the module's current constants: the knee, its
    measured ms over the fastest tile's, and the rank correlation."""
    spec = registry.get(name)
    out = {}
    for (kernel, grid, dtype), tiles in measured.items():
        if kernel != name:
            continue
        knee = tuple(sorted(autotune_kernel(spec, grid, dtype)["knee"]
                            .params.items()))
        est = [spec.cost_fn(grid, dict(t), dtype_nbytes(dtype))[1]
               for t in tiles]
        fixed = tuple(sorted(spec.fixed_tile(grid).items()))
        out[f"{list(grid)} {dtype}"] = {
            "knee": dict(knee),
            "knee_over_fastest": tiles[knee] / min(tiles.values())
            if knee in tiles else None,
            "knee_over_fixed": tiles[knee] / tiles[fixed]
            if knee in tiles and fixed in tiles else None,
            "rank_correlation": spearman(est, list(tiles.values()))}
    return out


def fit(name, measured) -> dict:
    module, names = FITS[name]
    spec = registry.get(name)
    points = [(grid, dict(t), dtype_nbytes(dtype), ms * 1e-3)
              for (kernel, grid, dtype), tiles in measured.items()
              if kernel == name for t, ms in tiles.items()]
    # each other tile against the kernel's own launch at the same grid,
    # where both were timed
    pairs = []
    for (kernel, grid, dtype), tiles in measured.items():
        fixed = tuple(sorted(spec.fixed_tile(grid).items())) \
            if kernel == name else None
        if fixed in tiles:
            pairs += [(grid, dict(t), dict(fixed), dtype_nbytes(dtype),
                       ms / tiles[fixed]) for t, ms in tiles.items()
                      if t != fixed]
    start = np.array([getattr(module, n) for n in names], dtype=float)
    lo = np.log([BOUNDS.get(n, (v / 100, 0))[0]
                 for n, v in zip(names, start)])
    hi = np.log([BOUNDS.get(n, (0, v * 100))[1]
                 for n, v in zip(names, start)])

    def residuals(q):
        for n, v in zip(names, np.exp(q)):
            setattr(module, n, float(v))
        return [math.log(spec.cost_fn(g, t, b)[1] / ms)
                for g, t, b, ms in points] + \
            [PAIR_WEIGHT * math.log(spec.cost_fn(g, t, b)[1]
                                    / spec.cost_fn(g, f, b)[1] / ratio)
             for g, t, f, b, ratio in pairs]

    before = {"constants": dict(zip(names, start.tolist())),
              "max_error_factor": math.exp(max(
                  abs(x) for x in residuals(np.log(start))[:len(points)])),
              **report(name, measured)}
    rng = np.random.default_rng(0)
    best = None
    for trial in range(24):
        q0 = np.clip(np.log(start), lo, hi) if trial == 0 else \
            lo + (hi - lo) * rng.random(len(names))
        r = least_squares(residuals, q0, bounds=(lo, hi))
        if best is None or r.cost < best.cost:
            best = r
    fitted = [float(f"{v:.3g}") for v in np.exp(best.x)]
    err = max(abs(x) for x in residuals(np.log(fitted))[:len(points)])
    after = {"constants": dict(zip(names, fitted)),
             "max_error_factor": math.exp(err), **report(name, measured)}
    for n, v in zip(names, start):          # leave the module as found
        setattr(module, n, float(v))
    return {"kernel": name, "points": len(points), "before": before,
            "after": after}


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    measured = sweeps(argv)
    for name in FITS:
        print(json.dumps(fit(name, measured)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
