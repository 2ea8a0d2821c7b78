#!/usr/bin/env python3
"""Fit the stencil kernels' Hopper cost models to the card's tile sweep:

    python3 tools/stencil_fit.py chiprun_out/<run>.log [more logs ...]

Reads the COSMO-grid rows of ``chip_smoke.py``'s stencil phase (each
tile's `device_ms`, the median over the logs given), then fits the
constants of ``repro_torch.kernels.hdiff.spec`` (the tma route's warp
instructions per Laplacian pass, output row, plane and item, and the L2
rate of the boxes' lines) and of ``repro_torch.kernels.vadvc.spec`` (the
prefetch route's share of the memory rate) by least squares on
log(estimate / measured), from the constants in the source and from
seeded random starts. Prints one JSON line per kernel: the constants
before and after (three significant digits: what goes into the spec),
the largest error factor, and per dtype the knee, its measured time over
the fastest tile's and the rank correlation of estimate and measurement,
under both sets. Runs on the CPU; needs scipy.
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
from repro_torch.kernels.hdiff import spec as hdiff_spec  # noqa: E402
from repro_torch.kernels.vadvc import spec as vadvc_spec  # noqa: E402

FITS = {"hdiff": (hdiff_spec, ("LAP_PASS_ISSUE", "OUT_ROW_ISSUE",
                               "PLANE_ISSUE", "ITEM_ISSUE", "HALO_L2_BW")),
        "vadvc": (vadvc_spec, ("STREAM_EFFICIENCY",))}
BOUNDS = {"STREAM_EFFICIENCY": (0.2, 1.0)}      # else 1/10 .. 10x the source's


def sweeps(logs) -> dict:
    """{(kernel, dtype): {tile (sorted items): median ms over the logs}}."""
    found: dict = {}
    for log in logs:
        for line in Path(log).read_text().splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            if row.get("phase") == "stencil" and isinstance(
                    row.get("tiles"), list):
                key = (row["kernel"], row["dtype"])
                for t in row["tiles"]:
                    tile = tuple(sorted(t["tile"].items()))
                    found.setdefault(key, {}).setdefault(tile, []).append(
                        t["ms"])
    return {k: {t: statistics.median(v) for t, v in d.items()}
            for k, d in found.items()}


def spearman(xs, ys) -> float:
    rx, ry = np.argsort(np.argsort(xs)), np.argsort(np.argsort(ys))
    n = len(xs)
    return float(1 - 6 * ((rx - ry) ** 2).sum() / (n * (n * n - 1)))


def report(name, measured) -> dict:
    """Per dtype, with the module's current constants: the knee, its
    measured ms over the fastest tile's, and the rank correlation."""
    spec = registry.get(name)
    grid = tuple(spec.bench_shape[k] for k in spec.shape_keys)
    out = {}
    for (kernel, dtype), tiles in measured.items():
        if kernel != name:
            continue
        knee = tuple(sorted(autotune_kernel(spec, grid, dtype)["knee"]
                            .params.items()))
        est = [spec.cost_fn(grid, dict(t), dtype_nbytes(dtype))[1]
               for t in tiles]
        out[dtype] = {"knee": dict(knee),
                      "knee_over_fastest": tiles[knee] / min(tiles.values())
                      if knee in tiles else None,
                      "rank_correlation": spearman(est, list(tiles.values()))}
    return out


def fit(name, measured) -> dict:
    module, names = FITS[name]
    spec = registry.get(name)
    grid = tuple(spec.bench_shape[k] for k in spec.shape_keys)
    points = [(dict(t), dtype_nbytes(dtype), ms * 1e-3)
              for (kernel, dtype), tiles in measured.items() if kernel == name
              for t, ms in tiles.items()]
    start = np.array([getattr(module, n) for n in names], dtype=float)
    lo = np.log([BOUNDS.get(n, (v / 10, 0))[0] for n, v in zip(names, start)])
    hi = np.log([BOUNDS.get(n, (0, v * 10))[1] for n, v in zip(names, start)])

    def residuals(q):
        for n, v in zip(names, np.exp(q)):
            setattr(module, n, float(v))
        return [math.log(spec.cost_fn(grid, t, b)[1] / ms)
                for t, b, ms in points]

    before = {"constants": dict(zip(names, start.tolist())),
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
    for n, v in zip(names, fitted):
        setattr(module, n, v)
    err = max(abs(x) for x in residuals(np.log(fitted)))
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
