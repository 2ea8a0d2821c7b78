"""Design-of-experiments samplers (thesis §5.2.4, §6.2.3) — a copy of the
JAX package's ``repro/core/napel/doe.py`` (numpy; its samples equal the
reference's to the bit).

Central composite design (Box–Wilson CCD) picks corners(low/high) + axial
points(min/max) + center over 5-level parameters; Latin hypercube sampling
for LEAPER's base-model data collection.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

LEVELS = ("min", "low", "central", "high", "max")


def central_composite(params: dict[str, Sequence]) -> list[dict]:
    """params: name -> 5 levels (min, low, central, high, max).
    Returns CCD configurations (2^k corners + 2k axial + 1 center)."""
    names = sorted(params)
    for n in names:
        assert len(params[n]) == 5, f"{n} needs 5 levels"
    out = []
    # corners: low/high
    for combo in itertools.product(*([1, 3] for _ in names)):
        out.append({n: params[n][c] for n, c in zip(names, combo)})
    # axial: min/max with others central
    for i, n in enumerate(names):
        for lvl in (0, 4):
            cfg = {m: params[m][2] for m in names}
            cfg[n] = params[n][lvl]
            out.append(cfg)
    # center
    out.append({n: params[n][2] for n in names})
    # dedup
    seen, uniq = set(), []
    for cfg in out:
        key = tuple(sorted(cfg.items()))
        if key not in seen:
            seen.add(key)
            uniq.append(cfg)
    return uniq


def latin_hypercube(params: dict[str, Sequence], n: int,
                    seed: int = 0) -> list[dict]:
    """LHS over discrete candidate lists: n non-overlapping stratified picks."""
    rng = np.random.default_rng(seed)
    names = sorted(params)
    cols = {}
    for name in names:
        levels = list(params[name])
        strata = np.linspace(0, len(levels), n + 1)
        picks = [levels[int(rng.uniform(strata[i], strata[i + 1]))
                        % len(levels)] for i in range(n)]
        rng.shuffle(picks)
        cols[name] = picks
    return [{name: cols[name][i] for name in names} for i in range(n)]
