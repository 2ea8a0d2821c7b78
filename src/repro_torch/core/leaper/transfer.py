"""LEAPER: few-shot transfer of cost models across hardware platforms
(thesis Ch. 6) — the port of the JAX package's
``repro/core/leaper/transfer.py``.

Each target platform has nonlinear efficiency curves (utilization vs.
arithmetic intensity, collective efficiency vs. message size) that a
pure roofline rescale cannot capture — the cross-platform gap the thesis
bridges with transfer learning. The base model is trained cheaply on a
source platform's labels; K labeled target samples adapt it via an
ensemble of per-base-learner residual regressors (negative-transfer
avoidance, thesis §6.2.5).

The port's `PLATFORMS` holds one entry, ``h100``, whose efficiency
parameters are fitted on the card by ``chip_smoke.py --only napel``
(part ``leaper``): ``mem_eff`` from a device copy's achieved bandwidth,
``launch_overhead_s`` from an empty launch, ``compute_eff_knee`` from
bf16 matmuls at rising arithmetic intensity; ``coll_eff`` is 1.0 and
unused on one card. The reference's TPU / Trainium platforms are not
restated: `platform_labels` and `evaluate_transfer` take ``platforms``
(and the source platform, which the reference fixes to its v5e) as
keyword arguments, and the tests pass the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.napel.forest import RandomForest, mean_relative_error
from repro_torch.core.roofline import H100_SXM, Hardware


# ---------------------------------------------------------------------------
# Platform simulators (ground truth for transfer experiments)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Platform:
    hw: Hardware
    compute_eff_knee: float      # arithmetic intensity at 50% MXU efficiency
    mem_eff: float               # achievable HBM fraction
    coll_eff: float              # achievable ICI fraction
    launch_overhead_s: float

    def step_time(self, flops, hbm_bytes, coll_bytes) -> float:
        ai = flops / max(hbm_bytes, 1.0)
        ceff = ai / (ai + self.compute_eff_knee)
        t_c = flops / (self.hw.peak_flops * max(ceff, 1e-3))
        t_m = hbm_bytes / (self.hw.hbm_bw * self.mem_eff)
        t_i = coll_bytes / (self.hw.ici_bw * self.coll_eff)
        return max(t_c, t_m, t_i) + 0.5 * min(t_c + t_i, t_m) \
            + self.launch_overhead_s


# Fitted on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
# `chip_smoke.py --only napel` (PERF.md §5-6): bf16 matmuls M = N =
# 8192, K = 64-8192 reach 0.158-0.705 of the bf16 peak (the knee is the
# least-squares fit of ai / (ai + knee), 0.10 rms off); a 1 GiB device
# copy moves 3.00 TB/s; an empty launch (`torch.cuda._sleep(0)`) costs
# 5.79 us back to back.
PLATFORMS = {
    "h100": Platform(H100_SXM, compute_eff_knee=390.2, mem_eff=0.8949,
                     coll_eff=1.0, launch_overhead_s=5.79e-6),
}


def platform_labels(platform: str, cells: Sequence, *,
                    platforms=PLATFORMS) -> np.ndarray:
    """Ground-truth log step-times of (flops, bytes, coll) cells."""
    p = platforms[platform]
    return np.array([math.log2(p.step_time(c.flops, c.bytes_, c.coll))
                     for c in cells])


# ---------------------------------------------------------------------------
# Transfer learner
# ---------------------------------------------------------------------------
class _Ridge:
    def __init__(self, lam=1e-2):
        self.lam = lam

    def fit(self, x, y):
        x = np.column_stack([np.ones(len(x)), x])
        a = x.T @ x + self.lam * np.eye(x.shape[1])
        self.w = np.linalg.solve(a, x.T @ y)
        return self

    def predict(self, x):
        x = np.column_stack([np.ones(len(x)), x])
        return x @ self.w


class Leaper:
    """Ensemble of base learners, each adapted with a few-shot residual
    model; ensemble weights from leave-one-out shot error (avoids negative
    transfer when a base learner doesn't match the target)."""

    def __init__(self, base_models: list, seed: int = 0):
        self.base_models = base_models      # each: predict(features)->log t
        self.seed = seed

    def _adapter_feats(self, base_pred, x):
        if self.n_shots >= 6:
            return np.column_stack([base_pred, x[:, :4]])
        return base_pred[:, None]      # low-shot: scale+offset only

    def transfer(self, shot_x: np.ndarray, shot_y: np.ndarray):
        self.n_shots = len(shot_y)
        self.adapters = []
        self.weights = []
        for bm in self.base_models:
            base_pred = bm.predict(shot_x)
            feats = self._adapter_feats(base_pred, shot_x)
            ad = _Ridge().fit(feats, shot_y)
            # leave-one-out error for ensemble weighting
            errs = []
            n = len(shot_y)
            for i in range(n):
                mask = np.arange(n) != i
                if mask.sum() < 2:
                    continue
                ad_i = _Ridge().fit(feats[mask], shot_y[mask])
                errs.append(abs(ad_i.predict(feats[i:i + 1])[0] - shot_y[i]))
            err = float(np.mean(errs)) if errs else 1.0
            self.adapters.append(ad)
            self.weights.append(1.0 / (err + 1e-6))
        w = np.array(self.weights)
        self.weights = w / w.sum()
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        preds = []
        for bm, ad in zip(self.base_models, self.adapters):
            base_pred = bm.predict(x)
            feats = self._adapter_feats(base_pred, x)
            preds.append(ad.predict(feats))
        return np.average(np.stack(preds), axis=0, weights=self.weights)


def invariant_features(cells, config_features: np.ndarray) -> np.ndarray:
    """Platform-invariant features (thesis §6.2.2): the measured per-device
    cost profile (known from the cheap source platform's dry-run) plus
    config features. Only the *target platform's timing response* is
    unknown and few-shot."""
    lf = np.log2([max(c.flops, 1.0) for c in cells])
    lb = np.log2([max(c.bytes_, 1.0) for c in cells])
    lc = np.log2([max(c.coll, 1.0) for c in cells])
    return np.column_stack([lf, lb, lc, lf - lb, lf - lc, config_features])


def base_learners(features: np.ndarray, y_src: np.ndarray,
                  seed: int = 0) -> list:
    """The base learners on the cheap source platform's labels: one global
    forest and one per step kind (the last three feature columns) with at
    least 8 cells."""
    base_all = RandomForest(n_trees=60, seed=seed, min_samples_leaf=1,
                            max_features=features.shape[1]).fit(features,
                                                                y_src)
    bases = [base_all]
    kind_cols = features[:, -3:]
    for k in range(3):
        mask = kind_cols[:, k] > 0.5
        if mask.sum() >= 8:
            bases.append(RandomForest(n_trees=30, seed=seed + k + 1,
                                      min_samples_leaf=1)
                         .fit(features[mask], y_src[mask]))
    return bases


def evaluate_transfer(cells, features: np.ndarray, target: str,
                      shots_list=(1, 3, 5, 10, 20), seed=0, *, source: str,
                      platforms=PLATFORMS) -> dict:
    """Accuracy (100 - MRE%) on the target platform vs. #shots, compared to
    training from scratch on the same shots (thesis Fig. 6-4 / Table 6.6)."""
    rng = np.random.default_rng(seed)
    y_src = platform_labels(source, cells, platforms=platforms)
    y_tgt = platform_labels(target, cells, platforms=platforms)
    features = invariant_features(cells, features)
    bases = base_learners(features, y_src, seed)

    out = {}
    idx = rng.permutation(len(cells))
    for shots in shots_list:
        shot_idx = idx[:shots]
        test_idx = idx[shots:]
        if len(test_idx) < 5:
            continue
        lp = Leaper(bases, seed).transfer(features[shot_idx], y_tgt[shot_idx])
        pred = lp.predict(features[test_idx])
        mre_t = mean_relative_error(2.0 ** pred, 2.0 ** y_tgt[test_idx])
        # from-scratch baseline on the same shots
        if shots >= 2:
            scratch = RandomForest(n_trees=30, seed=seed).fit(
                features[shot_idx], y_tgt[shot_idx])
            pred_s = scratch.predict(features[test_idx])
            mre_s = mean_relative_error(2.0 ** pred_s,
                                        2.0 ** y_tgt[test_idx])
        else:
            mre_s = float("nan")
        out[shots] = {"leaper_acc_pct": 100 * (1 - min(mre_t, 1.0)),
                      "scratch_acc_pct": 100 * (1 - min(mre_s, 1.0)),
                      "n_test": len(test_idx)}
    return out
