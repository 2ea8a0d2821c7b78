"""Random-forest regression from scratch (numpy) — NAPEL's ensemble learner
(thesis §5.2.5), a copy of the JAX package's ``repro/core/napel/forest.py``
whose fits and predictions equal the reference's to the bit. No sklearn:
CART trees with feature subsampling + bootstrap aggregation, plus
feature importances for the explainability analyses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    value: float = 0.0


class RegressionTree:
    def __init__(self, max_depth=12, min_samples_leaf=2, max_features=None,
                 rng=None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)
        self.root = None
        self.importances_ = None

    def fit(self, x, y):
        self.importances_ = np.zeros(x.shape[1])
        self.root = self._build(x, y, 0)
        tot = self.importances_.sum()
        if tot > 0:
            self.importances_ /= tot
        return self

    def _build(self, x, y, depth):
        node = _Node(value=float(y.mean()))
        if depth >= self.max_depth or len(y) < 2 * self.min_samples_leaf \
                or np.allclose(y, y[0]):
            return node
        nfeat = x.shape[1]
        k = self.max_features or max(1, int(np.sqrt(nfeat)))
        feats = self.rng.choice(nfeat, size=min(k, nfeat), replace=False)
        best = (None, None, np.inf)
        base_sse = float(((y - y.mean()) ** 2).sum())
        for f in feats:
            order = np.argsort(x[:, f], kind="stable")
            xs, ys = x[order, f], y[order]
            csum = np.cumsum(ys)
            csq = np.cumsum(ys * ys)
            n = len(ys)
            tot, totsq = csum[-1], csq[-1]
            idxs = np.arange(self.min_samples_leaf, n - self.min_samples_leaf + 1)
            if len(idxs) == 0:
                continue
            valid = xs[idxs - 1] < xs[np.minimum(idxs, n - 1)]
            idxs = idxs[valid]
            if len(idxs) == 0:
                continue
            nl = idxs.astype(float)
            sl, sql = csum[idxs - 1], csq[idxs - 1]
            sse_l = sql - sl * sl / nl
            nr = n - nl
            sr, sqr = tot - sl, totsq - sql
            sse_r = sqr - sr * sr / nr
            sse = sse_l + sse_r
            j = int(np.argmin(sse))
            if sse[j] < best[2]:
                i = idxs[j]
                best = (f, (xs[i - 1] + xs[i]) / 2.0, float(sse[j]))
        f, thresh, sse = best
        if f is None or not np.isfinite(sse) or sse >= base_sse - 1e-12:
            return node
        mask = x[:, f] <= thresh
        if mask.all() or (~mask).all():
            return node
        self.importances_[f] += base_sse - sse
        node.feature, node.thresh = int(f), float(thresh)
        node.left = self._build(x[mask], y[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], depth + 1)
        return node

    def predict(self, x):
        out = np.empty(len(x))
        for i, row in enumerate(x):
            node = self.root
            while node.left is not None:
                node = node.left if row[node.feature] <= node.thresh \
                    else node.right
            out[i] = node.value
        return out


class RandomForest:
    """Bagged regression trees with hyper-parameter tuning support."""

    def __init__(self, n_trees=60, max_depth=12, min_samples_leaf=2,
                 max_features=None, seed=0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.seed = seed
        self.trees: list[RegressionTree] = []

    def fit(self, x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for _ in range(self.n_trees):
            idx = rng.integers(0, len(y), size=len(y))
            t = RegressionTree(self.max_depth, self.min_samples_leaf,
                               self.max_features,
                               np.random.default_rng(rng.integers(1 << 31)))
            t.fit(x[idx], y[idx])
            self.trees.append(t)
        return self

    def predict(self, x):
        x = np.asarray(x, np.float64)
        return np.mean([t.predict(x) for t in self.trees], axis=0)

    @property
    def feature_importances_(self):
        return np.mean([t.importances_ for t in self.trees], axis=0)


def tune_hyperparameters(x, y, folds=3, seed=0):
    """Small grid cross-validation (thesis: 'additional tuning of
    hyper-parameters'). Returns the best RandomForest kwargs."""
    x = np.asarray(x)
    y = np.asarray(y)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    grid = [dict(n_trees=nt, max_depth=d, min_samples_leaf=m)
            for nt in (40, 80) for d in (8, 14) for m in (1, 3)]
    best, best_err = grid[0], np.inf
    for kw in grid:
        errs = []
        for f in range(folds):
            test = idx[f::folds]
            train = np.setdiff1d(idx, test)
            if len(train) < 4 or len(test) < 1:
                continue
            rf = RandomForest(seed=seed, **kw).fit(x[train], y[train])
            p = rf.predict(x[test])
            errs.append(np.mean(np.abs(p - y[test]) /
                                np.maximum(np.abs(y[test]), 1e-12)))
        err = float(np.mean(errs)) if errs else np.inf
        if err < best_err:
            best, best_err = kw, err
    return best, best_err


def mean_relative_error(pred, actual) -> float:
    pred = np.asarray(pred, np.float64)
    actual = np.asarray(actual, np.float64)
    return float(np.mean(np.abs(pred - actual) /
                         np.maximum(np.abs(actual), 1e-12)))
