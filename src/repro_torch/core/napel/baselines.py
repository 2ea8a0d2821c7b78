"""Comparison learners for the NAPEL/LEAPER evaluations (thesis Fig. 5-5,
6-7): a small ANN (numpy MLP) and a single decision tree — a copy of the
JAX package's ``repro/core/napel/baselines.py`` (numpy; equal to the bit)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.napel.forest import RegressionTree


class MLPRegressor:
    """2-hidden-layer tanh MLP trained with Adam (numpy)."""

    def __init__(self, hidden=(32, 32), lr=1e-2, epochs=400, seed=0):
        self.hidden = hidden
        self.lr = lr
        self.epochs = epochs
        self.seed = seed

    def fit(self, x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64).reshape(-1, 1)
        self.mu, self.sd = x.mean(0), x.std(0) + 1e-9
        self.ymu, self.ysd = y.mean(), y.std() + 1e-9
        xs = (x - self.mu) / self.sd
        ys = (y - self.ymu) / self.ysd
        rng = np.random.default_rng(self.seed)
        sizes = [x.shape[1], *self.hidden, 1]
        self.ws = [rng.normal(0, 1 / np.sqrt(sizes[i]),
                              (sizes[i], sizes[i + 1]))
                   for i in range(len(sizes) - 1)]
        self.bs = [np.zeros(s) for s in sizes[1:]]
        m = [np.zeros_like(w) for w in self.ws + self.bs]
        v = [np.zeros_like(w) for w in self.ws + self.bs]
        b1, b2, eps = 0.9, 0.999, 1e-8
        for t in range(1, self.epochs + 1):
            # forward
            acts = [xs]
            for i, (w, b) in enumerate(zip(self.ws, self.bs)):
                z = acts[-1] @ w + b
                acts.append(np.tanh(z) if i < len(self.ws) - 1 else z)
            err = acts[-1] - ys
            # backward
            grads_w, grads_b = [], []
            delta = 2 * err / len(ys)
            for i in range(len(self.ws) - 1, -1, -1):
                grads_w.insert(0, acts[i].T @ delta)
                grads_b.insert(0, delta.sum(0))
                if i > 0:
                    delta = (delta @ self.ws[i].T) * (1 - acts[i] ** 2)
            params = self.ws + self.bs
            grads = grads_w + grads_b
            for j, (p, g) in enumerate(zip(params, grads)):
                m[j] = b1 * m[j] + (1 - b1) * g
                v[j] = b2 * v[j] + (1 - b2) * g * g
                mh = m[j] / (1 - b1 ** t)
                vh = v[j] / (1 - b2 ** t)
                p -= self.lr * mh / (np.sqrt(vh) + eps)
        return self

    def predict(self, x):
        xs = (np.asarray(x, np.float64) - self.mu) / self.sd
        a = xs
        for i, (w, b) in enumerate(zip(self.ws, self.bs)):
            z = a @ w + b
            a = np.tanh(z) if i < len(self.ws) - 1 else z
        return a[:, 0] * self.ysd + self.ymu


class DecisionTree:
    """Single deep CART tree (the 'linear decision tree' comparison)."""

    def __init__(self, max_depth=16, seed=0):
        self.t = RegressionTree(max_depth=max_depth, min_samples_leaf=1,
                                max_features=10 ** 9,
                                rng=np.random.default_rng(seed))

    def fit(self, x, y):
        self.t.fit(np.asarray(x, np.float64), np.asarray(y, np.float64))
        return self

    def predict(self, x):
        return self.t.predict(np.asarray(x, np.float64))
