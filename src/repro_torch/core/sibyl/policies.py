"""Baseline data-placement policies (thesis §7.3, §7.8 comparison set):
Fast-Only / Slow-Only, random, CDE-style (cold-data eviction heuristic),
HPS-style (history-based hot-page placement), and an offline
logistic-hotness predictor standing in for the RNN-HSS class.

A copy of the JAX package's ``repro/core/sibyl/policies.py`` (numpy, no
jax there either)."""
from __future__ import annotations

import numpy as np


class Policy:
    name = "base"

    def act(self, obs: np.ndarray, n_devices: int) -> int:
        raise NotImplementedError

    def feedback(self, reward: float):
        pass


class FastOnly(Policy):
    name = "fast_only"

    def act(self, obs, n_devices):
        return 0


class SlowOnly(Policy):
    name = "slow_only"

    def act(self, obs, n_devices):
        return n_devices - 1


class RandomPolicy(Policy):
    name = "random"

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def act(self, obs, n_devices):
        return int(self.rng.integers(0, n_devices))


class CDE(Policy):
    """Cold-data-eviction style: write to fast unless fast is full of
    hotter data; large cold writes go slow."""
    name = "cde"

    def act(self, obs, n_devices):
        size, fast_used, hot = obs[0], obs[2], obs[5]
        if fast_used > 0.95 and hot < 0.25:
            return n_devices - 1
        if size > 0.5 and hot < 0.125:
            return n_devices - 1
        return 0


class HPS(Policy):
    """History-based: place by access-count threshold + recency."""
    name = "hps"

    def act(self, obs, n_devices):
        hot, recency, fast_used = obs[5], obs[6], obs[2]
        if hot >= 0.25 or recency < 0.2:
            return 0
        if fast_used > 0.9:
            return n_devices - 1
        return 0 if hot > 0.0625 else n_devices - 1


class HotnessPredictor(Policy):
    """Offline-trained logistic predictor of near-future reuse (the
    supervised-learning comparison class). Online SGD on observed reward."""
    name = "archivist"

    def __init__(self, seed=0, lr=0.05):
        rng = np.random.default_rng(seed)
        self.w = rng.normal(0, 0.1, 10)
        self.b = 0.0
        self.lr = lr
        self._last = None

    def act(self, obs, n_devices):
        p = 1.0 / (1.0 + np.exp(-(obs @ self.w + self.b)))
        self._last = (obs, p)
        return 0 if p > 0.5 else n_devices - 1

    def feedback(self, reward):
        if self._last is None:
            return
        obs, p = self._last
        # good outcome (low latency) reinforces the chosen side
        target = 1.0 if reward > -1.0 else 0.0
        g = (p - target)
        self.w -= self.lr * g * obs
        self.b -= self.lr * g
