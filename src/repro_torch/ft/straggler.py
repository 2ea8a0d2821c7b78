"""Straggler detection — a copy of the JAX package's
``repro/ft/straggler.py`` (numpy only): per-host step-time tracking with
robust outlier flagging (median + MAD). At fleet scale the supervisor
uses this to evict or deprioritize slow hosts; here it also powers tests
and the trainer's step-time health metric."""
from __future__ import annotations

import collections

import numpy as np


class StragglerMonitor:
    def __init__(self, n_hosts: int, window: int = 32, threshold: float = 3.5):
        self.n_hosts = n_hosts
        self.window = window
        self.threshold = threshold
        self.history = [collections.deque(maxlen=window)
                        for _ in range(n_hosts)]

    def record(self, host: int, step_time_s: float):
        self.history[host].append(step_time_s)

    def host_means(self) -> np.ndarray:
        return np.array([np.mean(h) if h else np.nan for h in self.history])

    def stragglers(self) -> list[int]:
        """Hosts whose mean step time is a MAD outlier above the median."""
        means = self.host_means()
        ok = ~np.isnan(means)
        if ok.sum() < 3:
            return []
        med = np.median(means[ok])
        mad = np.median(np.abs(means[ok] - med)) + 1e-9
        z = 0.6745 * (means - med) / mad
        return [i for i in range(self.n_hosts)
                if ok[i] and z[i] > self.threshold]

    def should_mitigate(self) -> bool:
        return len(self.stragglers()) > 0
