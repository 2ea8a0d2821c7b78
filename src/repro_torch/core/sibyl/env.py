"""Hybrid storage system (HSS) simulator — Sibyl's environment (thesis Ch. 7).

Trace-driven model of a fast + slow (+ optional mid, for tri-hybrid) device
pair: per-device service-time model (fixed cost + per-byte cost, separate
read/write asymmetry) with FIFO queue delay. A placement policy decides,
per write/miss, which device holds each page; reads hit wherever the page
lives; evictions migrate cold pages out of the fast device.

Devices follow the thesis' configurations: H&L (NVMe + HDD),
H&M (NVMe + SATA SSD), M&L, and tri-hybrid (H&M&L).

A copy of the JAX package's ``repro/core/sibyl/env.py`` (numpy, no jax
there either).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    read_base_us: float
    read_us_per_kb: float
    write_base_us: float
    write_us_per_kb: float
    capacity_pages: int
    gc_factor: float = 0.0   # SSD write amplification as the device fills

    def service_us(self, is_write: bool, size_kb: float,
                   fill: float = 0.0) -> float:
        if is_write:
            base = self.write_base_us + self.write_us_per_kb * size_kb
            # garbage-collection pressure: writes slow sharply near-full
            # (the read/write asymmetry + device state Sibyl learns, §7.9)
            over = max(0.0, fill - 0.7) / 0.3
            return base * (1.0 + self.gc_factor * over * over)
        return self.read_base_us + self.read_us_per_kb * size_kb


# device models (approximate public spec numbers; thesis Table 7.3 class)
NVME = lambda cap: Device("nvme", 8.0, 0.06, 12.0, 0.08, cap, 60.0)    # H
SATA = lambda cap: Device("sata_ssd", 90.0, 0.35, 70.0, 0.30, cap, 25.0)  # M
HDD = lambda cap: Device("hdd", 4000.0, 2.5, 4500.0, 2.5, cap, 0.0)    # L


def hss_config(name: str, fast_cap: int = 2048):
    if name == "H&L":
        return [NVME(fast_cap), HDD(1 << 30)]
    if name == "H&M":
        return [NVME(fast_cap), SATA(1 << 30)]
    if name == "M&L":
        return [SATA(fast_cap), HDD(1 << 30)]
    if name == "H&M&L":
        return [NVME(fast_cap), SATA(8 * fast_cap), HDD(1 << 30)]
    raise ValueError(name)


@dataclasses.dataclass
class PageMeta:
    device: int
    access_count: int = 0
    last_access_us: float = 0.0


N_FEATURES = 10


class HssEnv:
    """Gym-style loop: obs -> action (device index for current request's
    page) -> reward (negative served latency; thesis: system feedback)."""

    def __init__(self, devices: list[Device], evict_policy: str = "lru"):
        self.devices = devices
        self.evict_policy = evict_policy
        self.reset()

    def reset(self):
        self.pages: dict[int, PageMeta] = {}
        # per-device LRU order (OrderedDict: lba -> None); O(1) eviction
        self.lru: list[OrderedDict] = [OrderedDict()
                                       for _ in self.devices]
        self.dev_busy_until = np.zeros(len(self.devices))
        self.dev_counts = np.zeros(len(self.devices), int)
        self.now_us = 0.0
        self.total_lat = 0.0
        self.n_req = 0
        self.lat_ema = 100.0
        self.migrations = 0
        return None

    def _touch(self, lba: int, dev: int):
        od = self.lru[dev]
        od.pop(lba, None)
        od[lba] = None

    def _remove(self, lba: int, dev: int):
        self.lru[dev].pop(lba, None)

    # -- features (thesis Table 7.1 analogue) --------------------------------
    def observe(self, lba: int, size_kb: float, is_write: bool) -> np.ndarray:
        meta = self.pages.get(lba)
        fast = self.devices[0]
        fast_used = self.dev_counts[0] / max(fast.capacity_pages, 1)
        q = [max(0.0, b - self.now_us) for b in self.dev_busy_until]
        return np.array([
            min(size_kb / 256.0, 1.0),                     # request size
            1.0 if is_write else 0.0,                      # type
            fast_used,                                     # fast capacity used
            min(q[0] / 1000.0, 4.0),                       # fast queue (ms)
            min(q[-1] / 1000.0, 4.0),                      # slow queue (ms)
            min((meta.access_count if meta else 0) / 16.0, 2.0),  # hotness
            min((self.now_us - meta.last_access_us) / 1e5, 2.0)
            if meta else 2.0,                              # recency
            1.0 if meta and meta.device == 0 else 0.0,     # currently fast
            min(self.lat_ema / 1000.0, 4.0),               # latency EMA (ms)
            len(self.devices) - 2.0,                       # config id
        ], np.float32)

    # -- mechanics ------------------------------------------------------------
    def _serve(self, dev_idx: int, is_write: bool, size_kb: float) -> float:
        dev = self.devices[dev_idx]
        fill = self.dev_counts[dev_idx] / max(dev.capacity_pages, 1)
        start = max(self.now_us, self.dev_busy_until[dev_idx])
        svc = dev.service_us(is_write, size_kb, min(fill, 1.0))
        self.dev_busy_until[dev_idx] = start + svc
        return (start - self.now_us) + svc

    def _evict_if_full(self, dev_idx: int) -> float:
        """Demote the LRU page to the next tier. The demotion write blocks
        the allocating request (allocation stall — real HSS behaviour when
        the fast tier has no free space)."""
        lat = 0.0
        dev = self.devices[dev_idx]
        while self.dev_counts[dev_idx] > dev.capacity_pages and \
                dev_idx + 1 < len(self.devices):
            if not self.lru[dev_idx]:
                break
            victim, _ = self.lru[dev_idx].popitem(last=False)   # LRU head
            lat += self._serve(dev_idx, False, 4.0)     # read victim out
            lat += self._serve(dev_idx + 1, True, 4.0)  # write next tier
            self.pages[victim].device = dev_idx + 1
            self._touch(victim, dev_idx + 1)
            self.dev_counts[dev_idx] -= 1
            self.dev_counts[dev_idx + 1] += 1
            self.migrations += 1
        return lat

    def step(self, lba: int, size_kb: float, is_write: bool,
             action: int, inter_arrival_us: float = 10.0) -> tuple:
        """Returns (latency_us, reward)."""
        self.now_us += inter_arrival_us
        meta = self.pages.get(lba)
        lat = 0.0
        if is_write or meta is None:
            target = int(np.clip(action, 0, len(self.devices) - 1))
            if meta is None:
                meta = PageMeta(device=target)
                self.pages[lba] = meta
                self.dev_counts[target] += 1
            elif meta.device != target:
                # move on write (placement decision applies to writes)
                self.dev_counts[meta.device] -= 1
                self._remove(lba, meta.device)
                meta.device = target
                self.dev_counts[target] += 1
            lat += self._serve(target, True, size_kb)
            self._touch(lba, target)
            lat += self._evict_if_full(target)
        else:
            lat += self._serve(meta.device, False, size_kb)
            self._touch(lba, meta.device)
        meta.access_count += 1
        meta.last_access_us = self.now_us
        self.total_lat += lat
        self.n_req += 1
        self.lat_ema = 0.99 * self.lat_ema + 0.01 * lat
        # Sibyl reward: encourage low long-term latency. Log scale keeps
        # the us..ms dynamic range learnable for the Q-network. (An EMA
        # "system feedback" term was tried and measured worse — see
        # EXPERIMENTS.md §Validation notes.)
        reward = -float(np.log1p(lat / 100.0))
        return lat, reward

    @property
    def avg_latency_us(self) -> float:
        return self.total_lat / max(self.n_req, 1)
