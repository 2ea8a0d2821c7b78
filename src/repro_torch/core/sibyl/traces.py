"""Synthetic MSRC-like block traces (thesis Table 7.4 workload classes).

Each named workload mixes zipfian hot spots, sequential runs, and random
scatter with a characteristic read ratio / working-set size — capturing the
randomness/hotness axes of thesis Fig. 7-3. Deterministic per seed.

A copy of the JAX package's ``repro/core/sibyl/traces.py`` (numpy, no
jax there either); `DecodeTraceRecorder` attaches to the port's
`serve.kvcache.PagedKVPool`.
"""
from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    read_ratio: float
    working_set: int          # pages
    zipf_a: float             # hotness skew (higher = hotter)
    seq_fraction: float       # sequential-run probability
    mean_size_kb: float
    inter_arrival_us: float
    scan_fraction: float = 0.2   # one-shot pages (backup/scan pollution)
    burst_len: int = 768         # scan burst length (back-to-back requests)


# 14 evaluated workloads (names mirror the MSRC set the thesis uses).
# Inter-arrival times are ms-scale: MSRC block traces run at ~10-500 IOPS,
# below even HDD saturation — placement, not raw queueing, decides latency.
WORKLOADS = {
    "hm_1": TraceSpec("hm_1", 0.95, 8192, 1.2, 0.1, 16, 8_000, 0.10, 512),
    "proj_0": TraceSpec("proj_0", 0.10, 16384, 1.4, 0.3, 32, 12_000, 0.30, 1024),
    "proj_2": TraceSpec("proj_2", 0.85, 32768, 1.1, 0.5, 64, 10_000, 0.35, 1536),
    "prxy_0": TraceSpec("prxy_0", 0.05, 2048, 1.8, 0.05, 8, 3_000, 0.08, 512),
    "prxy_1": TraceSpec("prxy_1", 0.60, 4096, 1.6, 0.1, 12, 4_000, 0.12, 768),
    "rsrch_0": TraceSpec("rsrch_0", 0.10, 3072, 1.7, 0.15, 12, 6_000, 0.20, 1024),
    "src1_0": TraceSpec("src1_0", 0.55, 24576, 1.3, 0.4, 48, 7_000, 0.25, 1024),
    "src1_2": TraceSpec("src1_2", 0.25, 12288, 1.5, 0.2, 24, 8_000, 0.20, 1280),
    "src2_0": TraceSpec("src2_0", 0.12, 6144, 1.6, 0.1, 16, 10_000, 0.15, 768),
    "stg_0": TraceSpec("stg_0", 0.30, 20480, 1.2, 0.6, 96, 15_000, 0.40, 2048),
    "ts_0": TraceSpec("ts_0", 0.18, 4096, 1.5, 0.1, 12, 8_000, 0.10, 640),
    "usr_0": TraceSpec("usr_0", 0.40, 16384, 1.4, 0.25, 24, 9_000, 0.25, 1024),
    "wdev_0": TraceSpec("wdev_0", 0.20, 5120, 1.6, 0.1, 16, 7_000, 0.12, 768),
    "web_0": TraceSpec("web_0", 0.70, 10240, 1.3, 0.35, 32, 6_000, 0.18, 1024),
}
UNSEEN = {
    "stg_1": TraceSpec("stg_1", 0.64, 28672, 1.15, 0.5, 72, 12_000, 0.35, 1536),
    "hm_0": TraceSpec("hm_0", 0.35, 9216, 1.45, 0.2, 20, 8_000, 0.15, 896),
    "mds_0": TraceSpec("mds_0", 0.12, 7168, 1.55, 0.15, 16, 9_000, 0.18, 1024),
    "wdev_2": TraceSpec("wdev_2", 0.45, 6144, 1.5, 0.12, 16, 7_000, 0.14, 768),
}


def generate(spec: TraceSpec, n: int, seed: int = 0) -> list[tuple]:
    """Returns [(lba, size_kb, is_write, inter_arrival_us), ...].

    Mix of a zipf-hot resident set, sequential runs, and *scan bursts*
    over one-shot pages (the cache-pollution pattern of MSRC traces —
    thesis Fig. 7-4 shows exactly these bursts in rsrch_0).
    """
    # zlib.crc32: stable across processes (str hash() is salted per run)
    rng = np.random.default_rng(seed ^ (zlib.crc32(spec.name.encode())
                                        & 0xFFFF))
    out = []
    lba = int(rng.integers(0, spec.working_set))
    scan_next = spec.working_set + 1_000_000   # fresh one-shot region
    burst_left = 0
    for _ in range(n):
        if burst_left > 0:
            burst_left -= 1
            scan_next += 1
            lba_req = scan_next
            size = 128.0   # scans are large sequential I/O
            is_write = rng.random() > 0.5
            dt = float(rng.exponential(spec.inter_arrival_us * 0.05))
        else:
            if rng.random() < spec.scan_fraction / max(spec.burst_len, 1):
                burst_left = spec.burst_len - 1
                scan_next += 1
                lba_req = scan_next
                size = 128.0   # scans are large sequential I/O
                is_write = rng.random() > 0.5
                dt = float(rng.exponential(spec.inter_arrival_us * 0.05))
            else:
                if rng.random() < spec.seq_fraction:
                    lba = (lba + 1) % spec.working_set
                else:
                    lba = int(rng.zipf(spec.zipf_a) % spec.working_set)
                lba_req = lba
                size = float(np.clip(rng.exponential(spec.mean_size_kb),
                                     4, 256))
                is_write = rng.random() > spec.read_ratio
                dt = float(rng.exponential(spec.inter_arrival_us))
        out.append((lba_req, size, is_write, dt))
    return out


class DecodeTraceRecorder:
    """Capture *real* serve-layer pool events as trace tuples.

    Attach to a `PagedKVPool` (``pool.recorder = DecodeTraceRecorder()``):
    every page ``put`` records a write, every gather ``touch`` a read, as
    ``(lba=page_id, size_kb, is_write, inter_arrival_us)`` — the exact
    schema `generate` emits — so decode-time placement workloads replay
    through `HssEnv` + `run_policy` next to the synthetic MSRC set
    (Sibyl trained where the data actually lives, thesis §7.7).
    """

    def __init__(self, max_events: int = 1_000_000):
        self.events: list[tuple] = []
        self.max_events = max_events
        self._last: float | None = None

    def record(self, lba: int, size_kb: float, is_write: bool):
        if len(self.events) >= self.max_events:
            return
        now = time.monotonic()
        dt = 0.0 if self._last is None else (now - self._last) * 1e6
        self._last = now
        self.events.append((int(lba), float(size_kb), bool(is_write), dt))


def mixed(specs: list[TraceSpec], n: int, seed: int = 0) -> list[tuple]:
    """Interleave several workloads with disjoint address spaces."""
    parts = [generate(s, n // len(specs), seed + i)
             for i, s in enumerate(specs)]
    rng = np.random.default_rng(seed)
    out = []
    offsets = [i * (1 << 24) for i in range(len(specs))]
    iters = [iter(p) for p in parts]
    alive = list(range(len(specs)))
    while alive:
        i = int(rng.choice(alive))
        try:
            lba, size, w, dt = next(iters[i])
            out.append((lba + offsets[i], size, w, dt))
        except StopIteration:
            alive.remove(i)
    return out
