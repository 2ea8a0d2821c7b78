"""Paged KV pool: int8 page quantization and tier placement.

The part of the JAX package's ``repro/serve/kvcache.py`` pool that the
port's serving path drives (the port imports nothing of that package);
page contents stay host numpy, as there. The host swap tier (preemption)
comes with the slice that ports it.

The `PagedKVPool` owns the page *lifecycle*: tier placement per page
(policy-driven), LRU demotion under fast-tier pressure, reference-counted
sharing of content-identical pages (prefix caching), adoption of cached
pages by reference (the radix prefix cache's pins, `adopt_page` /
`ref_page` / `unref_page`), and `free(seq_id)` when a request retires — so the pool's live page count tracks the working
set instead of growing monotonically. Page *contents* are additionally
mirrored into device-resident arrays by `repro_torch.serve.device_pool` for the
decode-step gather.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# int8 page quantization (data-centric: "reduce the memory footprint") —
# the format is shared with the paged-attention kernel's example inputs
# ---------------------------------------------------------------------------
from repro_torch.kernels.paged_attention.quant import (  # noqa: E402,F401
    dequantize_page, quantize_page)


# ---------------------------------------------------------------------------
# Paged KV pool with two device tiers ("fast" float / "slow" int8) —
# Sibyl's substrate
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Page:
    page_id: int
    seq_id: int        # first owner (refs may span several sequences)
    tier: str          # "fast" | "slow"
    quantized: bool
    layer: int = 0     # model layer the page belongs to
    access_count: int = 0
    last_access: int = 0
    data: Optional[tuple] = None   # (k, v) or ((kq, ks), (vq, vs))
    refs: int = 1                  # holders (prefix-shared pages: > 1)
    content_hash: Optional[tuple] = None   # (layer, token-prefix hash)
    version: int = 0               # bumped on tier change (mirror sync key)
    nbytes: int = 0


def _data_nbytes(data) -> int:
    total = 0
    for part in data:
        if isinstance(part, tuple):
            total += sum(np.asarray(x).nbytes for x in part)
        else:
            total += np.asarray(part).nbytes
    return total


class PagedKVPool:
    """Page-granular KV store with tier placement decided by a policy object
    (heuristic or Sibyl RL agent). The slow tier stores pages int8-quantized.

    ``capacity_pages`` is the soft total-page budget the serve scheduler's
    admission gate checks; the pool itself never refuses a put —
    overflowing ``fast_capacity_pages`` LRU-demotes to slow instead.
    """

    def __init__(self, page_tokens: int = 128, fast_capacity_pages: int = 1024,
                 placement_policy=None, capacity_pages: Optional[int] = None):
        self.page_tokens = page_tokens
        self.fast_capacity = fast_capacity_pages
        self.capacity_pages = capacity_pages
        self.policy = placement_policy
        self.pages: dict[int, Page] = {}
        self._by_seq: dict[tuple, list[int]] = {}   # (seq, layer) -> pids
        self._by_hash: dict[tuple, int] = {}        # (layer, hash) -> pid
        # fast-tier pages in LRU order (oldest first) — eviction pops the
        # head in O(1) instead of rescanning every page per victim
        self._fast_lru: OrderedDict[int, None] = OrderedDict()
        self.clock = 0
        self.next_id = 0
        self.stats = {"fast_hits": 0, "slow_hits": 0, "evictions": 0,
                      "fast_bytes": 0, "slow_bytes": 0, "freed": 0,
                      "shared_puts": 0, "adopted_pages": 0}

    @property
    def live_pages(self) -> int:
        return len(self.pages)

    def put(self, seq_id: int, k: np.ndarray, v: np.ndarray,
            layer: int = 0, content_hash=None) -> int:
        """Store one page for (seq_id, layer). With a `content_hash` (a
        token-prefix digest), a page already holding identical content is
        shared instead: its ref count grows and both sequences' page lists
        name the same page id."""
        self.clock += 1
        if content_hash is not None:
            pid = self._by_hash.get((layer, content_hash))
            if pid is not None:
                page = self.pages[pid]
                page.refs += 1
                page.last_access = self.clock
                if page.tier == "fast":
                    self._fast_lru.move_to_end(pid)
                self._by_seq.setdefault((seq_id, layer), []).append(pid)
                self.stats["shared_puts"] += 1
                return pid
        pid = self.next_id
        self.next_id += 1
        feats = self._features(seq_id)
        tier = "fast"
        if self.policy is not None:
            tier = self.policy.place(feats)
        page = Page(pid, seq_id, tier, quantized=(tier == "slow"),
                    layer=layer, last_access=self.clock)
        if tier == "slow":
            page.data = (quantize_page(k), quantize_page(v))
        else:
            page.data = (k, v)
        page.nbytes = _data_nbytes(page.data)
        if content_hash is not None:
            page.content_hash = (layer, content_hash)
            self._by_hash[page.content_hash] = pid
        self.pages[pid] = page
        self._by_seq.setdefault((seq_id, layer), []).append(pid)
        if tier == "fast":
            self._fast_lru[pid] = None
        self.stats[f"{tier}_bytes"] += page.nbytes
        self._maybe_evict()
        return pid

    def _touch_page(self, pid: int) -> Page:
        """Per-page access bookkeeping (hit stats, LRU recency)
        at the current clock — the clock tick itself is the caller's."""
        page = self.pages[pid]
        page.access_count += 1
        page.last_access = self.clock
        if page.tier == "fast":
            self._fast_lru.move_to_end(pid)
            self.stats["fast_hits"] += 1
        else:
            self.stats["slow_hits"] += 1
        return page

    def touch(self, pid: int) -> Page:
        """Record an access (hit stats, LRU recency) and return the page
        without dequantizing — the paged-attention gather wants the raw
        tier representation (the kernel dequantizes slow pages on load)."""
        self.clock += 1
        return self._touch_page(pid)

    def touch_many(self, pids) -> None:
        """Batched access recording for one decode step: the clock ticks
        ONCE for the whole step and every page the step reads is touched
        once per (pid, step) — not once per layer — so the clock-phase
        recency feature the Sibyl policy sees advances in decode steps,
        not in (layers x pages) micro-events, and hit stats count each
        page read once per token."""
        self.clock += 1
        for pid in dict.fromkeys(pids):
            self._touch_page(pid)

    def get(self, pid: int):
        page = self.touch(pid)
        if not page.quantized:
            return page.data
        (kq, ks), (vq, vs) = page.data
        return dequantize_page(kq, ks), dequantize_page(vq, vs)

    def seq_pages(self, seq_id: int, layer: int = 0) -> list[int]:
        """Page ids of (seq_id, layer) in write order — O(1) lookup, not a
        pool scan (gather calls this per layer per decode step)."""
        return list(self._by_seq.get((seq_id, layer), ()))

    # -- reference management (radix prefix cache hooks) ---------------------
    def page_by_hash(self, layer: int, content_hash) -> Optional[int]:
        """Page id currently storing `(layer, content_hash)`, or None —
        how the radix prefix index resolves hashes to live pages."""
        return self._by_hash.get((layer, content_hash))

    def ref_page(self, pid: int) -> None:
        """Take an extra reference on a live page (the radix tree's pin:
        the page now survives every sequence that wrote it retiring)."""
        self.pages[pid].refs += 1

    def unref_page(self, pid: int) -> list[tuple]:
        """Drop one reference (the tree's unpin). Returns the destroyed
        ``(page_id, layer)`` pairs — empty while other holders remain —
        in `free`'s format so device-slot recycling is uniform."""
        page = self.pages.get(pid)
        if page is None:
            return []
        page.refs -= 1
        if page.refs > 0:
            return []
        self._destroy(page)
        return [(pid, page.layer)]

    def adopt_page(self, seq_id: int, pid: int, layer: int) -> None:
        """Attach a cached page to a sequence WITHOUT storing anything:
        refs grow, the page joins the sequence's per-layer page list, and
        the prefill that would have re-computed it never runs."""
        self.clock += 1
        page = self.pages[pid]
        page.refs += 1
        page.last_access = self.clock
        if page.tier == "fast":
            self._fast_lru.move_to_end(pid)
        self._by_seq.setdefault((seq_id, layer), []).append(pid)
        self.stats["adopted_pages"] += 1

    def _destroy(self, page: Page) -> None:
        del self.pages[page.page_id]
        self._fast_lru.pop(page.page_id, None)
        if page.content_hash is not None:
            del self._by_hash[page.content_hash]
        self.stats[f"{page.tier}_bytes"] -= page.nbytes
        self.stats["freed"] += 1

    def free(self, seq_id: int) -> list[tuple]:
        """Release every (seq_id, layer) page reference of a retired
        request. Pages whose last holder this was are destroyed (byte stats
        shrink back to the live working set); prefix-shared pages survive
        until the final holder frees them.
        Returns destroyed ``(page_id, layer)`` pairs (the layer routes
        device-slot recycling without scanning every layer's mirror)."""
        destroyed: list[tuple] = []
        # key scan is O(live (seq, layer) entries) — bounded by active
        # requests x layers, not by pool size
        for key in [k for k in self._by_seq if k[0] == seq_id]:
            for pid in self._by_seq.pop(key):
                page = self.pages.get(pid)
                if page is None:
                    continue
                page.refs -= 1
                if page.refs > 0:
                    continue
                self._destroy(page)
                destroyed.append((pid, page.layer))
        return destroyed

    def drop_front(self, seq_id: int, layer: int = 0) -> list[tuple]:
        """Retire the OLDEST page of ``(seq_id, layer)`` — the ring-page
        recycling primitive of sliding-window layers: once the window has
        slid past a page's positions they are never attended again.
        Returns the destroyed ``(page_id, layer)`` pairs in `free`'s
        format (empty while other holders keep the page alive)."""
        pids = self._by_seq.get((seq_id, layer))
        if not pids:
            return []
        pid = pids.pop(0)
        if not pids:
            del self._by_seq[(seq_id, layer)]
        page = self.pages.get(pid)
        if page is None:
            return []
        page.refs -= 1
        if page.refs > 0:
            return []
        self._destroy(page)
        return [(pid, page.layer)]

    def check_invariants(self, pins: Optional[dict] = None) -> None:
        """Structural self-check: every page is held by the sequences whose
        page lists name it plus ``pins`` (page id -> references held from
        outside, e.g. the radix tree's `pin_counts()`; without it no page
        may be pinned), tier, quantization and LRU membership agree, the
        byte stats equal the live sums and the hash index names live
        pages. Raises AssertionError on the first breach."""
        pins = pins or {}
        holders: dict[int, int] = {}
        for key, pids in self._by_seq.items():
            for pid in pids:
                assert pid in self.pages, \
                    f"_by_seq[{key}] names dead page {pid}"
                holders[pid] = holders.get(pid, 0) + 1
        tier_bytes = {"fast": 0, "slow": 0}
        for pid, page in self.pages.items():
            assert page.page_id == pid
            assert page.tier in tier_bytes, f"page {pid} tier {page.tier!r}"
            held = holders.get(pid, 0)
            pinned = pins.get(pid, 0)
            assert page.refs == held + pinned >= 1, \
                (f"page {pid}: refs={page.refs} != seq holders {held} + "
                 f"pins {pinned}")
            assert (pid in self._fast_lru) == (page.tier == "fast"), \
                f"page {pid}: tier {page.tier} vs LRU membership mismatch"
            assert page.quantized == (page.tier == "slow"), \
                f"page {pid}: tier {page.tier} quantized={page.quantized}"
            tier_bytes[page.tier] += page.nbytes
        for tier, total in tier_bytes.items():
            assert self.stats[f"{tier}_bytes"] == total, \
                (f"{tier}_bytes stat {self.stats[f'{tier}_bytes']} != "
                 f"live sum {total}")
        for h, pid in self._by_hash.items():
            page = self.pages.get(pid)
            assert page is not None, f"_by_hash[{h}] names dead page {pid}"
            assert page.content_hash == h, \
                f"_by_hash[{h}] -> page {pid} hashed {page.content_hash}"

    def _maybe_evict(self):
        # O(1) per victim: pop the LRU head instead of rescanning the pool
        while len(self._fast_lru) > self.fast_capacity:
            pid, _ = self._fast_lru.popitem(last=False)
            victim = self.pages[pid]
            k, v = victim.data
            self.stats["fast_bytes"] -= victim.nbytes
            victim.data = (quantize_page(k), quantize_page(v))
            victim.tier, victim.quantized = "slow", True
            victim.version += 1            # device mirror must rewrite
            victim.nbytes = _data_nbytes(victim.data)
            self.stats["slow_bytes"] += victim.nbytes
            self.stats["evictions"] += 1

    def _features(self, seq_id: int) -> np.ndarray:
        """Sibyl-style state features (Table 7.1 analogue)."""
        n_fast = len(self._fast_lru)
        return np.array([
            n_fast / max(1, self.fast_capacity),            # fast fill ratio
            len(self.pages) / max(1, self.fast_capacity),   # total pressure
            seq_id % 16 / 16.0,                             # request stream id
            (self.clock % 4096) / 4096.0,                   # phase
        ], np.float32)
