"""Paged KV pool: int8 page quantization and tier placement.

The JAX package's ``repro/serve/kvcache.py`` pool (the port imports
nothing of that package; its dense-cache ``pad_caches`` lives in
`repro_torch.models.transformer`); page contents stay host numpy, as
there, in three tiers: device "fast" float, device "slow" int8 and the
host "host" swap tier of preempted sequences.

The `PagedKVPool` owns the page *lifecycle*: tier placement per page
(policy-driven), LRU demotion under fast-tier pressure, reference-counted
sharing of content-identical pages (prefix caching), adoption of cached
pages by reference (the radix prefix cache's pins, `adopt_page` /
`ref_page` / `unref_page`), whole-sequence swap to the host tier and
back (`swap_out_seq` / `swap_in_seq`, the preemption substrate), and
`free(seq_id)` when a request retires — so the pool's live page count
tracks the working set instead of growing monotonically. Page *contents*
are additionally mirrored into device-resident tensors by
`repro_torch.serve.device_pool` for the decode step.
"""
from __future__ import annotations

import dataclasses
import weakref
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
# Paged KV pool with three tiers (device "fast" float / device "slow" int8 /
# host "host" swap space) — Sibyl's substrate
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Page:
    page_id: int
    seq_id: int        # first owner (refs may span several sequences)
    tier: str          # "fast" | "slow" | "host" (swapped out, no mirror)
    quantized: bool
    layer: int = 0     # model layer the page belongs to
    access_count: int = 0
    last_access: int = 0
    data: Optional[tuple] = None   # (k, v) or ((kq, ks), (vq, vs))
    refs: int = 1                  # holders (prefix-shared pages: > 1)
    content_hash: Optional[tuple] = None   # (layer, token-prefix hash)
    version: int = 0               # bumped on tier change (mirror sync key)
    nbytes: int = 0
    resident_tier: Optional[str] = None  # pre-swap tier while tier == "host"


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
    admission gate checks (`headroom()`); the pool itself never refuses a
    put — overflowing ``fast_capacity_pages`` LRU-demotes to slow instead.

    A third "host" tier holds swapped-out (preempted) sequences:
    `swap_out_seq` parks a sequence's exclusively-held pages on the host
    *keeping their exact resident representation* (fast pages stay float,
    slow pages stay int8) so `swap_in_seq` restores bit-identical content
    and a resumed sequence decodes token-for-token as if never preempted.
    Host pages don't count against `headroom()` and are unreachable via
    `page_by_hash` (no dedup or radix pin can land on a parked page).
    """

    # every live pool, for test-teardown invariant sweeps (conftest)
    _instances: "weakref.WeakSet[PagedKVPool]" = weakref.WeakSet()

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
        self.host_pages = 0           # pages currently in the "host" tier
        self._parked: set[int] = set()  # seq ids swapped out via swap_out_seq
        self.recorder = None          # optional record(pid, kib, is_write)
        self.stats = {"fast_hits": 0, "slow_hits": 0, "host_hits": 0,
                      "evictions": 0, "fast_bytes": 0, "slow_bytes": 0,
                      "host_bytes": 0, "freed": 0, "shared_puts": 0,
                      "adopted_pages": 0, "swapped_out": 0, "swapped_in": 0,
                      "swap_out_bytes": 0, "swap_in_bytes": 0}
        PagedKVPool._instances.add(self)

    def _fast_pages(self):
        """Inspection helper only — the put/touch/evict hot paths must not
        rescan the pool (see `_fast_lru`)."""
        return [p for p in self.pages.values() if p.tier == "fast"]

    @property
    def live_pages(self) -> int:
        return len(self.pages)

    @property
    def resident_pages(self) -> int:
        """Pages on the device tiers — host-parked pages are excluded, so
        a preempted sequence releases its whole budget footprint."""
        return len(self.pages) - self.host_pages

    def headroom(self) -> float:
        """Pages left under the soft budget (inf when unbounded)."""
        if self.capacity_pages is None:
            return float("inf")
        return self.capacity_pages - self.resident_pages

    def _record(self, page: Page, is_write: bool):
        if self.recorder is not None:
            self.recorder.record(page.page_id, page.nbytes / 1024.0, is_write)

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
                self._record(page, is_write=False)
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
        self._record(page, is_write=True)
        self._maybe_evict()
        return pid

    def _touch_page(self, pid: int) -> Page:
        """Per-page access bookkeeping (hit stats, LRU recency, recorder)
        at the current clock — the clock tick itself is the caller's."""
        page = self.pages[pid]
        page.access_count += 1
        page.last_access = self.clock
        if page.tier == "fast":
            self._fast_lru.move_to_end(pid)
            self.stats["fast_hits"] += 1
        elif page.tier == "host":
            self.stats["host_hits"] += 1
        else:
            self.stats["slow_hits"] += 1
        self._record(page, is_write=False)
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
        if not page.quantized:     # fast, or a host page swapped from fast
            return page.data
        (kq, ks), (vq, vs) = page.data
        return dequantize_page(kq, ks), dequantize_page(vq, vs)

    def seq_pages(self, seq_id: int, layer: int = 0) -> list[int]:
        """Page ids of (seq_id, layer) in write order — O(1) lookup, not a
        pool scan (gather calls this per layer per decode step)."""
        return list(self._by_seq.get((seq_id, layer), ()))

    # -- reference management (prefix cache / radix tree hooks) -------------
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
        the prefill that would have re-computed it never runs. Counted
        separately from `shared_puts` (those still re-compute and dedup
        on store; adoption skips the compute entirely)."""
        self.clock += 1
        page = self.pages[pid]
        page.refs += 1
        page.last_access = self.clock
        if page.tier == "fast":
            self._fast_lru.move_to_end(pid)
        self._by_seq.setdefault((seq_id, layer), []).append(pid)
        self.stats["adopted_pages"] += 1
        self._record(page, is_write=False)

    def _destroy(self, page: Page) -> None:
        del self.pages[page.page_id]
        self._fast_lru.pop(page.page_id, None)
        # only drop the hash mapping if it still points at THIS page — a
        # swapped-out page's hash may have been re-claimed by a new page
        if page.content_hash is not None and \
                self._by_hash.get(page.content_hash) == page.page_id:
            del self._by_hash[page.content_hash]
        if page.tier == "host":
            self.host_pages -= 1
        self.stats[f"{page.tier}_bytes"] -= page.nbytes
        self.stats["freed"] += 1

    def free(self, seq_id: int) -> list[tuple]:
        """Release every (seq_id, layer) page reference of a retired
        request. Pages whose last holder this was are destroyed (byte stats
        shrink back to the live working set); prefix-shared and
        radix-pinned pages survive until the final holder frees them.
        Returns destroyed ``(page_id, layer)`` pairs (the layer routes
        device-slot recycling without scanning every layer's mirror)."""
        destroyed: list[tuple] = []
        self._parked.discard(seq_id)
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
        """Retire the OLDEST page of ``(seq_id, layer)`` — the ring-buffer
        recycling primitive for sliding-window layers. Once the window
        slides past a page's positions those rows can never be attended
        again, so dropping the front page bounds the per-sequence page
        need at O(window) instead of O(generated length). Returns the
        destroyed ``(page_id, layer)`` pairs in `free`'s format (empty
        while other holders keep the page alive)."""
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

    # -- host tier: whole-sequence swap (preemption substrate) --------------
    def swap_out_seq(self, seq_id: int) -> list[tuple]:
        """Park a sequence's exclusively-held pages on the host tier.

        Refcount- and radix-pin-aware: a page with ``refs > 1`` stays
        resident while any *live* reader remains (another active sequence
        or a radix-tree pin still serves gathers from it), so only this
        sequence's private KV leaves the device budget. Shared-page
        parking rule: when the LAST live holder of a shared page parks —
        every holding sequence is itself swapped out and no external pin
        covers it (``refs`` equals the holder multiplicity) — the page
        parks with it; otherwise it would sit device-resident with no
        covering reservation, silently eating the budget the scheduler
        believes is free. Parked pages keep their exact resident
        representation (float stays float, int8 stays int8): swap-in is a
        bit-identical restore, which is what makes a resumed sequence's
        greedy output token-for-token equal to the never-preempted run.
        The page's content hash is unregistered so no new put/adoption can
        dedup onto a page with no device mirror.

        Returns the parked ``(page_id, layer)`` pairs so the caller can
        release the matching device slots.
        """
        swapped: list[tuple] = []
        seen: set[int] = set()
        self._parked.add(seq_id)
        holder_seqs: Optional[dict] = None   # pid -> [holding seq ids]
        for key in [k for k in self._by_seq if k[0] == seq_id]:
            for pid in self._by_seq[key]:
                if pid in seen:
                    continue
                seen.add(pid)
                page = self.pages[pid]
                if page.tier == "host":
                    continue
                if page.refs > 1:
                    # shared page: park only as the last live holder, and
                    # only when no non-sequence pin covers it. The holder
                    # map is built lazily — preemption touching a shared
                    # page is the rare path.
                    if holder_seqs is None:
                        holder_seqs = {}
                        for (s, _l), ps in self._by_seq.items():
                            for p2 in ps:
                                holder_seqs.setdefault(p2, []).append(s)
                    held = holder_seqs.get(pid, ())
                    if page.refs != len(held) or \
                            any(s not in self._parked for s in held):
                        continue
                self.stats[f"{page.tier}_bytes"] -= page.nbytes
                if page.tier == "fast":
                    self._fast_lru.pop(pid, None)
                page.resident_tier = page.tier
                page.tier = "host"
                page.version += 1
                if page.content_hash is not None and \
                        self._by_hash.get(page.content_hash) == pid:
                    del self._by_hash[page.content_hash]
                self.host_pages += 1
                self.stats["host_bytes"] += page.nbytes
                self.stats["swapped_out"] += 1
                self.stats["swap_out_bytes"] += page.nbytes
                swapped.append((pid, page.layer))
        return swapped

    def swap_in_seq(self, seq_id: int) -> list[tuple]:
        """Bring a parked sequence's host pages back to their pre-swap
        device tier, bit-identical (the representation was preserved).
        The version bump makes the next device `sync` re-upload them; the
        content hash re-registers unless a newer page claimed it while
        the sequence was parked. Returns restored ``(page_id, layer)``."""
        restored: list[tuple] = []
        seen: set[int] = set()
        self._parked.discard(seq_id)
        for key in [k for k in self._by_seq if k[0] == seq_id]:
            for pid in self._by_seq[key]:
                if pid in seen:
                    continue
                seen.add(pid)
                page = self.pages[pid]
                if page.tier != "host":
                    continue
                tier = page.resident_tier or "slow"
                page.tier, page.resident_tier = tier, None
                page.version += 1
                self.host_pages -= 1
                self.stats["host_bytes"] -= page.nbytes
                self.stats[f"{tier}_bytes"] += page.nbytes
                self.stats["swapped_in"] += 1
                self.stats["swap_in_bytes"] += page.nbytes
                if tier == "fast":
                    self._fast_lru[pid] = None
                if page.content_hash is not None:
                    self._by_hash.setdefault(page.content_hash, pid)
                restored.append((pid, page.layer))
        self._maybe_evict()
        return restored

    def check_invariants(self, pins: Optional[dict] = None) -> None:
        """Structural self-check (asserted per step under
        ``REPRO_SERVE_DEBUG``): every page is held by the sequences whose
        page lists name it plus ``pins`` (page id -> references held from
        outside, e.g. the radix tree's `pin_counts()`; without it no page
        may be pinned), tier, quantization and LRU membership agree, a
        host page keeps its resident tier, no resident page is left
        behind by holders that are all parked, the byte stats equal the
        live sums and the hash index names live, resident pages. Raises
        AssertionError on the first breach."""
        pins = pins or {}
        holders: dict[int, int] = {}
        holder_seqs: dict[int, set] = {}
        for key, pids in self._by_seq.items():
            for pid in pids:
                assert pid in self.pages, \
                    f"_by_seq[{key}] names dead page {pid}"
                holders[pid] = holders.get(pid, 0) + 1
                holder_seqs.setdefault(pid, set()).add(key[0])
        tier_bytes = {"fast": 0, "slow": 0, "host": 0}
        n_host = 0
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
            if page.tier == "host":
                n_host += 1
                assert page.resident_tier in ("fast", "slow"), \
                    f"host page {pid} lost its resident tier"
            else:
                assert page.quantized == (page.tier == "slow"), \
                    f"page {pid}: tier {page.tier} quantized={page.quantized}"
                # shared-page parking rule: a device-resident page whose
                # every holder is itself parked and that carries no
                # external pin (refs == holder multiplicity) has no live
                # reader and no covering reservation — it must have been
                # parked with the last holder to leave
                assert not (held > 0 and page.refs == held and
                            holder_seqs[pid] <= self._parked), \
                    (f"page {pid}: resident but every holder "
                     f"{sorted(holder_seqs[pid])} is parked and no pin "
                     f"covers it — swap_out_seq should have parked it")
            tier_bytes[page.tier] += page.nbytes
        assert n_host == self.host_pages, \
            f"host_pages={self.host_pages} but {n_host} host-tier pages"
        for tier, total in tier_bytes.items():
            assert self.stats[f"{tier}_bytes"] == total, \
                (f"{tier}_bytes stat {self.stats[f'{tier}_bytes']} != "
                 f"live sum {total}")
        for h, pid in self._by_hash.items():
            page = self.pages.get(pid)
            assert page is not None, f"_by_hash[{h}] names dead page {pid}"
            assert page.content_hash == h, \
                f"_by_hash[{h}] -> page {pid} hashed {page.content_hash}"
            assert page.tier != "host", \
                f"_by_hash[{h}] resolves to parked page {pid}"

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
