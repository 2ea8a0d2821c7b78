"""Device-resident page-pool tensors for the paged-attention kernel.

The port of ``repro/serve/device_pool.py`` on one device. The host
`PagedKVPool` owns page *lifecycle* (placement, ref counts, LRU demotion,
byte stats); this mirror keeps page *contents* resident in preallocated
tensors so that a decode step reads them where they are.

All layers share ONE pool with a leading layer axis on its six tensors,
``(num_layers, capacity, page_tokens, hkv, hd)``: fp32 float pages, int8
pages and fp32 per-row scales for K and V. A *slot* is layer-uniform —
the same KV token range lives at slot ``s`` of every layer — so one page
*group* (the per-layer pool pids of one logical page, keyed by its
layer-0 pid) occupies one slot and one page table per decode step serves
the whole stack.

Both tiers share one slot space, exactly the layout the kernel consumes:
a fast (layer, slot) cell holds float K/V and zeros in the int8 + scale
tensors, a slow cell the reverse, so ``k = k_pages + k_quant * k_scale``
is exact either way. A cell is written in full on (re)assignment.

Every write is in place (``index_copy_`` / ``index_fill_`` on flattened
views of the pool tensors): at full width the pool holds hundreds of MB
to GB, and a copy per write would swamp the step. Sync is incremental
and versioned: a page is rewritten only when it is new to the mirror or
its `Page.version` changed (LRU demotion bumps it).
"""
from __future__ import annotations

import weakref

import numpy as np
import torch


def _flat2(a):
    """View (L, C, ...) as (L * C, ...): one index per (layer, slot) cell."""
    return a.view((a.shape[0] * a.shape[1],) + a.shape[2:])


class DevicePagePool:
    """Layer-stacked, slot-addressed device tensors mirroring a
    `PagedKVPool` across the whole layer stack.

    ``arrays`` is the kernel's stacked pool-argument tuple ``(k_pages,
    v_pages, k_quant, v_quant, k_scale, v_scale)``; `sync` keeps it
    current for a set of page groups, `write_rows` streams token rows
    into one layer of a tail slot, and released slots are recycled
    through a free list. ``writes`` counts host->device write batches and
    ``reads`` device->host pulls."""

    # every live mirror, for test-teardown invariant sweeps
    _instances: "weakref.WeakSet[DevicePagePool]" = weakref.WeakSet()

    def __init__(self, num_layers: int, page_tokens: int, hkv: int, hd: int,
                 init_slots: int = 8, device="cuda"):
        self.num_layers = num_layers
        self.t, self.hkv, self.hd = page_tokens, hkv, hd
        self.device = torch.device(device)
        self.capacity = 1
        while self.capacity < max(8, init_slots):
            self.capacity *= 2
        self.arrays = self._zeros(self.capacity)
        self._free = list(range(self.capacity - 1, -1, -1))  # pop() -> lowest
        self.slot_of: dict[int, int] = {}       # group key pid -> slot
        self._synced: dict[int, int] = {}       # pid -> mirrored version
        self._dirty: set[int] = set()           # slots ever written
        self.writes = 0
        self.reads = 0
        DevicePagePool._instances.add(self)

    def _zeros(self, c: int) -> tuple:
        shape = (self.num_layers, c, self.t, self.hkv, self.hd)
        dev = self.device
        return (torch.zeros(shape, device=dev),                  # k_pages
                torch.zeros(shape, device=dev),                  # v_pages
                torch.zeros(shape, dtype=torch.int8, device=dev),  # k_quant
                torch.zeros(shape, dtype=torch.int8, device=dev),  # v_quant
                torch.zeros(shape[:-1], device=dev),             # k_scale
                torch.zeros(shape[:-1], device=dev))             # v_scale

    def slot(self, pid: int) -> int:
        return self.slot_of[pid]

    # -- slots ---------------------------------------------------------------
    def _grow(self):
        old = self.capacity
        self.capacity *= 2
        new = self._zeros(self.capacity)
        for a, b in zip(new, self.arrays):
            a[:, :old] = b
        self.arrays = new
        self._free.extend(range(self.capacity - 1, old - 1, -1))

    def alloc(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def release_slot(self, slot: int):
        self._free.append(slot)

    def release_pid(self, pid: int):
        """Forget a destroyed pool page. Only the group-key (layer-0) pid
        owns the slot; other layers' pids just drop their sync record."""
        self._synced.pop(pid, None)
        slot = self.slot_of.pop(pid, None)
        if slot is not None:
            self._free.append(slot)

    def adopt(self, group, slot: int, pool):
        """Hand an already-written tail slot to a page group that just
        filled. Per layer: a fast placement's device cell already holds
        the full float rows, so it is marked synced; a slow placement
        stays dirty and the next sync rewrites the cell in place (int8 +
        zeroed float). A group already mapped (the fill's hashed `put`
        deduped onto an existing page) keeps its synced slot and the
        incoming tail slot is recycled."""
        prev = self.slot_of.get(group[0])
        if prev is not None and prev != slot:
            self.release_slot(slot)
            return
        self.slot_of[group[0]] = slot
        for pid in group:
            page = pool.pages[pid]
            if page.tier == "fast":
                self._synced[pid] = page.version

    # -- content writes ------------------------------------------------------
    def _write_cells(self, idx, fast: bool, *vals):
        """Rewrite whole (layer, slot) cells in place: ``vals`` are the
        float K, V rows (fast) or the int8 K, scale K, int8 V, scale V
        rows (slow); the other tier's tensors are zeroed."""
        kf, vf, kq, vq, ks, vs = (_flat2(a) for a in self.arrays)
        if fast:
            k, v = vals
            kf.index_copy_(0, idx, k)
            vf.index_copy_(0, idx, v)
            for a in (kq, vq, ks, vs):
                a.index_fill_(0, idx, 0)
        else:
            kqn, ksn, vqn, vsn = vals
            for a, x in ((kq, kqn), (ks, ksn), (vq, vqn), (vs, vsn)):
                a.index_copy_(0, idx, x)
            for a in (kf, vf):
                a.index_fill_(0, idx, 0)
        self._dirty.update(int(i) % self.capacity for i in idx.tolist())
        self.writes += 1

    def zero_slot(self, slot: int):
        """Full clear of a slot across every layer before streaming tail
        rows into it (stale other-tier content from a previous occupant
        would otherwise alias into the dequant sum). Slots never written
        since allocation are already zero — skipped."""
        if slot not in self._dirty:
            return
        idx = torch.arange(self.num_layers, device=self.device) \
            * self.capacity + slot
        for a in self.arrays:
            _flat2(a).index_fill_(0, idx, 0)
        self._dirty.discard(slot)
        self.writes += 1

    def write_rows(self, layer: int, slots, rows, k_rows, v_rows):
        """Batched token-row write at one layer: row ``rows[i]`` of slot
        ``slots[i]`` gets ``k_rows[i]`` / ``v_rows[i]`` ((n, hkv, hd))."""
        c, t = self.capacity, self.t
        slots = torch.as_tensor(np.asarray(slots), device=self.device).long()
        rows = torch.as_tensor(np.asarray(rows), device=self.device).long()
        idx = (layer * c + slots) * t + rows
        for a, x in ((self.arrays[0], k_rows), (self.arrays[1], v_rows)):
            x = torch.as_tensor(x).to(self.device, a.dtype)
            a.view((-1,) + a.shape[3:]).index_copy_(0, idx, x)
        self._dirty.update(int(s) for s in slots.tolist())
        self.writes += 1

    def read_slot(self, slot: int):
        """Pull one slot's float rows for every layer back to the host —
        (num_layers, t, hkv, hd) each for K and V. Used once per *filled*
        page by the decode step and by a swap-out; 2 device->host
        transfers. Always a copy (``copy=True``: on a CPU tensor
        ``.cpu()`` would alias the pool, whose slot is reused once the
        page leaves the device); from the card the copy waits for the
        step's work on the current stream."""
        self.reads += 2
        return tuple(a[:, slot].to("cpu", copy=True).numpy()
                     for a in self.arrays[:2])

    def check_invariants(self) -> None:
        """Structural self-check: the free list holds unique in-range
        slots disjoint from every mapped slot; no two groups share a
        slot. Raises AssertionError on the first breach."""
        used: dict[int, int] = {}
        for key, slot in self.slot_of.items():
            assert 0 <= slot < self.capacity, \
                f"slot_of[{key}] = {slot} outside capacity {self.capacity}"
            assert slot not in used, \
                f"slot {slot} mapped by both {used[slot]} and {key}"
            used[slot] = key
        assert len(set(self._free)) == len(self._free), \
            "free list holds duplicate slots"
        for slot in self._free:
            assert 0 <= slot < self.capacity, f"freed out-of-range slot {slot}"
            assert slot not in used, \
                f"slot {slot} is both free and mapped by {used[slot]}"

    # -- sync ----------------------------------------------------------------
    def sync(self, pool, groups):
        """Bring the mirror current for an iterable of page groups (each a
        tuple of per-layer pids): allocate a slot for groups new to the
        mirror, rewrite (layer, slot) cells whose page version changed
        (demotions). Batched into at most one fast + one slow write."""
        fresh = {}
        for group in groups:
            fresh.setdefault(group[0], group)
        # allocate every slot FIRST: alloc() may _grow() (capacity
        # doubles) and the flat (layer * capacity + slot) indices must be
        # computed against the final capacity
        for key in fresh:
            if key not in self.slot_of:
                self.slot_of[key] = self.alloc()
        fast_w, slow_w = [], []
        c = self.capacity
        for key, group in fresh.items():
            slot = self.slot_of[key]
            for layer, pid in enumerate(group):
                page = pool.pages[pid]
                if self._synced.get(pid) == page.version:
                    continue
                idx = layer * c + slot
                if page.tier == "fast":
                    fast_w.append((idx, *page.data))
                else:
                    (kq, ks), (vq, vs) = page.data
                    slow_w.append((idx, kq, ks[..., 0], vq, vs[..., 0]))
                self._synced[pid] = page.version
        for fast, batch in ((True, fast_w), (False, slow_w)):
            if not batch:
                continue
            idx = torch.tensor([w[0] for w in batch], device=self.device)
            cols = [torch.from_numpy(np.stack([w[i] for w in batch]))
                    .to(self.device) for i in range(1, len(batch[0]))]
            if fast:
                cols = [x.float() for x in cols]
            else:
                cols = [x if x.dtype == torch.int8 else x.float()
                        for x in cols]
            self._write_cells(idx, fast, *cols)
