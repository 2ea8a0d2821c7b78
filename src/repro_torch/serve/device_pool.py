"""Device-resident page-pool tensors for the paged-attention kernel.

The port of ``repro/serve/device_pool.py``. The host
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

Under a mesh plan (`serve.sharding.ServePlan`) the slot space splits over
the ``dp`` data shards, interleaved: global slot ``local * dp + s`` is
shard ``s``'s local slot ``local``, which is what page tables carry, so a
shard grows without renumbering another's slots. The kv-head axis splits
over the model shards: shard (d, m) holds six tensors of ``(num_layers,
capacity, page_tokens, hkv / tp, hd)`` on its device, or the one kv
head of an MQA model on every shard (`ServePlan.replicate_heads`: more
kv heads than one that the model axis does not divide raise). A page
shared by
sequences on two data shards has a slot on each.

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
    v_pages, k_quant, v_quant, k_scale, v_scale)`` (``shard_arrays[d][m]``
    under a plan); `sync` keeps it current for a set of page groups,
    `write_rows` streams token rows into one layer of a tail slot, and
    released slots are recycled through per-shard free lists. ``writes``
    counts host->device write batches and ``reads`` device->host pulls,
    once each whatever the number of shards a batch touches."""

    # every live mirror, for test-teardown invariant sweeps
    _instances: "weakref.WeakSet[DevicePagePool]" = weakref.WeakSet()

    def __init__(self, num_layers: int, page_tokens: int, hkv: int, hd: int,
                 init_slots: int = 8, device="cuda", plan=None):
        self.num_layers = num_layers
        self.t, self.hkv, self.hd = page_tokens, hkv, hd
        self.plan = plan
        self.shards = plan.dp if plan is not None else 1
        self.tp = plan.tp if plan is not None else 1
        rep = plan is not None and plan.replicate_heads(hkv)
        # kv heads each model shard holds, and its block of the pool's
        self.hkv_local = hkv if rep else hkv // self.tp
        self._heads = [slice(None) if rep else
                       slice(m * self.hkv_local, (m + 1) * self.hkv_local)
                       for m in range(self.tp)]
        self._devs = [[torch.device(device)]] if plan is None else \
            [[plan.device(d, m) for m in range(self.tp)]
             for d in range(self.shards)]
        self.device = self._devs[0][0]
        # init_slots is the PER-SHARD requirement; each shard grows alone
        cap = 1
        while cap < max(8, init_slots):
            cap *= 2
        self._cap = [cap] * self.shards
        self.shard_arrays = [[self._zeros(cap, dev) for dev in row]
                             for row in self._devs]
        # per-shard free lists of GLOBAL slot ids; pop() -> lowest
        self._free = [[self._global(s, i) for i in range(cap - 1, -1, -1)]
                      for s in range(self.shards)]
        # group key -> slot; a multi-shard pool keys by (shard, pid), the
        # one-shard pool by pid
        self.slot_of: dict = {}
        self._synced: dict = {}                 # same keying -> version
        self._dirty: set[int] = set()           # slots ever written
        self.writes = 0
        self.reads = 0
        DevicePagePool._instances.add(self)

    @property
    def arrays(self) -> tuple:
        """The six tensors of the unsharded pool."""
        if self.shards * self.tp != 1:
            raise AttributeError("a sharded pool's tensors are "
                                 "shard_arrays[d][m]")
        return self.shard_arrays[0][0]

    def _zeros(self, c: int, dev) -> tuple:
        shape = (self.num_layers, c, self.t, self.hkv_local, self.hd)
        return (torch.zeros(shape, device=dev),                  # k_pages
                torch.zeros(shape, device=dev),                  # v_pages
                torch.zeros(shape, dtype=torch.int8, device=dev),  # k_quant
                torch.zeros(shape, dtype=torch.int8, device=dev),  # v_quant
                torch.zeros(shape[:-1], device=dev),             # k_scale
                torch.zeros(shape[:-1], device=dev))             # v_scale

    def _key(self, pid: int, shard: int):
        return pid if self.shards == 1 else (shard, pid)

    def slot(self, pid: int, shard: int = 0) -> int:
        """Global slot of page group `pid` on data shard `shard`."""
        return self.slot_of[self._key(pid, shard)]

    @property
    def capacity(self) -> int:
        """Slots of the whole pool (every data shard's)."""
        return sum(self._cap)

    def _global(self, shard: int, local: int) -> int:
        return local * self.shards + shard

    def local_slot(self, slot: int) -> int:
        """Shard-local slot id: what a page table carries."""
        return slot // self.shards

    def shard_of_slot(self, slot: int) -> int:
        return slot % self.shards

    # -- slots ---------------------------------------------------------------
    def _grow(self, shard: int):
        old = self._cap[shard]
        self._cap[shard] *= 2
        for m, dev in enumerate(self._devs[shard]):
            new = self._zeros(self._cap[shard], dev)
            for a, b in zip(new, self.shard_arrays[shard][m]):
                a[:, :old] = b
            self.shard_arrays[shard][m] = new
        self._free[shard].extend(self._global(shard, i) for i in
                                 range(self._cap[shard] - 1, old - 1, -1))

    def alloc(self, shard: int = 0) -> int:
        if not self._free[shard]:
            self._grow(shard)
        return self._free[shard].pop()

    def release_slot(self, slot: int):
        self._free[self.shard_of_slot(slot)].append(slot)

    def release_pid(self, pid: int):
        """Forget a destroyed pool page. Only the group-key (layer-0) pid
        owns a slot; other layers' pids just drop their sync record."""
        for shard in range(self.shards):
            key = self._key(pid, shard)
            self._synced.pop(key, None)
            slot = self.slot_of.pop(key, None)
            if slot is not None:
                self.release_slot(slot)

    def adopt(self, group, slot: int, pool, shard: int = 0):
        """Hand an already-written tail slot to a page group that just
        filled. Per layer: a fast placement's device cell already holds
        the full float rows, so it is marked synced; a slow placement
        stays dirty and the next sync rewrites the cell in place (int8 +
        zeroed float). A group already mapped (the fill's hashed `put`
        deduped onto an existing page) keeps its synced slot and the
        incoming tail slot is recycled."""
        key = self._key(group[0], shard)
        prev = self.slot_of.get(key)
        if prev is not None and prev != slot:
            self.release_slot(slot)
            return
        self.slot_of[key] = slot
        for pid in group:
            page = pool.pages[pid]
            if page.tier == "fast":
                self._synced[self._key(pid, shard)] = page.version

    # -- content writes ------------------------------------------------------
    def _write_cells(self, shard: int, idx, fast: bool, *vals):
        """Rewrite whole (layer, local slot) cells of one data shard in
        place, each model shard its block of heads: ``vals`` are the float
        K, V rows (fast) or the int8 K, scale K, int8 V, scale V rows
        (slow), all heads, on the host; the other tier's tensors are
        zeroed."""
        for m, arrays in enumerate(self.shard_arrays[shard]):
            dev = self._devs[shard][m]
            hs = self._heads[m]
            kf, vf, kq, vq, ks, vs = (_flat2(a) for a in arrays)
            i = idx.to(dev)
            if fast:
                k, v = (x[:, :, hs].to(dev) for x in vals)
                kf.index_copy_(0, i, k)
                vf.index_copy_(0, i, v)
                for a in (kq, vq, ks, vs):
                    a.index_fill_(0, i, 0)
            else:
                kqn, ksn, vqn, vsn = (x[:, :, hs].to(dev) for x in vals)
                for a, x in ((kq, kqn), (ks, ksn), (vq, vqn), (vs, vsn)):
                    a.index_copy_(0, i, x)
                for a in (kf, vf):
                    a.index_fill_(0, i, 0)

    def zero_slot(self, slot: int):
        """Full clear of a slot across every layer before streaming tail
        rows into it (stale other-tier content from a previous occupant
        would otherwise alias into the dequant sum). Slots never written
        since allocation are already zero — skipped."""
        if slot not in self._dirty:
            return
        shard, local = self.shard_of_slot(slot), self.local_slot(slot)
        for m, arrays in enumerate(self.shard_arrays[shard]):
            idx = torch.arange(self.num_layers, device=self._devs[shard][m]) \
                * self._cap[shard] + local
            for a in arrays:
                _flat2(a).index_fill_(0, idx, 0)
        self._dirty.discard(slot)
        self.writes += 1

    def write_rows(self, layer: int, slots, rows, k_rows, v_rows):
        """Batched token-row write at one layer: row ``rows[i]`` of slot
        ``slots[i]`` gets ``k_rows[i]`` / ``v_rows[i]`` ((n, hkv, hd), all
        heads)."""
        t = self.t
        slots = np.asarray(slots)
        rows = np.asarray(rows)
        k_rows = torch.as_tensor(np.asarray(k_rows))
        v_rows = torch.as_tensor(np.asarray(v_rows))
        for shard in sorted({self.shard_of_slot(int(s)) for s in slots}):
            sel = np.nonzero(slots % self.shards == shard)[0]
            local = slots[sel] // self.shards
            for m, arrays in enumerate(self.shard_arrays[shard]):
                dev = self._devs[shard][m]
                hs = self._heads[m]
                idx = torch.as_tensor(
                    (layer * self._cap[shard] + local) * t + rows[sel],
                    device=dev).long()
                for a, x in ((arrays[0], k_rows), (arrays[1], v_rows)):
                    x = x[torch.as_tensor(sel)][:, hs].to(dev, a.dtype)
                    a.view((-1,) + a.shape[3:]).index_copy_(0, idx, x)
        self._dirty.update(int(s) for s in slots.tolist())
        self.writes += 1

    def read_slot(self, slot: int):
        """Pull one slot's float rows for every layer back to the host —
        (num_layers, t, hkv, hd) each for K and V, the model shards' head
        blocks joined. Used once per *filled* page by the decode step and
        by a swap-out; 2 device->host transfers. Always a copy
        (``copy=True``: on a CPU tensor ``.cpu()`` would alias the pool,
        whose slot is reused once the page leaves the device); from the
        card the copy waits for the step's work on the current stream."""
        self.reads += 2
        shard, local = self.shard_of_slot(slot), self.local_slot(slot)
        parts = self.shard_arrays[shard]
        if self._heads[0] == slice(None):     # all heads on every shard
            parts = parts[:1]
        return tuple(
            np.concatenate([arrays[i][:, local].to("cpu", copy=True).numpy()
                            for arrays in parts], axis=2)
            for i in range(2))

    def check_invariants(self) -> None:
        """Structural self-check: each free list holds unique in-range
        slots of its own shard's range, disjoint from every mapped slot;
        no two groups share a slot. Raises AssertionError on the first
        breach."""
        def in_range(slot):
            return 0 <= self.local_slot(slot) < self._cap[
                self.shard_of_slot(slot)] and slot >= 0

        used: dict[int, object] = {}
        for key, slot in self.slot_of.items():
            assert in_range(slot), \
                f"slot_of[{key}] = {slot} outside its shard's capacity"
            assert slot not in used, \
                f"slot {slot} mapped by both {used[slot]} and {key}"
            used[slot] = key
        for shard, free in enumerate(self._free):
            assert len(set(free)) == len(free), \
                f"shard {shard} free list holds duplicate slots"
            for slot in free:
                assert in_range(slot), f"freed out-of-range slot {slot}"
                assert self.shard_of_slot(slot) == shard, \
                    f"slot {slot} on shard {shard}'s free list belongs " \
                    f"to shard {self.shard_of_slot(slot)}"
                assert slot not in used, \
                    f"slot {slot} is both free and mapped by {used[slot]}"

    # -- sync ----------------------------------------------------------------
    def sync(self, pool, groups, shards=None):
        """Bring the mirror current for an iterable of page groups (each a
        tuple of per-layer pids): allocate a slot for groups new to the
        mirror, rewrite (layer, slot) cells whose page version changed
        (demotions). ``shards`` (aligned with `groups`, default all 0)
        names the data shard whose rows attend each group. Batched into
        at most one fast + one slow write (one per data shard touched)."""
        groups = list(groups)
        if shards is None:
            shards = [0] * len(groups)
        # allocate every slot FIRST: alloc() may _grow() (a shard's
        # capacity doubles) and the flat (layer * capacity + slot) indices
        # must be computed against the final capacity
        fresh = {}
        for group, shard in zip(groups, shards):
            key = self._key(group[0], shard)
            if key in fresh:
                continue
            fresh[key] = (group, shard)
            if key not in self.slot_of:
                self.slot_of[key] = self.alloc(shard)
        fast_w, slow_w = {}, {}
        for key, (group, shard) in fresh.items():
            slot = self.slot_of[key]
            for layer, pid in enumerate(group):
                page = pool.pages[pid]
                pkey = self._key(pid, shard)
                if self._synced.get(pkey) == page.version:
                    continue
                idx = layer * self._cap[shard] + self.local_slot(slot)
                if page.tier == "fast":
                    fast_w.setdefault(shard, []).append((idx, *page.data))
                else:
                    (kq, ks), (vq, vs) = page.data
                    slow_w.setdefault(shard, []).append(
                        (idx, kq, ks[..., 0], vq, vs[..., 0]))
                self._synced[pkey] = page.version
                self._dirty.add(slot)
        for fast, by_shard in ((True, fast_w), (False, slow_w)):
            for shard, batch in sorted(by_shard.items()):
                idx = torch.tensor([w[0] for w in batch])
                cols = [torch.from_numpy(np.stack([w[i] for w in batch]))
                        for i in range(1, len(batch[0]))]
                if fast:
                    cols = [x.float() for x in cols]
                else:
                    cols = [x if x.dtype == torch.int8 else x.float()
                            for x in cols]
                self._write_cells(shard, idx, fast, *cols)
            if by_shard:
                self.writes += 1
