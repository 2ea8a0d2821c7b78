"""Paged decode: paged serving state + the fused decode step.

The port of ``repro/serve/paged_decode.py``, with one token per step or
k (speculative verify, chunked prefill). Each layer's state lives on the
substrate `paged_state.StateLayout` gives it: global-attention (KV) and
sliding-window (ring) layers in the page pool, SSD and RG-LRU layers in
one recurrent slot per sequence (`paged_state.RecurrentStore`). The KV
cache lives in a tiered `PagedKVPool` (fast float vs. slow int8 per page,
chosen by the placement policy),
mirrored into the layer-stacked `DevicePagePool`; attention over it runs
through ``api.run("paged_attention", ...)``: the CUDA kernel on the card,
its plain version on the CPU.

Per token, `build_fused_step` runs the whole step — embed -> every layer
(rms_norm, then per kind: QKV + bias + RoPE, the K/V row scatter into the
pool and paged attention (KV) or a ring gather and windowed attention
(ring); or the state gather, the one-token core and the state scatter
(recurrent); MLP) -> final norm -> lm_head -> sample — as one Python
function over device tensors, eagerly. The host's part shrinks
to bookkeeping: build the control block (page table + tail slot + tail
row + position + length) before the step, bump tail counters and hand
filled pages to the pool after. Steady state crosses the host/device
boundary twice per token — one int32 control upload, one sampled-token
download — whatever the depth.

``build_fused_step(k > 1)`` is the speculative VERIFY step over the same
body, widened to k token rows per sequence: the k input tokens ride in the
control block, every layer scatters k K/V rows (rows past the page
boundary go to a spill slot), one paged-attention launch scores all k
rows, and the accept rule runs on the device, so one download returns
``[k sampled tokens | accepted draft count]``. Chunked prefill reuses it
at k = page_tokens: a chunk row feeds up to a page of true prompt
tokens.

Page lifecycle:
  prefill  -> full pages ``put`` per (sequence, layer), remainder rows
              streamed into a layer-uniform tail slot
  adopt    -> a radix-cached prompt prefix joins the sequence by
              reference (``adopt_prefix``): nothing is stored
  decode   -> each step appends the token's K/V rows (one per layer) to
              the tail slot; a filled tail becomes a pool ``put`` per
              layer (tier decided there), the slot adopted in place;
              k-row steps keep only the accepted rows (``end_step``'s
              ``advanced``), the rest are phantom and overwritten
  ring     -> a sliding-window stack drops the front pages no future
              query can see (``_drop_ring``), O(window) pages per sequence
  attend   -> one page table per step serves every layer
  park     -> ``swap_out`` reads the tail rows and the recurrent slot
              back, moves the sequence's own pages to the pool's host
              tier and frees their device slots; ``swap_in`` restores
              them bit-identically (preemption)
  retire   -> ``free_seq`` releases the request's pool pages (ref-
              counted; prefix-shared pages survive), device slots and
              recurrent slot
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ATTN, LOCAL_ATTN, RGLRU, SSD
from repro_torch.kernels import api
from repro_torch.models.attention import decode_qkv, out_proj
from repro_torch.models.common import torch_dtype
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import mlp_tail
from repro_torch.serve.device_pool import DevicePagePool
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.paged_state import (RecurrentStore, StateLayout,
                                           gather_ring_kv, rec_array_names,
                                           rec_gather, rec_scan_tokens,
                                           rec_scatter, ring_attend,
                                           select_checkpoint)


class PagedKVState:
    """Pool-backed KV state for a decode batch.

    The pool holds full pages; a per-sequence *tail slot* in the
    layer-stacked device pool holds the < page_tokens newest rows of every
    layer until they fill a page. Tail fill level is layer-uniform, so one
    counter per sequence and one page table per step describe the stack.
    ``tail_slots=2`` sizes the page table for k-row steps, whose rows may
    cross one page boundary into a *spill slot*.

    Batch rows may carry ``seq_id = -1`` (continuous batching pads retired
    rows): they write to a scratch slot, attend a zero page and read and
    write the recurrent store's trash slot.

    The pool's layer axis holds only the KV-bearing layers (global and
    ring, `StateLayout.kv_of`); a stack with ring layers sizes its page
    table to ``ring_pages()`` and drops pages behind the window, one with
    recurrent layers keeps a `RecurrentStore` slot per sequence.

    ``h2d`` / ``d2h`` count the explicit host->device / device->host
    transfers of the decode path; `transfer_counts` adds the device
    pool's and the recurrent store's writes and readbacks."""

    def __init__(self, pool: PagedKVPool, capacity: int,
                 layout: StateLayout, hkv: int, hd: int, *,
                 batch_hint: int = 1, tail_slots: int = 1, device="cuda"):
        if tail_slots not in (1, 2):
            raise ValueError(f"tail_slots must be 1 or 2, got {tail_slots}")
        self.pool = pool
        self.layout = layout
        self.num_layers = num_layers = layout.n_kv
        self.hkv, self.hd = hkv, hd
        self.device = torch.device(device)
        t = pool.page_tokens
        slots = -(-capacity // t)          # ceil: pages covering capacity
        if layout.has_ring:
            slots = min(slots, layout.ring_pages())
        # + the tail page(s), rounded to a multiple of 8
        self.slots = -(-(slots + tail_slots) // 8) * 8
        self.batch_hint = max(1, batch_hint)
        self.tail_len: dict[int, int] = {}     # seq -> tail rows (all layers)
        self._tail_slot: dict[int, int] = {}   # seq -> device slot
        self._spill_slot: dict[int, int] = {}  # k > 1: boundary-crossing rows
        # chunked prefill: content hashes awaiting the seq's next page
        # fills, so prompt pages built by chunk scatters dedup/share and
        # can be pinned by the radix prefix tree
        self._pending_hashes: dict[int, list] = {}
        self._device = DevicePagePool(num_layers, t, hkv, hd,
                                      init_slots=self.slots * self.batch_hint,
                                      device=self.device)
        self._trash = self._device.alloc()
        self._rec: RecurrentStore | None = None
        if layout.has_rec:
            self._rec = RecurrentStore(
                layout, batch_hint=self.batch_hint,
                compute_dtype=torch_dtype(layout.cfg.compute_dtype),
                device=self.device)
        self._rec_slot: dict[int, int] = {}    # seq -> recurrent slot
        self._ring_base: dict[int, int] = {}   # seq -> dropped ring pages
        # preempted sequences: seq -> host copy of its partial tail rows
        # (num_layers, tail_len, hkv, hd) K/V, or None when the tail was
        # empty at swap-out; seq -> its parked recurrent state blocks
        self._parked_tail: dict[int, object] = {}
        self._parked_rec: dict[int, dict] = {}
        self._in_step = False     # between begin_step and end_step
        self.gather_s = 0.0       # host-side bookkeeping time
        self.h2d = 0
        self.d2h = 0

    @property
    def device_arrays(self):
        """The fused step's tensors, updated in place: the six
        layer-stacked pool tensors, then the recurrent store's (if any)."""
        kv = self._device.arrays
        return kv + self._rec.arrays if self._rec is not None else kv

    def transfer_counts(self) -> tuple[int, int]:
        """(host->device, device->host) explicit transfers so far,
        including the device pool's write batches and fill readbacks and
        the recurrent store's slot writes and reads."""
        h2d = self.h2d + self._device.writes
        d2h = self.d2h + self._device.reads
        if self._rec is not None:
            h2d += self._rec.writes
            d2h += self._rec.reads
        return h2d, d2h

    def rec_store_counts(self) -> dict:
        """The recurrent store's slot writes (host->device) and reads
        (device->host) so far; zeros for a stack without recurrent
        layers."""
        rec = self._rec
        return {"writes": rec.writes if rec is not None else 0,
                "reads": rec.reads if rec is not None else 0}

    # -- writes -------------------------------------------------------------
    def write_prefill(self, layer: int, seq: int, k: np.ndarray,
                      v: np.ndarray, page_hashes=None, skip_pages: int = 0):
        """k, v: (prefill_len, hkv, hd) — full pages into the pool, the
        remainder rows into the sequence's tail slot. `page_hashes[p]`
        (cumulative token-prefix digests) enables ref-counted page sharing
        across requests with identical prompt prefixes. ``skip_pages``
        full pages at the front were adopted from the radix prefix index
        and are not put again."""
        t = self.pool.page_tokens
        n_full = k.shape[0] // t
        for p in range(skip_pages, n_full):
            h = page_hashes[p] if page_hashes is not None else None
            self.pool.put(seq, k[p * t:(p + 1) * t], v[p * t:(p + 1) * t],
                          layer=layer, content_hash=h)
        n_rest = k.shape[0] - n_full * t
        prev = self.tail_len.setdefault(seq, n_rest)
        if prev != n_rest:
            raise ValueError(
                f"sequence {seq}: layer {layer} prefilled {n_rest} tail "
                f"rows where earlier layers prefilled {prev} — the paged "
                f"layout requires layer-uniform prefill lengths")
        if not n_rest:
            return
        slot = self._ensure_tail_slot(seq)
        self._device.write_rows(layer, np.full(n_rest, slot),
                                np.arange(n_rest), k[n_full * t:],
                                v[n_full * t:])

    def adopt_prefix(self, seq: int, groups, pending_hashes=()):
        """Start a sequence from cached pages instead of a prefill: each
        group (per-layer pool pids of one prompt page, from the radix
        prefix index) is adopted by reference — the pool stores nothing
        new, the device mirror already holds (or will sync) the slot — and
        ``pending_hashes`` (the cumulative digests of the prompt pages the
        suffix chunks will fill) are queued so `end_step`'s fills store
        them hash-shared. Must run before any suffix write."""
        prev = self.tail_len.setdefault(seq, 0)
        if prev != 0 or self.pool.seq_pages(seq, 0):
            raise RuntimeError(f"sequence {seq}: adopt_prefix must run "
                               f"before any prefill write")
        for group in groups:
            for layer, pid in enumerate(group):
                self.pool.adopt_page(seq, pid, layer)
        if pending_hashes:
            self._pending_hashes[seq] = list(pending_hashes)

    def _ensure_tail_slot(self, seq: int) -> int:
        slot = self._tail_slot.get(seq)
        if slot is None:
            slot = self._device.alloc()
            self._device.zero_slot(slot)
            self._tail_slot[seq] = slot
        return slot

    def _ensure_spill_slot(self, seq: int) -> int:
        """Second tail slot for k-row steps: rows past the page boundary
        scatter here; it becomes the tail slot when the kept tokens
        actually fill the page."""
        slot = self._spill_slot.get(seq)
        if slot is None:
            slot = self._device.alloc()
            self._device.zero_slot(slot)
            self._spill_slot[seq] = slot
        return slot

    def _ensure_rec_slot(self, seq: int) -> int:
        """The sequence's O(1) recurrent slot (one state block per
        recurrent layer), zeroed on first use."""
        slot = self._rec_slot.get(seq)
        if slot is None:
            slot = self._rec.alloc()
            self._rec.zero_slot(slot)
            self._rec_slot[seq] = slot
        return slot

    def write_prefill_rec(self, seq: int, blocks: dict):
        """Install post-prefill recurrent state for `seq`: ``blocks`` maps
        store tensor names to (layers of that kind, ...) host blocks. A
        full set skips the zeroing write."""
        slot = self._rec_slot.get(seq)
        if slot is None:
            slot = self._rec.alloc()
            self._rec_slot[seq] = slot
            if set(blocks) != set(self._rec.names):
                self._rec.zero_slot(slot)
        self._rec.write_slot(slot, blocks)

    # -- per-step protocol ---------------------------------------------------
    def _page_groups(self, seq: int, tail_slots: int = 1):
        """Per-layer pool pids of each logical page of `seq`, zipped into
        layer-uniform groups, with the slot-overflow check (+ the tail
        slot(s) every step appends into)."""
        if self.num_layers == 0:       # pure-recurrent stack: no KV pages
            return []
        per_layer = [self.pool.seq_pages(seq, l)
                     for l in range(self.num_layers)]
        n = len(per_layer[0])
        if any(len(p) != n for p in per_layer):
            raise RuntimeError(
                f"sequence {seq}: ragged page counts across layers "
                f"({[len(p) for p in per_layer]}) — paged decode requires "
                f"layer-uniform page structure")
        if n + tail_slots > self.slots:
            raise ValueError(
                f"sequence {seq}: {n} pages + {tail_slots} tail page(s) "
                f"exceed the page-table capacity of {self.slots} slots "
                f"({self.slots * self.pool.page_tokens} tokens); size the "
                f"PagedKVState capacity to the longest request")
        return list(zip(*per_layer)) if n else []

    def begin_step(self, seq_ids, positions, k: int = 1,
                   tokens=None, keep_fixed=None, keep_cap=None) -> np.ndarray:
        """Host bookkeeping before one step: touch each live page once
        (one pool-clock tick for the whole step), sync the device mirror
        (new prefill pages, demotion rewrites), and build the int32
        control block (`StateLayout.cols`). Its length column already
        counts the token this step appends; with k > 1 the position and
        length are row 0's (row j adds j inside the step), the spill slot
        follows the tail slot in the page table, and ``tokens`` (b, k)
        rides in the block. A recurrent stack adds each row's recurrent
        slot and, with k > 1, its ``keep_fixed`` / ``keep_cap`` (see
        `paged_state.ControlCols`; default: verify rows keeping up to
        k - 1 drafts); a ring stack adds each row's ring base. Dead rows
        (seq -1) get the scratch slot, the recurrent trash slot, length 1
        and keep exactly one phantom token."""
        t0 = time.perf_counter()
        t = self.pool.page_tokens
        if k > t:
            raise ValueError(
                f"k={k} tokens per step exceed page_tokens={t}: one step "
                f"may spill across at most one page boundary")
        b = len(seq_ids)
        positions = np.broadcast_to(np.asarray(positions, np.int32), (b,))
        cc = self.layout.cols(self.slots, k)
        control = np.zeros((b, cc.width), np.int32)
        control[:, cc.tail] = self._trash
        control[:, cc.len] = 1
        if self._rec is not None:
            control[:, cc.rec] = self._rec.trash
            if k > 1:
                control[:, cc.keep_fixed] = 1
                control[:, cc.keep_cap] = 0
        if k > 1:
            control[:, cc.spill] = self._trash
            if tokens is not None:
                control[:, cc.tok:cc.tok + k] = np.asarray(tokens, np.int32)
        groups_by_row, touch_pids, sync_groups = [], [], []
        for seq in seq_ids:
            if seq < 0:
                groups_by_row.append(None)
                continue
            groups = self._page_groups(seq, tail_slots=1 if k == 1 else 2)
            for g in groups:
                touch_pids.extend(g)
            sync_groups.extend(groups)
            groups_by_row.append(groups)
        self.pool.touch_many(touch_pids)
        self._device.sync(self.pool, sync_groups)
        for i, groups in enumerate(groups_by_row):
            if groups is None:
                continue
            seq = seq_ids[i]
            tail = self.tail_len.get(seq, 0)
            if self.num_layers:
                for n, g in enumerate(groups):
                    control[i, n] = self._device.slot(g[0])
                control[i, cc.tail] = self._ensure_tail_slot(seq)
                control[i, len(groups)] = control[i, cc.tail]
                if k > 1:
                    control[i, cc.spill] = self._ensure_spill_slot(seq)
                    control[i, len(groups) + 1] = control[i, cc.spill]
            if self._rec is not None:
                control[i, cc.rec] = self._ensure_rec_slot(seq)
                if k > 1:
                    control[i, cc.keep_fixed] = \
                        -1 if keep_fixed is None else int(keep_fixed[i])
                    control[i, cc.keep_cap] = \
                        k - 1 if keep_cap is None else int(keep_cap[i])
            if self.layout.has_ring:
                control[i, cc.base] = self._ring_base.get(seq, 0)
            control[i, cc.row] = tail
            control[i, cc.pos] = positions[i]
            control[i, cc.len] = len(groups) * t + tail + 1
        self._in_step = True
        self.gather_s += time.perf_counter() - t0
        return control

    def run_fused(self, step_fn, tokens, seq_ids, positions,
                  generator=None):
        """Drive one fused step (`build_fused_step`) with the steady-state
        transfer protocol — begin_step bookkeeping, one control upload,
        the step over the device pool, one sampled-token download,
        end_step bookkeeping. `tokens` may be the previous step's device
        tensor (no upload — the steady state) or host values (one extra
        upload: the first step, or a continuous admission). Returns
        ``(host_tokens, device_tokens)``."""
        control = self.begin_step(seq_ids, positions)
        cdev = torch.from_numpy(control).to(self.device)
        self.h2d += 1
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens, np.int32)) \
                .to(self.device)
            self.h2d += 1
        tok_dev = step_fn(self.device_arrays, tokens, cdev, generator)
        tok_host = tok_dev.cpu().numpy()
        self.d2h += 1
        self.end_step(seq_ids)
        return tok_host, tok_dev

    def run_spec(self, step_fn, tokens_k, seq_ids, positions,
                 generator=None, keep_fixed=None, keep_cap=None) -> np.ndarray:
        """Drive one k-row verify step (`build_fused_step(k=...)`): begin
        bookkeeping, ONE control upload (page table, tail and spill slots,
        the (b, k) input tokens), ONE download of the ``(b, k + 1)``
        verdict ``[k sampled tokens | accepted draft count]``. The step is
        left OPEN: the caller decides how many tokens each row keeps and
        must call ``end_step(seq_ids, advanced)``. ``keep_fixed`` /
        ``keep_cap`` (recurrent stacks) drive the in-step checkpoint
        pick: a row with ``keep_fixed[i] >= 0`` commits exactly that many
        tokens of recurrent state (chunk rows), a ``-1`` row ``min(
        accepted, keep_cap[i]) + 1`` (the verify rule)."""
        tokens_k = np.asarray(tokens_k, np.int32)
        control = self.begin_step(seq_ids, positions, k=tokens_k.shape[1],
                                  tokens=tokens_k, keep_fixed=keep_fixed,
                                  keep_cap=keep_cap)
        cdev = torch.from_numpy(control).to(self.device)
        self.h2d += 1
        out = step_fn(self.device_arrays, cdev, generator).cpu().numpy()
        self.d2h += 1
        return out

    def end_step(self, seq_ids, advanced=None):
        """Host bookkeeping after one step: bump tail counters and turn
        filled tails into pool pages — per layer, tier decided by the
        pool; the device tail slot is adopted in place (its float rows are
        already current; slow placements are rewritten by the next sync).
        A filled page is read back once (2 transfers per page_tokens
        tokens); row data never crosses on the per-token path.

        ``advanced`` (k-row steps) is the per-sequence count of tokens
        KEPT this step. Rows scattered beyond it are phantom: the tail
        counter does not advance over them, the length masking hides
        them, the next step overwrites them — that bookkeeping IS the
        rollback. When the kept tokens cross the page boundary, the spill
        slot (already holding their rows) becomes the tail slot. Default:
        1 token per live row."""
        if not self._in_step:
            raise RuntimeError("end_step() without begin_step()")
        t0 = time.perf_counter()
        t = self.pool.page_tokens
        if advanced is None:
            advanced = [1] * len(seq_ids)
        for seq, adv in zip(seq_ids, advanced):
            if seq < 0 or adv == 0:
                continue
            if not 0 < adv <= t:
                raise ValueError(
                    f"sequence {seq}: advanced {adv} tokens in one step "
                    f"(valid: 1..page_tokens={t})")
            if self.num_layers == 0:
                continue            # pure-recurrent stack: no pages to fill
            n = self.tail_len.get(seq, 0) + adv
            if n < t:
                self.tail_len[seq] = n
                if self.layout.has_ring:
                    self._drop_ring(seq)
                continue
            self.tail_len[seq] = n - t
            slot = self._tail_slot.pop(seq)
            k_all, v_all = self._device.read_slot(slot)
            # a chunked prefill queued this page's cumulative prompt hash:
            # store it shared (identical content dedups onto a live or
            # pinned page; `adopt` then recycles the tail slot)
            pending = self._pending_hashes.get(seq)
            h = pending.pop(0) if pending else None
            group = tuple(self.pool.put(seq, k_all[l], v_all[l], layer=l,
                                        content_hash=h)
                          for l in range(self.num_layers))
            self._device.adopt(group, slot, self.pool)
            spill = self._spill_slot.pop(seq, None)
            if spill is not None:
                # rows past the boundary were scattered here already
                self._tail_slot[seq] = spill
            elif n > t:
                raise RuntimeError(
                    f"sequence {seq}: {n - t} tokens crossed the page "
                    f"boundary without a spill slot — multi-token steps "
                    f"must begin_step with k > 1")
            if self.layout.has_ring:
                self._drop_ring(seq)
        self._in_step = False
        self.gather_s += time.perf_counter() - t0

    def _drop_ring(self, seq: int):
        """Ring recycling: retire the front pages no query from here on
        can see (`StateLayout.ring_base`), releasing their pool pages and
        device slots, so the sequence's resident pages stay O(window).
        ``_ring_base[seq]`` counts the drops: page-table position n holds
        logical page ``base + n``."""
        t = self.pool.page_tokens
        base = self._ring_base.get(seq, 0)
        n_pages = len(self.pool.seq_pages(seq, 0))
        last_pos = (base + n_pages) * t + self.tail_len.get(seq, 0) - 1
        target = self.layout.ring_base(last_pos)
        while base < target and n_pages > 0:
            for layer in range(self.num_layers):
                for pid, _layer in self.pool.drop_front(seq, layer):
                    self._device.release_pid(pid)
            base += 1
            n_pages -= 1
        self._ring_base[seq] = base

    def release_page(self, pid: int):
        """Recycle a destroyed pool page's device slot — the radix prefix
        tree hooks this (``on_release``) so an evicted or cleared pin
        frees its slot exactly like `free_seq` does for a retired
        sequence's pages."""
        self._device.release_pid(pid)

    # -- preemption: whole-sequence swap out / in ---------------------------
    def is_parked(self, seq: int) -> bool:
        return seq in self._parked_tail

    def swap_out(self, seq: int) -> int:
        """Park a live sequence between steps: its partial tail rows are
        read back to the host (``read_slot``'s ``.cpu()`` waits for the
        step's work on the current stream, so the rows are current), its
        tail / spill device slots are recycled, its recurrent slot is
        read back whole and released, its exclusively-held pool pages
        move to the host tier (`PagedKVPool.swap_out_seq` — shared and
        pinned pages stay resident) and their device slots free. All
        decode bookkeeping (`tail_len`, the ring base, pending chunk
        hashes) survives, so `swap_in` followed by the next `begin_step`
        resumes mid-decode with bit-identical state. Returns the tail and
        recurrent bytes moved to the host (page bytes are counted in the
        pool's ``swap_out_bytes`` stat, these too)."""
        if seq in self._parked_tail:
            raise RuntimeError(f"sequence {seq} is already swapped out")
        tail_bytes = 0
        n = self.tail_len.get(seq, 0)
        slot = self._tail_slot.pop(seq, None)
        if n > 0:
            if slot is None:
                raise RuntimeError(
                    f"sequence {seq}: {n} tail rows but no tail slot")
            k_all, v_all = self._device.read_slot(slot)
            kt = np.ascontiguousarray(k_all[:, :n])
            vt = np.ascontiguousarray(v_all[:, :n])
            self._parked_tail[seq] = (kt, vt)
            tail_bytes = kt.nbytes + vt.nbytes
            self.pool.stats["swap_out_bytes"] += tail_bytes
        else:
            self._parked_tail[seq] = None
        if slot is not None:
            self._device.release_slot(slot)
        # the spill slot only ever holds phantom (not yet kept) rows
        # between steps — nothing to preserve
        spill = self._spill_slot.pop(seq, None)
        if spill is not None:
            self._device.release_slot(spill)
        if self._rec is not None:
            slot = self._rec_slot.pop(seq, None)
            if slot is not None:
                blocks = self._rec.read_slot(slot)
                self._parked_rec[seq] = blocks
                self._rec.release_slot(slot)
                rec_bytes = sum(v.nbytes for v in blocks.values())
                self.pool.stats["swap_out_bytes"] += rec_bytes
                tail_bytes += rec_bytes
        for pid, _layer in self.pool.swap_out_seq(seq):
            self._device.release_pid(pid)
        return tail_bytes

    def swap_in(self, seq: int) -> int:
        """Un-park a sequence: pool pages return to their pre-swap device
        tier (the next `begin_step`'s `sync` uploads them to freshly
        allocated slots, and its page table names those), the saved tail
        rows scatter into a new tail slot and the recurrent blocks are
        installed whole in a new slot (`write_prefill_rec`). Returns the
        tail and recurrent bytes restored."""
        data = self._parked_tail.pop(seq)   # KeyError == caller bug
        self.pool.swap_in_seq(seq)
        tail_bytes = 0
        n = self.tail_len.get(seq, 0)
        if n > 0:
            kt, vt = data
            slot = self._ensure_tail_slot(seq)
            slots = np.full(n, slot)
            rows = np.arange(n)
            for layer in range(self.num_layers):
                self._device.write_rows(layer, slots, rows, kt[layer],
                                        vt[layer])
            tail_bytes = kt.nbytes + vt.nbytes
            self.pool.stats["swap_in_bytes"] += tail_bytes
        blocks = self._parked_rec.pop(seq, None)
        if blocks is not None:
            self.write_prefill_rec(seq, blocks)    # full set: bit-identical
            rec_bytes = sum(v.nbytes for v in blocks.values())
            self.pool.stats["swap_in_bytes"] += rec_bytes
            tail_bytes += rec_bytes
        return tail_bytes

    # -- retire -------------------------------------------------------------
    def free_seq(self, seq: int) -> list:
        """Retire a request (live or parked): drop its pool page refs
        (destroying pages whose last holder it was, host-tier ones
        included) and recycle its device slots, its recurrent slot and
        any parked tail or state. Returns the destroyed pool (page id,
        layer) pairs."""
        destroyed = self.pool.free(seq)
        for pid, _layer in destroyed:
            self._device.release_pid(pid)
        self.tail_len.pop(seq, None)
        self._pending_hashes.pop(seq, None)
        self._ring_base.pop(seq, None)
        self._parked_tail.pop(seq, None)
        self._parked_rec.pop(seq, None)
        slot = self._rec_slot.pop(seq, None)
        if slot is not None:
            self._rec.release_slot(slot)
        for slot in (self._tail_slot.pop(seq, None),
                     self._spill_slot.pop(seq, None)):
            if slot is not None:
                self._device.release_slot(slot)
        return destroyed


def extract_prefill_pages(model, caches, state: PagedKVState, seq_ids,
                          page_hashes=None, valid_len=None, skip_pages=None):
    """Write per-layer prefill caches into the paged state, one batch row
    per sequence in `seq_ids`: global-attention layers' ``{"k", "v"}``
    (b, s, hkv, hd) as pool pages, ring layers' as the pages the window
    still sees (the drop count seeds the sequence's ring base; no content
    hash), recurrent layers' ``{"conv", "state"}`` / ``{"h", "conv"}`` as
    one state block per layer in the recurrent store. `page_hashes[bi]`
    is that request's cumulative token-prefix digest list (prefix
    caching); `valid_len` keeps only the first rows of each cache (a
    right-padded prefill, which a recurrent state cannot undo);
    `skip_pages[bi]` front pages were adopted from the prefix cache and
    are not put again."""
    lay = state.layout
    t = state.pool.page_tokens
    if lay.has_rec and valid_len is not None:
        raise NotImplementedError(
            "a right-padded prefill cannot extract recurrent state — "
            "hybrid stacks admit through chunked prefill")
    rec_parts: list[dict] = [{} for _ in seq_ids]
    for layer, ((mixer, _), c) in enumerate(zip(model.kinds, caches)):
        if mixer in (SSD, RGLRU):
            names = (("ssd_conv", "conv"), ("ssd_state", "state")) \
                if mixer == SSD else (("rg_h", "h"), ("rg_conv", "conv"))
            for store_name, key in names:
                val = c[key].float().cpu().numpy()
                for bi in range(len(seq_ids)):
                    rec_parts[bi].setdefault(store_name, []).append(val[bi])
            continue
        row = lay.kv_of[layer]
        k = c["k"][:, :valid_len].float().cpu().numpy()
        v = c["v"][:, :valid_len].float().cpu().numpy()
        for bi, seq in enumerate(seq_ids):
            if mixer == LOCAL_ATTN:
                plen = k.shape[1]
                base = lay.ring_base(plen - 1)
                state.write_prefill(row, seq, k[bi, base * t:plen],
                                    v[bi, base * t:plen])
                state._ring_base[seq] = base
                continue
            state.write_prefill(
                row, seq, k[bi], v[bi],
                page_hashes=page_hashes[bi] if page_hashes is not None
                else None,
                skip_pages=skip_pages[bi] if skip_pages is not None else 0)
    for bi, seq in enumerate(seq_ids):
        if rec_parts[bi]:
            state.write_prefill_rec(
                seq, {n: np.stack(v) for n, v in rec_parts[bi].items()})


def sample(logits, greedy: bool, temperature: float, generator=None):
    """Greedy argmax, or one draw from softmax(logits / temperature) with
    an explicit ``torch.Generator``. Returns int32 tokens."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


def _attend_rows(cfg, lay, kind, p, h, positions, arrays, table, lengths,
                 ring_base, row_base, backend):
    """A KV or ring layer of the fused step: scatter the step's K/V rows
    into the pool at ``row_base`` (flat (slot, row) indices, (b * k,)),
    then attend — the paged-attention kernel for a global layer, the ring
    gather and windowed attention for a sliding-window one. h: (b, k, d);
    positions: (b, k). Returns the out-projected (b, k, d)."""
    kf, vf, kq, vq, ks, vs = arrays
    n_layers, c, t = kf.shape[:3]
    ap = p["attn"]
    b, kk = positions.shape
    q, k_new, v_new = decode_qkv(cfg, ap, h, positions)
    row = lay.kv_of[kind[2]]
    idx = row * (c * t) + row_base
    k_rows = kf.view((n_layers * c * t,) + kf.shape[3:])
    v_rows = vf.view((n_layers * c * t,) + vf.shape[3:])
    k_rows.index_copy_(0, idx, k_new.reshape((b * kk,) + k_new.shape[2:])
                       .to(kf.dtype))
    v_rows.index_copy_(0, idx, v_new.reshape((b * kk,) + v_new.shape[2:])
                       .to(vf.dtype))
    if kind[0] == ATTN:
        qq = q[:, 0].contiguous() if kk == 1 else q.contiguous()
        y = api.run("paged_attention", qq, kf, vf, kq, vq, ks, vs, table,
                    lengths, row, backend=backend)
        if kk == 1:
            y = y[:, None]
    else:
        k_all, v_all = gather_ring_kv(arrays, row, table)
        y = ring_attend(q, k_all, v_all, lengths=lengths, base=ring_base,
                        positions=positions, window=lay.window,
                        page_tokens=t)
    return out_proj(ap, y, h.dtype)


def _rec_names(mixer):
    """Store tensors of a recurrent layer, in its core's state order."""
    return ("ssd_conv", "ssd_state") if mixer == SSD else ("rg_h", "rg_conv")


def build_fused_step(model, num_slots: int, *, k: int = 1,
                     backend: str = "auto", greedy: bool = True,
                     temperature: float = 1.0, layout=None):
    """Build the fused decode step.

    ``k == 1``. Returned callable: ``step(arrays, tokens, control,
    generator) -> sampled tokens (b,) int32``, where ``arrays`` is
    `PagedKVState.device_arrays` (the layer-stacked pool tensors, then
    the recurrent store's; all updated in place) and ``control`` the
    int32 block from `PagedKVState.begin_step`, already on the device.
    Per layer kind: a global-attention layer scatters its K/V row and
    attends through the paged-attention kernel, a sliding-window layer
    attends its ring gather within the window (the control block's base
    column), a recurrent layer gathers its state slot, runs the one-token
    core and scatters the state back. The host sees only the sampled
    tokens.

    ``k > 1`` — the speculative VERIFY step (`_build_spec_step`). Returned
    callable:
    ``step(arrays, control, generator) -> verdict (b, k + 1) int32``.
    ``layout`` is the engine's `StateLayout` (built from the model's
    config when omitted)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    lay = layout if layout is not None else StateLayout(model.cfg, 1)
    if k > 1:
        return _build_spec_step(model, num_slots, k, backend=backend,
                                greedy=greedy, temperature=temperature,
                                layout=lay)
    cfg = model.cfg
    cc = lay.cols(num_slots, k)
    rec_of = {n: i for i, n in enumerate(rec_array_names(lay))}
    kinds = [(m, mlp, layer) for layer, (m, mlp) in enumerate(model.kinds)]

    def step(arrays, tokens, control, generator=None):
        kv, rec = tuple(arrays[:6]), arrays[6:]
        t = kv[0].shape[2]
        table = control[:, :num_slots].contiguous()
        lengths = control[:, cc.len].contiguous()
        positions = control[:, cc.pos][:, None]
        # flat (slot, row) index of each batch row's new K/V row
        row_base = control[:, cc.tail].long() * t + control[:, cc.row]
        rec_slots = control[:, cc.rec] if lay.has_rec else None
        ring_base = control[:, cc.base] if lay.has_ring else None
        x = model.embed_in(tokens[:, None])
        for kind, p in zip(kinds, model.layers):
            h = rms_norm(x, p["norm1"])
            mixer, layer = kind[0], kind[2]
            if mixer in (ATTN, LOCAL_ATTN):
                y = _attend_rows(cfg, lay, kind, p, h, positions, kv, table,
                                 lengths, ring_base, row_base, backend)
            else:
                row = lay.ssd_of[layer] if mixer == SSD else lay.rg_of[layer]
                stores = [rec[rec_of[n]] for n in _rec_names(mixer)]
                state0 = tuple(rec_gather(a, row, rec_slots) for a in stores)
                y, states = rec_scan_tokens(
                    cfg, mixer, p["ssm" if mixer == SSD else "rglru"], h,
                    state0)
                for a, st in zip(stores, states):
                    rec_scatter(a, row, rec_slots, st[0])
            x = mlp_tail(cfg, kind, p, x + y)
        logits = model.head(x)[:, 0]
        return sample(logits, greedy, temperature, generator)

    return step


def _build_spec_step(model, num_slots: int, k: int, *, backend: str = "auto",
                     greedy: bool = True, temperature: float = 1.0,
                     layout=None):
    """The k-row verify step behind `build_fused_step(k > 1)`: the k input
    tokens (last accepted + k - 1 drafts, or a chunk of prompt tokens)
    ride in the control block; every KV or ring layer scatters k K/V rows
    — rows past the page boundary go to the spill slot — and ONE
    paged-attention launch scores all k rows (row j sees ``lengths + j``
    positions); the accept rule runs on the device: position j's sampled
    token is the model's answer after inputs 0..j, draft j survives while
    it equals the token sampled at position j - 1. Returns the ``[k
    sampled tokens | accepted draft count]`` verdict, so one download
    tells the host a whole accepted run. Greedy verification emits
    exactly the tokens of the k = 1 step.

    Recurrent layers verify in O(1) per token: the pre-step state slot is
    read once, `rec_scan_tokens` runs the k tokens through the one-token
    core and keeps the candidate post-token states, and after the accept
    rule resolves each row's ``keep`` one scatter per store tensor
    commits checkpoint ``keep - 1``: chunk rows keep their fixed count,
    verify rows ``min(accepted, keep_cap) + 1``."""
    cfg = model.cfg
    lay = layout if layout is not None else StateLayout(cfg, 1)
    cc = lay.cols(num_slots, k)
    rec_of = {n: i for i, n in enumerate(rec_array_names(lay))}
    kinds = [(m, mlp, layer) for layer, (m, mlp) in enumerate(model.kinds)]

    def step(arrays, control, generator=None):
        kv, rec = tuple(arrays[:6]), arrays[6:]
        t = kv[0].shape[2]
        table = control[:, :num_slots].contiguous()
        lengths = control[:, cc.len].contiguous()          # row 0's
        tail_row = control[:, cc.row]
        tokens = control[:, cc.tok:cc.tok + k]             # (b, k)
        offs = torch.arange(k, dtype=torch.int32, device=control.device)
        positions = control[:, cc.pos][:, None] + offs[None, :]
        # per-row scatter target: rows crossing the page boundary go to
        # the spill slot (tail_row < t and k <= t keep r below 2t)
        r = tail_row[:, None] + offs[None, :]
        over = r >= t
        slot = torch.where(over, control[:, cc.spill][:, None],
                           control[:, cc.tail][:, None])
        row_base = (slot.long() * t + torch.where(over, r - t, r)).reshape(-1)
        rec_slots = control[:, cc.rec] if lay.has_rec else None
        ring_base = control[:, cc.base] if lay.has_ring else None
        keep_fixed = control[:, cc.keep_fixed] if lay.has_rec else None
        b = tokens.shape[0]
        x = model.embed_in(tokens)                         # (b, k, d)
        commits = []        # (store tensor, row, stacked checkpoints)
        for kind, p in zip(kinds, model.layers):
            h = rms_norm(x, p["norm1"])
            mixer, layer = kind[0], kind[2]
            if mixer in (ATTN, LOCAL_ATTN):
                y = _attend_rows(cfg, lay, kind, p, h, positions, kv, table,
                                 lengths, ring_base, row_base, backend)
            else:
                row = lay.ssd_of[layer] if mixer == SSD else lay.rg_of[layer]
                stores = [rec[rec_of[n]] for n in _rec_names(mixer)]
                state0 = tuple(rec_gather(a, row, rec_slots) for a in stores)
                y, states = rec_scan_tokens(
                    cfg, mixer, p["ssm" if mixer == SSD else "rglru"], h,
                    state0)
                commits += [(a, row, st) for a, st in zip(stores, states)]
            x = mlp_tail(cfg, kind, p, x + y)
        logits = model.head(x)                             # (b, k, V)
        samp = sample(logits.reshape(b * k, -1), greedy, temperature,
                      generator).reshape(b, k)
        match = (tokens[:, 1:] == samp[:, :-1]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        if commits:
            # chunk rows keep their fixed token count, verify rows the
            # accepted drafts + the bonus token, capped at the row's real
            # proposal count
            keep = torch.where(keep_fixed >= 0, keep_fixed,
                               torch.minimum(n_acc, control[:, cc.keep_cap])
                               + 1)
            keep = torch.clamp(keep, 1, k)
            for a, row, st in commits:
                rec_scatter(a, row, rec_slots, select_checkpoint(st, keep))
        return torch.cat([samp, n_acc[:, None]], dim=1)

    return step
