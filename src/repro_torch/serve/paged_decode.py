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

Three decode modes over one `PagedKVState`, as in the reference:

``fused``  (default) the step above.
``eager``  the per-layer reference path (`paged_decode_step`): a Python
           loop over layers, each bringing its new K/V rows back to the
           host, writing them into the same layer-stacked device pool
           (`DevicePagePool.write_rows`) and launching the paged kernel
           alone — about two transfers a layer a token.
``numpy``  no device pool: each layer's pool-shaped arrays are
           assembled on the host every step (padded to a power of two,
           at least 8 entries, so shapes change only as the pool grows)
           and uploaded for the call; the tail rows stay on the host.
Eager and numpy serve pure global-attention stacks, one token a step; on
the card both launch the paged kernel, never its plain version.

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
from repro_torch.core import spans
from repro_torch.kernels import api
from repro_torch.models.attention import decode_qkv, out_proj
from repro_torch.models.common import psum_one, torch_dtype
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import mlp_tail_tp
from repro_torch.serve.device_pool import DevicePagePool
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.paged_state import (RecurrentStore, StateLayout,
                                           gather_ring_kv, rec_array_names,
                                           rec_gather, rec_scan_tokens_tp,
                                           rec_scatter,
                                           ring_attend, select_checkpoint,
                                           supports_paged_layout)

MODES = ("fused", "eager", "numpy")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def paged_tile(backend: str, args):
    """The paged-attention launch shape for one step's shapes: with
    ``backend="auto"`` the knee of the spec's Hopper cost model
    (`api.resolve_tile`, cached per shape and persisted by the knee
    cache), looked up once a step and used for every layer; else None
    (``"cuda"``: the wrapper's own plan; ``"ref"`` takes no tile). On the
    CPU the knee is resolved all the same, and the plain version ignores
    it."""
    if backend != "auto":
        return None
    return api.resolve_tile("paged_attention", args)


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
    pool's and the recurrent store's writes and readbacks.

    Under a mesh ``plan`` (`serve.sharding.ServePlan`) a sequence is bound
    to a data shard (`bind_seq`) before its first write: its page, tail,
    spill and recurrent slots all come from that shard, and the control
    block carries shard-local slot ids, so its row attends only pages of
    its own shard. The decode batch must hold an equal block of rows per
    shard (pad with -1 rows: `ServePlan.pad_rows`); every shard has its
    own trash slots. The control block is still one upload.

    ``mode`` is the decode mode (`MODES`). ``"numpy"`` keeps no device
    pool: the tail rows live in ``tail_data`` on the host and `gather`
    assembles each layer's arrays for the step. A plan, or a stack with
    recurrent or ring layers, takes the fused mode only, as in the
    reference."""

    def __init__(self, pool: PagedKVPool, capacity: int,
                 layout: StateLayout, hkv: int, hd: int, *,
                 mode: str = "fused", batch_hint: int = 1,
                 tail_slots: int = 1, device="cuda", plan=None):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if tail_slots not in (1, 2):
            raise ValueError(f"tail_slots must be 1 or 2, got {tail_slots}")
        if plan is not None and mode != "fused":
            raise ValueError(f"mesh-sharded serving requires the fused "
                             f"decode mode, got {mode!r}")
        if (layout.has_rec or layout.has_ring) and mode != "fused":
            raise NotImplementedError(
                f"recurrent/ring paged state is fused-only, got mode "
                f"{mode!r}")
        self.mode = mode
        self.pool = pool
        self.layout = layout
        self.num_layers = num_layers = layout.n_kv
        self.hkv, self.hd = hkv, hd
        self.plan = plan
        shards = plan.dp if plan is not None else 1
        self.device = plan.device(0, 0) if plan is not None \
            else torch.device(device)
        t = pool.page_tokens
        slots = -(-capacity // t)          # ceil: pages covering capacity
        if layout.has_ring:
            slots = min(slots, layout.ring_pages())
        # + the tail page(s), rounded to a multiple of 8
        self.slots = -(-(slots + tail_slots) // 8) * 8
        self.batch_hint = max(1, batch_hint)
        self._shard_of: dict[int, int] = {}    # seq -> data shard
        self.tail_len: dict[int, int] = {}     # seq -> tail rows (all layers)
        self._tail_slot: dict[int, int] = {}   # seq -> device slot
        self._spill_slot: dict[int, int] = {}  # k > 1: boundary-crossing rows
        # chunked prefill: content hashes awaiting the seq's next page
        # fills, so prompt pages built by chunk scatters dedup/share and
        # can be pinned by the radix prefix tree
        self._pending_hashes: dict[int, list] = {}
        # init_slots is the PER-SHARD worst case: each shard carries its
        # block of decode rows
        rows_per_shard = -(-self.batch_hint // shards)
        self.tail_data: dict[tuple, list] = {}  # numpy: (seq, layer) -> rows
        self._device: DevicePagePool | None = None
        self._trash: list = []
        if mode != "numpy":
            self._device = DevicePagePool(
                num_layers, t, hkv, hd,
                init_slots=self.slots * rows_per_shard, device=self.device,
                plan=plan)
            self._trash = [self._device.alloc(s) for s in range(shards)]
        self._rec: RecurrentStore | None = None
        if layout.has_rec:
            self._rec = RecurrentStore(
                layout, batch_hint=self.batch_hint,
                compute_dtype=torch_dtype(layout.cfg.compute_dtype),
                device=self.device, plan=plan)
        self._rec_slot: dict[int, int] = {}    # seq -> recurrent slot
        self._ring_base: dict[int, int] = {}   # seq -> dropped ring pages
        # preempted sequences: seq -> host copy of its partial tail rows
        # (num_layers, tail_len, hkv, hd) K/V, or None when the tail was
        # empty at swap-out; seq -> its parked recurrent state blocks
        self._parked_tail: dict[int, object] = {}
        self._parked_rec: dict[int, dict] = {}
        # between begin_step and end_step: the step's sequences, control
        # block, and (eager) uploaded page table, lengths and tile
        self._step: dict | None = None
        self.gather_s = 0.0       # host-side bookkeeping time
        self.h2d = 0
        self.d2h = 0

    # -- data-shard binding --------------------------------------------------
    def bind_seq(self, seq: int, shard: int):
        """Pin a sequence to a data shard BEFORE its first write: all of
        its device slots (pages, tail, spill, recurrent) come from that
        shard, so its decode row attends only local pages. Rebinding to
        another shard is an error."""
        prev = self._shard_of.setdefault(seq, shard)
        if prev != shard:
            raise RuntimeError(f"sequence {seq} already bound to data "
                               f"shard {prev}, cannot rebind to {shard}")

    def shard_of(self, seq: int) -> int:
        if self._device is not None and self._device.shards > 1 \
                and seq not in self._shard_of:
            raise RuntimeError(f"sequence {seq} not bound to a data shard "
                               f"— call bind_seq before its first write")
        return self._shard_of.get(seq, 0)

    @property
    def device_arrays(self):
        """The fused step's tensors, updated in place: the six
        layer-stacked pool tensors, then the recurrent store's (if any).
        Under a plan, one such tuple per shard: ``[d][m]``."""
        rec = self._rec
        if self.plan is None:
            kv = self._device.arrays
            return kv + rec.arrays if rec is not None else kv
        return [[kv + (rec.shard_arrays[d][m] if rec is not None else ())
                 for m, kv in enumerate(row)]
                for d, row in enumerate(self._device.shard_arrays)]

    def transfer_counts(self) -> tuple[int, int]:
        """(host->device, device->host) explicit transfers so far,
        including the device pool's write batches and fill readbacks and
        the recurrent store's slot writes and reads."""
        dev = self._device
        h2d = self.h2d + (dev.writes if dev is not None else 0)
        d2h = self.d2h + (dev.reads if dev is not None else 0)
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
        rest_k, rest_v = k[n_full * t:], v[n_full * t:]
        if self._device is None:
            self.tail_data[(seq, layer)] = [(rest_k[r], rest_v[r])
                                            for r in range(n_rest)]
            return
        slot = self._ensure_tail_slot(seq)
        self._device.write_rows(layer, np.full(n_rest, slot),
                                np.arange(n_rest), rest_k, rest_v)

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
            slot = self._device.alloc(self.shard_of(seq))
            self._device.zero_slot(slot)
            self._tail_slot[seq] = slot
        return slot

    def _ensure_spill_slot(self, seq: int) -> int:
        """Second tail slot for k-row steps: rows past the page boundary
        scatter here; it becomes the tail slot when the kept tokens
        actually fill the page."""
        slot = self._spill_slot.get(seq)
        if slot is None:
            slot = self._device.alloc(self.shard_of(seq))
            self._device.zero_slot(slot)
            self._spill_slot[seq] = slot
        return slot

    def _ensure_rec_slot(self, seq: int) -> int:
        """The sequence's O(1) recurrent slot (one state block per
        recurrent layer), zeroed on first use."""
        slot = self._rec_slot.get(seq)
        if slot is None:
            slot = self._rec.alloc(self.shard_of(seq))
            self._rec.zero_slot(slot)
            self._rec_slot[seq] = slot
        return slot

    def write_prefill_rec(self, seq: int, blocks: dict):
        """Install post-prefill recurrent state for `seq`: ``blocks`` maps
        store tensor names to (layers of that kind, ...) host blocks. A
        full set skips the zeroing write."""
        slot = self._rec_slot.get(seq)
        if slot is None:
            slot = self._rec.alloc(self.shard_of(seq))
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
        and keep exactly one phantom token. Under a plan row i belongs to
        data shard ``i * dp // b``, which binds its sequence, and every
        slot is that shard's local id."""
        t0 = time.perf_counter()
        t = self.pool.page_tokens
        if k > t:
            raise ValueError(
                f"k={k} tokens per step exceed page_tokens={t}: one step "
                f"may spill across at most one page boundary")
        b = len(seq_ids)
        positions = np.broadcast_to(np.asarray(positions, np.int32), (b,))
        cc = self.layout.cols(self.slots, k)
        dev = self._device
        if k > 1 and dev is None:
            raise RuntimeError("k-row steps scatter inside the fused step "
                               "— they need a device pool")
        shards = dev.shards if dev is not None else 1
        if b % shards:
            raise ValueError(f"decode batch of {b} rows does not split "
                             f"over {shards} data shards — pad with -1 "
                             f"rows (ServePlan.pad_rows)")
        row_shard = [i * shards // b for i in range(b)]
        control = np.zeros((b, cc.width), np.int32)
        if dev is not None:
            control[:, cc.tail] = [dev.local_slot(self._trash[sh])
                                   for sh in row_shard]
        control[:, cc.len] = 1
        if self._rec is not None:
            control[:, cc.rec] = [self._rec.local_slot(self._rec.trash_of[sh])
                                  for sh in row_shard]
            if k > 1:
                control[:, cc.keep_fixed] = 1
                control[:, cc.keep_cap] = 0
        if k > 1:
            control[:, cc.spill] = control[:, cc.tail]
            if tokens is not None:
                control[:, cc.tok:cc.tok + k] = np.asarray(tokens, np.int32)
        groups_by_row, touch_pids = [], []
        sync_groups, sync_shards = [], []
        for i, seq in enumerate(seq_ids):
            if seq < 0:
                groups_by_row.append(None)
                continue
            if shards > 1:
                self.bind_seq(seq, row_shard[i])
            groups = self._page_groups(seq, tail_slots=1 if k == 1 else 2)
            for g in groups:
                touch_pids.extend(g)
            sync_groups.extend(groups)
            sync_shards.extend([row_shard[i]] * len(groups))
            groups_by_row.append(groups)
        self.pool.touch_many(touch_pids)
        if dev is not None:
            dev.sync(self.pool, sync_groups, sync_shards)
        for i, groups in enumerate(groups_by_row):
            if groups is None:
                continue
            seq = seq_ids[i]
            tail = self.tail_len.get(seq, 0)
            if dev is not None and self.num_layers:
                sh = row_shard[i]
                for n, g in enumerate(groups):
                    control[i, n] = dev.local_slot(dev.slot(g[0], sh))
                control[i, cc.tail] = \
                    dev.local_slot(self._ensure_tail_slot(seq))
                control[i, len(groups)] = control[i, cc.tail]
                if k > 1:
                    control[i, cc.spill] = \
                        dev.local_slot(self._ensure_spill_slot(seq))
                    control[i, len(groups) + 1] = control[i, cc.spill]
            if self._rec is not None:
                control[i, cc.rec] = \
                    self._rec.local_slot(self._ensure_rec_slot(seq))
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
        self._step = {"seq_ids": list(seq_ids), "control": control, "cc": cc,
                      "table": None, "lengths": None, "tile": None}
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
        with spans.span("repro_torch.serve.control"):
            control = self.begin_step(seq_ids, positions)
            cdev = torch.from_numpy(control).to(self.device)
            self.h2d += 1
            if not isinstance(tokens, torch.Tensor):
                tokens = torch.from_numpy(np.asarray(tokens, np.int32)) \
                    .to(self.device)
                self.h2d += 1
        with spans.span("repro_torch.serve.launch"):
            tok_dev = step_fn(self.device_arrays, tokens, cdev, generator)
        with spans.span("repro_torch.serve.tokens"):
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
        with spans.span("repro_torch.serve.control"):
            tokens_k = np.asarray(tokens_k, np.int32)
            control = self.begin_step(seq_ids, positions,
                                      k=tokens_k.shape[1], tokens=tokens_k,
                                      keep_fixed=keep_fixed,
                                      keep_cap=keep_cap)
            cdev = torch.from_numpy(control).to(self.device)
            self.h2d += 1
        with spans.span("repro_torch.serve.launch"):
            out = step_fn(self.device_arrays, cdev, generator)
        with spans.span("repro_torch.serve.tokens"):
            out = out.cpu().numpy()
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
        with spans.span("repro_torch.serve.pages"):
            if self._step is None:
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
                    continue        # pure-recurrent stack: no pages to fill
                n = self.tail_len.get(seq, 0) + adv
                if n < t:
                    self.tail_len[seq] = n
                    if self.layout.has_ring:
                        self._drop_ring(seq)
                    continue
                self.tail_len[seq] = n - t
                if self._device is None:
                    if adv != 1:
                        raise RuntimeError("multi-token steps need the device "
                                           "pool (decode_mode='fused')")
                    for layer in range(self.num_layers):
                        rows = self.tail_data.pop((seq, layer))
                        self.pool.put(seq, np.stack([r[0] for r in rows]),
                                      np.stack([r[1] for r in rows]),
                                      layer=layer)
                    continue
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
                self._device.adopt(group, slot, self.pool,
                                   shard=self._device.shard_of_slot(slot))
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
            self._step = None
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
        if self._device is not None:
            self._device.release_pid(pid)

    # -- eager / numpy modes: one layer at a time ----------------------------
    def _step_view(self) -> dict:
        if self._step is None:
            raise RuntimeError("decode step used outside "
                               "begin_step()/end_step()")
        return self._step

    def append_step_rows(self, layer: int, k_rows: np.ndarray,
                         v_rows: np.ndarray):
        """Eager / numpy modes: append this step's (b, hkv, hd) host K/V
        rows at one layer — one `DevicePagePool.write_rows` batch into the
        tail slots (dead rows into the scratch slot), or onto the host
        ``tail_data``. The fused step does the same scatter itself."""
        st = self._step_view()
        c, cc = st["control"], st["cc"]
        if self._device is not None:
            self._device.write_rows(layer, c[:, cc.tail], c[:, cc.row],
                                    k_rows, v_rows)
            return
        for i, seq in enumerate(st["seq_ids"]):
            if seq >= 0:
                self.tail_data.setdefault((seq, layer), []) \
                    .append((k_rows[i], v_rows[i]))

    def attend(self, q, layer: int, backend: str = "auto"):
        """Eager / numpy modes: q (b, hq, hd) for the step's token at one
        layer -> (b, hq, hd) over every pooled page and tail row, through
        ``api.run("paged_attention", ...)``. Eager attends the resident
        layer-stacked pool (the page table and lengths uploaded once a
        step: 2 transfers); numpy uploads the layer's host-assembled
        arrays for the call (8 transfers). The launch shape is resolved
        once a step (`paged_tile`)."""
        st = self._step_view()
        if self._device is not None:
            if st["table"] is None:
                c, cc = st["control"], st["cc"]
                st["table"] = torch.from_numpy(
                    np.ascontiguousarray(c[:, :self.slots])).to(self.device)
                st["lengths"] = torch.from_numpy(
                    np.ascontiguousarray(c[:, cc.len])).to(self.device)
                self.h2d += 2
            args = (q, *self._device.arrays, st["table"], st["lengths"],
                    layer)
        else:
            t0 = time.perf_counter()
            view = self._gather_numpy(layer, st["seq_ids"])
            self.gather_s += time.perf_counter() - t0
            self.h2d += len(view)
            args = (q, *[torch.from_numpy(a).to(self.device) for a in view])
        if st["tile"] is None:
            st["tile"] = paged_tile(backend, args) or {}
        return api.run("paged_attention", *args, backend=backend,
                       tile=st["tile"] or None)

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
        if self._device is None:
            self._parked_tail[seq] = None   # numpy tails already host-side
        elif n > 0:
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
            self.release_page(pid)
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
        if self._device is not None and n > 0:
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
            self.release_page(pid)
        self._shard_of.pop(seq, None)
        self.tail_len.pop(seq, None)
        self._pending_hashes.pop(seq, None)
        self._ring_base.pop(seq, None)
        self._parked_tail.pop(seq, None)
        self._parked_rec.pop(seq, None)
        slot = self._rec_slot.pop(seq, None)
        if slot is not None:
            self._rec.release_slot(slot)
        for key in [key for key in self.tail_data if key[0] == seq]:
            self.tail_data.pop(key)
        for slot in (self._tail_slot.pop(seq, None),
                     self._spill_slot.pop(seq, None)):
            if slot is not None:
                self._device.release_slot(slot)
        return destroyed


    # -- numpy mode: the host-assembled pool ---------------------------------
    def gather(self, layer: int, seq_ids) -> tuple:
        """numpy mode: (k_pages, v_pages, k_quant, v_quant, k_scale,
        v_scale, page_table, lengths) for the batch at this layer, host
        arrays in the kernel's argument order (the device modes keep the
        pool resident: use begin_step / attend)."""
        if self.mode != "numpy":
            raise RuntimeError("gather() assembles host arrays — device-"
                               "resident modes use begin_step()/attend()")
        t0 = time.perf_counter()
        view = self._gather_numpy(layer, list(seq_ids))
        self.gather_s += time.perf_counter() - t0
        return view

    def _seq_view_numpy(self, seq, layer):
        pids = self.pool.seq_pages(seq, layer)
        tail = self.tail_data.get((seq, layer), ())
        if len(pids) + bool(tail) > self.slots:
            raise ValueError(
                f"sequence {seq}: {len(pids)} pages + "
                f"{'a partial' if tail else 'no'} tail page exceed the "
                f"page-table capacity of {self.slots} slots "
                f"({self.slots * self.pool.page_tokens} tokens) at layer "
                f"{layer}; size the PagedKVState capacity to the longest "
                f"request")
        return pids, tail

    def _gather_numpy(self, layer: int, seq_ids) -> tuple:
        """The layer's pages and tail rows as one flat float32 / int8
        pool, padded to a power of two and at least 8 entries, with the
        page table into it and the lengths."""
        pool, t = self.pool, self.pool.page_tokens
        b = len(seq_ids)
        entries: list = []
        table = np.zeros((b, self.slots), np.int32)
        lengths = np.ones(b, np.int32)
        for i, seq in enumerate(seq_ids):
            if seq < 0:
                continue
            pids, tail = self._seq_view_numpy(seq, layer)
            for n, pid in enumerate(pids):
                table[i, n] = len(entries)
                entries.append(pool.pages[pid])
            if tail:
                table[i, len(pids)] = len(entries)
                entries.append(tuple(tail))
            lengths[i] = max(1, len(pids) * t + len(tail))
        hkv, hd = self.hkv, self.hd
        n = max(8, _next_pow2(len(entries)))
        kf = np.zeros((n, t, hkv, hd), np.float32)
        vf = np.zeros_like(kf)
        kq = np.zeros((n, t, hkv, hd), np.int8)
        vq = np.zeros_like(kq)
        ks = np.zeros((n, t, hkv), np.float32)
        vs = np.zeros_like(ks)
        for e, entry in enumerate(entries):
            if isinstance(entry, tuple):               # tail: partial page
                kf[e, :len(entry)] = np.stack([r[0] for r in entry])
                vf[e, :len(entry)] = np.stack([r[1] for r in entry])
            elif entry.tier == "fast":
                kf[e], vf[e] = entry.data
            else:                                      # slow: stays int8
                (pkq, pks), (pvq, pvs) = entry.data
                kq[e], ks[e] = pkq, pks[..., 0]
                vq[e], vs[e] = pvq, pvs[..., 0]
        return kf, vf, kq, vq, ks, vs, table, lengths


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


def paged_decode_step(model, tokens, state: PagedKVState, seq_ids, pos,
                      backend: str = "auto"):
    """One decode step with every attention layer served from the page
    pool, one layer at a time — the eager reference path and the numpy
    mode: each layer brings its new K/V rows back to the host (2
    transfers), appends them (`PagedKVState.append_step_rows`) and
    launches the paged kernel alone (`PagedKVState.attend`). The fused
    step must match it token for token.

    tokens: (b,) int32 host values; `pos` a scalar shared by the batch or
    (b,) per-sequence positions; `seq_ids` may carry -1 padding rows,
    whose logits are garbage. Returns logits (b, V) on the model's
    device. A stack that is not pure global attention raises
    `NotImplementedError`: recurrent and ring layers are fused-only."""
    cfg = model.cfg
    if not all(mixer == ATTN for mixer, _ in cfg.layer_kinds()) \
            or not supports_paged_layout(cfg):
        raise NotImplementedError(
            f"eager paged decode needs a pure global-attention stack "
            f"(recurrent/ring layers are fused-only), got "
            f"{cfg.layer_kinds()}")
    seq_ids = list(seq_ids)
    b = len(seq_ids)
    state.begin_step(seq_ids, pos)
    dev = state.device
    x = model.embed_in(torch.from_numpy(
        np.asarray(tokens, np.int32).reshape(b, 1)).to(dev))
    positions = torch.from_numpy(np.broadcast_to(
        np.asarray(pos, np.int32), (b,)).copy()).to(dev)
    for layer, kind in enumerate(model.kinds):
        p = model.layers[layer]
        h = rms_norm(x, p["norm1"])
        q, k_new, v_new = decode_qkv(cfg, p["attn"], h, positions)
        k_rows = k_new[:, 0].float().cpu().numpy()
        v_rows = v_new[:, 0].float().cpu().numpy()
        state.d2h += 2
        row = state.layout.kv_of[layer]
        state.append_step_rows(row, k_rows, v_rows)
        y = state.attend(q[:, 0].contiguous(), row, backend=backend)
        x = x + out_proj(p["attn"], y[:, None], h.dtype)
        (x,), _ = mlp_tail_tp(cfg, kind, [p], [x], psum_one)
    logits = model.head(x)[:, 0]
    state.end_step(seq_ids)
    return logits


def sample(logits, greedy: bool, temperature: float, generator=None):
    """Greedy argmax, or one draw from softmax(logits / temperature) with
    an explicit ``torch.Generator``. Returns int32 tokens."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


def _attend_rows(cfg, lay, kind, p, h, positions, arrays, table, lengths,
                 ring_base, row_base, backend, tiles, m):
    """A KV or ring layer of the fused step: scatter the step's K/V rows
    into the pool at ``row_base`` (flat (slot, row) indices, (b * k,)),
    then attend — the paged-attention kernel for a global layer, the ring
    gather and windowed attention for a sliding-window one. h: (b, k, d);
    positions: (b, k). The kernel's launch shape is model shard m's entry
    of ``tiles``, resolved at the step's first global layer
    (`paged_tile`). Returns the out-projected (b, k, d)."""
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
        args = (qq, kf, vf, kq, vq, ks, vs, table, lengths, row)
        if tiles[m] is None:
            tiles[m] = paged_tile(backend, args) or {}
        y = api.run("paged_attention", *args, backend=backend,
                    tile=tiles[m] or None)
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


class _Controls:
    """The step's view of a control block (`StateLayout.cols`): page
    table, lengths (row 0's), positions (b, k), each K/V row's flat (slot,
    row) scatter index, the input tokens (k > 1) and the recurrent slots
    and ring bases where the stack has them. k > 1 rows past the page
    boundary scatter to the spill slot (row < t and k <= t keep them below
    2t)."""

    def __init__(self, control, cc, lay, num_slots: int, k: int, t: int):
        self.table = control[:, :num_slots].contiguous()
        self.lengths = control[:, cc.len].contiguous()
        if k == 1:
            self.positions = control[:, cc.pos][:, None]
            self.row_base = control[:, cc.tail].long() * t \
                + control[:, cc.row]
            self.tokens = None
        else:
            offs = torch.arange(k, dtype=torch.int32, device=control.device)
            self.positions = control[:, cc.pos][:, None] + offs[None, :]
            r = control[:, cc.row][:, None] + offs[None, :]
            over = r >= t
            slot = torch.where(over, control[:, cc.spill][:, None],
                               control[:, cc.tail][:, None])
            self.row_base = (slot.long() * t
                             + torch.where(over, r - t, r)).reshape(-1)
            self.tokens = control[:, cc.tok:cc.tok + k]
        self.rec_slots = control[:, cc.rec] if lay.has_rec else None
        self.ring_base = control[:, cc.base] if lay.has_ring else None


def build_fused_step(model, num_slots: int, *, k: int = 1,
                     backend: str = "auto", greedy: bool = True,
                     temperature: float = 1.0, layout=None, plan=None):
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

    ``k > 1`` — the speculative VERIFY step. Returned callable:
    ``step(arrays, control, generator) -> verdict (b, k + 1) int32``. The
    k input tokens (last accepted + k - 1 drafts, or a chunk of prompt
    tokens) ride in the control block; every KV or ring layer scatters k
    K/V rows — rows past the page boundary go to the spill slot — and ONE
    paged-attention launch scores all k rows (row j sees ``lengths + j``
    positions); the accept rule runs on the device: position j's sampled
    token is the model's answer after inputs 0..j, draft j survives while
    it equals the token sampled at position j - 1. The ``[k sampled
    tokens | accepted draft count]`` verdict tells the host a whole
    accepted run in one download. Greedy verification emits exactly the
    tokens of the k = 1 step. Recurrent layers verify in O(1) per token:
    the pre-step state slot is read once, `rec_scan_tokens_tp` keeps the
    k candidate post-token states, and after the accept rule one scatter
    per store tensor commits checkpoint ``keep - 1``: chunk rows keep
    their fixed count, verify rows ``min(accepted, keep_cap) + 1``.

    ``layout`` is the engine's `StateLayout` (built from the model's
    config when omitted).

    ``plan`` (a `serve.sharding.ServePlan`; ``model`` then a
    `serve.sharding.ShardedModel`, ``arrays`` ``[d][m]``) runs the body
    per shard, one controller over every shard: data shard d takes rows
    ``[d b/dp, (d + 1) b/dp)`` of the control block (and of ``tokens``),
    copied to each of its model shards' devices, and attends its own pool
    slice through the block's local slot ids. Per layer each model shard
    runs its heads — the K/V row scatter into its pool slice and the
    paged-attention kernel at its head count (hq / tp, hkv / tp or the
    one kv head), or its block of a recurrent layer — and the attention
    out-projection and the MLP down-projection meet at `ServePlan.psum`
    (as do the SSD gate norm and the RG-LRU gates). Each data shard's
    logits come from model shard 0 to the controller's device, where one
    sample (and, k > 1, one accept rule) covers the batch. ``plan=None``
    is the one-shard case: the model itself, its device, no reduction."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    cfg = model.cfg
    lay = layout if layout is not None else StateLayout(cfg, 1)
    cc = lay.cols(num_slots, k)
    rec_of = {n: i for i, n in enumerate(rec_array_names(lay))}
    kinds = [(m, mlp, layer) for layer, (m, mlp) in enumerate(model.kinds)]
    if plan is None:
        shards, dp, psum = [[model]], 1, psum_one
    else:
        shards, dp, psum = model.shards, plan.dp, plan.psum

    def shard_rows(d, arrays_d, control, tokens):
        ws = shards[d]
        devs = [control.device if plan is None else plan.device(d, m)
                for m in range(len(ws))]
        t = arrays_d[0][0].shape[2]
        ctl = [_Controls(control.to(dev), cc, lay, num_slots, k, t)
               for dev in devs]
        if k == 1:
            xs = [w.embed_in(tokens.to(dev)[:, None])
                  for w, dev in zip(ws, devs)]
        else:
            xs = [w.embed_in(c.tokens) for w, c in zip(ws, ctl)]
        commits = []        # (store tensor, row, rec slots, checkpoints)
        tiles = [None] * len(ws)    # per model shard, resolved once a step
        for kind in kinds:
            mixer, layer = kind[0], kind[2]
            ps = [w.layers[layer] for w in ws]
            hs = [rms_norm(x, p["norm1"]) for p, x in zip(ps, xs)]
            if mixer in (ATTN, LOCAL_ATTN):
                ys = psum([_attend_rows(cfg, lay, kind, p, h, c.positions,
                                        tuple(a[:6]), c.table, c.lengths,
                                        c.ring_base, c.row_base, backend,
                                        tiles, m)
                           for m, (p, h, c, a) in enumerate(
                               zip(ps, hs, ctl, arrays_d))])
            else:
                row = lay.ssd_of[layer] if mixer == SSD else lay.rg_of[layer]
                stores = [[a[6 + rec_of[n]] for n in _rec_names(mixer)]
                          for a in arrays_d]
                state0 = [tuple(rec_gather(a, row, c.rec_slots) for a in st)
                          for st, c in zip(stores, ctl)]
                ys, states = rec_scan_tokens_tp(
                    cfg, mixer, [p["ssm" if mixer == SSD else "rglru"]
                                 for p in ps], hs, state0, psum)
                for st, c, new in zip(stores, ctl, states):
                    for a, leaf in zip(st, new):
                        if k == 1:
                            rec_scatter(a, row, c.rec_slots, leaf[0])
                        else:
                            commits.append((a, row, c.rec_slots, leaf))
            xs, _ = mlp_tail_tp(cfg, kind, ps, [x + y for x, y in zip(xs, ys)],
                                psum)
        return ws[0].head(xs[0]), commits

    def run(arrays, control, tokens):
        """Every data shard's rows: (logits on the controller's device,
        per data shard (its row slice, its pending recurrent commits))."""
        if plan is None:
            arrays = [[arrays]]
        rows = control.shape[0] // dp
        logits, commits = [], []
        for d in range(dp):
            sl = slice(d * rows, (d + 1) * rows)
            lg, cm = shard_rows(d, arrays[d], control[sl],
                                tokens[sl] if tokens is not None else None)
            logits.append(lg.to(control.device))
            commits.append((sl, cm))
        return (logits[0] if dp == 1 else torch.cat(logits)), commits

    if k == 1:
        def step(arrays, tokens, control, generator=None):
            logits, _ = run(arrays, control, tokens)
            return sample(logits[:, 0], greedy, temperature, generator)
        return step

    def spec_step(arrays, control, generator=None):
        logits, commits = run(arrays, control, None)
        b = control.shape[0]
        tokens = control[:, cc.tok:cc.tok + k]
        samp = sample(logits.reshape(b * k, -1), greedy, temperature,
                      generator).reshape(b, k)
        match = (tokens[:, 1:] == samp[:, :-1]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        if lay.has_rec:
            # chunk rows keep their fixed token count, verify rows the
            # accepted drafts + the bonus token, capped at the row's real
            # proposal count
            keep_fixed = control[:, cc.keep_fixed]
            keep = torch.where(keep_fixed >= 0, keep_fixed,
                               torch.minimum(n_acc, control[:, cc.keep_cap])
                               + 1)
            keep = torch.clamp(keep, 1, k)
            for sl, cm in commits:
                for a, row, slots, st in cm:
                    rec_scatter(a, row, slots,
                                select_checkpoint(st, keep[sl].to(a.device)))
        return torch.cat([samp, n_acc[:, None]], dim=1)

    return spec_step
