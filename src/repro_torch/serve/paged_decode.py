"""Paged decode: page-pool KV state + the fused decode step.

The port of ``repro/serve/paged_decode.py`` for global-attention stacks,
with one token per step or k (speculative verify, chunked prefill). The KV cache lives in a tiered `PagedKVPool`
(fast float vs. slow int8 per page, chosen by the placement policy),
mirrored into the layer-stacked `DevicePagePool`; attention over it runs
through ``api.run("paged_attention", ...)``: the CUDA kernel on the card,
its plain version on the CPU.

Per token, `build_fused_step` runs the whole step — embed -> every layer
(rms_norm, QKV + bias + RoPE, the K/V row scatter into the pool, paged
attention, out-projection, MLP) -> final norm -> lm_head -> sample — as
one Python function over device tensors, eagerly. The host's part shrinks
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
  attend   -> one page table per step serves every layer
  retire   -> ``free_seq`` releases the request's pool pages (ref-
              counted; prefix-shared pages survive) and device slots
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels import api
from repro_torch.models.attention import decode_qkv, out_proj
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import mlp_tail
from repro_torch.serve.device_pool import DevicePagePool
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.paged_state import StateLayout


class PagedKVState:
    """Pool-backed KV state for a decode batch.

    The pool holds full pages; a per-sequence *tail slot* in the
    layer-stacked device pool holds the < page_tokens newest rows of every
    layer until they fill a page. Tail fill level is layer-uniform, so one
    counter per sequence and one page table per step describe the stack.
    ``tail_slots=2`` sizes the page table for k-row steps, whose rows may
    cross one page boundary into a *spill slot*.

    Batch rows may carry ``seq_id = -1`` (continuous batching pads retired
    rows): they write to a scratch slot and attend a zero page.

    ``h2d`` / ``d2h`` count the explicit host->device / device->host
    transfers of the decode path; `transfer_counts` adds the device
    pool's write batches and fill readbacks."""

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
        # pages covering capacity + the tail page(s), rounded to a mult. of 8
        self.slots = -(-(-(-capacity // t) + tail_slots) // 8) * 8
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
        self._in_step = False     # between begin_step and end_step
        self.gather_s = 0.0       # host-side bookkeeping time
        self.h2d = 0
        self.d2h = 0

    @property
    def device_arrays(self):
        """The six layer-stacked pool tensors, updated in place."""
        return self._device.arrays

    def transfer_counts(self) -> tuple[int, int]:
        """(host->device, device->host) explicit transfers so far,
        including the device pool's write batches and fill readbacks."""
        return (self.h2d + self._device.writes,
                self.d2h + self._device.reads)

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

    # -- per-step protocol ---------------------------------------------------
    def _page_groups(self, seq: int, tail_slots: int = 1):
        """Per-layer pool pids of each logical page of `seq`, zipped into
        layer-uniform groups, with the slot-overflow check (+ the tail
        slot(s) every step appends into)."""
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
                   tokens=None) -> np.ndarray:
        """Host bookkeeping before one step: touch each live page once
        (one pool-clock tick for the whole step), sync the device mirror
        (new prefill pages, demotion rewrites), and build the int32
        control block (`StateLayout.cols`). Its length column already
        counts the token this step appends; with k > 1 the position and
        length are row 0's (row j adds j inside the step), the spill slot
        follows the tail slot in the page table, and ``tokens`` (b, k)
        rides in the block. Dead rows (seq -1) get the scratch slot and
        length 1."""
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
            for n, g in enumerate(groups):
                control[i, n] = self._device.slot(g[0])
            control[i, cc.tail] = self._ensure_tail_slot(seq)
            control[i, len(groups)] = control[i, cc.tail]
            if k > 1:
                control[i, cc.spill] = self._ensure_spill_slot(seq)
                control[i, len(groups) + 1] = control[i, cc.spill]
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
                 generator=None) -> np.ndarray:
        """Drive one k-row verify step (`build_fused_step(k=...)`): begin
        bookkeeping, ONE control upload (page table, tail and spill slots,
        the (b, k) input tokens), ONE download of the ``(b, k + 1)``
        verdict ``[k sampled tokens | accepted draft count]``. The step is
        left OPEN: the caller decides how many tokens each row keeps and
        must call ``end_step(seq_ids, advanced)``."""
        tokens_k = np.asarray(tokens_k, np.int32)
        control = self.begin_step(seq_ids, positions, k=tokens_k.shape[1],
                                  tokens=tokens_k)
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
            n = self.tail_len.get(seq, 0) + adv
            if n < t:
                self.tail_len[seq] = n
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
        self._in_step = False
        self.gather_s += time.perf_counter() - t0

    def release_page(self, pid: int):
        """Recycle a destroyed pool page's device slot — the radix prefix
        tree hooks this (``on_release``) so an evicted or cleared pin
        frees its slot exactly like `free_seq` does for a retired
        sequence's pages."""
        self._device.release_pid(pid)

    # -- retire -------------------------------------------------------------
    def free_seq(self, seq: int) -> list:
        """Retire a request: drop its pool page refs (destroying pages
        whose last holder it was) and recycle its device slots. Returns
        the destroyed pool (page id, layer) pairs."""
        destroyed = self.pool.free(seq)
        for pid, _layer in destroyed:
            self._device.release_pid(pid)
        self.tail_len.pop(seq, None)
        self._pending_hashes.pop(seq, None)
        for slot in (self._tail_slot.pop(seq, None),
                     self._spill_slot.pop(seq, None)):
            if slot is not None:
                self._device.release_slot(slot)
        return destroyed


def extract_prefill_pages(model, caches, state: PagedKVState, seq_ids,
                          page_hashes=None, valid_len=None, skip_pages=None):
    """Write per-layer prefill caches (``{"k", "v"}`` of (b, s, hkv, hd))
    into the page pool, one batch row per sequence in `seq_ids`.
    `page_hashes[bi]` is that request's cumulative token-prefix digest
    list (prefix caching); `valid_len` keeps only the first rows of each
    cache (a right-padded prefill); `skip_pages[bi]` front pages were
    adopted from the prefix cache and are not put again."""
    for layer, c in enumerate(caches):
        row = state.layout.kv_of[layer]
        k = c["k"][:, :valid_len].float().cpu().numpy()
        v = c["v"][:, :valid_len].float().cpu().numpy()
        for bi, seq in enumerate(seq_ids):
            state.write_prefill(
                row, seq, k[bi], v[bi],
                page_hashes=page_hashes[bi] if page_hashes is not None
                else None,
                skip_pages=skip_pages[bi] if skip_pages is not None else 0)


def sample(logits, greedy: bool, temperature: float, generator=None):
    """Greedy argmax, or one draw from softmax(logits / temperature) with
    an explicit ``torch.Generator``. Returns int32 tokens."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


def build_fused_step(model, num_slots: int, *, k: int = 1,
                     backend: str = "auto", greedy: bool = True,
                     temperature: float = 1.0):
    """Build the fused decode step.

    ``k == 1``. Returned callable: ``step(arrays, tokens, control,
    generator) -> sampled tokens (b,) int32``, where ``arrays`` is the
    layer-stacked device pool tuple (its K/V float tensors receive the
    step's rows in place) and ``control`` the int32 block from
    `PagedKVState.begin_step`, already on the device. Everything the step
    touches is device-resident; the host sees only the sampled tokens.

    ``k > 1`` — the speculative VERIFY step (`_build_spec_step`).
    Returned callable: ``step(arrays, control, generator) -> verdict
    (b, k + 1) int32``."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > 1:
        return _build_spec_step(model, num_slots, k, backend=backend,
                                greedy=greedy, temperature=temperature)
    cfg = model.cfg
    lay = StateLayout(cfg, 1)
    cc = lay.cols(num_slots, k)

    def step(arrays, tokens, control, generator=None):
        kf, vf, kq, vq, ks, vs = arrays
        n_layers, c, t = kf.shape[:3]
        table = control[:, :num_slots].contiguous()
        lengths = control[:, cc.len].contiguous()
        positions = control[:, cc.pos]
        # flat (layer, slot, row) index of each batch row's new K/V row
        row_base = control[:, cc.tail].long() * t + control[:, cc.row]
        k_rows = kf.view((n_layers * c * t,) + kf.shape[3:])
        v_rows = vf.view((n_layers * c * t,) + vf.shape[3:])
        x = model.embed_in(tokens[:, None])
        for layer, p in enumerate(model.layers):
            h = rms_norm(x, p["norm1"])
            ap = p["attn"]
            q, k_new, v_new = decode_qkv(cfg, ap, h, positions)
            idx = lay.kv_of[layer] * (c * t) + row_base
            k_rows.index_copy_(0, idx, k_new[:, 0].to(kf.dtype))
            v_rows.index_copy_(0, idx, v_new[:, 0].to(vf.dtype))
            y = api.run("paged_attention", q[:, 0].contiguous(), kf, vf, kq,
                        vq, ks, vs, table, lengths, lay.kv_of[layer],
                        backend=backend)
            x = mlp_tail(cfg, p, x + out_proj(ap, y, x.dtype)[:, None])
        logits = model.head(x)[:, 0]
        return sample(logits, greedy, temperature, generator)

    return step


def _build_spec_step(model, num_slots: int, k: int, *, backend: str = "auto",
                     greedy: bool = True, temperature: float = 1.0):
    """The k-row verify step behind `build_fused_step(k > 1)`: the k input
    tokens (last accepted + k - 1 drafts, or a chunk of prompt tokens)
    ride in the control block; every layer scatters k K/V rows — rows
    past the page boundary go to the spill slot — and ONE paged-attention
    launch scores all k rows (row j sees ``lengths + j`` positions); the
    accept rule runs on the device: position j's sampled token is the
    model's answer after inputs 0..j, draft j survives while it equals the
    token sampled at position j - 1. Returns the ``[k sampled tokens |
    accepted draft count]`` verdict, so one download tells the host a
    whole accepted run. Greedy verification emits exactly the tokens of
    the k = 1 step."""
    cfg = model.cfg
    lay = StateLayout(cfg, 1)
    cc = lay.cols(num_slots, k)

    def step(arrays, control, generator=None):
        kf, vf, kq, vq, ks, vs = arrays
        n_layers, c, t = kf.shape[:3]
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
        k_rows = kf.view((n_layers * c * t,) + kf.shape[3:])
        v_rows = vf.view((n_layers * c * t,) + vf.shape[3:])
        b = tokens.shape[0]
        x = model.embed_in(tokens)                         # (b, k, d)
        for layer, p in enumerate(model.layers):
            h = rms_norm(x, p["norm1"])
            ap = p["attn"]
            q, k_new, v_new = decode_qkv(cfg, ap, h, positions)
            idx = lay.kv_of[layer] * (c * t) + row_base
            k_rows.index_copy_(0, idx, k_new.reshape(
                (b * k,) + k_new.shape[2:]).to(kf.dtype))
            v_rows.index_copy_(0, idx, v_new.reshape(
                (b * k,) + v_new.shape[2:]).to(vf.dtype))
            y = api.run("paged_attention", q.contiguous(), kf, vf, kq, vq,
                        ks, vs, table, lengths, lay.kv_of[layer],
                        backend=backend)
            x = mlp_tail(cfg, p, x + out_proj(ap, y, x.dtype))
        logits = model.head(x)                             # (b, k, V)
        samp = sample(logits.reshape(b * k, -1), greedy, temperature,
                      generator).reshape(b, k)
        match = (tokens[:, 1:] == samp[:, :-1]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        return torch.cat([samp, n_acc[:, None]], dim=1)

    return step
