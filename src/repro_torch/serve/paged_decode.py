"""Paged decode: page-pool KV state + the fused decode step.

The port of ``repro/serve/paged_decode.py`` for global-attention stacks
and one token per step. The KV cache lives in a tiered `PagedKVPool`
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

Page lifecycle:
  prefill  -> full pages ``put`` per (sequence, layer), remainder rows
              streamed into a layer-uniform tail slot
  decode   -> each step appends the token's K/V rows (one per layer) to
              the tail slot; a filled tail becomes a pool ``put`` per
              layer (tier decided there), the slot adopted in place
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

    Batch rows may carry ``seq_id = -1`` (continuous batching pads retired
    rows): they write to a scratch slot and attend a zero page.

    ``h2d`` / ``d2h`` count the explicit host->device / device->host
    transfers of the decode path; `transfer_counts` adds the device
    pool's write batches and fill readbacks."""

    def __init__(self, pool: PagedKVPool, capacity: int,
                 layout: StateLayout, hkv: int, hd: int, *,
                 batch_hint: int = 1, device="cuda"):
        self.pool = pool
        self.layout = layout
        self.num_layers = num_layers = layout.n_kv
        self.hkv, self.hd = hkv, hd
        self.device = torch.device(device)
        t = pool.page_tokens
        # pages covering capacity + the tail page, rounded to a mult. of 8
        self.slots = -(-(-(-capacity // t) + 1) // 8) * 8
        self.batch_hint = max(1, batch_hint)
        self.tail_len: dict[int, int] = {}     # seq -> tail rows (all layers)
        self._tail_slot: dict[int, int] = {}   # seq -> device slot
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
                      v: np.ndarray, page_hashes=None):
        """k, v: (prefill_len, hkv, hd) — full pages into the pool, the
        remainder rows into the sequence's tail slot. `page_hashes[p]`
        (cumulative token-prefix digests) enables ref-counted page sharing
        across requests with identical prompt prefixes."""
        t = self.pool.page_tokens
        n_full = k.shape[0] // t
        for p in range(n_full):
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

    def _ensure_tail_slot(self, seq: int) -> int:
        slot = self._tail_slot.get(seq)
        if slot is None:
            slot = self._device.alloc()
            self._device.zero_slot(slot)
            self._tail_slot[seq] = slot
        return slot

    # -- per-step protocol ---------------------------------------------------
    def _page_groups(self, seq: int):
        """Per-layer pool pids of each logical page of `seq`, zipped into
        layer-uniform groups, with the slot-overflow check (+ the tail
        slot every decode step appends into)."""
        per_layer = [self.pool.seq_pages(seq, l)
                     for l in range(self.num_layers)]
        n = len(per_layer[0])
        if any(len(p) != n for p in per_layer):
            raise RuntimeError(
                f"sequence {seq}: ragged page counts across layers "
                f"({[len(p) for p in per_layer]}) — paged decode requires "
                f"layer-uniform page structure")
        if n + 1 > self.slots:
            raise ValueError(
                f"sequence {seq}: {n} pages + 1 tail page exceed the "
                f"page-table capacity of {self.slots} slots "
                f"({self.slots * self.pool.page_tokens} tokens); size the "
                f"PagedKVState capacity to the longest request")
        return list(zip(*per_layer)) if n else []

    def begin_step(self, seq_ids, positions) -> np.ndarray:
        """Host bookkeeping before one decode step: touch each live page
        once (one pool-clock tick for the whole step), sync the device
        mirror (new prefill pages, demotion rewrites), and build the
        ``(b, slots + 4)`` int32 control block ``[page table | tail slot |
        tail row | position | kv length]``, where the length already
        counts the token this step appends. Dead rows (seq -1) get the
        scratch slot and length 1."""
        t0 = time.perf_counter()
        t = self.pool.page_tokens
        b = len(seq_ids)
        positions = np.broadcast_to(np.asarray(positions, np.int32), (b,))
        cc = self.layout.cols(self.slots)
        control = np.zeros((b, cc.width), np.int32)
        control[:, cc.tail] = self._trash
        control[:, cc.len] = 1
        groups_by_row, touch_pids, sync_groups = [], [], []
        for seq in seq_ids:
            if seq < 0:
                groups_by_row.append(None)
                continue
            groups = self._page_groups(seq)
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
            for n, g in enumerate(groups):
                control[i, n] = self._device.slot(g[0])
            control[i, cc.tail] = self._ensure_tail_slot(seq)
            control[i, len(groups)] = control[i, cc.tail]
            control[i, cc.row] = self.tail_len.get(seq, 0)
            control[i, cc.pos] = positions[i]
            control[i, cc.len] = len(groups) * t + self.tail_len.get(seq, 0) + 1
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

    def end_step(self, seq_ids):
        """Host bookkeeping after one decode step: bump tail counters and
        turn filled tails into pool pages — per layer, tier decided by the
        pool; the device tail slot is adopted in place (its float rows are
        already current; slow placements are rewritten by the next sync).
        A filled page is read back once (2 transfers per page_tokens
        tokens); row data never crosses on the per-token path."""
        if not self._in_step:
            raise RuntimeError("end_step() without begin_step()")
        t0 = time.perf_counter()
        t = self.pool.page_tokens
        for seq in seq_ids:
            if seq < 0:
                continue
            n = self.tail_len.get(seq, 0) + 1
            if n < t:
                self.tail_len[seq] = n
                continue
            self.tail_len[seq] = 0
            slot = self._tail_slot.pop(seq)
            k_all, v_all = self._device.read_slot(slot)
            group = tuple(self.pool.put(seq, k_all[l], v_all[l], layer=l)
                          for l in range(self.num_layers))
            self._device.adopt(group, slot, self.pool)
        self._in_step = False
        self.gather_s += time.perf_counter() - t0

    # -- retire -------------------------------------------------------------
    def free_seq(self, seq: int) -> list:
        """Retire a request: drop its pool page refs (destroying pages
        whose last holder it was) and recycle its device slots. Returns
        the destroyed pool (page id, layer) pairs."""
        destroyed = self.pool.free(seq)
        for pid, _layer in destroyed:
            self._device.release_pid(pid)
        self.tail_len.pop(seq, None)
        slot = self._tail_slot.pop(seq, None)
        if slot is not None:
            self._device.release_slot(slot)
        return destroyed


def extract_prefill_pages(model, caches, state: PagedKVState, seq_ids,
                          page_hashes=None):
    """Write per-layer prefill caches (``{"k", "v"}`` of (b, s, hkv, hd))
    into the page pool, one batch row per sequence in `seq_ids`.
    `page_hashes[bi]` is that request's cumulative token-prefix digest
    list (prefix caching)."""
    for layer, c in enumerate(caches):
        row = state.layout.kv_of[layer]
        k = c["k"].float().cpu().numpy()
        v = c["v"].float().cpu().numpy()
        for bi, seq in enumerate(seq_ids):
            state.write_prefill(
                row, seq, k[bi], v[bi],
                page_hashes=page_hashes[bi] if page_hashes is not None
                else None)


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
    """Build the fused decode step. Returned callable:
    ``step(arrays, tokens, control, generator) -> sampled tokens (b,)
    int32``, where ``arrays`` is the layer-stacked device pool tuple
    (its K/V float tensors receive the step's rows in place) and
    ``control`` the int32 block from `PagedKVState.begin_step`, already
    on the device. Everything the step touches is device-resident; the
    host sees only the sampled tokens."""
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
