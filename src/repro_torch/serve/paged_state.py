"""Per-layer paged-state layout: one serving substrate for three state
kinds.

The port of ``repro/serve/paged_state.py`` on one device. A layer's
serving state lives on one of three substrates, keyed off the config's
layer pattern:

``kv``    `ATTN` layers: page-pool KV, O(len / page_tokens) pages per
          sequence, tiered fast/slow, prefix-shareable by content hash.
``rec``   `SSD` / `RGLRU` layers: ONE fixed-size state block per
          sequence per layer (the SSD (H, P, N) state + conv taps, or the
          RG-LRU (W,) state + conv taps) in a `RecurrentStore`: O(1) per
          sequence, updated in place by the fused step through the
          one-token cores.
``ring``  `LOCAL_ATTN` layers: pages fill like KV pages, but once the
          window has slid past a page it is dropped and its pool page
          and device slot recycled, so the need is O(window). Ring pages
          carry no content hash.

`StateLayout` is the static map from a config's stack onto these
substrates (store rows per layer, the control-block columns, the page
charge per request). `rec_scan_tokens`, `select_checkpoint`,
`ring_attend` and `gather_ring_kv` are the fused step's per-kind pieces,
plain PyTorch as the reference's are jnp.

Speculative verify over recurrent layers checkpoints: the pre-step state
is read once, the k candidate post-token states come out of
`rec_scan_tokens`, and after the accept rule one scatter per store
writes checkpoint ``keep - 1``. Rollback is selecting an earlier
checkpoint, O(1) per token, never a replay.
"""
from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, CROSS_ATTN, LOCAL_ATTN, MLA,
                                      MLP_DENSE, MLP_MOE, MLP_NONE, RGLRU,
                                      SSD)
from repro_torch.models.rglru import CONV_TAPS as RGLRU_CONV_TAPS
from repro_torch.models.rglru import rglru_decode_core
from repro_torch.models.ssm import ssd_decode_core, ssm_dims

KV, REC, RING = "kv", "rec", "ring"


def state_kind(mixer: str):
    """Which substrate a mixer's layer state lives on, or None for mixers
    the protocol does not cover (cross-attention)."""
    if mixer in (ATTN, MLA):
        return KV
    if mixer == LOCAL_ATTN:
        return RING
    if mixer in (SSD, RGLRU):
        return REC
    return None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ControlCols:
    """Column offsets into the per-step int32 control block for a table of
    `slots` pages. ``k == 1`` (plain decode): ``[page table | tail slot |
    tail row | position | kv length]``. ``k > 1`` (speculative verify and
    chunk fill): ``[page table | tail slot | spill slot | tail row |
    position | kv length | k input tokens]``. A stack with recurrent or
    ring layers appends:

    ``rec``        the row's recurrent slot (has_rec)
    ``base``       dropped ring pages: table position n holds logical page
                   ``base + n`` (has_ring)
    ``keep_fixed`` k > 1 only: recurrent state to commit for a chunk row
                   (-1 for verify rows, whose keep is the accept rule's)
    ``keep_cap``   k > 1 only: cap on accepted drafts (the row's real
                   proposal count; pad drafts must not advance state)
    """

    def __init__(self, layout: "StateLayout", slots: int, k: int = 1):
        s = slots
        if k == 1:
            self.tail, self.row, self.pos, self.len = s, s + 1, s + 2, s + 3
            w = s + 4
        else:
            self.tail, self.spill = s, s + 1
            self.row, self.pos, self.len = s + 2, s + 3, s + 4
            self.tok = s + 5
            w = s + 5 + k
        if layout.has_rec:
            self.rec = w
            w += 1
        if layout.has_ring:
            self.base = w
            w += 1
        if layout.has_rec and k > 1:
            self.keep_fixed, self.keep_cap = w, w + 1
            w += 2
        self.width = w


class StateLayout:
    """Static map of a config's layer stack onto the paged-state
    substrate: ``kv_of`` (KV and ring layers -> pool layer row),
    ``ssd_of`` / ``rg_of`` (recurrent layers -> store row), the control
    columns and the page charge per request."""

    def __init__(self, cfg, page_tokens: int):
        self.cfg = cfg
        self.page_tokens = page_tokens
        self.kv_of: dict[int, int] = {}
        self.ssd_of: dict[int, int] = {}
        self.rg_of: dict[int, int] = {}
        kinds = set()
        for l, (m, _) in enumerate(cfg.layer_kinds()):
            kind = state_kind(m)
            kinds.add(kind)
            if kind in (KV, RING):
                self.kv_of[l] = len(self.kv_of)
            elif m == SSD:
                self.ssd_of[l] = len(self.ssd_of)
            elif m == RGLRU:
                self.rg_of[l] = len(self.rg_of)
        self.n_kv = len(self.kv_of)
        self.n_ssd = len(self.ssd_of)
        self.n_rg = len(self.rg_of)
        self.has_rec = REC in kinds
        self.has_ring = RING in kinds
        self.window = cfg.window if self.has_ring else 0

    def cols(self, slots: int, k: int = 1) -> ControlCols:
        return ControlCols(self, slots, k)

    # -- ring math -----------------------------------------------------------
    def ring_pages(self) -> int:
        """Full pages a ring layer can need at once: the window plus one
        partly out-of-window page — O(window / page_tokens)."""
        return -(-self.window // self.page_tokens) + 1

    def ring_base(self, pos: int) -> int:
        """Logical index of the oldest page a query at absolute position
        >= ``pos`` can still see (the oldest in-window position is
        ``pos - window + 1``). Pages below it are recyclable."""
        oldest = pos - self.window + 1
        return max(0, oldest // self.page_tokens) if oldest > 0 else 0

    # -- admission math ------------------------------------------------------
    def pages_needed(self, cap_tokens: int, tail_slots: int = 1) -> int:
        """Pool-page charge for a request growing to ``cap_tokens``: KV
        layers pay O(len) pages, ring layers O(window), recurrent layers
        nothing (their state lives in the `RecurrentStore`). One charge
        per KV-bearing layer."""
        full = -(-cap_tokens // self.page_tokens)
        if self.has_ring:
            full = min(full, self.ring_pages())
        return self.n_kv * (full + tail_slots)


def supports_paged_layout(cfg) -> bool:
    """Whether the paged-state protocol covers every layer of `cfg`:
    ATTN / LOCAL_ATTN / SSD / RGLRU mixers with dense/MoE/no MLPs, and no
    stack mixing ATTN with LOCAL_ATTN (ring recycling drops whole
    layer-uniform page groups). MLA and cross-attention decline."""
    kinds = cfg.layer_kinds()
    mixers = {m for m, _ in kinds}
    if any(mlp not in (MLP_DENSE, MLP_MOE, MLP_NONE) for _, mlp in kinds):
        return False
    if mixers & {MLA, CROSS_ATTN}:
        return False
    if not mixers <= {ATTN, LOCAL_ATTN, SSD, RGLRU}:
        return False
    return not (ATTN in mixers and LOCAL_ATTN in mixers)


# ---------------------------------------------------------------------------
# Device-resident recurrent slot store
# ---------------------------------------------------------------------------
def rec_array_names(layout: StateLayout) -> tuple:
    """Names (and order) of the recurrent store tensors a layout needs."""
    names = []
    if layout.n_ssd:
        names += ["ssd_state", "ssd_conv"]
    if layout.n_rg:
        names += ["rg_h", "rg_conv"]
    return tuple(names)


def _flat1(a):
    return a.view((a.shape[0] * a.shape[1],) + a.shape[2:])


def rec_gather(arr, idx: int, slots):
    """(b, ...) state blocks at rows ``[idx, slots]`` of an (L, R, ...)
    store tensor."""
    return _flat1(arr)[idx * arr.shape[1] + slots.long()]


def rec_scatter(arr, idx: int, slots, vals):
    """In-place write of per-row state blocks at ``[idx, slots]``."""
    _flat1(arr).index_copy_(0, idx * arr.shape[1] + slots.long(),
                            vals.to(arr.dtype))


class RecurrentStore:
    """Slot-addressed device tensors holding every recurrent layer's
    per-sequence state, with the device pool's slot discipline: a trash
    slot for dead rows, free-list recycling, growth by doubling.

    ``arrays`` (in `names` order, a subset of ssd_state (L, R, H, P, N)
    fp32, ssd_conv (L, R, K-1, conv_dim) in the compute dtype, rg_h (L,
    R, W) fp32 and rg_conv (L, R, 3, W) fp32) are updated in place by the
    fused step. ``writes`` counts host->device slot writes (one per
    tensor), ``reads`` device->host slot pulls (one per tensor)."""

    _instances: "weakref.WeakSet[RecurrentStore]" = weakref.WeakSet()

    def __init__(self, layout: StateLayout, batch_hint: int = 1,
                 compute_dtype=torch.float32, device="cuda"):
        cfg = layout.cfg
        self.layout = layout
        self.device = torch.device(device)
        self.slots = _next_pow2(max(8, max(1, batch_hint) + 1))
        self.names = list(rec_array_names(layout))
        shapes, dtypes = {}, {}
        if layout.n_ssd:
            din, nh, conv_dim = ssm_dims(cfg)
            k = cfg.ssm_conv_width
            shapes["ssd_state"] = (layout.n_ssd, self.slots, nh,
                                   cfg.ssm_head_dim, cfg.ssm_state)
            shapes["ssd_conv"] = (layout.n_ssd, self.slots, k - 1, conv_dim)
            dtypes["ssd_state"] = torch.float32
            dtypes["ssd_conv"] = compute_dtype
        if layout.n_rg:
            w = cfg.lru_width
            shapes["rg_h"] = (layout.n_rg, self.slots, w)
            shapes["rg_conv"] = (layout.n_rg, self.slots,
                                 RGLRU_CONV_TAPS - 1, w)
            dtypes["rg_h"] = dtypes["rg_conv"] = torch.float32
        self.arrays = tuple(torch.zeros(shapes[n], dtype=dtypes[n],
                                        device=self.device)
                            for n in self.names)
        self._free = list(range(self.slots - 1, -1, -1))   # pop() -> lowest
        self._used: set[int] = set()
        self.trash = self.alloc()
        self.writes = 0
        self.reads = 0
        RecurrentStore._instances.add(self)

    # -- slots ---------------------------------------------------------------
    def _grow(self):
        old = self.slots
        self.slots *= 2
        new = []
        for a in self.arrays:
            b = a.new_zeros((a.shape[0], self.slots) + a.shape[2:])
            b[:, :old] = a
            new.append(b)
        self.arrays = tuple(new)
        self._free.extend(range(self.slots - 1, old - 1, -1))

    def alloc(self) -> int:
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self._used.add(slot)
        return slot

    def release_slot(self, slot: int):
        self._used.discard(slot)
        self._free.append(slot)

    # -- content -------------------------------------------------------------
    def write_slot(self, slot: int, blocks: dict):
        """Host -> device: install per-layer state blocks at one slot.
        ``blocks`` maps a subset of `names` to (L_kind, ...) arrays."""
        for name, val in blocks.items():
            a = self.arrays[self.names.index(name)]
            val = torch.as_tensor(np.asarray(val)).to(self.device, a.dtype)
            a[:, slot] = val
            self.writes += 1

    def zero_slot(self, slot: int):
        self.write_slot(slot, {
            n: np.zeros((a.shape[0],) + tuple(a.shape[2:]), np.float32)
            for n, a in zip(self.names, self.arrays)})

    def read_slot(self, slot: int) -> dict:
        """Device -> host: every tensor's per-layer blocks at one slot."""
        out = {}
        for name, a in zip(self.names, self.arrays):
            out[name] = a[:, slot].float().cpu().numpy()
            self.reads += 1
        return out

    def check_invariants(self) -> None:
        uniq = set(self._free)
        assert len(uniq) == len(self._free), \
            "recurrent free list holds duplicates"
        for slot in uniq:
            assert 0 <= slot < self.slots, f"free slot {slot} out of range"
            assert slot not in self._used, \
                f"recurrent slot {slot} both free and in use"


# ---------------------------------------------------------------------------
# The fused step's per-kind pieces
# ---------------------------------------------------------------------------
def rec_scan_tokens(cfg, mixer, p, x, state0):
    """Run k one-token recurrent steps over x: (b, k, d) from the state
    ``state0`` (SSD: (conv, state); RG-LRU: (h, conv)), through the
    one-token decode core, keeping every post-token state: nothing is
    overwritten, so a rollback is selecting checkpoint ``keep - 1``.
    Returns ``(y (b, k, d), states)``, each states leaf (k, b, ...)."""
    core = ssd_decode_core if mixer == SSD else rglru_decode_core
    stacks: list = [[], []]
    carry = state0
    ys = []
    for j in range(x.shape[1]):
        if mixer == SSD:
            y, conv, st = core(cfg, p, x[:, j:j + 1], carry[0], carry[1])
            carry = (conv, st)
        else:
            y, h, conv = core(cfg, p, x[:, j:j + 1], carry[0], carry[1])
            carry = (h, conv)
        ys.append(y)
        for leaf, c in zip(stacks, carry):
            leaf.append(c)
    return torch.cat(ys, dim=1), tuple(torch.stack(l) for l in stacks)


def select_checkpoint(stacked, keep):
    """Per-row checkpoint pick: stacked (n, b, ...) candidate states,
    keep (b,) in [1, n] -> (b, ...) the state after `keep` tokens."""
    sel = torch.clamp(keep - 1, 0, stacked.shape[0] - 1).long()
    idx = sel.view((1, -1) + (1,) * (stacked.ndim - 2)) \
        .expand((1,) + tuple(stacked.shape[1:]))
    return torch.gather(stacked, 0, idx)[0]


def ring_attend(q, k_all, v_all, *, lengths, base, positions, window: int,
                page_tokens: int):
    """Sliding-window attention over ring-gathered pages, with the
    numerics of `attention_core` (fp32 scores and softmax, -1e30 masks,
    normaliser clamped at 1e-30).

    q: (b, kq, hq, hd) already roped; k_all / v_all: (b, S, hkv, hd), the
    ring gather (table position n holds logical page ``base + n``);
    lengths: (b,) valid rows for query row 0; base: (b,) dropped-page
    counts; positions: (b, kq) absolute query positions. Column j's
    absolute position is ``base * page_tokens + j``; query row jq sees
    ``j < lengths + jq`` within the window."""
    b, kq, hq, hd = q.shape
    hkv = k_all.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = (q.reshape(b, kq, hkv, g, hd) * scale).to(q.dtype)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k_all.float())
    j = torch.arange(k_all.shape[1], dtype=torch.int32, device=q.device)
    offs = torch.arange(kq, dtype=torch.int32, device=q.device)
    ok = j[None, None, :] < (lengths[:, None, None] + offs[None, :, None])
    abs_col = base[:, None] * page_tokens + j[None, :]          # (b, S)
    ok &= abs_col[:, None, :] > (positions[:, :, None] - window)
    s = s + torch.where(ok, 0.0, -1e30)[:, None, None]          # (b,h,g,q,s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    pv = torch.einsum("bhgqs,bshd->bhgqd", p.to(v_all.dtype).float(),
                      v_all.float())
    out = pv / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, kq, hq, hd) \
        .to(v_all.dtype)


def gather_ring_kv(arrays, pool_layer: int, table):
    """Gather one layer's ring pages for the batch from the stacked pool
    tensors, dequantizing slow cells as the paged kernel does (``k =
    k_pages + k_quant * k_scale``). table: (b, s) slots -> (k_all, v_all):
    (b, s * t, hkv, hd)."""
    kf, vf, kq, vq, ks, vs = arrays
    c, t = kf.shape[1], kf.shape[2]
    rows = pool_layer * c + table.long()                       # (b, s)
    b, s = table.shape

    def merge(f, q, sc):
        out = _flat1(f)[rows] + _flat1(q)[rows].float() \
            * _flat1(sc)[rows][..., None]
        return out.reshape(b, s * t, out.shape[-2], out.shape[-1])

    return merge(kf, kq, ks), merge(vf, vq, vs)
