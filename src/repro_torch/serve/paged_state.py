"""Per-layer paged-state layout: one serving substrate for three state
kinds.

The port of ``repro/serve/paged_state.py``. A layer's
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
charge per request). `rec_scan_tokens_tp`, `select_checkpoint`,
`ring_attend` and `gather_ring_kv` are the fused step's per-kind pieces,
plain PyTorch as the reference's are jnp.

Speculative verify over recurrent layers checkpoints: the pre-step state
is read once, the k candidate post-token states come out of
`rec_scan_tokens_tp`, and after the accept rule one scatter per store
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
from repro_torch.models.rglru import rglru_decode_core_tp
from repro_torch.models.ssm import ssd_decode_core_tp, ssm_dims
from repro_torch.sharding.partition import P, mesh_axis_sizes

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


# logical axes per store tensor (slot axis second), aligned with
# `rec_array_names`: SSD heads and the LRU width shard over "model" like
# attention heads; the SSD conv taps replicate (their channels mix
# head-local x with group-shared B / C)
_REC_LOGICAL = {
    "ssd_state": (None, "data", "model", None, None),
    "ssd_conv": (None, "data", None, None),
    "rg_h": (None, "data", "model"),
    "rg_conv": (None, "data", None, "model"),
}


def rec_array_specs(layout: StateLayout, plan=None) -> tuple:
    """`sharding.partition.P`s aligned with `rec_array_names(layout)`.
    Axes the plan's mesh does not carry replicate."""
    if plan is None:
        return tuple(P() for _ in rec_array_names(layout))
    sizes = mesh_axis_sizes(plan.mesh)
    return tuple(P(*(ax if ax is None or ax in sizes else None
                     for ax in _REC_LOGICAL[n]))
                 for n in rec_array_names(layout))


class RecurrentStore:
    """Slot-addressed device tensors holding every recurrent layer's
    per-sequence state, with the device pool's slot discipline: a trash
    slot per data shard for dead rows, free-list recycling, growth by
    doubling (each shard alone: global slot ``local * dp + shard``).

    ``arrays`` (in `names` order, a subset of ssd_state (L, R, H, P, N)
    fp32, ssd_conv (L, R, K-1, conv_dim) in the compute dtype, rg_h (L,
    R, W) fp32 and rg_conv (L, R, 3, W) fp32) are updated in place by the
    fused step; under a mesh plan shard (d, m) holds ``shard_arrays[d][m]``
    at the layout of `rec_array_specs`. ``writes`` counts host->device
    slot writes (one per tensor), ``reads`` device->host slot pulls (one
    per tensor)."""

    _instances: "weakref.WeakSet[RecurrentStore]" = weakref.WeakSet()

    def __init__(self, layout: StateLayout, batch_hint: int = 1,
                 compute_dtype=torch.float32, device="cuda", plan=None):
        cfg = layout.cfg
        self.layout = layout
        self.plan = plan
        self.shards = plan.dp if plan is not None else 1
        tp = plan.tp if plan is not None else 1
        self._devs = [[torch.device(device)]] if plan is None else \
            [[plan.device(d, m) for m in range(tp)]
             for d in range(self.shards)]
        self.device = self._devs[0][0]
        rows = -(-max(1, batch_hint) // self.shards)
        self._cap = [_next_pow2(max(8, rows + 1))] * self.shards
        self.names = list(rec_array_names(layout))
        shapes, dtypes = {}, {}
        if layout.n_ssd:
            din, nh, conv_dim = ssm_dims(cfg)
            if nh % tp:
                raise ValueError(f"{cfg.name}: ssm heads {nh} not divisible "
                                 f"by the model-axis size {tp}")
            k = cfg.ssm_conv_width
            shapes["ssd_state"] = (layout.n_ssd, nh, cfg.ssm_head_dim,
                                   cfg.ssm_state)
            shapes["ssd_conv"] = (layout.n_ssd, k - 1, conv_dim)
            dtypes["ssd_state"] = torch.float32
            dtypes["ssd_conv"] = compute_dtype
        if layout.n_rg:
            w = cfg.lru_width
            if w % tp:
                raise ValueError(f"{cfg.name}: lru_width {w} not divisible "
                                 f"by the model-axis size {tp}")
            shapes["rg_h"] = (layout.n_rg, w)
            shapes["rg_conv"] = (layout.n_rg, RGLRU_CONV_TAPS - 1, w)
            dtypes["rg_h"] = dtypes["rg_conv"] = torch.float32
        self._dtypes = [dtypes[n] for n in self.names]
        # the model-sharded dim of each tensor's block (no slot axis), or
        # None when it replicates
        self._mdim = [spec.index("model") - 1 if "model" in spec else None
                      for spec in rec_array_specs(layout, plan)]
        # per-shard block shapes (no slot axis)
        self._block = []
        for n, md in zip(self.names, self._mdim):
            shape = list(shapes[n])
            if md is not None:
                shape[md] //= tp
            self._block.append(tuple(shape))
        self.shard_arrays = [[self._zeros(self._cap[d], dev) for dev in row]
                             for d, row in enumerate(self._devs)]
        self._free = [[self._global(s, i)
                       for i in range(self._cap[s] - 1, -1, -1)]
                      for s in range(self.shards)]
        self._used: set[int] = set()
        self.trash_of = [self.alloc(s) for s in range(self.shards)]
        self.writes = 0
        self.reads = 0
        RecurrentStore._instances.add(self)

    def _zeros(self, cap: int, dev) -> tuple:
        return tuple(torch.zeros((b[0], cap) + b[1:], dtype=dt, device=dev)
                     for b, dt in zip(self._block, self._dtypes))

    @property
    def arrays(self) -> tuple:
        """The unsharded store's tensors."""
        if len(self.shard_arrays) * len(self.shard_arrays[0]) != 1:
            raise AttributeError("a sharded store's tensors are "
                                 "shard_arrays[d][m]")
        return self.shard_arrays[0][0]

    @property
    def trash(self) -> int:
        """Data shard 0's trash slot."""
        return self.trash_of[0]

    @property
    def slots(self) -> int:
        return sum(self._cap)

    def _global(self, shard: int, local: int) -> int:
        return local * self.shards + shard

    def local_slot(self, slot: int) -> int:
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
        slot = self._free[shard].pop()
        self._used.add(slot)
        return slot

    def release_slot(self, slot: int):
        self._used.discard(slot)
        self._free[self.shard_of_slot(slot)].append(slot)

    # -- content -------------------------------------------------------------
    def _part(self, i: int, m: int, val):
        """Model shard m's block of a full-width (L, ...) value of tensor
        `i`."""
        md = self._mdim[i]
        if md is None:
            return val
        w = self._block[i][md]
        return val.narrow(md, m * w, w)

    def write_slot(self, slot: int, blocks: dict):
        """Host -> device: install per-layer state blocks at one slot.
        ``blocks`` maps a subset of `names` to full-width (L_kind, ...)
        arrays; each model shard takes its block."""
        shard, local = self.shard_of_slot(slot), self.local_slot(slot)
        for name, val in blocks.items():
            i = self.names.index(name)
            val = torch.as_tensor(np.asarray(val))
            for m, arrays in enumerate(self.shard_arrays[shard]):
                a = arrays[i]
                a[:, local] = self._part(i, m, val).to(a.device, a.dtype)
            self.writes += 1

    def zero_slot(self, slot: int):
        self.write_slot(slot, {
            n: np.zeros((b[0],) + self._full(i)[1:], np.float32)
            for i, (n, b) in enumerate(zip(self.names, self._block))})

    def _full(self, i: int) -> tuple:
        """Full-width block shape of tensor `i` (no slot axis)."""
        shape = list(self._block[i])
        if self._mdim[i] is not None:
            shape[self._mdim[i]] *= len(self.shard_arrays[0])
        return tuple(shape)

    def read_slot(self, slot: int) -> dict:
        """Device -> host: every tensor's per-layer blocks at one slot, as
        full-width fp32 copies (``copy=True``: never a view of the store,
        whose slot is reused once a parked sequence releases it)."""
        shard, local = self.shard_of_slot(slot), self.local_slot(slot)
        out = {}
        for i, name in enumerate(self.names):
            parts = self.shard_arrays[shard]
            if self._mdim[i] is None:
                parts = parts[:1]
            vals = [arrays[i][:, local].to("cpu", torch.float32,
                                           copy=True).numpy()
                    for arrays in parts]
            out[name] = vals[0] if len(vals) == 1 else \
                np.concatenate(vals, axis=self._mdim[i])
            self.reads += 1
        return out

    def check_invariants(self) -> None:
        for shard, free in enumerate(self._free):
            uniq = set(free)
            assert len(uniq) == len(free), \
                "recurrent free list holds duplicates"
            for slot in uniq:
                assert self.shard_of_slot(slot) == shard and \
                    0 <= self.local_slot(slot) < self._cap[shard], \
                    f"free slot {slot} out of range"
                assert slot not in self._used, \
                    f"recurrent slot {slot} both free and in use"


# ---------------------------------------------------------------------------
# The fused step's per-kind pieces
# ---------------------------------------------------------------------------
def rec_scan_tokens_tp(cfg, mixer, ps, xs, state0s, psum):
    """Run k one-token recurrent steps over a mesh plan's model axis from
    each shard's state (SSD: (conv, state); RG-LRU: (h, conv)): ``ps``,
    ``xs`` (b, k, d) and ``state0s`` hold one entry per model shard, each
    step through the one-token core (`ssd_decode_core_tp` /
    `rglru_decode_core_tp`, reducing through ``psum``), keeping every
    post-token state: nothing is overwritten, so a rollback is selecting
    checkpoint ``keep - 1``. Returns the lists ``(y (b, k, d), states)``,
    each states leaf (k, b, ...)."""
    core = ssd_decode_core_tp if mixer == SSD else rglru_decode_core_tp
    tp = len(ps)
    carry = [tuple(s) for s in state0s]
    ys = [[] for _ in range(tp)]
    stacks = [([], []) for _ in range(tp)]
    for j in range(xs[0].shape[1]):
        y, first, second = core(cfg, ps, [x[:, j:j + 1] for x in xs],
                                [c[0] for c in carry], [c[1] for c in carry],
                                psum)
        carry = list(zip(first, second))
        for m in range(tp):
            ys[m].append(y[m])
            for leaf, c in zip(stacks[m], carry[m]):
                leaf.append(c)
    return ([torch.cat(y, dim=1) for y in ys],
            [tuple(torch.stack(l) for l in st) for st in stacks])


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
